"""Sharded decode through the port's ``DecodeEngine`` on 4 gloo ranks
(dp2 x tp2: each rank's caches hold its slots and its 4 of 8 heads, the
flash-decode kernel's plain version running on them) against the JAX
package's engine under its (2, 2) mesh, from the same JAX-initialized
parameters: the JAX dryrun's four drives (plain, chunked prefill, a shared
prefix, ``run_many``) give token-identical completions, with bf16-free fp32
caches against JAX and with int8 caches against the single-process port."""

import jax
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash import parallel as jpar
from tpu_flash.inference.engine import DecodeEngine as JaxEngine
from tpu_flash.inference.engine import Request as JaxRequest
from tpu_flash.inference.sampler import SamplingConfig as JaxSampling
from tpu_flash_torch.parallel import dryrun

torch.set_num_threads(1)

CFG = dict(n_vocab=512, n_embd=128, n_head=8, n_positions=64, n_layer=2,
           p_dropout=0.0, attention_kind="flash")
MODES = tuple(dryrun.DECODE_MODES)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    model = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = model.init(jax.random.key(0))
    port = dryrun.run_world(
        "tpu_flash_torch.parallel.dryrun.rank_decode", 4, device="cpu",
        timeout=240,
        config_kw={}, data=2, model=2, params=np_tree(params),
        kv_quants=("none", "int8"))
    return model, params, port


def jax_engine(model, params, mode):
    spec = dryrun.DECODE_MODES[mode]
    ctx = jpar.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    jpar.set_parallel_context(ctx)
    try:
        engine = JaxEngine(model, params, n_slots=2, max_len=32,
                           sampling=JaxSampling(max_new_tokens=6),
                           **spec["kw"])
        if spec["prefix"] is not None:
            engine.set_prefix(spec["prefix"])
        for uid, p in dryrun.DECODE_PROMPTS.items():
            engine.submit(JaxRequest(uid, p))
        done = (engine.run_many(4) if spec["method"] == "run_many"
                else engine.run())
    finally:
        jpar.set_parallel_context(None)
    return {c.uid: (tuple(c.tokens), c.finished_reason) for c in done}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_engine_matches_jax(setup, mode):
    model, params, port = setup
    got = port[0]["completions"][f"{mode}/none"]
    assert got == jax_engine(model, params, mode)
    for r in port[1:]:                   # every rank's host logic agrees
        assert r["completions"][f"{mode}/none"] == got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_sharded_engine_matches_single_process(setup, mode, kv_quant):
    r0 = setup[2][0]
    key = f"{mode}/{kv_quant}"
    assert r0["completions"][key] == r0["reference"][key]


def test_each_rank_caches_its_heads(setup):
    assert all(r["kv_heads_local"] == 4 for r in setup[2])
    assert setup[2][0]["transport"] == "gloo-host"
