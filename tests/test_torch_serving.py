"""The port's serving path against the JAX package's: ``generate`` and
``DecodeEngine`` (``run`` and ``run_many``, bucketed and chunked prefill,
fp32 and int8 caches) give the same greedy tokens as JAX ``generate`` on
the same JAX-initialized parameters and prompts from a numpy seed.

Before any comparison, the fixture checks that every greedy decision of the
reference has a top-2 logit gap above 1e-4: the two frameworks' logits agree
to 1e-5 in fp32, so no near-tie can flip a token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.inference import SamplingConfig as JaxSampling
from tpu_flash.inference import generate as jax_generate
from tpu_flash.inference.sampler import adjusted_logits as jax_adjusted
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import (DecodeEngine, Request, SamplingConfig,
                                       adjusted_logits, generate)

torch.set_num_threads(1)

CFG = dict(n_vocab=128, n_embd=64, n_head=4, n_positions=256, n_layer=2,
           ff_middle_dim=128, p_dropout=0.0, attention_kind="naive")
LENS = [3, 12, 7, 20]
N_NEW, MAX_LEN = 8, 64


@pytest.fixture(scope="module")
def ref():
    """JAX model, params, prompts and the JAX greedy tokens (fp32 and
    int8 caches); the port model with the same params."""
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, CFG["n_vocab"], n).tolist() for n in LENS]
    ids = np.zeros((len(LENS), max(LENS)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    tokens, n_gens = {}, {}
    for quant in ("none", "int8"):
        run = jax.jit(lambda p, i, n, q=quant: jax_generate(
            jm, p, i, n, JaxSampling(max_new_tokens=N_NEW), max_len=MAX_LEN,
            kv_quant=q))
        toks, n_gen = run(params, jnp.asarray(ids), jnp.asarray(LENS))
        tokens[quant], n_gens[quant] = np.asarray(toks), np.asarray(n_gen)
    # every fp32 greedy decision must be far from a tie
    full = np.zeros((len(LENS), max(LENS) + N_NEW), np.int32)
    for i, p in enumerate(prompts):
        full[i, :len(p) + N_NEW] = p + tokens["none"][i].tolist()
    logits = np.asarray(jax.jit(lambda p, x: jm(p, x))(params,
                                                       jnp.asarray(full)))
    for i, n in enumerate(LENS):
        top2 = np.sort(logits[i, n - 1:n - 1 + N_NEW], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4
        assert (logits[i, n - 1:n - 1 + N_NEW].argmax(-1)
                == tokens["none"][i]).all()
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.load_jax_params(tm, params)
    return dict(model=tm, prompts=prompts, ids=ids, tokens=tokens,
                n_gen=n_gens)


def engine_tokens(ref, drive, n_slots=2, **kw):
    eng = DecodeEngine(ref["model"], n_slots=n_slots, max_len=MAX_LEN,
                       sampling=SamplingConfig(max_new_tokens=N_NEW),
                       device="cpu", **kw)
    for uid, p in enumerate(ref["prompts"]):
        eng.submit(Request(uid, p))
    done = eng.run() if drive == "run" else eng.run_many(drive)
    assert sorted(c.uid for c in done) == list(range(len(LENS)))
    assert all(c.finished_reason == "length" for c in done)
    assert eng.stats["admissions"] == len(LENS)
    return {c.uid: c.tokens for c in done}


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_generate_matches_jax(ref, quant):
    toks, n_gen = generate(ref["model"], ref["ids"], LENS,
                           SamplingConfig(max_new_tokens=N_NEW),
                           max_len=MAX_LEN, kv_quant=quant, device="cpu")
    np.testing.assert_array_equal(toks.numpy(), ref["tokens"][quant])
    # n_gen counts tokens other than pad_id, as JAX does: a generated id 0
    # (the pad id) is not counted
    np.testing.assert_array_equal(n_gen.numpy(), ref["n_gen"][quant])


@pytest.mark.parametrize("drive,chunk,quant", [
    ("run", None, "none"),           # bucketed prefill, 2 slots for 4
    (3, None, "none"),               # run_many(3)
    ("run", 4, "none"),              # chunked prefill: 4-token chunks
    (3, 4, "int8"),                  # take the decode path over the cache
])
def test_engine_matches_jax(ref, drive, chunk, quant):
    got = engine_tokens(ref, drive, prefill_chunk=chunk, kv_quant=quant)
    for uid, toks in got.items():
        assert toks == ref["tokens"][quant][uid].tolist(), uid


def test_engine_retires_on_eos_mid_run(ref):
    """eos as the third greedy token of prompt 0: that request ends after
    two tokens with reason "eos", per-token and in a 4-step run alike."""
    want = ref["tokens"]["none"][0].tolist()
    eos = want[2]
    assert eos not in want[:2]
    for drive in ("run", 4):
        eng = DecodeEngine(ref["model"], n_slots=2, max_len=MAX_LEN,
                           sampling=SamplingConfig(max_new_tokens=N_NEW,
                                                   eos_id=eos),
                           device="cpu")
        eng.submit(Request(0, ref["prompts"][0]))
        done = eng.run() if drive == "run" else eng.run_many(drive)
        assert (done[0].tokens, done[0].finished_reason) == (want[:2], "eos")


def test_engine_retires_at_max_len(ref):
    """A 12-token prompt in a 16-row cache: the request stops when
    tokens + cache length reach max_len - 1, and run_many's step count is
    clamped to the cache room; both drives agree with the JAX tokens."""
    outs = []
    for drive in ("run", 8):
        eng = DecodeEngine(ref["model"], n_slots=1, max_len=16,
                           sampling=SamplingConfig(max_new_tokens=100),
                           device="cpu")
        eng.submit(Request(1, ref["prompts"][1]))
        done = eng.run() if drive == "run" else eng.run_many(drive)
        assert done[0].finished_reason == "length"
        outs.append(done[0].tokens)
    assert outs[0] == outs[1]
    # the first token comes with admission (cache length 12) and each step
    # adds one row: n + (12 + n - 1) >= 15 first holds at n = 2
    assert outs[0] == ref["tokens"]["none"][1][:2].tolist()


def test_engine_options_outside_the_slice_raise(ref):
    with pytest.raises(NotImplementedError, match="A6"):
        DecodeEngine(ref["model"], n_slots=1, max_len=8,
                     sampling=SamplingConfig(), draft_model=ref["model"],
                     device="cpu")
    eng = DecodeEngine(ref["model"], n_slots=1, max_len=8,
                       sampling=SamplingConfig(), prefill_chunk=4,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        eng.set_prefix([1, 2])
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(ref["model"], n_slots=1, max_len=8,
                     sampling=SamplingConfig(), prefill_chunk=0,
                     device="cpu")


@pytest.mark.parametrize("kw", [dict(temperature=0.7, top_k=5),
                                dict(temperature=1.3, top_p=0.8),
                                dict(temperature=0.5, top_k=9, top_p=0.6)])
def test_adjusted_logits_match_jax(rng, kw):
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    want = np.asarray(jax_adjusted(jnp.asarray(logits), JaxSampling(**kw)))
    got = adjusted_logits(torch.from_numpy(logits), SamplingConfig(**kw))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    np.testing.assert_allclose(got.numpy()[~np.isinf(want)],
                               want[~np.isinf(want)], rtol=1e-6)


def test_random_sampling_is_seeded(ref):
    """Temperature sampling draws from the engine's own generator: the
    same seed gives the same completions, another seed other ones."""
    def run(seed):
        eng = DecodeEngine(ref["model"], n_slots=2, max_len=MAX_LEN,
                           sampling=SamplingConfig(max_new_tokens=N_NEW,
                                                   temperature=1.0, top_k=20),
                           seed=seed, device="cpu")
        for uid, p in enumerate(ref["prompts"]):
            eng.submit(Request(uid, p))
        return {c.uid: c.tokens for c in eng.run_many(4)}

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c
    assert all(0 <= t < CFG["n_vocab"] for toks in a.values() for t in toks)
