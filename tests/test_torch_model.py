"""The port's DecoderLM against the JAX package's, with the same
JAX-initialized parameters loaded through ``load_jax_params``: uncached and
cached logits (prefill through the composed graph, decode through the
decode kernel's path) at 1e-5 in fp32, and the bf16 model at a looser
tolerance.  Also: what the slice does not port raises, entry points need a
card or ``device="cpu"``, and the package imports neither JAX nor
``tpu_flash``."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.inference import sampler as jsampler
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import sampler as tsampler

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(n_vocab=128, n_embd=64, n_head=4, n_positions=256, n_layer=2,
           ff_middle_dim=128, p_dropout=0.0, attention_kind="naive")
F32 = dict(atol=1e-5, rtol=1e-5)


def make_pair(dtype="float32", **over):
    """The JAX model (a jitted forward) with params from its own init, and
    the port with the same params."""
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG, **over,
                                         dtype=getattr(jnp, dtype)))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, **over,
                                         dtype=getattr(torch, dtype)),
                       device="cpu")
    tnn.load_jax_params(tm, params)
    fwd = jax.jit(lambda p, ids, **kw: jm(p, ids, **kw))
    return jm, params, tm, fwd


@pytest.fixture(scope="module")
def fp32_pair():
    return make_pair()


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_uncached_logits_match_jax(rng, fp32_pair):
    jm, params, tm, fwd = fp32_pair
    ids = rng.integers(0, CFG["n_vocab"], (3, 20))
    kv_mask = np.zeros((3, 20), np.float32)
    kv_mask[1, 15:] = -1e7                  # a right-padded row
    want = fwd(params, jnp.asarray(ids, jnp.int32),
               kv_mask=jnp.asarray(kv_mask))
    got = tm(torch.from_numpy(ids), kv_mask=torch.from_numpy(kv_mask))
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("over,quant,widths", [
    ({}, "none", (12, 1, 3)),
    ({"n_kv_head": 2, "window": 6}, "none", (12, 1)),  # GQA + window
    ({}, "int8", (12, 3)),
])
def test_cached_logits_match_jax(rng, fp32_pair, over, quant, widths):
    """Prefill 12 tokens (composed path), reset to ragged lengths as
    prefill_prompt does, then 1- or 3-token steps (decode path)."""
    jm, params, tm, fwd = make_pair(**over) if over else fp32_pair
    B, max_len = 2, 32
    jc = jsampler.make_caches(jm, B, max_len, quant=quant)
    tc = tsampler.make_caches(tm, B, max_len, quant=quant)
    steps = [rng.integers(0, CFG["n_vocab"], (B, n)) for n in widths]
    lengths = np.asarray([12, 7], np.int32)
    for i, ids in enumerate(steps):
        if i == 0:
            pos = np.arange(12)[None].repeat(B, 0)
        else:
            pos = lengths[:, None] + np.arange(ids.shape[1])[None]
            lengths = lengths + ids.shape[1]
        want, jc = fwd(params, jnp.asarray(ids, jnp.int32), kv_caches=jc,
                       positions=jnp.asarray(pos, jnp.int32))
        got, tc = tm(torch.from_numpy(ids), kv_caches=tc,
                     positions=torch.from_numpy(pos))
        np.testing.assert_allclose(np32(got), np32(want), **F32)
        if i == 0:
            jc = [dataclasses.replace(c, lengths=jnp.asarray(lengths))
                  for c in jc]
            for c in tc:
                c.lengths.copy_(torch.from_numpy(lengths))
    assert tc[0].lengths.tolist() == list(lengths)


def test_bf16_logits_close_to_jax(rng):
    """bf16 parameters, activations and cache: a 12-token prefill (the
    composed path) and a decode step.  The two frameworks round at
    different places (matmul accumulation, LayerNorm statistics), so the
    logits (|x| of a few units) agree to 1.5e-1, a few bf16 ulps."""
    jm, params, tm, fwd = make_pair("bfloat16")
    ids = rng.integers(0, CFG["n_vocab"], (2, 12))
    jc = jsampler.make_caches(jm, 2, 16, compute_dtype=jnp.bfloat16)
    tc = tsampler.make_caches(tm, 2, 16, compute_dtype=torch.bfloat16)
    for ids in (ids, ids[:, :1]):
        want, jc = fwd(params, jnp.asarray(ids, jnp.int32), kv_caches=jc,
                       positions=jc[0].lengths[:, None]
                       + jnp.arange(ids.shape[1])[None])
        got, tc = tm(torch.from_numpy(ids), kv_caches=tc,
                     positions=tc[0].lengths[:, None].long()
                     + torch.arange(ids.shape[1])[None])
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want), atol=1.5e-1,
                                   rtol=0)


def test_load_jax_params_maps_every_parameter(fp32_pair):
    jm, params, tm, _ = fp32_pair
    assert tnn.num_parameters(tm) == jnn.num_parameters(params)
    names = {n for n, _ in tnn.named_tree_leaves(params)}
    assert names == {n for n, _ in tm.named_parameters()}
    np.testing.assert_array_equal(                     # [in, out] -> [out, in]
        np32(tm.lm_head.weight), np.asarray(params["lm_head"]["weight"]).T)
    with pytest.raises(KeyError, match="missing"):
        tnn.load_jax_params(tm, {k: v for k, v in params.items()
                                 if k != "lm_head"})
    with pytest.raises(KeyError, match="no counterpart"):
        tnn.load_jax_params(tm, {**params, "extra": {"w": np.zeros(2)}})


def test_init_params_draws_the_jax_distributions():
    cfg = tnn.DecoderConfig(**CFG)
    a, b = (tnn.DecoderLM(cfg, device="cpu") for _ in range(2))
    tnn.init_params(a, torch.Generator().manual_seed(3))
    tnn.init_params(b, torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    bound = 1.0 / np.sqrt(CFG["n_embd"])
    w = a.layers[0].attention.q_projection.weight
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    emb = a.token_embeddings.weight
    assert abs(float(emb.mean())) < 0.05 and abs(float(emb.std()) - 1) < 0.05
    assert torch.equal(a.ln.gamma, torch.ones(CFG["n_embd"]))
    assert torch.equal(a.ln.beta, torch.zeros(CFG["n_embd"]))
    tnn.init_params(b, torch.Generator().manual_seed(4))
    assert not torch.equal(a.lm_head.weight, b.lm_head.weight)


def test_auto_attention_below_the_flash_threshold_is_naive(rng, fp32_pair):
    _, params, naive, _ = fp32_pair
    auto = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "attention_kind":
                                              "auto"}), device="cpu")
    tnn.load_jax_params(auto, params)
    ids = torch.from_numpy(rng.integers(0, CFG["n_vocab"], (1, 9)))
    torch.testing.assert_close(auto(ids), naive(ids), rtol=0, atol=0)


@pytest.mark.parametrize("over", [
    {"positional": "rope"}, {"moe": object()},
    {"kv_quant": "int8", "attention_kind": "naive"},
    {"attn_dropout": 0.1, "kv_quant": "int4"},
    {"embedding_one_hot": True}, {"sequence_parallel": True},
])
def test_unported_config_raises(over):
    """What the config refuses: an unported option names its ROADMAP.md
    item; quantized K/V is ported, and refused with the JAX package's
    ValueError on a dense route and for an unknown mode."""
    error, match = ((ValueError, "kv_quant") if "kv_quant" in over
                    else (NotImplementedError, r"ROADMAP\.md"))
    with pytest.raises(error, match=match):
        tnn.DecoderConfig(**{**CFG, **over})


def test_unported_forward_paths_raise():
    """What the uncached forward still refuses, as the JAX package does: a
    window or packed sequences on the fused route (its [B, Lk] mask cannot
    express them), and packed sequences on the cached decode path.  The
    flash and naive routes take both.  Attention dropout runs on every
    route, and composes with quantized K/V on the flash route."""
    ids = torch.zeros(1, 4, dtype=torch.long)
    for kind in ("flash", "naive"):
        m = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "attention_kind": kind},
                                            window=4), device="cpu")
        assert torch.isfinite(m(ids, training=True,
                                segment_ids=torch.tensor([[0, 0, 1, 1]]))
                              ).all()
    fused = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "attention_kind":
                                               "fused"}, window=4),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        fused(ids)
    with pytest.raises(NotImplementedError, match="segment_ids"):
        m(ids, segment_ids=ids, kv_caches=[])
    for kind in ("flash", "naive", "fused"):
        m = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "attention_kind": kind},
                                            attn_dropout=0.5), device="cpu")
        dropped = m(ids, training=True,
                    generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(dropped).all()
        assert not torch.equal(dropped, m(ids))
    m = tnn.DecoderLM(tnn.DecoderConfig(**{**CFG, "attention_kind": "flash"},
                                        attn_dropout=0.5, kv_quant="int8"),
                      device="cpu")
    dropped = m(ids, training=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(dropped).all()
    assert not torch.equal(dropped, m(ids))


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    cfg = tnn.DecoderConfig(**CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnn.DecoderLM(cfg)
    model = tnn.DecoderLM(cfg, device="cpu")
    from tpu_flash_torch.inference import DecodeEngine, SamplingConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, n_slots=1, max_len=8, sampling=SamplingConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsampler.generate(model, [[1, 2]], [2], SamplingConfig(), max_len=8)


def test_import_leaves_out_jax_and_the_jax_package():
    code = ("import sys, tpu_flash_torch, tpu_flash_torch.nn, "
            "tpu_flash_torch.inference, tpu_flash_torch.kernels, "
            "tpu_flash_torch.ops, tpu_flash_torch.utils, "
            "tpu_flash_torch.apps.machine_translation; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tpu_flash.')) or m == 'tpu_flash'); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_package_sources_call_no_library_attention():
    """No JAX or tpu_flash import, no scaled_dot_product_attention, no
    library LayerNorm or softmax backward, no library quantized matmul
    (``torch._int_mm``, ``_weight_int8pack_mm``, ``_weight_int4pack_mm``,
    ``torch.ao``), no torch.compile and no import of the flash_attn package
    anywhere in the port's sources (the port's own parity aliases keep
    their names); chip_smoke.py times the library calls as yardsticks
    only."""
    library = (r"scaled_dot_product_attention|torch\.nn\.functional\."
               r"layer_norm|torch\.layer_norm|_softmax_backward_data")
    quantized = r"torch\._int_mm|_weight_int[48]pack_mm|torch\.ao\b"
    banned = re.compile(r"^\s*(from|import)\s+(jax|tpu_flash|flash_attn)\b"
                        rf"|{library}|{quantized}|torch\.compile", re.M)
    files = [*(REPO / "tpu_flash_torch").rglob("*.py"),
             *(REPO / "tpu_flash_torch").rglob("*.cu*"),
             REPO / "chip_smoke.py"]
    hits = [f"{f.name}: {m.group(0)}" for f in files
            for m in banned.finditer(f.read_text())
            if not (f.name == "chip_smoke.py"
                    and re.fullmatch(library, m.group(0)))]
    assert len(files) > 10 and not hits, hits
