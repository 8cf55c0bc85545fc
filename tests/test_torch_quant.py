"""The port's weight-only quantized path against the JAX package's, on the
CPU: the quantizers bit for bit, the int8 and int4 matmuls' plain versions
against the JAX Pallas kernels (run in interpret mode), ``int8_linear`` and
``int4_linear`` with their x-gradients against ``jax.grad``,
``quantize_model_linears`` and the quantized tree's round trip, and the
tiny quantized decoder (2 layers, E=64, 4 heads, vocab 128): logits
uncached, in a cached prefill and in decode steps, and greedy tokens from
``generate`` and ``DecodeEngine`` over an int8 cache.

Tolerances: fp32 outputs within 1e-5 of the output's rms plus 1e-5 of the
value (both sides sum the same fp32 products in another order); bf16
outputs within one bf16 ulp (rtol 8e-3: an ulp is at most 2^-7 of |x|) on
top, since a sum near a rounding boundary may round either way; the bf16
model's logits, as ``tests/test_torch_model.py``'s, to 1.5e-1 (the
frameworks round at different places).  Inputs come from numpy seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash import nn as jnn
from tpu_flash.inference import SamplingConfig as JaxSampling
from tpu_flash.inference import generate as jax_generate
from tpu_flash.inference import sampler as jsampler
from tpu_flash.kernels import quant as jq
from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import (DecodeEngine, Request, SamplingConfig,
                                       generate)
from tpu_flash_torch.inference import sampler as tsampler
from tpu_flash_torch.kernels import quant as tq

torch.set_num_threads(1)

CFG = dict(n_vocab=128, n_embd=64, n_head=4, n_positions=256, n_layer=2,
           ff_middle_dim=128, p_dropout=0.0, attention_kind="naive")
# bits, group_size: int8, int4 per column, int4 in groups of 16
MODES = [(8, None), (4, None), (4, 16)]
MODE_IDS = ["int8", "int4", "int4-g16"]
BF16_RTOL = 8e-3


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_within(got, want, arms=1e-5, rtol=1e-5):
    """|got - want| <= arms * rms(want) + rtol * |want|, element-wise."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    excess = np.abs(got - want) - arms * rms - rtol * np.abs(want)
    assert excess.max() <= 0, (float(np.abs(got - want).max()), rms)


def weight(rng, K, N, dtype):
    """A [K, N] weight exact in ``dtype`` (so both frameworks see the same
    values), with an all-zero column (scale 1) and a column of exact
    half-steps (round half to even decides its codes)."""
    w = rng.standard_normal((K, N)).astype(np.float32) * 2.0
    w[:, 0] = 0.0
    w[:, 1] = 0.0
    w[0, 1] = 127.0
    w[1:, 1] = (np.arange(K - 1) % 7) - 3.5
    w = np.array(jnp.asarray(w, dtype).astype(jnp.float32))
    return jnp.asarray(w, dtype), torch.from_numpy(w).to(getattr(torch,
                                                                 dtype))


def qmode_tree_and_model(params, bits, group_size, dtype="float32"):
    """JAX's quantized tree from ``params``, and the port model carrying the
    same float weights quantized on the port's side."""
    qparams = jnn.quantize_model_linears(
        params, bits=bits, group_size=group_size, allow_small_groups=True)
    tm = tnn.DecoderLM(tnn.DecoderConfig(**CFG, dtype=getattr(torch, dtype)),
                       device="cpu")
    tnn.load_jax_params(tm, params)
    tnn.quantize_model_linears(tm, bits=bits, group_size=group_size,
                               allow_small_groups=True)
    return qparams, tm


@pytest.fixture(scope="module")
def jax_model():
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG))
    params = jax.jit(jm.init)(jax.random.key(0))
    fwd = jax.jit(lambda p, ids, **kw: jm(p, ids, **kw))
    return jm, params, fwd


# --- quantizers -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(64, 48), (255, 300), (9, 5)])
def test_quantize_weight_matches_jax_bit_for_bit(rng, dtype, K, N):
    jw, tw = weight(rng, K, N, dtype)
    jcodes, jscales = jq.quantize_weight(jw)
    codes, scales = tq.quantize_weight(tw)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    assert float(scales[0]) == 1.0                 # the all-zero column


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N,g", [(64, 48, None), (255, 300, None),
                                   (9, 5, None), (64, 48, 16),
                                   (128, 40, 32)])
def test_quantize_weight_int4_matches_jax_bit_for_bit(rng, dtype, K, N, g):
    jw, tw = weight(rng, K, N, dtype)
    jpacked, jscales, jk = jq.quantize_weight_int4(
        jw, group_size=g, allow_small_groups=True)
    packed, scales, k = tq.quantize_weight_int4(
        tw, group_size=g, allow_small_groups=True)
    assert packed.dtype == torch.uint8 and k == jk == K
    assert packed.shape == ((K + 1) // 2, N)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    np.testing.assert_array_equal(tq.unpack_int4(packed, K).numpy(),
                                  np.asarray(jq.unpack_int4(jpacked, K)))
    js = np.asarray(jscales)
    want = np.asarray(jq.unpack_int4(jpacked, K), np.float32) * (
        js if g is None else np.repeat(js, g, axis=0))
    np.testing.assert_array_equal(tq.dequantize(packed, scales, K).numpy(),
                                  want)


@pytest.mark.parametrize("K,g,allow,match", [
    (64, 24, True, r"requires K % \(2\*group_size\) == 0"),
    (256, 64, False, "underutilizes"),
])
def test_quantize_weight_int4_refuses_as_jax(K, g, allow, match):
    w = np.ones((K, 8), np.float32)
    for fn, arr in ((jq.quantize_weight_int4, jnp.asarray(w)),
                    (tq.quantize_weight_int4, torch.from_numpy(w))):
        with pytest.raises(ValueError, match=match):
            fn(arr, group_size=g, allow_small_groups=allow)


# --- matmuls ----------------------------------------------------------------

def matmul_inputs(rng, M, K, N, dtype):
    x = rng.standard_normal((M, K)).astype(np.float32)
    x = np.array(jnp.asarray(x, dtype).astype(jnp.float32))
    w = rng.standard_normal((K, N)).astype(np.float32)
    return (jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)), w)


def assert_matmul_close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    assert_within(got, want, 1e-5, 1e-5 if dtype == "float32" else BF16_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(8, 64, 128), (100, 256, 300),
                                   (1, 512, 512)])
def test_int8_matmul_plain_matches_jax(rng, dtype, M, K, N):
    jx, tx, w = matmul_inputs(rng, M, K, N, dtype)
    codes, scales = jq.quantize_weight(jnp.asarray(w))
    want = jq.int8_matmul(jx, codes, scales, interpret=True)
    tc, ts = torch.from_numpy(np.asarray(codes)), torch.from_numpy(
        np.asarray(scales))
    got = tq.int8_matmul(tx, tc, ts)               # a CPU tensor: plain
    assert_matmul_close(got, want, dtype)
    torch.testing.assert_close(got, tq.int8_matmul_plain(tx, tc, ts),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tq.int8_matmul(tx, tc, ts, impl="kernel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,g", [(8, 64, 128, None),
                                     (100, 255, 300, None),
                                     (1, 512, 512, None), (16, 512, 256, 64),
                                     (16, 512, 256, 128), (5, 96, 40, 16)])
def test_int4_matmul_plain_matches_jax(rng, dtype, M, K, N, g):
    jx, tx, w = matmul_inputs(rng, M, K, N, dtype)
    packed, scales, k = jq.quantize_weight_int4(
        jnp.asarray(w), group_size=g, allow_small_groups=True)
    want = jq.int4_matmul(jx, packed, scales, k_dim=k, interpret=True)
    got = tq.int4_matmul(tx, torch.from_numpy(np.asarray(packed)),
                         torch.from_numpy(np.asarray(scales)), k_dim=k)
    assert_matmul_close(got, want, dtype)


def test_int4_matmul_refuses_as_jax():
    x = torch.zeros(2, 64)
    packed = torch.zeros(32, 8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="even group count"):
        tq.int4_matmul(x, packed, torch.ones(3, 8))
    with pytest.raises(ValueError, match="k_dim"):
        tq.int4_matmul(x, packed, torch.ones(8), k_dim=63)
    with pytest.raises(ValueError, match="ceil"):
        tq.int4_matmul(x[:, :60], packed, torch.ones(8))


@pytest.mark.parametrize("bits,g", MODES, ids=MODE_IDS)
def test_linear_values_and_x_grads_match_jax(rng, bits, g):
    """[4, 6, K] activations with a bias: the output and d sum(out^2)/dx."""
    K, N = 64, 96
    x = rng.standard_normal((4, 6, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    if bits == 8:
        codes, scales = jq.quantize_weight(jnp.asarray(w))
        jqw = jq.QuantizedLinearWeights(codes, scales, jnp.asarray(b))
        tqw = tq.QuantizedLinearWeights(
            torch.from_numpy(np.asarray(codes)),
            torch.from_numpy(np.asarray(scales)), torch.from_numpy(b))
        jfn, tfn = jq.int8_linear, tq.int8_linear
    else:
        packed, scales, k = jq.quantize_weight_int4(
            jnp.asarray(w), group_size=g, allow_small_groups=True)
        jqw = jq.QuantizedLinearWeights4(packed, scales, k, jnp.asarray(b))
        tqw = tq.QuantizedLinearWeights4(
            torch.from_numpy(np.asarray(packed)),
            torch.from_numpy(np.asarray(scales)), k, torch.from_numpy(b))
        jfn, tfn = jq.int4_linear, tq.int4_linear
    want = jfn(jnp.asarray(x), jqw)
    want_dx = jax.grad(lambda x: jnp.sum(jfn(x, jqw) ** 2))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tfn(tx, tqw)
    (dx,) = torch.autograd.grad((got ** 2).sum(), tx)
    assert got.shape == (4, 6, N)
    assert_within(got, want)
    assert_within(dx, want_dx)


# --- model ------------------------------------------------------------------

@pytest.mark.parametrize("bits,g", MODES, ids=MODE_IDS)
def test_quantize_model_linears_matches_the_jax_tree(jax_model, bits, g):
    """The same layers are quantized (every projection, the feed-forward
    layers and lm_head; no embedding or LayerNorm), port-side quantization
    of the same float weights gives JAX's codes and scales bit for bit, and
    JAX's quantized tree loads and exports unchanged."""
    _, params, _ = jax_model
    qparams, tm = qmode_tree_and_model(params, bits, g)
    want = dict(tnn.named_tree_leaves(qparams))
    state = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    assert set(state) == set(want)
    key = "codes" if bits == 8 else "codes4"
    quantized = {n.rsplit(".", 1)[0] for n in want if n.endswith(key)}
    assert quantized == {n for n, m in tm.named_modules()
                         if isinstance(m, tnn.QuantizedLinear)}
    assert "lm_head" in quantized and len(quantized) == 6 * 2 + 1
    for name, leaf in want.items():
        np.testing.assert_array_equal(state[name].detach().numpy(),
                                      np.asarray(leaf), err_msg=name)
        assert state[name].dtype == torch.from_numpy(np.asarray(leaf)).dtype

    # JAX's tree into a port model quantized from other weights
    other = tnn.DecoderLM(tnn.DecoderConfig(**CFG), device="cpu")
    tnn.init_params(other, torch.Generator().manual_seed(5))
    tnn.quantize_model_linears(other, bits=bits, group_size=g,
                               allow_small_groups=True)
    tnn.load_jax_params(other, qparams)
    back = dict(tnn.named_tree_leaves(tnn.to_jax_params(other)))
    assert set(back) == set(want)
    for name, leaf in want.items():
        assert back[name].dtype == np.asarray(leaf).dtype, name
        np.testing.assert_array_equal(back[name], np.asarray(leaf))
    with pytest.raises(KeyError, match="missing"):
        tnn.load_jax_params(other, {k: v for k, v in qparams.items()
                                    if k != "lm_head"})


def test_quantized_model_keeps_its_device_and_init_leaves_codes(jax_model):
    _, params, _ = jax_model
    _, tm = qmode_tree_and_model(params, 8, None)
    assert tm.device == torch.device("cpu")
    codes = tm.lm_head.codes.clone()
    tnn.init_params(tm, torch.Generator().manual_seed(1))
    assert torch.equal(tm.lm_head.codes, codes)


@pytest.mark.parametrize("bits,g", MODES, ids=MODE_IDS)
def test_quantized_logits_match_jax(rng, jax_model, bits, g):
    """Uncached logits, then a 12-token cached prefill reset to ragged
    lengths and a 1-token and a 3-token decode step, fp32, at 1e-5."""
    jm, params, fwd = jax_model
    qparams, tm = qmode_tree_and_model(params, bits, g)
    ids = rng.integers(0, CFG["n_vocab"], (2, 12))
    with torch.no_grad():
        assert_within(tm(torch.from_numpy(ids)),
                      fwd(qparams, jnp.asarray(ids, jnp.int32)))
    B, max_len = 2, 32
    jc = jsampler.make_caches(jm, B, max_len)
    tc = tsampler.make_caches(tm, B, max_len)
    lengths = np.asarray([12, 7], np.int32)
    for i, ids in enumerate([ids] + [rng.integers(0, CFG["n_vocab"], (B, n))
                                     for n in (1, 3)]):
        if i == 0:
            pos = np.arange(12)[None].repeat(B, 0)
        else:
            pos = lengths[:, None] + np.arange(ids.shape[1])[None]
            lengths = lengths + ids.shape[1]
        want, jc = fwd(qparams, jnp.asarray(ids, jnp.int32), kv_caches=jc,
                       positions=jnp.asarray(pos, jnp.int32))
        with torch.no_grad():
            got, tc = tm(torch.from_numpy(ids), kv_caches=tc,
                         positions=torch.from_numpy(pos))
        assert_within(got, want)
        if i == 0:
            jc = [dataclasses.replace(c, lengths=jnp.asarray(lengths))
                  for c in jc]
            for c in tc:
                c.lengths.copy_(torch.from_numpy(lengths))


@pytest.mark.parametrize("bits,g", [(8, None), (4, 16)], ids=["int8",
                                                               "int4-g16"])
def test_bf16_quantized_logits_close_to_jax(rng, bits, g):
    jm = jnn.DecoderLM(jnn.DecoderConfig(**CFG, dtype=jnp.bfloat16))
    params = jax.jit(jm.init)(jax.random.key(0))
    qparams, tm = qmode_tree_and_model(params, bits, g, "bfloat16")
    ids = rng.integers(0, CFG["n_vocab"], (2, 12))
    want = jax.jit(lambda p, i: jm(p, i))(qparams, jnp.asarray(ids,
                                                              jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), atol=1.5e-1, rtol=0)


@pytest.mark.parametrize("bits,g", [(8, None), (4, 16)], ids=["int8",
                                                               "int4-g16"])
def test_quantized_generate_and_engine_match_jax(jax_model, bits, g):
    """Greedy tokens over an int8 KV cache, as tests/test_quant.py's
    quantized generate: the port's generate and DecodeEngine (run_many(3),
    two slots for four prompts) against JAX's generate.  Every greedy
    decision of the reference is first checked to be no near tie."""
    jm, params, fwd = jax_model
    qparams, tm = qmode_tree_and_model(params, bits, g)
    lens, n_new, max_len = [3, 12, 7, 20], 8, 64
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, CFG["n_vocab"], n).tolist() for n in lens]
    ids = np.zeros((len(lens), max(lens)), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    want, _ = jax.jit(lambda p, i, n: jax_generate(
        jm, p, i, n, JaxSampling(max_new_tokens=n_new), max_len=max_len,
        kv_quant="int8"))(qparams, jnp.asarray(ids), jnp.asarray(lens))
    want = np.asarray(want)
    full = np.zeros((len(lens), max(lens) + n_new), np.int32)
    for i, p in enumerate(prompts):
        full[i, :len(p) + n_new] = p + want[i].tolist()
    logits = np.asarray(fwd(qparams, jnp.asarray(full)))
    for i, n in enumerate(lens):
        top2 = np.sort(logits[i, n - 1:n - 1 + n_new], axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-4

    toks, _ = generate(tm, ids, lens, SamplingConfig(max_new_tokens=n_new),
                       max_len=max_len, kv_quant="int8", device="cpu")
    np.testing.assert_array_equal(toks.numpy(), want)
    eng = DecodeEngine(tm, n_slots=2, max_len=max_len,
                       sampling=SamplingConfig(max_new_tokens=n_new),
                       kv_quant="int8", device="cpu")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p))
    done = eng.run_many(3)
    assert sorted(c.uid for c in done) == list(range(len(lens)))
    for c in done:
        assert c.tokens == want[c.uid].tolist(), c.uid
