"""The port's flash-decode attention against the JAX package's kernel.

``flash_decode_attention_plain`` (what CPU tensors take) is held against
``tpu_flash.kernels.decode.flash_decode_attention`` run in Pallas interpret
mode, on the same inputs made from a numpy seed and the same cache codes
(quantized by the JAX ``KVCache``).  Tolerances: 1e-5 in fp32; 3e-2 where q
is bf16 (outputs are rounded to bf16, and the TPU kernel rounds p to bf16
before P.V).  The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py``, which needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.inference import KVCache as JaxKVCache
from tpu_flash.kernels.decode import flash_decode_attention as jax_decode
from tpu_flash_torch.inference import KVCache
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels.decode import (
    flash_decode_attention,
    flash_decode_attention_plain,
)

torch.set_num_threads(1)

# one compile per shape instead of one per eager op
jax_append = jax.jit(lambda c, k, v: c.append(k, v))

TOL = {jnp.float32: 1e-5, jnp.bfloat16: 3e-2}
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def to_torch(x) -> torch.Tensor:
    """JAX array -> torch tensor, bit for bit (bf16 passes through fp32,
    fp8 through its bytes: torch.from_numpy takes neither)."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def make_inputs(rng, B, Hq, Hkv, Lq, S, d, dtype, quant, lengths):
    q = jnp.asarray(rng.standard_normal((B, Hq, Lq, d)) * 0.5, dtype)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, d)) * 0.5, dtype)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, d)) * 0.5, dtype)
    cache = JaxKVCache.create(B, Hkv, S, d, quant=quant, compute_dtype=dtype)
    cache = jax_append(cache, k, v)
    return q, cache, jnp.asarray(lengths, jnp.int32)


def compare(q, cache, lengths, dtype, window=None, block_s=None):
    kw = {} if block_s is None else {"block_s": block_s}
    want = jax_decode(q, cache.k, cache.v, lengths, cache.k_scale,
                      cache.v_scale, window=window, **kw)
    scales = ((to_torch(cache.k_scale), to_torch(cache.v_scale))
              if cache.k_scale is not None else (None, None))
    got = flash_decode_attention_plain(
        to_torch(q), to_torch(cache.k), to_torch(cache.v), to_torch(lengths),
        *scales, window=window)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == q.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    return got


@pytest.mark.parametrize(
    "B,Hq,Hkv,Lq,S,d,dtype,quant,lengths,window,block_s",
    [
        # lengths 0, one key, and both sides of the 128-key tile edges
        (6, 2, 2, 1, 256, 16, jnp.float32, "none",
         [0, 1, 127, 128, 129, 256], None, 128),
        # GQA g=4, Lq=3, one sequence shorter than Lq
        (3, 8, 2, 3, 160, 32, jnp.float32, "none", [1, 3, 160], None, None),
        # sliding window across tiles, Lq=2
        (3, 4, 4, 2, 256, 16, jnp.float32, "none", [5, 100, 256], 40, 128),
        (3, 4, 2, 1, 192, 32, jnp.bfloat16, "int8", [1, 100, 192], None,
         None),
        # JAX's fp8_e4m3_to_bf16 flushes e4m3 subnormals to zero, torch
        # converts them exactly; a flushed code is below 2^-6 * scale and
        # moves a score by well under 1e-3, inside the bf16 tolerance.
        (3, 4, 4, 2, 192, 32, jnp.bfloat16, "fp8", [2, 90, 192], 50, None),
        (2, 4, 2, 1, 128, 64, jnp.bfloat16, "none", [17, 128], None, None),
    ],
)
def test_plain_matches_jax(rng, B, Hq, Hkv, Lq, S, d, dtype, quant, lengths,
                           window, block_s):
    q, cache, ln = make_inputs(rng, B, Hq, Hkv, Lq, S, d, dtype, quant,
                               lengths)
    compare(q, cache, ln, dtype, window, block_s)


@pytest.mark.parametrize("Lq", range(1, 9))
def test_plain_matches_jax_each_lq(rng, Lq):
    """Every query width the decode path takes (1..8), MQA, with one
    sequence shorter than Lq whose first rows see nothing."""
    q, cache, ln = make_inputs(rng, 2, 4, 1, Lq, 64, 16, jnp.float32,
                               "none", [max(Lq - 2, 0), 64])
    got = compare(q, cache, ln, jnp.float32)
    short = max(Lq - 2, 0)     # row i sees positions < short - Lq + i + 1
    n_empty = min(Lq, Lq - short)
    assert torch.count_nonzero(got[0, :, :n_empty]) == 0


def test_plain_matches_jax_legacy_4d_layout(rng):
    B, H, S, d = 2, 4, 96, 16
    q = jnp.asarray(rng.standard_normal((B, H, 1, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, H, S, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, H, S, d)), jnp.float32)
    ln = jnp.asarray([S, 40], jnp.int32)
    want = jax_decode(q, k, v, ln)
    got = flash_decode_attention_plain(to_torch(q), to_torch(k), to_torch(v),
                                       to_torch(ln))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_port_cache_codes_feed_the_same_result(rng):
    """The port's own KVCache, quantizing in torch, feeds the same result."""
    B, H, S, d = 2, 4, 64, 16
    q = jnp.asarray(rng.standard_normal((B, H, 1, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, H, S, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, H, S, d)), jnp.float32)
    ln = jnp.asarray([30, 64], jnp.int32)
    jcache = jax_append(JaxKVCache.create(B, H, S, d, quant="int8"), k, v)
    cache = KVCache.create(B, H, S, d, quant="int8", device="cpu")
    cache.append(to_torch(k), to_torch(v))
    got = flash_decode_attention(to_torch(q), cache.k, cache.v,
                                 to_torch(ln), cache.k_scale, cache.v_scale)
    want = jax_decode(q, jcache.k, jcache.v, ln, jcache.k_scale,
                      jcache.v_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_version(rng):
    q = torch.from_numpy(rng.standard_normal((2, 4, 1, 16)).astype("f4"))
    kv = torch.from_numpy(rng.standard_normal((2, 64, 2 * 16)).astype("f4"))
    args = (q, kv, kv.flip(1), torch.tensor([10, 64]))
    before = common.launch_counts["flash_decode"]
    torch.testing.assert_close(flash_decode_attention(*args),
                               flash_decode_attention_plain(*args))
    assert common.launch_counts["flash_decode"] == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode_attention(*args, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        flash_decode_attention(*args, impl="pallas")


def test_rejects_inconsistent_inputs(rng):
    q = torch.zeros(2, 6, 1, 16)
    cache = torch.zeros(2, 32, 4 * 16)
    lengths = torch.tensor([1, 2])
    with pytest.raises(ValueError, match="multiple of KV heads"):
        flash_decode_attention_plain(q, cache, cache, lengths)
    codes = torch.zeros(2, 32, 6 * 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="k_scale"):
        flash_decode_attention_plain(q, codes, codes, lengths)
    six = torch.zeros(2, 32, 6 * 16)
    with pytest.raises(ValueError, match="window"):
        flash_decode_attention_plain(q, six, six, lengths, window=0)
