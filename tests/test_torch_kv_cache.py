"""The port's KVCache against the JAX package's: append, the stored codes
and scales, the dequantized reads, the length mask, and the write that runs
past ``max_len`` (``lax.dynamic_update_slice`` clamps its start to
``max_len - Lnew`` and overwrites the tail; the port must do the same).
Inputs come from a numpy seed; codes and scales must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.inference import KVCache as JaxKVCache
from tpu_flash_torch.inference import KVCache
from tpu_flash_torch.inference.kv_cache import _quantize

torch.set_num_threads(1)

# Eager on purpose: under jit XLA turns ``amax / 127`` into a multiply by
# the reciprocal, which moves scales by an ulp; eager JAX divides, as torch.
def jax_append(cache, k, v):
    return cache.append(k, v)


def to_np(x) -> np.ndarray:
    """Codes as comparable numpy arrays (fp8 by its bytes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def assert_same_cache(port: KVCache, ref) -> None:
    np.testing.assert_array_equal(to_np(port.k), to_np(ref.k))
    np.testing.assert_array_equal(to_np(port.v), to_np(ref.v))
    np.testing.assert_array_equal(port.lengths.numpy(), np.asarray(ref.lengths))
    if ref.k_scale is None:
        assert port.k_scale is None and port.v_scale is None
    else:
        np.testing.assert_array_equal(port.k_scale.numpy(),
                                      np.asarray(ref.k_scale))
        np.testing.assert_array_equal(port.v_scale.numpy(),
                                      np.asarray(ref.v_scale))
    np.testing.assert_allclose(to_np(port.read_k()), to_np(ref.read_k()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(port.read_v()), to_np(ref.read_v()),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_and_read_match_jax(rng, quant, dtype):
    B, H, S, d = 3, 2, 24, 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JaxKVCache.create(B, H, S, d, quant=quant, compute_dtype=jdt)
    port = KVCache.create(B, H, S, d, quant=quant, compute_dtype=tdt,
                          device="cpu")
    for n in (5, 1, 3):          # a prefill, a decode step, a verify window
        k = rng.standard_normal((B, H, n, d)).astype(np.float32)
        v = rng.standard_normal((B, H, n, d)).astype(np.float32)
        ref = jax_append(ref, jnp.asarray(k, jdt), jnp.asarray(v, jdt))
        out = port.append(torch.from_numpy(k).to(tdt),
                          torch.from_numpy(v).to(tdt))
        assert out is port            # updated in place
    assert_same_cache(port, ref)
    np.testing.assert_array_equal(port.attention_mask(3).numpy(),
                                  np.asarray(ref.attention_mask(3)))


def test_update_returns_dequantized_views(rng):
    B, H, S, d = 2, 2, 8, 4
    k = rng.standard_normal((B, H, 3, d)).astype(np.float32)
    ref_k, ref_v, ref = JaxKVCache.create(B, H, S, d, quant="int8").update(
        jnp.asarray(k), jnp.asarray(k * 2))
    port = KVCache.create(B, H, S, d, quant="int8", device="cpu")
    got_k, got_v, same = port.update(torch.from_numpy(k),
                                     torch.from_numpy(k * 2))
    assert same is port
    np.testing.assert_allclose(got_k.numpy(), np.asarray(ref_k), atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=1e-6)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_write_past_max_len_clamps_like_jax(rng, quant):
    """Sequences at length 6 and 8 of an 8-row cache take 3 new rows: the
    writes start at row 5 (overwriting the tail) and the lengths still
    advance by 3, past max_len."""
    B, H, S, d = 3, 2, 8, 4
    ref = JaxKVCache.create(B, H, S, d, quant=quant)
    port = KVCache.create(B, H, S, d, quant=quant, device="cpu")
    fill = rng.standard_normal((B, H, S, d)).astype(np.float32)
    ref = jax_append(ref, jnp.asarray(fill), jnp.asarray(-fill))
    port.append(torch.from_numpy(fill), torch.from_numpy(-fill))
    lengths = np.asarray([6, 8, 2], np.int32)
    ref = JaxKVCache(ref.k, ref.v, ref.k_scale, ref.v_scale,
                     jnp.asarray(lengths), ref.quant, ref.compute_dtype,
                     n_head=H)
    port.lengths.copy_(torch.from_numpy(lengths))
    new = rng.standard_normal((B, H, 3, d)).astype(np.float32) + 5.0
    ref = jax_append(ref, jnp.asarray(new), jnp.asarray(new))
    port.append(torch.from_numpy(new), torch.from_numpy(new))
    assert port.lengths.tolist() == [9, 11, 5]
    assert_same_cache(port, ref)
    if quant == "none":         # the tail rows 5..7 hold the new keys
        np.testing.assert_array_equal(port.read_k()[0, :, 5:].numpy(), new[0])


def test_int8_rounds_half_to_even_and_keeps_zero_scales():
    """amax 127 gives scale 1, so x/scale = x: 2.5 -> 2, 3.5 -> 4, -0.5 ->
    -0 (half to even, as jnp.round); an all-zero row stores scale 0 with
    codes 0 (the divisor 0 is replaced by 1)."""
    x = np.zeros((2, 8), np.float32)
    x[0, :4] = [127.0, 2.5, 3.5, -0.5]
    codes, scales = _quantize(torch.from_numpy(x), "int8")
    assert codes[0, :4].tolist() == [127, 2, 4, 0]
    assert scales.tolist() == [1.0, 0.0]
    assert codes[1].abs().sum() == 0
    ref = jax_append(JaxKVCache.create(1, 2, 1, 8, quant="int8"),
                     jnp.asarray(x[None, :, None, :]),
                     jnp.asarray(x[None, :, None, :]))
    np.testing.assert_array_equal(np.asarray(ref.k)[0, 0].reshape(2, 8),
                                  codes.numpy())


def test_create_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.create(1, 1, 4, 4)
