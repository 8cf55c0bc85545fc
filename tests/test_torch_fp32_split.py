"""The arithmetic of the flash kernels' fp32 form on the tensor cores, on the
CPU: ``split3_bf16`` splits an fp32 value into three bf16 pieces whose sum
is the value exactly, and ``matmul_x6`` (six bf16 products of the pieces,
in the kernels' order) agrees with the JAX package's ``_dot`` at
Precision.HIGHEST and with a float64 product, within 2^-18 of the absolute
sum ``|a| @ |b|`` element by element: 64 ulps of that sum, room for two
fp32 summation orders over k <= 128.  One bf16 product alone does not meet
that bound, so the bound can tell the split from no split."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.kernels.flash_attention import _dot
from tpu_flash_torch.kernels.flash_attention import matmul_x6, split3_bf16

torch.set_num_threads(1)

BOUND = 2.0 ** -18


def log_uniform(rng, n, lo_exp, hi_exp):
    """fp32 values of both signs with |x| spread evenly in log2 over
    [2^lo_exp, 2^hi_exp] and every mantissa bit drawn."""
    mag = np.exp2(rng.uniform(lo_exp, hi_exp, n))
    return (rng.choice([-1.0, 1.0], n) * mag).astype(np.float32)


@pytest.mark.parametrize("seed,lo_exp,hi_exp", [
    (0, -60, 60), (1, -60, -40), (2, 40, 60), (3, -2, 2)])
def test_the_three_pieces_sum_to_the_value_bit_for_bit(seed, lo_exp,
                                                       hi_exp):
    x = log_uniform(np.random.default_rng(seed), 20_000, lo_exp, hi_exp)
    hi, mid, lo = split3_bf16(torch.from_numpy(x))
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float() + lo.float()).numpy()
    np.testing.assert_array_equal(total.view(np.uint32), x.view(np.uint32))
    # each piece rounds the residual the one before it leaves
    ax = np.abs(x)
    assert (np.abs(mid.float().numpy()) <= 2.0 ** -8 * ax).all()
    assert (np.abs(lo.float().numpy()) <= 2.0 ** -16 * ax).all()


def test_zeros_split_into_zeros():
    x = torch.tensor([0.0, -0.0])
    for piece in split3_bf16(x):
        assert (piece.float() == 0).all()
    hi, mid, lo = split3_bf16(x)
    assert (hi.float() + mid.float() + lo.float() == x).all()
    assert torch.signbit(hi[1])        # hi keeps the sign of -0


def jax_dot(a, b):
    """The JAX kernels' fp32 dot (Precision.HIGHEST) on the CPU."""
    return np.asarray(_dot(jnp.asarray(a), jnp.asarray(b), ((1,), (0,))))


@pytest.mark.parametrize("M,K,N,spread", [
    (64, 64, 64, 0),          # a [64, 64] tile by a [64, 64] tile
    (64, 16, 64, 0),          # d = 16: the contraction over the head dim
    (64, 128, 64, 0),         # d = 128
    (64, 64, 128, 0),         # P [64 keys] by V [64, d = 128]
    (64, 64, 64, 20)])        # rows and columns scaled by 2^-20 .. 2^20
def test_six_products_agree_with_jax_and_float64(M, K, N, spread):
    rng = np.random.default_rng(M * K + N + spread)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    if spread:
        a *= np.exp2(rng.uniform(-spread, spread, (M, 1))).astype(np.float32)
        b *= np.exp2(rng.uniform(-spread, spread, (1, N))).astype(np.float32)
    got = matmul_x6(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = jax_dot(a, b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    limit = BOUND * (np.abs(a).astype(np.float64) @ np.abs(b))
    assert got.dtype == np.float32 and got.shape == (M, N)
    assert (np.abs(got - want) <= limit).all()
    assert (np.abs(got - exact) <= limit).all()
    assert (np.abs(want - exact) <= limit).all()
    # the hi pieces alone (one bf16 product) miss the bound by far
    hi = (t.float() for t in (split3_bf16(torch.from_numpy(a))[0],
                              split3_bf16(torch.from_numpy(b))[0]))
    one = torch.matmul(*hi).numpy()
    assert (np.abs(one - exact) > limit).any()
