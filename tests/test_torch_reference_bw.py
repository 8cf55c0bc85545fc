"""The port's FA1 / FA2 backward oracles (``ops/reference.py``
``flash_attention1_bw_reference``, ``flash_attention2_bw_reference``)
against the JAX package's on the same numpy inputs, and against autograd
of the port's ``naive_attention``, at ``tests/test_reference_ops.py``'s
shapes, causal and not, fp32:

* from the same saved statistics (JAX's forward oracle's) the port's dq,
  dk, dv equal JAX's within 1e-5 (the same tiles and sums; the products'
  order of summation may differ);
* from the port's own forward oracle, against autograd of
  ``sum(naive_attention(q, k, v) * dO)`` within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.ops import reference as jref
from tpu_flash_torch.ops import reference as tref

torch.set_num_threads(1)

SHAPES = [(1, 2, 32, 16), (2, 4, 64, 32), (1, 8, 128, 64)]
SAME = dict(atol=1e-5, rtol=1e-5)
AUTOGRAD = dict(atol=1e-4, rtol=1e-4)


def inputs(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_backward_oracle_matches_jax(rng, shape, causal, version):
    q, k, v, do = inputs(rng, shape)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    if version == 1:
        res = jref.flash_attention1_fw_reference(jq, jk, jv, causal=causal)
        want = jref.flash_attention1_bw_reference(jq, jk, jv, *res, jdo,
                                                  causal=causal)
        got = tref.flash_attention1_bw_reference(
            t(q), t(k), t(v), *map(t, res), t(do), causal=causal)
    else:
        res = jref.flash_attention2_fw_reference(jq, jk, jv, causal=causal)
        want = jref.flash_attention2_bw_reference(jq, jk, jv, *res, jdo,
                                                  causal=causal)
        got = tref.flash_attention2_bw_reference(
            t(q), t(k), t(v), *map(t, res), t(do), causal=causal)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("version", [1, 2])
def test_backward_oracle_matches_autograd(rng, shape, causal, version):
    q, k, v, do = map(torch.from_numpy, inputs(rng, shape))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        (tref.naive_attention(*leaves, causal=causal) * do).sum(), leaves)
    if version == 1:
        res = tref.flash_attention1_fw_reference(q, k, v, causal=causal)
        got = tref.flash_attention1_bw_reference(q, k, v, *res, do,
                                                 causal=causal)
    else:
        res = tref.flash_attention2_fw_reference(q, k, v, causal=causal)
        got = tref.flash_attention2_bw_reference(q, k, v, *res, do,
                                                 causal=causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **AUTOGRAD)


@pytest.mark.parametrize("block_q,block_k", [(32, 16), (16, 64), (64, 32)])
def test_backward_oracle_tiles_match_jax(rng, block_q, block_k):
    """Other tiles than the default 16 x 16, causal (tiles skipped above
    the diagonal and masked across it)."""
    q, k, v, do = inputs(rng, SHAPES[1])
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    tiles = dict(causal=True, block_q=block_q, block_k=block_k)
    out, lse = jref.flash_attention2_fw_reference(jq, jk, jv, causal=True)
    want = jref.flash_attention2_bw_reference(jq, jk, jv, out, lse, jdo,
                                              **tiles)
    got = tref.flash_attention2_bw_reference(t(q), t(k), t(v), t(out),
                                             t(lse), t(do), **tiles)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME)
