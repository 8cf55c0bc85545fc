"""The port's pooling and convolution (``nn/functional.py``: ``tile``,
``avgpool2d``, ``maxpool2d``, ``argmax``, ``conv1d``, ``conv2d``) against
the JAX package's on the same numpy inputs from a seed, fp32: forwards
within 1e-5 (the convolutions sum in another order), gradients of a
weighted sum against ``jax.grad`` within 1e-5; ``argmax`` at every axis
exactly, with the first index taken on ties; ``maxpool2d`` over tied
maxima, whose gradient JAX splits evenly among them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.nn import functional as JF
from tpu_flash_torch.nn import functional as TF

torch.set_num_threads(1)

F32 = dict(atol=1e-5, rtol=1e-5)


def both(fn_j, fn_t, inputs, weight_shape):
    """Forward of both on the same inputs, and the gradient of ``sum(out *
    w)`` for every input, w a fixed random weight."""
    w = np.random.default_rng(7).standard_normal(weight_shape).astype(
        np.float32)
    out_j = fn_j(*map(jnp.asarray, inputs))
    gj = jax.grad(lambda *a: jnp.sum(fn_j(*a) * w),
                  argnums=tuple(range(len(inputs))))(*map(jnp.asarray,
                                                          inputs))
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    out_t = fn_t(*ts)
    gt = torch.autograd.grad((out_t * torch.from_numpy(w)).sum(), ts)
    return (np.asarray(out_j), out_t.detach().numpy(),
            [np.asarray(g) for g in gj], [g.numpy() for g in gt])


@pytest.mark.parametrize("kernel", [(2, 2), (4, 4), (2, 4), (1, 3)])
def test_tile_matches_jax(rng, kernel):
    x = rng.standard_normal((2, 3, 8, 12)).astype(np.float32)
    tj, nhj, nwj = JF.tile(jnp.asarray(x), kernel)
    tt, nht, nwt = TF.tile(torch.from_numpy(x), kernel)
    assert (nht, nwt) == (nhj, nwj)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def test_tile_rejects_a_kernel_that_does_not_divide():
    with pytest.raises(ValueError, match="does not tile"):
        TF.tile(torch.zeros(1, 1, 6, 6), (4, 4))


@pytest.mark.parametrize("pool", ["avgpool2d", "maxpool2d"])
@pytest.mark.parametrize("kernel", [(2, 2), (4, 4), (2, 3)])
def test_pools_match_jax(rng, pool, kernel):
    x = rng.standard_normal((2, 3, 12, 12)).astype(np.float32)
    shape = (2, 3, 12 // kernel[0], 12 // kernel[1])
    oj, ot, gj, gt = both(lambda a: getattr(JF, pool)(a, kernel),
                          lambda a: getattr(TF, pool)(a, kernel), [x], shape)
    np.testing.assert_allclose(ot, oj, **F32)
    np.testing.assert_allclose(gt[0], gj[0], **F32)


def test_maxpool_splits_the_gradient_among_ties_as_jax():
    """Values drawn from {0, 1, 2}: most 2x2 and 4x4 windows hold a tied
    maximum; JAX's gradient is 1/n on each of n tied maxima."""
    x = np.random.default_rng(3).integers(0, 3, (2, 4, 8, 8)).astype(
        np.float32)
    for kernel in ((2, 2), (4, 4)):
        shape = (2, 4, 8 // kernel[0], 8 // kernel[1])
        oj, ot, gj, gt = both(lambda a: JF.maxpool2d(a, kernel),
                              lambda a: TF.maxpool2d(a, kernel), [x], shape)
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_allclose(gt[0], gj[0], **F32)
        xt = torch.tensor(x, requires_grad=True)
        (g,) = torch.autograd.grad(TF.maxpool2d(xt, kernel).sum(), xt)
        want = jax.grad(lambda a: jnp.sum(JF.maxpool2d(a, kernel)))(
            jnp.asarray(x))
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **F32)
        assert ((g > 0) & (g < 1)).any()    # some window's maxima split


@pytest.mark.parametrize("shape", [(3, 5, 7), (4, 4, 4), (2, 3, 4, 5)])
def test_argmax_matches_jax_at_every_axis(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 0] = 1.5                       # ties along the last axes
    for axis in list(range(-len(shape), len(shape))):
        want = np.asarray(JF.argmax(jnp.asarray(x), axis))
        got = TF.argmax(torch.from_numpy(x), axis)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_argmax_takes_the_first_index_on_ties_and_has_no_gradient():
    x = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]], np.float32)
    got = TF.argmax(torch.tensor(x, requires_grad=True))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JF.argmax(jnp.asarray(x))))
    np.testing.assert_array_equal(got.numpy()[:, :2], [[0, 1], [1, 0]])
    assert not got.requires_grad    # JAX's gradient through it is 0
    g = jax.grad(lambda a: jnp.sum(JF.argmax(a)))(jnp.asarray(x))
    assert not np.asarray(g).any()


@pytest.mark.parametrize("K", [1, 3, 5])
def test_conv1d_matches_jax(rng, K):
    x = rng.standard_normal((2, 4, 17)).astype(np.float32)
    w = rng.standard_normal((6, 4, K)).astype(np.float32)
    oj, ot, gj, gt = both(JF.conv1d, TF.conv1d, [x, w], (2, 6, 17))
    np.testing.assert_allclose(ot, oj, **F32)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("KH,KW", [(1, 1), (3, 3), (5, 5), (2, 4)])
def test_conv2d_matches_jax(rng, KH, KW):
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    w = rng.standard_normal((5, 3, KH, KW)).astype(np.float32)
    oj, ot, gj, gt = both(JF.conv2d, TF.conv2d, [x, w], (2, 5, 9, 11))
    np.testing.assert_allclose(ot, oj, **F32)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, **F32)


def test_conv_pads_only_past_the_end():
    """out[..., t] = sum of taps t..t+K-1: a one-hot input at position 0
    reaches out[0] only through tap 0, never a tap left of it."""
    x = torch.zeros(1, 1, 6)
    x[0, 0, 0] = 1.0
    w = torch.tensor([[[1.0, 10.0, 100.0]]])
    np.testing.assert_array_equal(TF.conv1d(x, w)[0, 0].numpy(),
                                  [1.0, 0, 0, 0, 0, 0])
    x[0, 0] = 0
    x[0, 0, 5] = 1.0
    np.testing.assert_array_equal(TF.conv1d(x, w)[0, 0].numpy(),
                                  [0, 0, 0, 100.0, 10.0, 1.0])
