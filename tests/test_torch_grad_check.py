"""The port's ``grad_check`` (``utils/grad_check.py``) against the JAX
package's, and the scalar track's derivative rules through
``torch.autograd`` against ``jax.grad`` (``tests/test_scalar_track.py``'s
cases):

* ``central_difference`` equals JAX's on the same fp32 function, inputs
  and positions within 1e-3 (each side evaluates in fp32, one ulp of a
  sum over 2 * eps);
* ``grad_check`` samples JAX's positions (the same numpy draw), skips
  integer arguments, catches a wrong backward and names it, and passes
  over the plain flash attention (causal and not, the fused and the
  two-pass backward), the fused LayerNorm and the masked softmax;
* the seven derivative rules, the comparison ops' zero gradients, the max
  subgradient and the chain-rule expression against ``jax.grad`` within
  1e-5 / 1e-6, as the scalar track holds them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_flash
from tpu_flash.utils import grad_check as jgc
from tpu_flash_torch import grad_check
from tpu_flash_torch import ops as tops
from tpu_flash_torch.kernels import flash_attention as tfa
from tpu_flash_torch.utils import grad_check as tgc

torch.set_num_threads(1)


def expr_j(x, y):
    return jnp.log(x * y + 1.0) * jax.nn.sigmoid(x - y) + jnp.tanh(y) / x


def expr_t(x, y):
    return torch.log(x * y + 1.0) * torch.sigmoid(x - y) + torch.tanh(y) / x


def test_central_difference_matches_jax(rng):
    x = (rng.random((3, 4)) + 0.5).astype(np.float32)
    y = (rng.random((3, 4)) + 0.5).astype(np.float32)
    for arg, idx in ((0, (0, 0)), (0, (2, 3)), (1, (1, 2))):
        for eps in (1e-3, 1e-2):
            want = jgc.central_difference(expr_j, jnp.asarray(x),
                                          jnp.asarray(y), arg=arg, idx=idx,
                                          eps=eps)
            got = tgc.central_difference(expr_t, torch.from_numpy(x),
                                         torch.from_numpy(y), arg=arg,
                                         idx=idx, eps=eps)
            np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def positions(module, fn, args, monkeypatch, **kw):
    """The (argument, index) pairs ``module.grad_check`` perturbs."""
    seen = []
    real = module.central_difference

    def spy(f, *a, arg, idx, eps):
        seen.append((arg, tuple(int(i) for i in idx)))
        return real(f, *a, arg=arg, idx=idx, eps=eps)

    monkeypatch.setattr(module, "central_difference", spy)
    assert module.grad_check(fn, *args, **kw)
    return seen


def test_positions_and_integer_skip_match_jax(rng, monkeypatch):
    x = rng.standard_normal((5, 7)).astype(np.float32)
    n = rng.integers(1, 4, (5, 7)).astype(np.int32)
    w = rng.standard_normal(3).astype(np.float32)
    kw = dict(n_samples=6, seed=3)
    want = positions(jgc, lambda a, m, b: a * m + jnp.sum(b * b),
                     [jnp.asarray(x), jnp.asarray(n), jnp.asarray(w)],
                     monkeypatch, **kw)
    got = positions(tgc, lambda a, m, b: a * m + torch.sum(b * b),
                    [torch.from_numpy(x), torch.from_numpy(n),
                     torch.from_numpy(w)], monkeypatch, **kw)
    assert got == want
    assert {a for a, _ in got} == {0, 2}        # the int32 argument skipped
    assert len(got) == 6 + 3                    # w has only 3 positions


class _FlippedSquare(torch.autograd.Function):
    """x**2 whose backward returns -2x: a wrong VJP."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return -2.0 * x * g


def test_a_wrong_vjp_is_caught_and_named():
    x = torch.linspace(0.5, 2.0, 6)
    y = torch.ones(6)
    assert grad_check(lambda a, b: a * a + b, x, y)
    with pytest.raises(AssertionError,
                       match=r"argument 0 at index \(\d\,?\): analytic "
                             r"-\d.* vs central-difference \d"):
        grad_check(lambda a, b: _FlippedSquare.apply(a) + b, x, y)

    @jax.custom_vjp
    def flipped(a):
        return a * a

    flipped.defvjp(lambda a: (a * a, a), lambda a, g: (-2.0 * a * g,))
    with pytest.raises(AssertionError, match="argument 0 at index"):
        tpu_flash.grad_check(flipped, jnp.asarray(x.numpy()))


# the scalar track's (fn, sample points): log, inv, sigmoid, relu, tanh,
# exp, power
RULES = [
    (jnp.log, torch.log, [0.3, 1.0, 4.2]),
    (lambda x: 1.0 / x, lambda x: 1.0 / x, [0.5, -2.0, 3.0]),
    (jax.nn.sigmoid, torch.sigmoid, [-3.0, 0.0, 2.0]),
    (jax.nn.relu, torch.relu, [-1.5, 0.7, 3.0]),
    (jnp.tanh, torch.tanh, [-2.0, 0.1, 1.0]),
    (jnp.exp, torch.exp, [-1.0, 0.0, 2.0]),
    (lambda x: x ** 3.0, lambda x: x ** 3.0, [0.5, -1.2, 2.0]),
]


@pytest.mark.parametrize("fj,ft,points", RULES)
def test_derivative_rules_match_jax(fj, ft, points):
    for p in points:
        want = jax.grad(fj)(jnp.float32(p))
        x = torch.tensor(p, dtype=torch.float32, requires_grad=True)
        (got,) = torch.autograd.grad(ft(x), x)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-6)
        assert grad_check(ft, torch.tensor([p]), eps=1e-3, rtol=1e-2,
                          atol=1e-3)


@pytest.mark.parametrize("fj,ft", [
    (lambda x: (x < 2.0).astype(jnp.float32), lambda x: (x < 2.0).float()),
    (lambda x: (x == 2.0).astype(jnp.float32), lambda x: (x == 2.0).float()),
    (lambda x: jnp.isclose(x, 2.0).astype(jnp.float32),
     lambda x: torch.isclose(x, torch.tensor(2.0)).float()),
])
def test_comparison_ops_have_zero_gradient(fj, ft):
    for p in (1.0, 2.0):
        assert float(jax.grad(fj)(jnp.float32(p))) == 0.0
        x = torch.tensor(p, requires_grad=True)
        assert not ft(x).requires_grad      # no path back: gradient 0
        assert grad_check(ft, torch.tensor([p + 0.5]))


def test_max_subgradient_matches_jax():
    def fj(x):
        return jnp.max(jnp.stack([x * 2.0, x + 10.0]))

    def ft(x):
        return torch.max(torch.stack([x * 2.0, x + 10.0]))

    for p in (1.0, 20.0):       # x + 10 wins at 1, x * 2 at 20
        x = torch.tensor(p, requires_grad=True)
        (got,) = torch.autograd.grad(ft(x), x)
        assert float(got) == float(jax.grad(fj)(jnp.float32(p)))
    assert float(got) == 2.0


def test_chain_rule_expression_matches_jax():
    x = torch.tensor([1.3])
    y = torch.tensor([0.7])
    assert grad_check(expr_t, x, y, eps=1e-3, rtol=1e-3, atol=1e-3)
    want = jax.grad(lambda a, b: jnp.sum(expr_j(a, b)), argnums=(0, 1))(
        jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    xs, ys = (t.clone().requires_grad_(True) for t in (x, y))
    got = torch.autograd.grad(expr_t(xs, ys).sum(), (xs, ys))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


class _TwoPass(torch.autograd.Function):
    """The flash forward, then the two-pass backward (the forcing entry)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse, _ = tfa.flash_attention_forward(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*tfa.flash_attention_backward_two_pass(
            q, k, v, out, lse, do, causal=ctx.causal), None)


@pytest.mark.parametrize("causal", [False, True])
def test_grad_check_over_the_plain_flash_attention(rng, causal):
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((1, 2, 40, 16)).astype(
        np.float32))
    assert grad_check(lambda *a: tops.flash_attention(*a, causal=causal) * w,
                      q, k, v, n_samples=6)
    assert grad_check(lambda *a: _TwoPass.apply(*a, causal) * w, q, k, v,
                      n_samples=6)
    # the backward oracles' gradients are the op's
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad((tops.flash_attention(qs, ks, vs,
                                                    causal=causal) * w).sum(),
                              (qs, ks, vs))
    ref = tops.reference
    res = ref.flash_attention2_fw_reference(q, k, v, causal=causal)
    want = ref.flash_attention2_bw_reference(q, k, v, res.out, res.lse, w,
                                             causal=causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_grad_check_over_layer_norm_and_softmax(rng):
    x = torch.from_numpy(rng.standard_normal((3, 5, 24)).astype(np.float32))
    gamma = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    beta = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    assert grad_check(tops.layer_norm, x, gamma, beta, n_samples=6)
    s = torch.from_numpy(rng.standard_normal((2, 2, 6, 6)).astype(np.float32))
    pad = torch.zeros(2, 6)
    pad[1, 4:] = -1e4
    w = torch.from_numpy(rng.standard_normal((2, 2, 6, 6)).astype(np.float32))
    for mask_future in (False, True):
        assert grad_check(
            lambda a: tops.attn_softmax(a, pad, mask_future=mask_future) * w,
            s, n_samples=8)
