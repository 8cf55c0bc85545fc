"""The arithmetic of the flash kernels' fp32 form on the tensor cores, on the
CPU: ``split3_bf16`` splits an fp32 value into three bf16 pieces whose sum
is the value exactly, and ``matmul_x6`` (six bf16 products of the pieces,
in the kernels' order) agrees with the JAX package's ``_dot`` at
Precision.HIGHEST and with a float64 product, within 2^-18 of the absolute
sum ``|a| @ |b|`` element by element: 64 ulps of that sum, room for two
fp32 summation orders over k <= 128.  One bf16 product alone does not meet
that bound, so the bound can tell the split from no split.

The two-pass backward's six-product arithmetic (the dK/dV and dQ passes'
``_x6`` form) is formed here from ``matmul_x6`` and held against JAX's
two-pass backward and a float64 backward at the same bound, each output's
absolute sum carried through the chain S, P, dP, dS."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.kernels import flash_attention as jfa
from tpu_flash.kernels.flash_attention import _dot
from tpu_flash_torch.kernels import flash_attention as tfa
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


# --- the two-pass backward's six-product arithmetic --------------------------

STEP = 16      # rows (dK, dV) or keys (dQ) whose products a step sums apart


@pytest.fixture
def jax_two_pass_forced(monkeypatch):
    """The JAX backward forced to its two-pass form (its fused footprint
    caps set to 1 byte), jit caches cleared around the test."""
    jax.clear_caches()
    monkeypatch.setattr(jfa, "_FUSED_VMEM_CAP_BF16", 1)
    monkeypatch.setattr(jfa, "_FUSED_VMEM_CAP_FP32", 1)
    yield
    jax.clear_caches()


def matmul_bf16(a, b):
    """One bf16 product of the hi pieces (no split): the bound must fail it."""
    return split3_bf16(a)[0].float() @ split3_bf16(b)[0].float()


def stepped(products, n, combine):
    """``sum_i products(i)`` over steps of ``STEP`` along a length ``n``,
    each step's product formed apart and added to the sum in fp32 (the
    kernels' ``mma_x6_add``); ``combine`` folds a step into the sum."""
    acc = None
    for i0 in range(0, n, STEP):
        part = products(slice(i0, i0 + STEP))
        acc = combine(part) if acc is None else acc + combine(part)
    return acc


def two_pass_x6(q, k, v, do, lse, delta, scale, causal, q_offset,
                matmul=matmul_x6):
    """dq, dk, dv as the ``_x6`` passes form them, every product ``matmul``:
    S2 and dP over the head dim in one product each, P = exp2(S2 - lse2)
    (0 where masked and for rows with lse -inf), dS = P (dP - D); dV and
    dK summed over 16-row query steps and the GQA group, dK as
    scale / scale2 times the sum of dS^T (q scale2); dQ over 16-key steps,
    times scale."""
    B, H, Lq, d = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale2 = scale * tfa.LOG2E
    ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
    qs = q * scale2
    s2 = matmul(qs, ke.transpose(-1, -2))
    lse2 = torch.where(torch.isneginf(lse), math.inf, lse * tfa.LOG2E)
    p = torch.exp2(s2 - lse2[..., None])
    if causal:
        rows = torch.arange(Lq)[:, None] + q_offset
        p = p.masked_fill(torch.arange(Lk)[None, :] > rows, 0.0)
    dp = matmul(do, ve.transpose(-1, -2))
    ds = p * (dp - delta[..., None])

    def group_sum(x):           # [B, H, Lk, d] -> [B, Hkv, Lk, d], in turn
        x = x.reshape(B, Hkv, g, Lk, d)
        acc = x[:, :, 0]
        for h in range(1, g):
            acc = acc + x[:, :, h]
        return acc

    dv = stepped(lambda r: matmul(p[..., r, :].transpose(-1, -2), do[..., r, :]),
                 Lq, group_sum)
    dk = stepped(lambda r: matmul(ds[..., r, :].transpose(-1, -2),
                                  qs[..., r, :]), Lq, group_sum)
    dq = stepped(lambda c: matmul(ds[..., c], ke[..., c, :]), Lk,
                 lambda x: x)
    return scale * dq, (scale / scale2) * dk, dv


def backward_f64(q, k, v, do, scale, causal, q_offset):
    """The exact gradients from float64 inputs (out and lse formed in
    float64 too), and each one's absolute sum: the sum of the magnitudes
    of the terms it adds, each intermediate's own absolute sum carried
    along (S2's through exp2, a relative error of ln 2 times it in P)."""
    B, H, Lq, d = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = H // Hkv
    ke, ve = (x.repeat_interleave(g, dim=1) for x in (k, v))
    s = scale * (q @ ke.transpose(-1, -2))
    a_s2 = scale * tfa.LOG2E * (q.abs() @ ke.abs().transpose(-1, -2))
    if causal:
        rows = torch.arange(Lq)[:, None] + q_offset
        s = s.masked_fill(torch.arange(Lk)[None, :] > rows, -math.inf)
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = p @ ve
    delta = (do * out).sum(-1)
    dp = do @ ve.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    a_p = p * (1 + math.log(2) * a_s2)
    a_ds = (p * (do.abs() @ ve.abs().transpose(-1, -2)
                 + (do.abs() * out.abs()).sum(-1)[..., None])
            + (dp - delta[..., None]).abs() * (a_p - p))

    def group_sum(x):
        return x.reshape(B, Hkv, g, Lk, d).sum(2)

    grads = (scale * ds @ ke,
             group_sum(scale * ds.transpose(-1, -2) @ q),
             group_sum(p.transpose(-1, -2) @ do))
    sums = (scale * a_ds @ ke.abs(),
            group_sum(scale * a_ds.transpose(-1, -2) @ q.abs()),
            group_sum(a_p.transpose(-1, -2) @ do.abs()))
    return grads, sums


@pytest.mark.parametrize("B,H,Hkv,L,d", [
    (1, 2, 2, 256, 64),        # B1 H2 L256 d64 causal
    (1, 4, 2, 200, 64)])       # GQA, L not a multiple of the steps
def test_the_two_passes_six_products_agree_with_jax_and_float64(
        jax_two_pass_forced, B, H, Hkv, L, d):
    rng = np.random.default_rng(L + H)
    q, do = (rng.standard_normal((B, H, L, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, L, d)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    scale = 1 / math.sqrt(d)
    out, lse, _ = tfa.flash_attention_forward(tq, tk, tv, causal=True)
    delta = tfa._delta(out, tdo, None)
    got = two_pass_x6(tq, tk, tv, tdo, lse, delta, scale, True, 0)
    want = jfa.flash_attention_backward.__wrapped__(
        *(jnp.asarray(x) for x in (q, k, v, out.numpy(), lse.numpy(), do)),
        None, causal=True, interpret=True)
    exact, sums = backward_f64(*(t.double() for t in (tq, tk, tv, tdo)),
                               scale, True, 0)
    one = two_pass_x6(tq, tk, tv, tdo, lse, delta, scale, True, 0,
                      matmul=matmul_bf16)
    missed = False
    for name, a, j, x, a_sum, b in zip(("dq", "dk", "dv"), got, want, exact,
                                       sums, one):
        limit = BOUND * a_sum.numpy()
        a, j, x = a.numpy(), np.asarray(j), x.numpy()
        assert a.dtype == np.float32 and a.shape == j.shape == x.shape
        assert (np.abs(a - j) <= limit).all(), name
        assert (np.abs(a - x) <= limit).all(), name
        assert (np.abs(j - x) <= limit).all(), name
        missed |= bool((np.abs(b.numpy() - x) > limit).any())
    # one bf16 product a product misses the bound by far
    assert missed
