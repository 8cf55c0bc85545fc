"""The port's flash attention against the JAX package's, on the CPU: the
kernels' plain versions against ``flash_attention_forward/backward`` (Pallas
in interpret mode, as the JAX package's own tests run it) at the reference
tolerances, forward 1e-3 and backward 1e-2 in fp32; the empty-row rule
exactly; GQA; the FA1 residuals; the autograd Function against autograd
through naive attention; the oracles of ``ops.reference``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.kernels.flash_attention import (
    flash_attention_backward as jax_backward,
    flash_attention_forward as jax_forward,
)
from tpu_flash.ops import flash_attention_with_residuals as jax_residuals
from tpu_flash.ops import reference as jref
from tpu_flash_torch import ops as tops
from tpu_flash_torch.kernels.flash_attention import (
    flash_attention_backward,
    flash_attention_forward,
)
from tpu_flash_torch.ops import reference as tref

torch.set_num_threads(1)

FW_TOL = dict(atol=1e-3, rtol=1e-3)
BW_TOL = dict(atol=1e-2, rtol=1e-3)
# (B, H, L, d): L below, at and above the TPU's tile, and a ragged L
SHAPES = [(1, 2, 64, 32), (2, 2, 128, 64), (1, 2, 256, 64), (1, 1, 200, 64)]


def draw(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(*arrays):
    """numpy -> (JAX arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def assert_close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_forward_and_backward_match_jax(rng, shape, causal):
    (jq, jk, jv, jdo), (q, k, v, do) = both(*draw(rng, *[shape] * 4))
    jout, jlse, jm = jax_forward(jq, jk, jv, causal=causal, with_m=True)
    out, lse, m = flash_attention_forward(q, k, v, causal=causal, with_m=True)
    assert_close(out, jout, FW_TOL)
    assert_close(lse, jlse, FW_TOL)
    assert_close(m, jm, dict(atol=1e-5, rtol=1e-5))
    want = jax_backward(jq, jk, jv, jout, jlse, jdo, causal=causal)
    got = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert_close(g, w, BW_TOL)


def test_lse_cotangent_matches_jax(rng):
    shape = (1, 2, 64, 32)
    (jq, jk, jv, jdo), (q, k, v, do) = both(*draw(rng, *[shape] * 4))
    (jdl,), (dl,) = both(*draw(rng, shape[:3]))
    jout, jlse, _ = jax_forward(jq, jk, jv, causal=True)
    out, lse, _ = flash_attention_forward(q, k, v, causal=True)
    want = jax_backward(jq, jk, jv, jout, jlse, jdo, jdl, causal=True)
    got = flash_attention_backward(q, k, v, out, lse, do, dl, causal=True)
    for g, w in zip(got, want):
        assert_close(g, w, BW_TOL)


def test_empty_rows_match_jax(rng):
    """Causal with Lq > Lk: rows 0..59 see no key.  out 0, lse -inf and
    dq 0 exactly, as in the JAX package; the rest agree at the reference
    tolerances, and nothing is NaN."""
    (jq, jk, jv, jdo), (q, k, v, do) = both(*draw(
        rng, (1, 2, 130, 16), (1, 2, 70, 16), (1, 2, 70, 16),
        (1, 2, 130, 16)))
    jout, jlse, _ = jax_forward(jq, jk, jv, causal=True)
    out, lse, m = flash_attention_forward(q, k, v, causal=True, with_m=True)
    assert torch.count_nonzero(out[:, :, :60]) == 0
    assert torch.isneginf(lse[:, :, :60]).all()
    assert torch.isneginf(m[:, :, :60]).all()
    assert_close(out, jout, FW_TOL)
    np.testing.assert_array_equal(np.isneginf(lse.numpy()),
                                  np.isneginf(np.asarray(jlse)))
    assert_close(lse[:, :, 60:], jlse[:, :, 60:], FW_TOL)
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse, do, causal=True)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    assert torch.count_nonzero(dq[:, :, :60]) == 0
    want = jax_backward(jq, jk, jv, jout, jlse, jdo, causal=True)
    for g, w in zip((dq, dk, dv), want):
        assert_close(g, w, BW_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gqa_matches_jax(rng, causal):
    """Four query heads on two KV heads: dk and dv come out per KV head."""
    (jq, jk, jv, jdo), (q, k, v, do) = both(*draw(
        rng, (2, 4, 96, 32), (2, 2, 96, 32), (2, 2, 96, 32), (2, 4, 96, 32)))
    jout, jlse, _ = jax_forward(jq, jk, jv, causal=causal)
    out, lse, _ = flash_attention_forward(q, k, v, causal=causal)
    assert_close(out, jout, FW_TOL)
    assert_close(lse, jlse, FW_TOL)
    want = jax_backward(jq, jk, jv, jout, jlse, jdo, causal=causal)
    got = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    assert got[1].shape == k.shape and got[2].shape == v.shape
    for g, w in zip(got, want):
        assert_close(g, w, BW_TOL)


def test_bf16_forward_close_to_jax(rng):
    """bf16 inputs: q * scale * log2(e) and p are rounded to bf16 before
    their products in both packages; outputs agree to a few bf16 ulps."""
    (jq, jk, jv), (q, k, v) = both(*draw(rng, *[(1, 2, 128, 64)] * 3))
    jout, jlse, _ = jax_forward(
        *(x.astype(jnp.bfloat16) for x in (jq, jk, jv)), causal=True)
    out, lse, _ = flash_attention_forward(
        *(x.bfloat16() for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    assert_close(out.float(), jout.astype(jnp.float32),
                 dict(atol=2e-2, rtol=2e-2))
    assert_close(lse, jlse, dict(atol=2e-2, rtol=2e-2))


@pytest.mark.parametrize("L", [200, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_forward_normaliser_matches_jax(d, causal, L):
    """bf16 inputs from a seed: below d = 128 the JAX forward's softmax
    normaliser ``l`` is the sum of the bf16 P that multiplies V (its ones
    column rides the P.V product, ``_fold_l``), at d = 128 the sum of the
    fp32 P; the port's plain forward takes the same sum.  Measured with
    that rule: lse within 4.1e-5 and out within 9.8e-4 of JAX at these
    shapes; summing the fp32 P at d = 64 puts lse ~1e-3 away."""
    rng = np.random.default_rng(100 + d + L + causal)
    arrays = [rng.standard_normal((1, 2, L, d)).astype(np.float32)
              for _ in range(3)]
    jout, jlse, _ = jax_forward(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrays), causal=causal)
    out, lse, _ = flash_attention_forward(
        *(torch.from_numpy(a).bfloat16() for a in arrays), causal=causal)
    assert_close(lse, jlse, dict(atol=2e-4, rtol=0))
    assert_close(out.float(), jout.astype(jnp.float32),
                 dict(atol=2e-3, rtol=0))


@pytest.mark.parametrize("version", [1, 2])
def test_residuals_match_jax_and_the_oracles(rng, version):
    (jq, jk, jv), (q, k, v) = both(*draw(rng, *[(1, 2, 64, 32)] * 3))
    got = tops.flash_attention_with_residuals(q, k, v, version=version)
    want = jax_residuals(jq, jk, jv, version=version, impl="pallas")
    assert len(got) == len(want) == (3 if version == 1 else 2)
    for g, w in zip(got, want):
        assert_close(g, w, FW_TOL)
    oracle = (tref.flash_attention1_fw_reference(q, k, v) if version == 1
              else tref.flash_attention2_fw_reference(q, k, v))
    for g, o in zip(got, oracle):
        assert_close(g, o.numpy(), FW_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_oracles_match_jax(rng, causal):
    (jq, jk, jv), (q, k, v) = both(*draw(rng, *[(1, 2, 48, 16)] * 3))
    assert_close(tref.naive_attention(q, k, v, causal=causal),
                 jref.naive_attention(jq, jk, jv, causal=causal),
                 dict(atol=1e-5, rtol=1e-5))
    for t, j in ((tref.flash_attention1_fw_reference,
                  jref.flash_attention1_fw_reference),
                 (tref.flash_attention2_fw_reference,
                  jref.flash_attention2_fw_reference)):
        for g, w in zip(t(q, k, v, causal=causal),
                        j(jq, jk, jv, causal=causal)):
            assert_close(g, w, dict(atol=1e-5, rtol=1e-5))
    assert tref.default_scale(64) == jref.default_scale(64)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 1])
def test_autograd_function_matches_naive_attention(rng, causal, hkv):
    """The torch.autograd.Function (forward and backward through the
    kernels' plain versions) against autograd through naive attention."""
    q, k, v, do = (torch.from_numpy(a) for a in draw(
        rng, (2, 4, 80, 32), (2, hkv, 80, 32), (2, hkv, 80, 32),
        (2, 4, 80, 32)))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad((out * do).sum(), leaves)
    g = 4 // hkv
    ref = tref.naive_attention(q, k.repeat_interleave(g, 1),
                               v.repeat_interleave(g, 1), causal=causal)
    ref_grads = torch.autograd.grad((ref * do).sum(), leaves)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_aliases_and_what_raises(rng):
    q, k, v = (torch.from_numpy(a) for a in draw(rng, *[(1, 2, 32, 16)] * 3))
    ref = tops.flash_attention(q, k, v)
    torch.testing.assert_close(tops.flash_attn(q, k, v), ref)
    torch.testing.assert_close(tops.flash_attn2(q, k, v), ref)
    torch.testing.assert_close(tops.flash_attn_causal(q, k, v),
                               tops.flash_attention(q, k, v, causal=True))
    # quantized K/V is ported: int8 codes stay within quantization noise
    # of the unquantized op, and an unknown mode is refused; attention
    # dropout is ported: the op equals naive attention with P times the
    # kernels' keep multiplier
    torch.testing.assert_close(tops.flash_attention(q, k, v, kv_quant="int8"),
                               ref, atol=5e-2, rtol=5e-2)
    with pytest.raises(ValueError, match="kv_quant must be"):
        tops.flash_attention(q, k, v, kv_quant="int4")
    s = q @ k.transpose(-1, -2) / 4.0
    p = torch.softmax(s, -1) * tref.dropout_keep_oracle(1, 2, 32, 32, 3, 0.1)
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=3),
        p @ v, atol=1e-5, rtol=1e-5)
    # window and segment ids are ported: the op equals naive attention
    # under the same masks
    seg = torch.tensor([[0] * 12 + [1] * 20])
    mask = (tref.window_mask(32, 32, 4)
            + tref.apply_segment_mask(torch.zeros(1, 1, 32, 32), seg))
    torch.testing.assert_close(
        tops.flash_attention(q, k, v, causal=True, window=4,
                             segment_ids=seg),
        tref.naive_attention(q, k, v, causal=True, mask=mask), atol=1e-5,
        rtol=1e-5)
    with pytest.raises(ValueError, match="version"):
        tops.flash_attention(q, k, v, version=3)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_forward(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="multiple"):
        kv3 = k[:, :1].repeat(1, 3, 1, 1)
        flash_attention_forward(q, kv3, kv3)
