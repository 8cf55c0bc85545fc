"""The arithmetic of the quantized matmuls' fp32-x forms on the tensor
cores, on the CPU: x is split into three bf16 planes whose sum is x
exactly.  The prefill form (``int8_matmul_x3`` / ``int4_matmul_x3`` /
``int4_matmul_group_x3``): ``matmul_x3`` (each step of code rows' three
products, lo, mid and hi, summed apart and added in row order; per-column
scales after the sum, group scales on each group's sum).  The decode form
(``int8_matmul_dec_x3`` / ``int4_matmul_dec_x3`` /
``int4_matmul_group_dec_x3``): ``matmul_dec_x3``
(``_plan``'s ranges of code rows, each warp's quarter of a range in 16-row
steps of three products, the warps' sums and then the ranges' added in
order).  Both agree with the JAX package's ``int8_matmul`` and
``int4_matmul``, per column and grouped (Pallas, in interpret mode), and
with a float64 product.

Tolerance: within 1e-5 of the output's rms plus 1e-5 of the value
(chip_smoke.py's fp32 ``QUANT_TOL``): both sides add the same exact
products in fp32, in another order.  The hi plane alone (one bf16 product
a product) misses that limit, so the limit tells the split from no split.
Inputs come from numpy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.kernels import quant as jq
from tpu_flash_torch.kernels import quant as tq
from tpu_flash_torch.kernels.common import split3_bf16

torch.set_num_threads(1)


def excess(got, want, arms=1e-5, rtol=1e-5):
    """The largest of |got - want| - arms * rms(want) - rtol * |want|: not
    above 0 where ``got`` is within the limit."""
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    rms = np.sqrt(np.mean(want ** 2))
    return float((np.abs(got - want) - arms * rms - rtol * np.abs(want)).max())


def matmul_x3(x, codes, scales, *, k2=None):
    """The ``_x3`` kernels' arithmetic in plain PyTorch: fp32 ``x`` [M, K]
    split by ``split3_bf16`` (hi + mid + lo == x); the integer ``codes``
    [K, N] (int8 codes, or int4 codes unpacked) met by the three planes in
    steps of rows, lo, mid, hi (smallest first, each product exact), each
    step's products summed apart and added in row order.  Per-column
    ``scales`` [N]: steps of 64 rows (the kernel's), the sum times the
    scales; ``k2``, int4's packed rows ceil(K/2), starts the steps afresh
    at row k2, as the kernel walks the low nibbles' rows, then the high
    ones'.  Group scales [G, N]: steps of 16 rows added to the group's
    sum, each group's sum scaled and added to the total group by group (the
    low half's groups, then the high half's, as the kernel walks the packed
    rows).  Returns fp32 [M, N]."""
    hi, mid, lo = (t.float() for t in split3_bf16(x))
    c = codes.float()
    K = x.shape[1]
    s = scales.float()
    grouped = s.dim() == 2
    g, step = (K // s.shape[0], 16) if grouped else (k2 or K, 64)
    acc = None
    for g0 in range(0, K, g):
        part = None
        for k0 in range(g0, min(K, g0 + g), step):
            r = slice(k0, min(K, g0 + g, k0 + step))
            fresh = lo[:, r] @ c[r]
            fresh = fresh + mid[:, r] @ c[r]
            fresh = fresh + hi[:, r] @ c[r]
            if grouped:
                part = fresh if part is None else part + fresh
            else:
                acc = fresh if acc is None else acc + fresh
        if grouped:
            part = part * s[g0 // g]
            acc = part if acc is None else acc + part
    return acc if grouped else acc * s


def inputs(M, K, N, seed):
    """fp32 x [M, K] with rows spread over 2^-8 .. 2^8, and a weight [K, N]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x *= np.exp2(rng.uniform(-8, 8, (M, 1))).astype(np.float32)
    return x, rng.standard_normal((K, N)).astype(np.float32)


def hi_only(x, codes, scales):
    """``matmul_x3`` with the hi plane alone: one bf16 product a product."""
    return matmul_x3(split3_bf16(x)[0].float(), codes, scales)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_planes_sum_to_x_bit_for_bit(seed):
    x, _ = inputs(64, 256, 1, seed)
    hi, mid, lo = split3_bf16(torch.from_numpy(x))
    total = (hi.float() + mid.float() + lo.float()).numpy()
    np.testing.assert_array_equal(total.view(np.uint32), x.view(np.uint32))


@pytest.mark.parametrize("M,K,N", [(24, 64, 128), (40, 200, 72),
                                   (16, 4096, 64)])
def test_three_products_match_jax_int8_matmul(M, K, N):
    x, w = inputs(M, K, N, M + K)
    codes, scales = jq.quantize_weight(jnp.asarray(w))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), codes, scales,
                                     interpret=True))
    tc, ts = (torch.from_numpy(np.array(a)) for a in (codes, scales))
    tx = torch.from_numpy(x)
    got = matmul_x3(tx, tc, ts)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    exact = x.astype(np.float64) @ (np.asarray(codes, np.float64)
                                    * np.asarray(scales, np.float64))
    assert excess(got, want) <= 0
    assert excess(got, exact) <= 0
    assert excess(hi_only(tx, tc, ts), exact) > 0


@pytest.mark.parametrize("M,K,N", [(24, 255, 128), (40, 200, 72),
                                   (16, 4096, 64)])
def test_three_products_match_jax_int4_matmul(M, K, N):
    """Per-column int4: the packed rows walked twice, the low nibbles'
    K2 = ceil(K/2) rows, then the high ones', in steps of 64 rows; K 255
    is odd (x's column K reads 0 against the last packed row's high
    nibble, the zero code) and K2 128 at K 255 or 100 at K 200 ends the
    low half inside a step."""
    x, w = inputs(M, K, N, M + K + 1)
    packed, scales, k = jq.quantize_weight_int4(jnp.asarray(w))
    want = np.asarray(jq.int4_matmul(jnp.asarray(x), packed, scales,
                                     k_dim=k, interpret=True))
    tp = torch.from_numpy(np.array(packed))
    codes = tq.unpack_int4(tp, K)
    ts, tx = torch.from_numpy(np.array(scales)), torch.from_numpy(x)
    got = matmul_x3(tx, codes, ts, k2=tp.shape[0])
    assert got.dtype == torch.float32 and got.shape == (M, N)
    exact = x.astype(np.float64) @ tq.dequantize(codes, ts, K).double().numpy()
    assert excess(got, want) <= 0
    assert excess(got, exact) <= 0
    assert excess(hi_only(tx, codes, ts), exact) > 0


@pytest.mark.parametrize("M,K,N,g", [(24, 256, 128, 128), (40, 192, 72, 32),
                                     (16, 4096, 64, 128)])
def test_three_products_match_jax_grouped_int4_matmul(M, K, N, g):
    x, w = inputs(M, K, N, M + K + g)
    packed, scales, k = jq.quantize_weight_int4(
        jnp.asarray(w), group_size=g, allow_small_groups=True)
    want = np.asarray(jq.int4_matmul(jnp.asarray(x), packed, scales,
                                     k_dim=k, interpret=True))
    codes = tq.unpack_int4(torch.from_numpy(np.array(packed)), K)
    ts, tx = torch.from_numpy(np.array(scales)), torch.from_numpy(x)
    got = matmul_x3(tx, codes, ts)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    exact = x.astype(np.float64) @ tq.dequantize(codes, ts, K).double().numpy()
    assert excess(got, want) <= 0
    assert excess(got, exact) <= 0
    assert excess(hi_only(tx, codes, ts), exact) > 0


def test_groups_are_scaled_before_they_are_summed():
    """Group scales multiply each group's sum: a weight whose two groups
    differ in scale by 2^20 keeps the small group's products, which a
    per-column scale after the sum could not."""
    x = torch.ones(16, 64)
    codes = torch.ones(64, 8, dtype=torch.int8)
    scales = torch.tensor([[1.0] * 8, [2.0 ** -20] * 8])
    got = matmul_x3(x, codes, scales)
    assert torch.equal(got, torch.full((16, 8), 32 + 32 * 2.0 ** -20))


def matmul_dec_x3(x, codes, scales, plan, *, k2=None):
    """The ``_dec_x3`` kernels' arithmetic in plain PyTorch, at M <= 8:
    fp32 ``x`` [M, K] split by ``split3_bf16``; the integer ``codes``
    [K, N] (int8 codes, or int4 codes unpacked); ``plan``, the
    ``decode_tc_x3`` plan of ``_plan``: ``plan.splits`` ranges of
    ``plan.chunk`` code rows (the blocks of a cluster), each split into 4
    warps' quarters.  A warp walks its rows in 16-row steps, each meeting
    the three planes, lo, mid, hi, in a fresh sum added to the warp's
    (``mma_x3_b``); int4 (``k2``: the packed rows ceil(K/2)) meets x's
    first half with the low codes and its second with the high ones in
    each step (per column both into the warp's sum, x's column K of an odd
    K absent, as the zero it reads on the card); grouped, each half's
    group sum is kept apart and scaled into the warp's sum at the group's
    last step or the warp's.  The 4 warps' sums
    are added in warp order, then the ranges' in range order; per-column
    scales after the sum.  Returns fp32 [M, N]."""
    planes = [t.float() for t in split3_bf16(x)][::-1]    # lo, mid, hi
    c = codes.float()
    s = scales.float()
    grouped = s.dim() == 2
    K = x.shape[1]
    rows = k2 or K
    halves = (0, rows) if k2 else (0,)
    g = K // s.shape[0] if grouped else K
    zeros = torch.zeros(x.shape[0], c.shape[1])
    total = None
    for rank in range(plan.splits):
        block = zeros
        for warp in range(4):
            w0 = rank * plan.chunk + warp * plan.chunk // 4
            w1 = min(rows, w0 + plan.chunk // 4)
            acc, part = zeros, {h: zeros for h in halves}
            for r0 in range(w0, w1, 16):
                r1 = min(w1, r0 + 16)
                for h in halves:
                    cols = slice(h + r0, h + r1)
                    step = zeros
                    for plane in planes:
                        step = step + plane[:, cols] @ c[cols]
                    if grouped:
                        part[h] = part[h] + step
                    else:
                        acc = acc + step
                if grouped and (r1 == w1 or r0 // g != (r0 + 16) // g):
                    for h in halves:
                        acc = acc + part[h] * s[(h + r0) // g]
                        part[h] = zeros
            block = block + acc
        total = block if total is None else total + block
    return total if grouped else total * s


def dec_plan(M, N, rows, group, sms):
    plan = tq._plan(M, N, rows, sms, torch.float32, group)
    assert plan.form == "decode_tc_x3"
    return plan


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("K,N,sms", [(256, 48, 132), (512, 80, 1),
                                     (4096, 32, 1), (1024, 64, 132)])
def test_the_decode_form_matches_jax_int8_matmul(M, K, N, sms):
    """int8 at M 1 and 8: a range a block (132 SMs: 4 to 8 short ranges,
    a step or two a warp; 1 SM: one long range of up to 1024 rows, or 4 of
    1024 at K4096, 8 to 16 steps a warp), N ragged against the tile (48,
    80) or whole."""
    x, w = inputs(M, K, N, 7 * M + K)
    codes, scales = jq.quantize_weight(jnp.asarray(w))
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), codes, scales,
                                     interpret=True))
    tc, ts = (torch.from_numpy(np.array(a)) for a in (codes, scales))
    tx = torch.from_numpy(x)
    plan = dec_plan(M, N, K, None, sms)
    got = matmul_dec_x3(tx, tc, ts, plan)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    exact = x.astype(np.float64) @ (np.asarray(codes, np.float64)
                                    * np.asarray(scales, np.float64))
    assert excess(got, want) <= 0
    assert excess(got, exact) <= 0
    assert excess(hi_only(tx, tc, ts), exact) > 0


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("K,N,sms", [(255, 48, 132), (512, 80, 1),
                                     (4096, 32, 1), (8192, 32, 1),
                                     (1024, 64, 132)])
def test_the_decode_form_matches_jax_int4_matmul(M, K, N, sms):
    """Per-column int4 at M 1 and 8: K 255 is odd (128 packed rows, x's
    column 255 absent against the last packed row's high nibble, the zero
    code), N 48 ragged against the tile, on 132 SMs' plan (2 ranges of 64
    rows, a step a warp); 1 SM: one range of 256 rows (K512, N 80 ragged),
    two of 1024 (K4096) and four of 1024 (K8192), 16 steps a warp; K1024
    on 132 SMs, 8 ranges of 64 rows."""
    x, w = inputs(M, K, N, 3 * M + K)
    packed, scales, k = jq.quantize_weight_int4(jnp.asarray(w))
    want = np.asarray(jq.int4_matmul(jnp.asarray(x), packed, scales,
                                     k_dim=k, interpret=True))
    tp = torch.from_numpy(np.array(packed))
    codes = tq.unpack_int4(tp, K)
    ts, tx = torch.from_numpy(np.array(scales)), torch.from_numpy(x)
    plan = dec_plan(M, N, tp.shape[0], None, sms)
    got = matmul_dec_x3(tx, codes, ts, plan, k2=tp.shape[0])
    assert got.dtype == torch.float32 and got.shape == (M, N)
    exact = x.astype(np.float64) @ tq.dequantize(codes, ts, K).double().numpy()
    assert excess(got, want) <= 0
    assert excess(got, exact) <= 0
    assert excess(hi_only(tx, codes, ts), exact) > 0


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("K,N,g,sms", [(256, 48, 16, 132), (512, 80, 32, 1),
                                       (1024, 64, 128, 132),
                                       (4096, 32, 128, 1)])
def test_the_decode_form_matches_jax_grouped_int4_matmul(M, K, N, g, sms):
    """Grouped int4 at M 1 and 8, groups of 16, 32 and 128: a group ends
    inside a warp's quarter (16, 32), with it (1024 rows in 132 SMs' plan)
    or spans warps (128 at K1024: 64-row ranges, 16 rows a warp)."""
    x, w = inputs(M, K, N, 5 * M + K + g)
    packed, scales, k = jq.quantize_weight_int4(
        jnp.asarray(w), group_size=g, allow_small_groups=True)
    want = np.asarray(jq.int4_matmul(jnp.asarray(x), packed, scales,
                                     k_dim=k, interpret=True))
    tp = torch.from_numpy(np.array(packed))
    codes = tq.unpack_int4(tp, K)
    ts, tx = torch.from_numpy(np.array(scales)), torch.from_numpy(x)
    plan = dec_plan(M, N, tp.shape[0], g, sms)
    got = matmul_dec_x3(tx, codes, ts, plan, k2=tp.shape[0])
    assert got.dtype == torch.float32 and got.shape == (M, N)
    exact = x.astype(np.float64) @ tq.dequantize(codes, ts, K).double().numpy()
    assert excess(got, want) <= 0
    assert excess(got, exact) <= 0
    assert excess(hi_only(tx, codes, ts), exact) > 0


def test_the_decode_form_scales_groups_before_they_are_summed():
    """As in the prefill form: two groups whose scales differ by 2^20
    keep the small group's products, in each half of the packed rows."""
    x = torch.ones(8, 128)
    codes = torch.ones(128, 16, dtype=torch.int8)
    scales = torch.tensor([[1.0] * 16, [2.0 ** -20] * 16] * 2)
    plan = dec_plan(8, 16, 64, 32, 132)
    got = matmul_dec_x3(x, codes, scales, plan, k2=64)
    assert torch.equal(got, torch.full((8, 16), 64 + 64 * 2.0 ** -20))
