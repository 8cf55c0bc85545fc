"""The CUDA kernels (flash decode, flash-attention forward and backward, with
windows, packed segments and attention dropout (each dropout form against
its plain version, every kernel's keep bits against the hash, the same
bits twice, no host sync),
fused LayerNorm and masked softmax forward and backward, the int8 and
packed-int4 weight-only matmuls) against their plain PyTorch versions, on
the card, and ``remat`` with dropout from a CUDA generator against no
remat.  Every test here needs a
CUDA device and skips without one; the file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Decode tolerances: 2e-2 with bf16 q (outputs are rounded to bf16, and the
kernel rounds p to bf16 before P.V where the plain version keeps fp32);
1e-5 in fp32 with TF32 off (summation order and ``__expf`` only).  The
flash-attention tolerances are stated beside their tests.
"""

import numpy as np
import pytest
import torch

from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import KVCache, make_caches
from tpu_flash_torch.kernels import common, decode
from tpu_flash_torch.kernels.decode import flash_decode_attention

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def filled_cache(gen, dev, B, Hkv, S, d, quant, dtype, lengths):
    cache = KVCache.create(B, Hkv, S, d, quant=quant, compute_dtype=dtype,
                           device=dev)
    k, v = (torch.randn(B, Hkv, S, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    cache.append(k, v)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def kernel_and_plain(cache, q, window):
    args = (q, cache.k, cache.v, cache.lengths, cache.k_scale, cache.v_scale)
    before = common.launch_counts["flash_decode"]
    got = flash_decode_attention(*args, window=window)
    assert common.launch_counts["flash_decode"] == before + 1
    want = flash_decode_attention(*args, window=window, impl="plain")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    return got.float(), want.float()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_kernel_matches_plain_bf16(cuda_device, quant, window):
    """bf16 q, ragged lengths (0 and 1 < Lq among them), GQA g=2, Lq=2."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    cache = filled_cache(gen, cuda_device, 4, 4, 512, 64, quant,
                         torch.bfloat16, [0, 1, 300, 512])
    q = torch.randn(4, 8, 2, 64, generator=gen,
                    device=cuda_device).bfloat16()
    got, want = kernel_and_plain(cache, q, window)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert torch.count_nonzero(got[0]) == 0          # length 0: all rows 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,Hq,Hkv,Lq", [(16, 4, 4, 1), (32, 16, 1, 8),
                                          (128, 8, 2, 3)])
def test_kernel_matches_plain_fp32(cuda_device, d, Hq, Hkv, Lq):
    gen = torch.Generator(cuda_device).manual_seed(1)
    cache = filled_cache(gen, cuda_device, 3, Hkv, 300, d, "none",
                         torch.float32, [2, 129, 300])
    q = torch.randn(3, Hq, Lq, d, generator=gen, device=cuda_device)
    got, want = kernel_and_plain(cache, q, None)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def serving_plan(dev, B, Hq, Hkv, Lq, dtype, d=64):
    return decode._plan(B, Hkv, Lq * (Hq // Hkv), d, dtype,
                        common.sm_count(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_split_decode_at_the_split_s_edges(cuda_device, quant):
    """The serving shape (B8 Hq16 d64; over an int8 cache clusters of C = 2
    at 132 multiprocessors), lengths 0, 1, C - 1, C, 7, 1000, 8191 and
    8192 = S; then windows of 1 and 5, which leave a block of the cluster
    nothing to read; the same bits on two calls."""
    gen = torch.Generator(cuda_device).manual_seed(11)
    C = serving_plan(cuda_device, 8, 16, 16, 1, torch.int8).cluster
    assert C > 1         # over a bf16 cache the plan takes no cluster
    lengths = [0, 1, C - 1, C, 7, 1000, 8191, 8192]
    cache = filled_cache(gen, cuda_device, 8, 16, 8192, 64, quant,
                         torch.bfloat16, lengths)
    q = torch.randn(8, 16, 1, 64, generator=gen,
                    device=cuda_device).bfloat16()
    for window in (None, 1, 5):
        got, want = kernel_and_plain(cache, q, window)
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        assert torch.count_nonzero(got[0]) == 0      # length 0: all rows 0
        again = flash_decode_attention(q, cache.k, cache.v, cache.lengths,
                                       cache.k_scale, cache.v_scale,
                                       window=window)
        assert torch.equal(again.float(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, "none"),
                                         (torch.bfloat16, "fp8"),
                                         (torch.float32, "none")])
def test_split_decode_gqa_lq8(cuda_device, dtype, quant):
    """Lq = 8 with 4 query heads a KV head: 32 rows a KV head, more than a
    block holds (several chunks), each row its own causal limit; lengths
    below Lq (rows that see no position), below C, and S below the length
    (an idle slot); a window; the same bits on two calls."""
    gen = torch.Generator(cuda_device).manual_seed(12)
    plan = serving_plan(cuda_device, 4, 8, 2, 8, dtype)
    assert plan.chunks > 1
    cache = filled_cache(gen, cuda_device, 4, 2, 300, 64, quant, dtype,
                         [3, plan.cluster - 1, 257, 300])
    cache.lengths[3] = 310            # past S: reads stop at S
    q = torch.randn(4, 8, 8, 64, generator=gen, device=cuda_device).to(dtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for window in (None, 20):
        got, want = kernel_and_plain(cache, q, window)
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
        again = flash_decode_attention(q, cache.k, cache.v, cache.lengths,
                                       cache.k_scale, cache.v_scale,
                                       window=window)
        assert torch.equal(again.float(), got)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 1, 48, device=cuda_device)
    kv = torch.zeros(1, 8, 2 * 48, device=cuda_device)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_attention(q, kv, kv, lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_decode_attention(q[..., :32].half(), kv[..., :64], kv[..., :64],
                               lengths)


@pytest.mark.cuda
def test_decode_step_logits_kernel_matches_plain(cuda_device):
    """One decode step of a small fp32 DecoderLM over an int8 cache: the
    logits through the kernel and through the plain version agree, and the
    kernel ran once per layer."""
    cfg = tnn.DecoderConfig(n_vocab=128, n_embd=64, n_head=4, n_positions=64,
                            n_layer=2, ff_middle_dim=128, p_dropout=0.0,
                            attention_kind="naive")
    model = tnn.DecoderLM(cfg, device=cuda_device)
    tnn.init_params(model, torch.Generator(cuda_device).manual_seed(2))
    ids = torch.randint(0, 128, (3, 20), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(3))
    logits = {}
    for impl in ("kernel", "plain"):
        caches = make_caches(model, 3, 32, quant="int8")
        with torch.no_grad():
            model(ids, kv_caches=caches)
            before = common.launch_counts["flash_decode"]
            out, _ = model(ids[:, -1:], kv_caches=caches,
                           positions=caches[0].lengths[:, None].long(),
                           impl=impl)
        launched = common.launch_counts["flash_decode"] - before
        assert launched == (cfg.n_layer if impl == "kernel" else 0)
        logits[impl] = out
    torch.testing.assert_close(logits["kernel"], logits["plain"], atol=1e-4,
                               rtol=1e-4)


# --- flash-attention forward and backward kernels -------------------------
#
# Tolerances, kernel against plain on the same inputs: fp32 with TF32 off
# differs by summation order, exp2f and, in the forward's and the fused
# backward's six-product form, the products that form leaves out (below
# 2^-24 of each) (1e-4 on out/lse, 1e-3 on the gradients, whose sums run
# over up to 2048 rows in another order).  lse
# and m are fp32 in both dtypes and keep 1e-4.  bf16 out and gradients are
# rounded to bf16 and may land an ulp either side of a boundary (rtol 2e-2
# covers two), and the forward kernel rounds p relative to its running max
# where the plain version uses the row's final max: BF16_ARMS of the
# output's root mean square on top, chip_smoke.py's limit.  Below d = 128
# the bf16 normaliser sums that rounded p (the JAX kernel's rule), so the
# kernel's lse carries the same rounding: in bf16 it is held at 1e-4 against
# ``stepped_lse``, the plain arithmetic with p rounded where the tensor-core
# kernel rounds it.

FA_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1e-4, None)}
BF16_ARMS, BF16_RTOL = 3e-2, 2e-2


def assert_within(got, want, arms, rtol):
    """Finite, and |got - want| <= arms * rms(want) + rtol * |want|."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    rms = float(want.square().mean().sqrt())
    excess = (got - want).abs() - arms * rms - rtol * want.abs()
    assert float(excess.max()) <= 0, (float((got - want).abs().max()), rms)


def assert_close_bf16(got, want):
    assert_within(got, want, BF16_ARMS, BF16_RTOL)


def stepped_lse(q, k, causal, q_offset=None, window=None, seg=None):
    """lse as the tensor-core forward computes it from bf16 q and k: the
    online softmax over steps of 64 keys (32 at d = 128), each step's p
    rounded to bf16 against the running max, and below d = 128 the
    normaliser summing that bf16 p (at d = 128 the fp32 p); ``window`` and
    ``seg`` mask as the masked form does."""
    from tpu_flash_torch.kernels import flash_attention as fa

    B, H, Lq, d = q.shape
    Lk, g = k.shape[2], H // k.shape[1]
    q_offset = Lk - Lq if q_offset is None else q_offset
    s2 = fa._scores2(q, k, 1 / d ** 0.5, causal, q_offset, window, seg)
    m = torch.full((B, H, Lq, 1), -float("inf"), device=q.device)
    l = torch.zeros_like(m)
    step = 64 if d <= 64 else 32
    for k0 in range(0, Lk, step):
        s = s2[..., k0:k0 + step]
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(torch.isneginf(mx), 0.0, mx)
        p = torch.exp2(s - base)
        if d < 128:
            p = p.bfloat16().float()
        l = l * torch.exp2(m - base) + p.sum(-1, keepdim=True)
        m = mx
    lse = m[..., 0] / fa.LOG2E + torch.log(l[..., 0])
    return torch.where(torch.isneginf(m[..., 0]), -float("inf"), lse)


def attention_case(gen, dev, B, H, Hkv, Lq, Lk, d, dtype):
    q = torch.randn(B, H, Lq, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, Hkv, Lk, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn(B, H, Lq, d, generator=gen, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d", [
    (2, 4, 4, 64, 64, 64), (1, 2, 2, 200, 200, 32), (1, 8, 2, 256, 256, 128),
    (2, 2, 1, 130, 70, 16), (1, 4, 4, 70, 130, 64)])
def test_flash_attention_kernels_match_plain(cuda_device, dtype, causal, B,
                                             H, Hkv, Lq, Lk, d):
    from tpu_flash_torch.kernels import flash_attention as fa
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(4)
    q, k, v, do = attention_case(gen, cuda_device, B, H, Hkv, Lq, Lk, d,
                                 dtype)
    fw_tol, bw_tol = FA_TOL[dtype]
    before = dict(common.launch_counts)
    got = flash_attention_forward(q, k, v, causal=causal, with_m=True)
    want = flash_attention_forward(q, k, v, causal=causal, with_m=True,
                                   impl="plain")
    out, lse = got[0], got[1]
    grads = flash_attention_backward(q, k, v, out, lse, do, causal=causal)
    ref = flash_attention_backward(q, k, v, out, lse, do, causal=causal,
                                   impl="plain")
    torch.cuda.synchronize()
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for name in (fa.KERNEL_FWD, fa.KERNEL_BWD):
        mine, theirs = fa._form_name(name, dtype), fa._form_name(name, other)
        assert common.launch_counts[mine] == before.get(mine, 0) + 1
        assert common.launch_counts[theirs] == before.get(theirs, 0)
    if dtype == torch.bfloat16:
        want = (want[0], stepped_lse(q, k, causal), want[2])
    for a, b in zip(got[1:], want[1:]):          # lse, m (-inf on empty rows)
        torch.testing.assert_close(a, b, atol=fw_tol, rtol=fw_tol)
    for a, b in zip((got[0], *grads), (want[0], *ref)):   # out, dq, dk, dv
        assert torch.isfinite(a).all()
        if dtype == torch.bfloat16:
            assert_close_bf16(a, b)
        else:
            tol = fw_tol if a is got[0] else bw_tol
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    if causal and Lq > Lk:                       # rows before the first key
        empty = Lq - Lk
        assert torch.count_nonzero(out[:, :, :empty]) == 0
        assert torch.isneginf(lse[:, :, :empty]).all()
        assert torch.count_nonzero(grads[0][:, :, :empty]) == 0


@pytest.mark.cuda
def test_flash_attention_op_trains_through_the_kernels(cuda_device):
    """The autograd Function on CUDA tensors launches both kernels once and
    its gradients agree with autograd through naive attention."""
    from tpu_flash_torch.ops import flash_attention, naive_attention

    gen = torch.Generator(cuda_device).manual_seed(5)
    q, k, v, do = attention_case(gen, cuda_device, 2, 4, 4, 300, 300, 64,
                                 torch.float32)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    before = dict(common.launch_counts)
    out = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad((out * do).sum(), leaves)
    ref = naive_attention(*leaves, causal=True)
    ref_grads = torch.autograd.grad((ref * do).sum(), leaves)
    for name in ("flash_attention_fwd_x6", "flash_attention_bwd_x6"):
        assert common.launch_counts[name] == before.get(name, 0) + 1
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_training_step_from_a_host_batch_makes_the_host_wait_nowhere(
        cuda_device):
    """place_batch and a training step with dropout, under torch's sync
    debug mode set to raise at any operation that waits for the card."""
    from tpu_flash_torch.apps import machine_translation as tmt

    cfg = tnn.DecoderConfig(n_vocab=64, n_embd=64, n_head=4, n_positions=128,
                            n_layer=2, ff_middle_dim=64, p_dropout=0.1,
                            attention_kind="flash")
    model = tnn.DecoderLM(cfg, device=cuda_device)
    tnn.init_params(model, torch.Generator(cuda_device).manual_seed(0))
    opt = tnn.mixed_precision(tnn.adam())
    step = tmt.make_train_step(model, opt)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 64, (2, 128)),
             "labels": rng.integers(0, 64, (2, 128)),
             "label_token_weights": np.ones((2, 128), np.float32)}
    state, _ = step(opt.init(dict(model.named_parameters())),
                    tmt.place_batch(batch, cuda_device))   # builds, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        placed = tmt.place_batch(batch, cuda_device)
        state, loss = step(state, placed)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert placed["input_ids"].is_cuda
    np.testing.assert_array_equal(placed["input_ids"].cpu().numpy(),
                                  batch["input_ids"])
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_flash_attention_kernels_reject_what_they_do_not_take(cuda_device):
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_forward)

    x = torch.zeros(1, 2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_forward(x, x, x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_forward(*(x[..., :32].half() for _ in range(3)))
    with pytest.raises(ValueError, match="window requires causal"):
        flash_attention_forward(x[..., :32], x[..., :32], x[..., :32],
                                window=4)
    # dropout is ported: a rate outside [0, 1) is refused; quantized K/V
    # is ported: scales need codes, and both scales
    with pytest.raises(ValueError, match="dropout_rate"):
        flash_attention_forward(x[..., :32], x[..., :32], x[..., :32],
                                dropout_rate=1.0)
    with pytest.raises(TypeError, match="codes"):
        flash_attention_forward(x[..., :32], x[..., :32], x[..., :32],
                                dropout_rate=0.1, k_scale=x[0, :, :, 0],
                                v_scale=x[0, :, :, 0])
    codes = x[..., :32].to(torch.int8)
    with pytest.raises(ValueError, match="both"):
        flash_attention_forward(x[..., :32], codes, codes,
                                dropout_rate=0.1, k_scale=x[:, :, :, 0])


# --- the tensor-core forms of the forward and the fused backward (bf16) ----


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,q_offset", [
    (1, 4, 2, 77, 77, 64, None),       # lengths not multiples of 16
    (1, 2, 2, 100, 45, 32, None),      # Lq > Lk: rows that see no key
    (1, 2, 2, 45, 100, 32, None),      # Lq < Lk
    (1, 2, 2, 96, 96, 64, 17),         # q_offset > 0 at Lq = Lk
    (1, 2, 2, 96, 96, 64, -23),        # q_offset < 0: rows that see no key
    (1, 2, 2, 150, 90, 64, -70),
    (2, 8, 2, 200, 200, 16, None),     # d 16 under GQA
    (1, 8, 2, 300, 300, 128, None),    # d 128 under GQA
    (1, 4, 1, 129, 257, 128, 100)])
def test_tc_forward_and_fused_backward_at_ragged_shapes(cuda_device, causal,
                                                        B, H, Hkv, Lq, Lk, d,
                                                        q_offset):
    """The bf16 tensor-core forward and fused backward where their tiles
    are masked (ragged ends of Lq and Lk, the causal diagonal moved by
    q_offset either way, d 16 and 128 under GQA): each launched once under
    its ``_tc`` name; out and the gradients within BF16_ARMS of the plain
    versions, lse within 1e-4 of ``stepped_lse`` and m of the plain row
    max; rows that see no key give out 0, lse and m -inf and dq 0."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused, flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(12)
    q, k, v, do = attention_case(gen, cuda_device, B, H, Hkv, Lq, Lk, d,
                                 torch.bfloat16)
    kw = dict(causal=causal, q_offset=q_offset)
    before = dict(common.launch_counts)
    out, lse, m = flash_attention_forward(q, k, v, with_m=True, **kw)
    want = flash_attention_forward(q, k, v, with_m=True, impl="plain", **kw)
    grads = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
    ref = flash_attention_backward_fused(q, k, v, out, lse, do, impl="plain",
                                         **kw)
    torch.cuda.synchronize()
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    assert launched == {"flash_attention_fwd_tc": 1,
                        "flash_attention_bwd_tc": 1}
    torch.testing.assert_close(lse, stepped_lse(q, k, causal, q_offset),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(m, want[2], atol=1e-4, rtol=1e-4)
    for a, b in zip((out, *grads), (want[0], *ref)):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        assert_close_bf16(a, b)
    empty = max(0, Lq - Lk if q_offset is None else -q_offset) if causal else 0
    assert torch.count_nonzero(out[:, :, :empty]) == 0
    assert torch.isneginf(lse[:, :, :empty]).all()
    assert torch.isneginf(m[:, :, :empty]).all()
    assert torch.count_nonzero(grads[0][:, :, :empty]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,causal,q_offset", [
    (4, 8, 8, 2048, 2048, 64, True, None),    # the production shape
    (2, 8, 2, 1000, 1000, 128, True, None),   # d 128 under GQA
    (1, 4, 4, 300, 700, 32, True, 100),
    (2, 4, 2, 513, 513, 16, False, None)])
def test_tc_fused_backward_gives_the_same_bits(cuda_device, B, H, Hkv, Lq,
                                               Lk, d, causal, q_offset):
    """The tensor-core fused backward adds each 64-row tile's dQ in the
    order of the key tiles: two calls give the same bits for dq, dk and dv
    (at d 128 dQ is formed 32 columns at a time inside the ordered
    section)."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused)

    args = two_pass_case(cuda_device, 13, B, H, Hkv, Lq, Lk, d,
                         torch.bfloat16, causal, q_offset)
    kw = dict(causal=causal, q_offset=q_offset)
    before = common.launch_counts["flash_attention_bwd_tc"]
    first = flash_attention_backward_fused(*args, **kw)
    second = flash_attention_backward_fused(*args, **kw)
    torch.cuda.synchronize()
    assert common.launch_counts["flash_attention_bwd_tc"] == before + 2
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# --- the fp32 forms of the forward and the fused backward (six products) --


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,q_offset", [
    (1, 4, 2, 77, 77, 64, None),       # lengths not multiples of 16
    (1, 2, 2, 100, 45, 32, None),      # Lq > Lk: rows that see no key
    (1, 2, 2, 45, 100, 32, None),      # Lq < Lk
    (1, 2, 2, 96, 96, 64, 17),         # q_offset > 0 at Lq = Lk
    (1, 2, 2, 96, 96, 64, -23),        # q_offset < 0: rows that see no key
    (2, 8, 2, 200, 200, 16, None),     # d 16 under GQA
    (1, 8, 2, 300, 300, 128, None),    # d 128 under GQA
    (1, 8, 2, 130, 250, 128, 60),      # d 128 under GQA, q_offset given
    (1, 4, 1, 129, 257, 128, -40)])    # and q_offset < 0
def test_x6_forward_and_fused_backward_at_ragged_shapes(cuda_device, causal,
                                                        B, H, Hkv, Lq, Lk, d,
                                                        q_offset):
    """The fp32 forward and fused backward (each product six bf16 products
    on the tensor cores) where their tiles are masked: ragged ends of Lq and
    Lk, the causal diagonal moved by q_offset either way, d 16 and 128 under
    GQA; each launched once under its ``_x6`` name, within FA_TOL's fp32
    limits of the plain versions (with ``dlse`` given); rows that see no
    key give out 0, lse and m -inf and dq 0."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused, flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(14)
    q, k, v, do = attention_case(gen, cuda_device, B, H, Hkv, Lq, Lk, d,
                                 torch.float32)
    kw = dict(causal=causal, q_offset=q_offset)
    fw_tol, bw_tol = FA_TOL[torch.float32]
    before = dict(common.launch_counts)
    out, lse, m = flash_attention_forward(q, k, v, with_m=True, **kw)
    want = flash_attention_forward(q, k, v, with_m=True, impl="plain", **kw)
    dlse = torch.randn(B, H, Lq, generator=gen, device=cuda_device)
    grads = flash_attention_backward_fused(q, k, v, out, lse, do, dlse, **kw)
    ref = flash_attention_backward_fused(q, k, v, out, lse, do, dlse,
                                         impl="plain", **kw)
    torch.cuda.synchronize()
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    assert launched == {"flash_attention_fwd_x6": 1,
                        "flash_attention_bwd_x6": 1}
    for a, b in zip((out, lse, m), want):
        torch.testing.assert_close(a, b, atol=fw_tol, rtol=fw_tol)
    for a, b in zip(grads, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=bw_tol, rtol=bw_tol)
    empty = max(0, Lq - Lk if q_offset is None else -q_offset) if causal else 0
    assert torch.count_nonzero(out[:, :, :empty]) == 0
    assert torch.isneginf(lse[:, :, :empty]).all()
    assert torch.isneginf(m[:, :, :empty]).all()
    assert torch.count_nonzero(grads[0][:, :, :empty]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,causal,q_offset", [
    (4, 8, 8, 2048, 2048, 64, True, None),    # the production shape
    (2, 8, 2, 1000, 1000, 128, True, None),   # d 128 under GQA: 32-row tiles
    (1, 8, 2, 700, 500, 128, True, -30),      # and q_offset given
    (1, 4, 4, 300, 700, 32, True, 100),
    (2, 4, 2, 513, 513, 16, False, None)])
def test_x6_fused_backward_gives_the_same_bits(cuda_device, B, H, Hkv, Lq,
                                               Lk, d, causal, q_offset):
    """The fp32 fused backward adds each query tile's dQ in the order of the
    key tiles: two calls give the same bits for dq, dk and dv."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused)

    args = two_pass_case(cuda_device, 15, B, H, Hkv, Lq, Lk, d,
                         torch.float32, causal, q_offset)
    kw = dict(causal=causal, q_offset=q_offset)
    before = common.launch_counts["flash_attention_bwd_x6"]
    first = flash_attention_backward_fused(*args, **kw)
    second = flash_attention_backward_fused(*args, **kw)
    torch.cuda.synchronize()
    assert common.launch_counts["flash_attention_bwd_x6"] == before + 2
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_entries_refuse_the_other_forms_dtype(cuda_device, which,
                                                    dtype):
    """The forward's and the fused backward's ``_tc`` entries take bf16
    only, their ``_x6`` entries fp32 only: handed the other dtype's flag,
    an entry returns an error and writes nothing."""
    import ctypes

    from tpu_flash_torch.kernels import flash_attention as fa

    q, k, v, out, lse, do = two_pass_case(cuda_device, 5, 1, 2, 2, 64, 64,
                                          16, dtype, True)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    kernel = fa.KERNEL_FWD if which == "fwd" else fa.KERNEL_BWD
    symbol = "tf_" + fa._form_name(kernel, dtype)
    shape = (1, 2, 2, 64, 64, 16, fa._DTYPES[other], 1, 0)

    def nan_like(t, dtype=None):
        return torch.full_like(t, float("nan"), dtype=dtype)

    if which == "fwd":
        outs = (nan_like(q), nan_like(lse), nan_like(lse))
        _, fn = common.entry(kernel, symbol, [ctypes.c_void_p] * 6
                             + [ctypes.c_int] * 9
                             + [ctypes.c_float] + fa._MASK_DROP_ARGS)
        err = common.call_on_stream(
            fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(t.data_ptr() for t in outs), *shape, 0.25 * fa.LOG2E, 0, None,
            None, 0, 1.0)
    else:
        kin = fa._bwd_inputs(q, k, v, out, lse, do, None)
        order = torch.zeros(2, dtype=torch.int32, device=q.device)
        outs = (nan_like(q, torch.float32), nan_like(k), nan_like(v))
        _, fn = common.entry(kernel, symbol, [ctypes.c_void_p] * 10
                             + [ctypes.c_int] * 9
                             + [ctypes.c_float, ctypes.c_float]
                             + fa._MASK_DROP_ARGS)
        err = common.call_on_stream(
            fn, q.device, *(t.data_ptr() for t in kin), outs[0].data_ptr(),
            order.data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(), *shape,
            0.25, 0.25 * fa.LOG2E, 0, None, None, 0, 1.0)
    torch.cuda.synchronize()
    assert err != 0
    assert all(torch.isnan(t.float()).all() for t in outs)


# --- the two-pass backward (dK/dV pass, dQ pass) ----------------------------
#
# Each pass against its plain half on the same inputs, at the limits above.
# The two passes use no atomics: two calls give the same bits.  bf16 takes
# the tensor-core form (launches counted under the names + "_tc"), fp32 the
# six-product form (the names + "_x6").


def two_pass_case(dev, seed, B, H, Hkv, Lq, Lk, d, dtype, causal,
                  q_offset=None):
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_forward)

    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v, do = attention_case(gen, dev, B, H, Hkv, Lq, Lk, d, dtype)
    out, lse, _ = flash_attention_forward(q, k, v, causal=causal,
                                          q_offset=q_offset)
    return q, k, v, out, lse, do


def two_pass_names(dtype):
    """The launch-count names of the two passes' form for ``dtype``."""
    from tpu_flash_torch.kernels import flash_attention as fa

    return tuple(fa._form_name(n, dtype)
                 for n in (fa.KERNEL_DKV, fa.KERNEL_DQ))


def check_two_pass(q, k, v, out, lse, do, dtype, causal, q_offset=None):
    """The two passes against their plain halves, each launched once
    under its form's name (and the other form's names not at all)."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_dkv_plain, flash_attention_backward_dq_plain,
        flash_attention_backward_two_pass)

    kw = dict(causal=causal, q_offset=q_offset)
    names = two_pass_names(dtype)
    others = two_pass_names(torch.float32 if dtype == torch.bfloat16
                            else torch.bfloat16) + ("flash_attention_bwd_x6",
                                                    "flash_attention_bwd_tc")
    before = dict(common.launch_counts)
    dq, dk, dv = flash_attention_backward_two_pass(q, k, v, out, lse, do,
                                                   **kw)
    want_dk, want_dv = flash_attention_backward_dkv_plain(q, k, v, out, lse,
                                                          do, **kw)
    want_dq = flash_attention_backward_dq_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    for name in names:
        assert common.launch_counts[name] == before.get(name, 0) + 1
    for name in others:
        assert common.launch_counts[name] == before.get(name, 0)
    for a, b in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        if dtype == torch.bfloat16:
            assert_close_bf16(a, b)
        else:
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d", [
    (2, 4, 4, 300, 300, 64), (1, 8, 2, 256, 256, 128), (2, 2, 1, 130, 70, 16),
    (1, 4, 4, 70, 130, 32), (1, 2, 2, 1000, 1000, 64)])
def test_two_pass_kernels_match_plain(cuda_device, dtype, causal, B, H, Hkv,
                                      Lq, Lk, d):
    args = two_pass_case(cuda_device, 6, B, H, Hkv, Lq, Lk, d, dtype, causal)
    dq = check_two_pass(*args, dtype, causal)
    if causal and Lq > Lk:                       # rows before the first key
        assert torch.count_nonzero(dq[:, :, :Lq - Lk]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("B,H,Hkv,Lq,Lk,d,q_offset", [
    (1, 4, 2, 77, 77, 64, None),       # lengths not multiples of 16
    (1, 2, 2, 100, 45, 32, None),      # Lq > Lk, ragged
    (1, 2, 2, 45, 100, 32, None),      # Lq < Lk, ragged
    (1, 2, 2, 96, 96, 64, 17),         # q_offset > 0 at Lq = Lk
    (1, 2, 2, 96, 96, 64, -23),        # q_offset < 0: rows that see no key
    (1, 2, 2, 90, 150, 64, 10),
    (1, 2, 2, 150, 90, 64, -70),
    (2, 8, 2, 200, 200, 16, None),     # d 16 under GQA
    (1, 8, 2, 300, 300, 128, None),    # d 128 under GQA
    (1, 4, 1, 129, 257, 128, 100)])
def test_two_pass_tensor_core_form_at_ragged_shapes(cuda_device, dtype,
                                                    causal, B, H, Hkv, Lq,
                                                    Lk, d, q_offset):
    """The tensor-core passes of each dtype (bf16 one product, fp32 six) at
    the shapes where their tiles are masked: ragged ends of Lq and Lk, the
    causal diagonal moved by q_offset either way, and d 16 and 128 under
    GQA."""
    args = two_pass_case(cuda_device, 9, B, H, Hkv, Lq, Lk, d, dtype,
                         causal, q_offset)
    dq = check_two_pass(*args, dtype, causal, q_offset)
    if causal and q_offset is not None and q_offset < 0:
        assert torch.count_nonzero(dq[:, :, :-q_offset]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dkv", "dq"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_entries_refuse_the_other_forms_dtype(cuda_device, which,
                                                       dtype):
    """The tensor-core entries (``tf_..._tc``) take bf16 only, the
    six-product entries (``tf_flash_attention_bwd_dkv_x6``,
    ``tf_flash_attention_bwd_dq_x6``) fp32 only: handed the other dtype's
    flag, an entry returns an error and writes nothing."""
    import ctypes

    from tpu_flash_torch.kernels import flash_attention as fa

    q, k, v, out, lse, do = two_pass_case(cuda_device, 5, 1, 2, 2, 64, 64,
                                          16, dtype, True)
    kin = fa._bwd_inputs(q, k, v, out, lse, do, None)
    outs = ((torch.full_like(k, float("nan")),
             torch.full_like(v, float("nan"))) if which == "dkv"
            else (torch.full_like(q, float("nan")),))
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    name = fa._form_name(
        fa.KERNEL_DKV if which == "dkv" else fa.KERNEL_DQ, dtype)
    _, fn = common.entry(fa.SOURCE_TWO_PASS, "tf_" + name,
                         fa._two_pass_args(6 + len(outs)))
    err = common.call_on_stream(
        fn, q.device, *(t.data_ptr() for t in kin), *(t.data_ptr()
                                                       for t in outs),
        1, 2, 2, 64, 64, 16, fa._DTYPES[other], 1, 0, 0.25, 0.25 * fa.LOG2E,
        0, None, None, 0, 1.0)
    torch.cuda.synchronize()
    assert err != 0
    assert all(torch.isnan(t.float()).all() for t in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_pass_is_deterministic_and_matches_the_fused_pass(cuda_device,
                                                             dtype):
    """Two calls give the same bits; the fused kernel (its dQ summed in
    another order) agrees within the kernel-vs-plain limits."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused, flash_attention_backward_two_pass)

    args = two_pass_case(cuda_device, 7, 2, 8, 2, 2048, 2048, 64, dtype, True)
    first = flash_attention_backward_two_pass(*args, causal=True)
    second = flash_attention_backward_two_pass(*args, causal=True)
    fused = flash_attention_backward_fused(*args, causal=True)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, fused):
        assert torch.equal(a, b)
        if dtype == torch.bfloat16:
            assert_close_bf16(a, c)
        else:
            torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,causal,B,H,Hkv,Lq,Lk,d", [
    (torch.bfloat16, True, 4, 8, 8, 2048, 2048, 64),
    (torch.float32, True, 4, 8, 8, 2048, 2048, 64),
    (torch.bfloat16, False, 2, 4, 4, 1000, 1000, 64),
    (torch.bfloat16, True, 2, 8, 2, 130, 70, 32),
    (torch.float32, True, 1, 4, 4, 70, 130, 128)])
def test_fused_backward_is_deterministic(cuda_device, dtype, causal, B, H,
                                         Hkv, Lq, Lk, d):
    """The fused pass adds each query chunk's dQ in a fixed order: two
    calls give the same bits for dq, dk and dv (B4 H8 L2048 d64 causal is
    the production shape; the others cover no causal limit, GQA, Lq > Lk
    with rows that see no key, and Lq < Lk), and they agree with the plain
    version within its limits."""
    from tpu_flash_torch.kernels import flash_attention as fa
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused)

    args = two_pass_case(cuda_device, 11, B, H, Hkv, Lq, Lk, d, dtype,
                         causal)
    name = fa._form_name(fa.KERNEL_BWD, dtype)
    before = common.launch_counts[name]
    first = flash_attention_backward_fused(*args, causal=causal)
    second = flash_attention_backward_fused(*args, causal=causal)
    want = flash_attention_backward_fused(*args, causal=causal, impl="plain")
    torch.cuda.synchronize()
    assert common.launch_counts[name] == before + 2
    for a, b, c in zip(first, second, want):
        assert torch.equal(a, b)
        if dtype == torch.bfloat16:
            assert_close_bf16(a, c)
        else:
            torch.testing.assert_close(a, c, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_backward_takes_the_jax_form_for_the_shape(cuda_device):
    """bf16 causal at L = 16384 takes the two passes, at 2048 the fused
    pass, as the JAX package's selector does (each in its tensor-core
    form)."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward)

    for L, two in ((2048, False), (16384, True)):
        args = two_pass_case(cuda_device, 8, 1, 1, 1, L, L, 64,
                             torch.bfloat16, True)
        before = dict(common.launch_counts)
        grads = flash_attention_backward(*args, causal=True)
        torch.cuda.synchronize()
        launched = {n: common.launch_counts[n] - before.get(n, 0) for n in
                    ("flash_attention_bwd_tc", "flash_attention_bwd_dkv_tc",
                     "flash_attention_bwd_dq_tc")}
        assert launched == {"flash_attention_bwd_tc": int(not two),
                            "flash_attention_bwd_dkv_tc": int(two),
                            "flash_attention_bwd_dq_tc": int(two)}
        assert all(torch.isfinite(g).all() for g in grads)


def naive_remat(layer, x, *, generator, **kw):
    """``checkpoint`` around the layer with the caller's generator: the
    recompute draws other dropout masks than the forward did."""
    return torch.utils.checkpoint.checkpoint(
        lambda t: layer(t, generator=generator, **kw), x,
        use_reentrant=False)


def remat_runs(dev, cfg, L, V, chunks):
    """The loss, every gradient and the generator's final state of one
    forward and backward with and without remat (dropout from one seeded
    CUDA generator), and the attention kernels each launched."""
    from tpu_flash_torch.apps import machine_translation as tmt

    rng = np.random.default_rng(3)
    batch = tmt.place_batch(
        {"input_ids": rng.integers(0, V, (1, L)),
         "labels": rng.integers(0, V, (1, L)),
         "label_token_weights": (rng.random((1, L)) > 0.3
                                 ).astype(np.float32)}, dev)
    runs = {}
    for remat in (False, True):
        model = tnn.DecoderLM(tnn.DecoderConfig(**cfg, remat=remat),
                              device=dev)
        tnn.init_params(model, torch.Generator(dev).manual_seed(0))
        gen = torch.Generator(dev).manual_seed(5)
        before = dict(common.launch_counts)
        loss = tmt.make_loss_fn(model, chunked_vocab=chunks)(
            batch, generator=gen, training=True)
        loss.backward()
        torch.cuda.synchronize()
        launched = {n: common.launch_counts[n] - before.get(n, 0)
                    for base in ("flash_attention_fwd", "flash_attention_bwd",
                                 "flash_attention_bwd_dkv",
                                 "flash_attention_bwd_dq")
                    for n in (base, base + common.TC, base + common.X6)}
        runs[remat] = (loss.detach(), {n: p.grad.clone() for n, p in
                                       model.named_parameters()},
                       gen.get_state(), launched)
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("wrap", ["restored", "naive"])
def test_remat_equals_no_remat_bit_for_bit_on_the_card(cuda_device,
                                                       monkeypatch, wrap):
    """fp32 at d 128 and L 4096, where the backward takes the two passes
    (every kernel of the step gives the same bits each call), dropout 0.1
    from one seeded CUDA generator, the chunked loss: the loss, every
    gradient and the generator's final state are the same bits with and
    without remat.  A naive wrap gives other gradients."""
    from tpu_flash_torch.kernels.backward_form import two_pass
    from tpu_flash_torch.nn import transformer as ttr

    L, V = 4096, 500
    assert two_pass(L, L, 128, 4, True)
    if wrap == "naive":
        monkeypatch.setattr(ttr, "_remat_layer", naive_remat)
    runs = remat_runs(cuda_device, dict(
        n_vocab=V, n_embd=256, n_head=2, n_positions=L, n_layer=2,
        ff_middle_dim=256, p_dropout=0.1, attention_kind="flash"), L, V, 4)
    for remat in (False, True):
        launched = {n: c for n, c in runs[remat][3].items() if c}
        assert launched == {"flash_attention_fwd_x6": 2 * (1 + remat),
                            "flash_attention_bwd_dkv_x6": 2,
                            "flash_attention_bwd_dq_x6": 2}
    (loss0, g0, s0, _), (loss1, g1, s1, _) = runs[False], runs[True]
    assert torch.equal(loss0, loss1)
    same = all(torch.equal(g0[n], g1[n]) for n in g0)
    if wrap == "restored":
        assert same and torch.equal(s0, s1)
    else:
        assert not same


@pytest.mark.cuda
def test_remat_equals_no_remat_bit_for_bit_with_the_fused_backward(
        cuda_device):
    """The production shape (E 512, 8 heads of d 64, L 2048, bf16), where
    the backward takes the fused pass, its dQ added in a fixed order:
    remat on and off give the same loss, gradients and generator state."""
    from tpu_flash_torch.kernels.backward_form import two_pass

    L, V = 2048, 10_000
    assert not two_pass(L, L, 64, 2, True)
    runs = remat_runs(cuda_device, dict(
        n_vocab=V, n_embd=512, n_head=8, n_positions=L, n_layer=2,
        ff_middle_dim=256, p_dropout=0.1, attention_kind="flash",
        dtype=torch.bfloat16), L, V, 0)
    for remat in (False, True):
        launched = {n: c for n, c in runs[remat][3].items() if c}
        assert launched == {"flash_attention_fwd_tc": 2 * (1 + remat),
                            "flash_attention_bwd_tc": 2}
    (loss0, g0, s0, _), (loss1, g1, s1, _) = runs[False], runs[True]
    assert torch.equal(loss0, loss1) and torch.equal(s0, s1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


# --- fused LayerNorm and masked-softmax kernels ----------------------------
#
# Kernel against plain on the same inputs, |got - want| <= arms * rms(want)
# + rtol * |want|.  fp32: the two differ by summation order, rsqrtf and
# expf (1e-5, 1e-5); dgamma and dbeta sum over every row in another order
# (1e-4 of their rms).  bf16: the stores may round to the neighbouring bf16
# (rtol 2e-2 covers two ulps) on top of 1e-2 of the rms (chip_smoke.py's
# limits).

FUSED_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lead,H", [((37,), 200), ((4, 16), 256),
                                    ((3, 5), 640), ((33,), 70)])
def test_layernorm_kernels_match_plain(cuda_device, dtype, lead, H):
    """Ragged rows (37, 33) and widths (200, 70: not multiples of 32; 70
    not of 4), and H = 640 above the ops' 512 limit."""
    from tpu_flash_torch.kernels.layernorm import (layernorm_backward,
                                                   layernorm_forward)

    gen = torch.Generator(cuda_device).manual_seed(6)
    x, dy = (torch.randn(*lead, H, generator=gen, device=cuda_device
                         ).to(dtype) for _ in range(2))
    g, b = (torch.randn(H, generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    before = dict(common.launch_counts)
    y, mean, var = layernorm_forward(x, g, b)
    ref = layernorm_forward(x, g, b, impl="plain")
    grads = layernorm_backward(dy, x, g, mean, var)
    ref_grads = layernorm_backward(dy, x, g, mean, var, impl="plain")
    torch.cuda.synchronize()
    for name in ("layernorm_fwd", "layernorm_bwd"):
        assert common.launch_counts[name] == before.get(name, 0) + 1
    arms, rtol = FUSED_TOL[dtype]
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    for a, w in zip((y, mean, var, grads[0]), (*ref, ref_grads[0])):
        assert_within(a, w, arms, rtol)
    for a, w in zip(grads[1:], ref_grads[1:]):      # dgamma, dbeta
        assert a.dtype == dtype
        assert_within(a, w, max(arms, 1e-4), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,H", [(8192, 256), (8192, 512), (5000, 1024),
                                 (0, 256), (3, 70)])
def test_layernorm_backward_gives_the_same_bits(cuda_device, dtype, R, H):
    """The one-launch backward, dgamma and dbeta included, the same bits on
    two calls: the reference MT and production widths, a row held at the
    widest, no rows at all (dgamma and dbeta zero), and the looped form;
    against the plain version too."""
    from tpu_flash_torch.kernels.layernorm import (layernorm_backward,
                                                   layernorm_forward)

    gen = torch.Generator(cuda_device).manual_seed(7)
    x, dy = (torch.randn(R, H, generator=gen, device=cuda_device).to(dtype)
             for _ in range(2))
    g = torch.randn(H, generator=gen, device=cuda_device).to(dtype)
    _, mean, var = layernorm_forward(x, g, torch.zeros_like(g))
    before = common.launch_counts["layernorm_bwd"]
    first = layernorm_backward(dy, x, g, mean, var)
    second = layernorm_backward(dy, x, g, mean, var)
    torch.cuda.synchronize()
    assert common.launch_counts["layernorm_bwd"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    if R == 0:
        assert first[0].shape == (0, H)
        assert not first[1].any() and not first[2].any()
        return
    ref = layernorm_backward(dy, x, g, mean, var, impl="plain")
    arms, rtol = FUSED_TOL[dtype]
    assert_within(first[0], ref[0], arms, rtol)
    for a, w in zip(first[1:], ref[1:]):
        assert a.dtype == dtype
        assert_within(a, w, max(arms, 1e-4), rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,keep", [
    ((2, 3, 130, 70), True, None),        # rows that see no key
    ((2, 3, 70, 200), False, (150, 0)),   # a batch row with every key hidden
    ((2, 2, 64, 256), True, (256, 100)),
    ((1, 2, 4, 640), True, None),         # above 512: the chunked loop
    ((2, 3, 33, 257), True, (257, 100)),  # Lk 257: single values, 2 chunks
    ((2, 3, 70, 70), False, (70, 30)),    # Lk 70: single values
    ((2, 2, 6, 1030), True, (1030, 600)),  # above 512, single values
    ((2, 2, 300, 264), True, (264, 0)),   # Lq > Lk, vectors, every key hidden
])
def test_attn_softmax_kernels_match_plain(cuda_device, dtype, shape, causal,
                                          keep):
    """The forward's 16-byte vectors (Lk a multiple of 4 fp32 or 8 bf16
    values) and its single values (70, 257, 1030), rows held in registers
    (Lk <= 512) and read again (640, 1030), the pad mask with and without
    the causal mask, and rows that see no key (Lq > Lk), uniform over the
    TPU's padded width; two forward calls give the same bits."""
    from tpu_flash_torch.kernels.softmax import (TPU_LANES,
                                                 attn_softmax_backward,
                                                 attn_softmax_forward)
    from tpu_flash_torch.kernels.common import round_up

    gen = torch.Generator(cuda_device).manual_seed(7)
    x, dp = (torch.randn(*shape, generator=gen, device=cuda_device).to(dtype)
             for _ in range(2))
    mask = None
    if keep is not None:
        cols = torch.arange(shape[3], device=cuda_device)[None, :]
        kept = torch.tensor(keep, device=cuda_device)[:, None]
        mask = torch.where(cols < kept, 0.0, -1e9)
    before = dict(common.launch_counts)
    p = attn_softmax_forward(x, mask, mask_future=causal)
    ref = attn_softmax_forward(x, mask, mask_future=causal, impl="plain")
    dx = attn_softmax_backward(ref, dp)
    ref_dx = attn_softmax_backward(ref, dp, impl="plain")
    torch.cuda.synchronize()
    for name in ("attn_softmax_fwd", "attn_softmax_bwd"):
        assert common.launch_counts[name] == before.get(name, 0) + 1
    arms, rtol = FUSED_TOL[dtype]
    assert p.dtype == dx.dtype == dtype
    assert_within(p, ref, arms, rtol)
    assert_within(dx, ref_dx, arms, rtol)
    assert torch.equal(p, attn_softmax_forward(x, mask, mask_future=causal))
    Lq, Lk = shape[2], shape[3]
    if causal and Lq > Lk:       # uniform over the TPU's padded width
        uniform = torch.tensor(1 / round_up(Lk, TPU_LANES)).to(dtype)
        assert bool((p[:, :, :Lq - Lk] == uniform).all())


@pytest.mark.cuda
def test_fused_model_step_launches_the_fused_kernels(cuda_device):
    """One fp32 training step of a small fused model: softmax forward and
    backward once a layer, LayerNorm forward and backward twice a layer
    plus the final LN, no flash kernel; the loss equals the plain step's
    to 1e-5."""
    from tpu_flash_torch.apps import machine_translation as tmt

    cfg = tnn.DecoderConfig(n_vocab=64, n_embd=64, n_head=4, n_positions=96,
                            n_layer=2, ff_middle_dim=64, p_dropout=0.0,
                            attention_kind="fused", use_fused_kernel=True)
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, 64, (2, 96)),
             "labels": rng.integers(0, 64, (2, 96)),
             "label_token_weights": np.ones((2, 96), np.float32)}
    losses, counts = {}, {}
    for impl in ("kernel", "plain"):
        model = tnn.DecoderLM(cfg, device=cuda_device)
        tnn.init_params(model, torch.Generator(cuda_device).manual_seed(0))
        opt = tnn.adam()
        step = tmt.make_train_step(model, opt, impl=impl)
        before = dict(common.launch_counts)
        _, loss = step(opt.init(dict(model.named_parameters())),
                       tmt.place_batch(batch, cuda_device))
        losses[impl] = float(loss)
        counts[impl] = {n: common.launch_counts[n] - before.get(n, 0)
                        for n in common.launch_counts}
    assert counts["kernel"] == {
        "attn_softmax_fwd": 2, "attn_softmax_bwd": 2, "layernorm_fwd": 5,
        "layernorm_bwd": 5, **{n: 0 for n in counts["kernel"]
                               if not n.startswith(("attn_", "layernorm"))}}
    assert not any(counts["plain"].values())
    np.testing.assert_allclose(losses["kernel"], losses["plain"], rtol=1e-5)


# --- weight-only quantized matmul kernels ----------------------------------
#
# Kernel against plain on the same inputs, |got - want| <= arms * rms(want)
# + rtol * |want|.  fp32 with TF32 off: the same products summed in another
# order (1e-5, 1e-5).  bf16: out may round to the neighbouring bf16 (rtol
# 2e-2 covers two ulps) on top of 1e-2 of the rms (chip_smoke.py's limits).
# The shapes cover ragged M, N and K (odd K for int4), N not a multiple of
# 16 (the kernels' byte-wise loads), both block shapes (M <= 8 and above)
# and split code rows (small N over a long K); bf16 x at M <= 8 runs the
# tensor-core decode form where 16 divides the group and N, else the
# CUDA-core decode kernel (the groups of 24 and 8 at M 1 and 8, and N 300);
# fp32 x above M = 8 runs the fp32 tensor-core form (``_x3``) per column and
# for groups that are a multiple of 16, the CUDA-core form for the rest; at
# M <= 8 the fp32 tensor-core decode form (``_dec_x3``) per column and for
# groups that are a multiple of 16 where 16 divides N, up to 8 x 1024 code
# rows, the CUDA-core decode kernel for the rest.

QUANT_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}
QUANT_SHAPES = [(1, 255, 300), (8, 1024, 384), (37, 513, 200),
                (100, 96, 130), (260, 128, 64), (8, 4096, 16)]
GROUP_SHAPES = [(1, 256, 300, 64), (8, 1024, 384, 128), (37, 512, 200, 32),
                (100, 96, 130, 16), (260, 192, 64, 32), (8, 4096, 16, 128),
                (1, 240, 304, 24), (8, 240, 304, 24), (1, 256, 256, 8),
                (8, 1024, 384, 8)]


def quant_case(gen, dev, kind, M, K, N, g, dtype):
    from tpu_flash_torch.kernels import quant

    x = torch.randn(M, K, generator=gen, device=dev).to(dtype)
    w = torch.randn(K, N, generator=gen, device=dev)
    if kind == "int8_matmul":
        codes, scales = quant.quantize_weight(w)
        return lambda impl=None: quant.int8_matmul(x, codes, scales,
                                                   impl=impl)
    packed, scales, _ = quant.quantize_weight_int4(
        w, group_size=g, allow_small_groups=True)
    return lambda impl=None: quant.int4_matmul(x, packed, scales, k_dim=K,
                                               impl=impl)


def form_name(kind, M, K, N, g, dtype):
    """The launch count a call adds to: the tensor-core forms' (groups a
    multiple of 16; at M <= 8 where 16 divides N too and the code rows, K
    or int4's ceil(K / 2), are at most 8 x 2048 for bf16 x (``_dec``) or
    8 x 1024 for fp32 x (``_dec_x3``); above M = 8 bf16 x ``_tc``, fp32 x
    ``_x3``) or the CUDA-core forms'."""
    if g is not None and g % 16:
        return kind
    if M > 8:
        return kind + (common.TC if dtype == torch.bfloat16 else common.X3)
    rows = K if kind == "int8_matmul" else (K + 1) // 2
    if N % 16 or rows > 8 * (2048 if dtype == torch.bfloat16 else 1024):
        return kind
    return kind + (common.DEC if dtype == torch.bfloat16 else common.DEC_X3)


def check_quant_case(dev, dtype, kind, M, K, N, g):
    """A CUDA tensor with impl=None launches the kernel of its form (that
    count rises by one, no other) and agrees with the plain version."""
    gen = torch.Generator(dev).manual_seed(8)
    call = quant_case(gen, dev, kind, M, K, N, g, dtype)
    before = dict(common.launch_counts)
    got = call()
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    assert launched == {form_name(kind, M, K, N, g, dtype): 1}
    want = call("plain")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == (M, N)
    assert_within(got, want, *QUANT_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,M,K,N,g", [
    *(("int8_matmul", *s, None) for s in QUANT_SHAPES),
    *(("int4_matmul", *s, None) for s in QUANT_SHAPES),
    *(("int4_matmul_group", *s) for s in GROUP_SHAPES)])
def test_quant_matmul_kernels_match_plain(cuda_device, dtype, kind, M, K, N,
                                          g):
    check_quant_case(cuda_device, dtype, kind, M, K, N, g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [9, 100, 256, 1024])
@pytest.mark.parametrize("kind,K,N,g", [
    ("int8_matmul", 1024, 4096, None), ("int8_matmul", 255, 300, None),
    ("int4_matmul", 1024, 4096, None), ("int4_matmul", 255, 300, None),
    ("int4_matmul_group", 1024, 4096, 128),
    ("int4_matmul_group", 1024, 4096, 64),
    ("int4_matmul_group", 256, 300, 64)])
def test_prefill_forms_match_plain(cuda_device, dtype, M, kind, K, N, g):
    """The prefill forms: bf16 x takes the tensor-core form, fp32 x the
    fp32 tensor-core form, at the serving model's K1024 N4096 and at ragged
    K and N (odd K for int4 per column: x by single values)."""
    check_quant_case(cuda_device, dtype, kind, M, K, N, g)


X3_CASES = [("int8_matmul", None), ("int4_matmul", None),
            ("int4_matmul_group", 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g", X3_CASES)
@pytest.mark.parametrize("M,K,N", [(1024, 1024, 4096), (37, 768, 200),
                                   (256, 4096, 1024)])
def test_x3_form_repeats_its_bits(cuda_device, kind, g, M, K, N):
    """Two calls of the fp32 tensor-core form on the same inputs give the
    same bits (a fixed order of sums, no atomics; K4096 N1024 at M256
    splits the code rows)."""
    gen = torch.Generator(cuda_device).manual_seed(12)
    call = quant_case(gen, cuda_device, kind, M, K, N, g, torch.float32)
    before = common.launch_counts[kind + common.X3]
    first, second = call(), call()
    torch.cuda.synchronize()
    assert common.launch_counts[kind + common.X3] == before + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8_matmul", "int4_matmul"])
@pytest.mark.parametrize("M", [100, 256])
def test_x3_form_repeats_its_bits_at_an_odd_k(cuda_device, kind, M):
    """The same at K 255, N 300 (per column only: x by single values,
    int4's last packed row holding the zero code in its high nibble; codes
    by single bytes)."""
    gen = torch.Generator(cuda_device).manual_seed(14)
    call = quant_case(gen, cuda_device, kind, M, 255, 300, None,
                      torch.float32)
    before = common.launch_counts[kind + common.X3]
    first, second = call(), call()
    torch.cuda.synchronize()
    assert common.launch_counts[kind + common.X3] == before + 2
    assert torch.equal(first, second)
    assert_within(first, call("plain"), *QUANT_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g", X3_CASES)
def test_x3_form_error_against_float64(cuda_device, kind, g):
    """At M1024 K4096 N1024 the fp32 tensor-core form's largest error
    against the float64 product of the same x and weights is at most twice
    the plain fp32 version's (its products are summed apart a 64-row step,
    grouped 16 rows, at a time and added rounded to nearest: the tensor
    cores' own sums truncate)."""
    from tpu_flash_torch.kernels import quant

    gen = torch.Generator(cuda_device).manual_seed(13)
    M, K, N = 1024, 4096, 1024
    x = torch.randn(M, K, generator=gen, device=cuda_device)
    w = torch.randn(K, N, generator=gen, device=cuda_device)
    if kind == "int8_matmul":
        q = quant.quantize_weight(w)
        codes, scales = q
    else:
        packed, scales, _ = quant.quantize_weight_int4(w, group_size=g)
        codes = quant.unpack_int4(packed, K)
        q = (packed, scales)
    exact = x.double() @ quant.dequantize(codes, scales, K).double()
    if kind == "int8_matmul":
        got, plain = (quant.int8_matmul(x, *q, impl=impl)
                      for impl in ("kernel", "plain"))
    else:
        got, plain = (quant.int4_matmul(x, *q, k_dim=K, impl=impl)
                      for impl in ("kernel", "plain"))
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)


# The tensor-core decode form (bf16 x, M <= 8): every serving linear of the
# 176M model at M 1 and 8, every M from 1 to 8 at the projections' shape,
# and ragged N and K (N 304 ends in a ragged tile, K 255 odd for int4 per
# column; grouped K 256 in groups of 64), groups of 64 and 128.  N 300, not
# a multiple of 16, takes the CUDA-core decode kernel, with the same checks.
SERVING_LINEARS = ((1024, 1024), (1024, 4096), (4096, 1024), (1024, 32768))
DECODE_KINDS = (("int8_matmul", None), ("int4_matmul", None),
                ("int4_matmul_group", 128))
DECODE_CASES = [
    *((kind, M, K, N, g) for kind, g in DECODE_KINDS
      for K, N in SERVING_LINEARS for M in (1, 8)),
    *((kind, M, 1024, 1024, g) for kind, g in DECODE_KINDS
      for M in range(2, 8)),
    *((kind, M, K, N, g) for kind, K, g in (
        ("int8_matmul", 255, None), ("int4_matmul", 255, None),
        ("int4_matmul_group", 256, 64)) for M in (1, 5, 8)
      for N in (304, 300)),
    *(("int4_matmul_group", M, 1024, 4096, 64) for M in (1, 8)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,M,K,N,g", DECODE_CASES)
def test_decode_form_matches_plain_and_repeats_its_bits(cuda_device, kind, M,
                                                        K, N, g):
    """Each call launches its decode form once (the tensor-core one
    counted under ``_dec``); two calls give the same bits; the values agree
    with the plain version under the bf16 limits of QUANT_TOL."""
    gen = torch.Generator(cuda_device).manual_seed(10)
    call = quant_case(gen, cuda_device, kind, M, K, N, g, torch.bfloat16)
    before = dict(common.launch_counts)
    got, again = call(), call()
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    assert launched == {form_name(kind, M, K, N, g, torch.bfloat16): 2}
    want = call("plain")
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, again)
    assert_within(got, want, *QUANT_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g", DECODE_KINDS)
def test_decode_form_runs_one_kernel_a_call(cuda_device, kind, g):
    """Under the profiler three decode calls at K1024 N4096 (a cluster of
    4) run exactly three kernels, all the decode form's: no reduction
    kernel and no workspace fill."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(cuda_device).manual_seed(11)
    call = quant_case(gen, cuda_device, kind, 8, 1024, 4096, g,
                      torch.bfloat16)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 3, [e.key for e in kernels]
    assert all("_dec_kernel" in e.key for e in kernels)


# The fp32-x decode form (``_dec_x3``: int8, int4 per column and int4 in
# groups that are a multiple of 16): the same shapes as the bf16 decode
# form's, at fp32 x (K 255 odd for int4 per column: x by single values, its
# column K read as 0).


@pytest.mark.cuda
@pytest.mark.parametrize("kind,M,K,N,g", DECODE_CASES)
def test_fp32_decode_form_matches_plain_and_repeats_its_bits(cuda_device,
                                                             kind, M, K, N,
                                                             g):
    """Each fp32 call launches its decode form once (the tensor-core one
    counted under ``_dec_x3``, N 300 the CUDA-core one); two calls give the
    same bits (the cluster's partials are added in rank order); the values
    agree with the plain version under the fp32 limits of QUANT_TOL."""
    gen = torch.Generator(cuda_device).manual_seed(15)
    call = quant_case(gen, cuda_device, kind, M, K, N, g, torch.float32)
    before = dict(common.launch_counts)
    got, again = call(), call()
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    assert launched == {form_name(kind, M, K, N, g, torch.float32): 2}
    want = call("plain")
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, again)
    assert_within(got, want, *QUANT_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g", DECODE_KINDS)
@pytest.mark.parametrize("K,N", SERVING_LINEARS)
def test_fp32_decode_form_runs_one_kernel_a_call(cuda_device, kind, g, K,
                                                 N):
    """Under the profiler three fp32 decode calls at each serving linear
    run exactly three kernels, all the fp32 decode form's: no reduction
    kernel and no workspace fill."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(cuda_device).manual_seed(16)
    call = quant_case(gen, cuda_device, kind, 8, K, N, g, torch.float32)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum(e.count for e in kernels) == 3, [e.key for e in kernels]
    assert all("_dec_x3_kernel" in e.key for e in kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g", DECODE_KINDS)
@pytest.mark.parametrize("M", [1, 8])
def test_fp32_decode_form_error_against_float64(cuda_device, kind, g, M):
    """At K4096 N1024 the fp32 decode form's largest error against the
    float64 product of the same x and weights is at most twice the plain
    fp32 version's."""
    from tpu_flash_torch.kernels import quant

    gen = torch.Generator(cuda_device).manual_seed(17)
    K, N = 4096, 1024
    x = torch.randn(M, K, generator=gen, device=cuda_device)
    w = torch.randn(K, N, generator=gen, device=cuda_device)
    if kind == "int8_matmul":
        q = quant.quantize_weight(w)
        codes = q[0]
        got, plain = (quant.int8_matmul(x, *q, impl=impl)
                      for impl in ("kernel", "plain"))
    else:
        q = quant.quantize_weight_int4(w, group_size=g)[:2]
        codes = quant.unpack_int4(q[0], K)
        got, plain = (quant.int4_matmul(x, *q, k_dim=K, impl=impl)
                      for impl in ("kernel", "plain"))
    exact = x.double() @ quant.dequantize(codes, q[1], K).double()
    torch.cuda.synchronize()
    err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)


@pytest.mark.cuda
def test_per_column_int4_takes_the_fp32_decode_form_and_bf16_x_is_refused(
        cuda_device, monkeypatch):
    """int4 per column at fp32 x and M 8 launches its fp32 decode kernel
    once, counted under ``int4_matmul_dec_x3``, and agrees with the plain
    version; bf16 x has no kernel of form 5: a plan for one raises and
    counts nothing (no fallback)."""
    from tpu_flash_torch.kernels import quant

    x = torch.randn(8, 256, device=cuda_device)
    w = torch.randn(256, 64, device=cuda_device)
    packed, scales, _ = quant.quantize_weight_int4(w)
    codes, scales8 = quant.quantize_weight(w)
    before = dict(common.launch_counts)
    got = quant.int4_matmul(x, packed, scales, k_dim=256)
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    assert launched == {"int4_matmul_dec_x3": 1}
    assert_within(got, quant.int4_matmul(x, packed, scales, k_dim=256,
                                         impl="plain"),
                  *QUANT_TOL[torch.float32])
    plan = quant._plan
    monkeypatch.setattr(quant, "_plan", lambda M, N, rows, sms, dtype, group:
                        plan(M, N, rows, sms, torch.float32, group))
    assert quant._plan(8, 64, 256, 132, torch.bfloat16,
                       None).form == "decode_tc_x3"
    before = dict(common.launch_counts)
    with pytest.raises(RuntimeError,
                       match="int8_matmul_dec_x3 kernel failed"):
        quant.int8_matmul(x.to(torch.bfloat16), codes, scales8)
    torch.cuda.synchronize()
    assert dict(common.launch_counts) == before


# Past the decode forms' cap of code rows (8 x 1024 for fp32 x: int8 at
# K8320, int4 per column at K16400, 8,200 packed rows, grouped at K16640;
# 8 x 2048 for bf16 x: int8 at K16400) a call at M <= 8 takes the CUDA-core
# decode kernel (``_m8``) with its reduction, counted under the bare name.
OVER_CAP_CASES = [("int8_matmul", 8320, None, torch.float32),
                  ("int4_matmul", 16400, None, torch.float32),
                  ("int4_matmul_group", 16640, 128, torch.float32),
                  ("int8_matmul", 16400, None, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,K,g,dtype", OVER_CAP_CASES)
@pytest.mark.parametrize("M", [1, 8])
def test_decode_above_the_row_cap_takes_the_cuda_core_form(cuda_device,
                                                           kind, K, g, dtype,
                                                           M):
    """Each such call launches the CUDA-core decode form once and agrees
    with the plain version under QUANT_TOL."""
    assert form_name(kind, M, K, 1024, g, dtype) == kind
    check_quant_case(cuda_device, dtype, kind, M, K, 1024, g)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,g", [(8, None), (4, None), (4, 32)])
def test_quantized_linears_train_x_through_the_kernels(cuda_device, bits, g):
    """int8_linear / int4_linear on CUDA tensors, fp32 x of 15 rows: the
    forward launches its kernel's fp32 tensor-core form; dx of the
    per-column forms launches the int8 kernel's fp32 tensor-core form on
    the transposed codes, the grouped form's a dense matmul; values and dx
    agree with the plain route."""
    from tpu_flash_torch.kernels import quant

    gen = torch.Generator(cuda_device).manual_seed(9)
    x = torch.randn(3, 5, 128, generator=gen, device=cuda_device)
    w = torch.randn(128, 96, generator=gen, device=cuda_device)
    b = torch.randn(96, generator=gen, device=cuda_device)
    if bits == 8:
        qw = quant.QuantizedLinearWeights(*quant.quantize_weight(w), b)
        fn, kind = quant.int8_linear, "int8_matmul"
    else:
        packed, scales, k = quant.quantize_weight_int4(
            w, group_size=g, allow_small_groups=True)
        qw = quant.QuantizedLinearWeights4(packed, scales, k, b)
        fn = quant.int4_linear
        kind = "int4_matmul_group" if g else "int4_matmul"
    outs = {}
    for impl in (None, "plain"):
        leaf = x.clone().requires_grad_()
        before = dict(common.launch_counts)
        out = fn(leaf, qw, impl=impl)
        (dx,) = torch.autograd.grad((out ** 2).sum(), leaf)
        launched = {n: common.launch_counts[n] - before.get(n, 0)
                    for n in common.launch_counts}
        outs[impl] = (out, dx, {n: c for n, c in launched.items() if c})
    x3 = "int8_matmul" + common.X3
    want = ({kind + common.X3: 1} if g else {x3: 2} if bits == 8
            else {kind + common.X3: 1, x3: 1})
    assert outs[None][2] == want and not outs["plain"][2]
    for a, b in zip(outs[None][:2], outs["plain"][:2]):
        assert_within(a.detach(), b.detach(), 1e-5, 1e-5)


@pytest.mark.cuda
def test_quant_kernel_that_fails_to_launch_raises(cuda_device, monkeypatch):
    """A grid the card refuses (65,536 or more blocks along z) is reported
    by the C entry and raised by the wrapper; nothing is counted."""
    from tpu_flash_torch.kernels import quant

    x = torch.randn(1, 128, device=cuda_device)
    codes, scales = quant.quantize_weight(torch.randn(128, 16,
                                                      device=cuda_device))
    monkeypatch.setattr(quant, "_plan", lambda *a: quant.Plan(
        "decode", 8, 128, 70_000, 128, 70_000))
    before = common.launch_counts["int8_matmul"]
    with pytest.raises(RuntimeError, match="int8_matmul kernel failed"):
        quant.int8_matmul(x, codes, scales)
    assert common.launch_counts["int8_matmul"] == before
    with pytest.raises(TypeError, match="int8"):
        quant.int8_matmul(x, codes.to(torch.int16), scales)


@pytest.mark.cuda
def test_quant_x3_kernel_that_fails_to_launch_raises(cuda_device,
                                                     monkeypatch):
    """The fp32 tensor-core form raises as the other forms do, for a grid
    the card refuses and for a plan its C entry refuses (the form for bf16
    x), and counts nothing: no call falls back to the CUDA-core form or to
    the plain version."""
    from tpu_flash_torch.kernels import quant

    x = torch.randn(16, 128, device=cuda_device)
    w = torch.randn(128, 16, device=cuda_device)
    codes, scales = quant.quantize_weight(w)
    packed, scales4, _ = quant.quantize_weight_int4(w)
    before = dict(common.launch_counts)
    monkeypatch.setattr(quant, "_plan", lambda *a: quant.Plan(
        "tensor_core_x3", 128, 128, 70_000, 64, 70_000))
    with pytest.raises(RuntimeError, match="int8_matmul_x3 kernel failed"):
        quant.int8_matmul(x, codes, scales)
    monkeypatch.setattr(quant, "_plan", lambda *a: quant.Plan(
        "tensor_core_x3", 128, 128, 1, 64, 1))
    with pytest.raises(RuntimeError, match="int4_matmul_x3 kernel failed"):
        quant.int4_matmul(x.to(torch.bfloat16), packed, scales4, k_dim=128)
    torch.cuda.synchronize()
    assert dict(common.launch_counts) == before


@pytest.mark.cuda
def test_int8_entry_refuses_the_cuda_core_prefill_form(cuda_device,
                                                       monkeypatch):
    """int8 has no CUDA-core prefill kernel (the tensor-core forms take
    every M > 8): a plan for one raises and counts nothing."""
    from tpu_flash_torch.kernels import quant

    x = torch.randn(16, 128, device=cuda_device)
    codes, scales = quant.quantize_weight(
        torch.randn(128, 16, device=cuda_device))
    before = dict(common.launch_counts)
    monkeypatch.setattr(quant, "_plan", lambda *a: quant.Plan(
        "cuda_core", 64, 128, 1, 128, 1))
    with pytest.raises(RuntimeError, match="int8_matmul kernel failed"):
        quant.int8_matmul(x, codes, scales)
    torch.cuda.synchronize()
    assert dict(common.launch_counts) == before


@pytest.mark.cuda
def test_int4_entry_refuses_the_cuda_core_prefill_form(cuda_device,
                                                       monkeypatch):
    """Per-column int4 has no CUDA-core prefill kernel either (the
    tensor-core forms take every M > 8): a plan for one raises and counts
    nothing; groups that are not a multiple of 16 keep theirs."""
    from tpu_flash_torch.kernels import quant

    x = torch.randn(16, 128, device=cuda_device)
    w = torch.randn(128, 16, device=cuda_device)
    packed, scales, _ = quant.quantize_weight_int4(w)
    before = dict(common.launch_counts)
    monkeypatch.setattr(quant, "_plan", lambda *a: quant.Plan(
        "cuda_core", 64, 128, 1, 64, 1))
    with pytest.raises(RuntimeError, match="int4_matmul kernel failed"):
        quant.int4_matmul(x, packed, scales, k_dim=128)
    torch.cuda.synchronize()
    assert dict(common.launch_counts) == before
    packed, scales, _ = quant.quantize_weight_int4(
        w, group_size=8, allow_small_groups=True)
    got = quant.int4_matmul(x, packed, scales, k_dim=128)
    assert common.launch_counts["int4_matmul_group"] == before.get(
        "int4_matmul_group", 0) + 1
    assert_within(got, quant.int4_matmul(x, packed, scales, k_dim=128,
                                         impl="plain"),
                  *QUANT_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,g", [(8, None), (4, None), (4, 32)])
def test_quantized_decode_step_kernel_matches_plain(cuda_device, bits, g):
    """One decode step of a small fp32 quantized DecoderLM: the matmul
    kernel launches once a Linear (6 a layer and lm_head) in its fp32
    decode form (``_dec_x3``) and the logits agree with the plain
    path's."""
    cfg = tnn.DecoderConfig(n_vocab=128, n_embd=64, n_head=4, n_positions=64,
                            n_layer=2, ff_middle_dim=128, p_dropout=0.0,
                            attention_kind="naive")
    model = tnn.DecoderLM(cfg, device=cuda_device)
    tnn.init_params(model, torch.Generator(cuda_device).manual_seed(2))
    tnn.quantize_model_linears(model, bits=bits, group_size=g,
                               allow_small_groups=True)
    kind = form_name("int8_matmul" if bits == 8 else
                     "int4_matmul_group" if g else "int4_matmul", 3, 64, 64,
                     g, torch.float32)
    ids = torch.randint(0, 128, (3, 20), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(3))
    logits = {}
    for impl in ("kernel", "plain"):
        caches = make_caches(model, 3, 32, quant="int8")
        with torch.no_grad():
            model(ids, kv_caches=caches, impl=impl)
            before = common.launch_counts[kind]
            out, _ = model(ids[:, -1:], kv_caches=caches,
                           positions=caches[0].lengths[:, None].long(),
                           impl=impl)
        launched = common.launch_counts[kind] - before
        assert launched == (6 * cfg.n_layer + 1 if impl == "kernel" else 0)
        logits[impl] = out
    torch.testing.assert_close(logits["kernel"], logits["plain"], atol=1e-4,
                               rtol=1e-4)


# --- sliding windows and packed segments: the masked forms ---------------


def packed_segments(B, L, seed, dev):
    """Segment ids [B, L] as a packed batch gives them: runs of 1 to 40
    positions (length-1 runs among them), then a pad-tail segment of its
    own id in every row but the last (which ends with a length-1 run)."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        ids, sid = [], 0
        tail = 0 if b == B - 1 else int(rng.integers(1, L // 4))
        while len(ids) < L - tail:
            n = 1 if rng.random() < 0.2 else int(rng.integers(2, 41))
            ids += [sid] * min(n, L - tail - len(ids))
            sid += 1
        if b == B - 1:
            ids[-1] = sid
        rows.append(ids + [sid + 1] * tail)
    return torch.tensor(rows, dtype=torch.int32, device=dev)


# name, B, H, Hkv, Lq, Lk, d, window, segments: chip_smoke.py's MASK_CASES
# (windows of one key, just under, at and off a 64-key tile, past L; Lq <
# Lk; GQA; ragged L; each head dim; packed segments alone and under a
# window)
MASK_CASES = [
    ("w1", 2, 8, 8, 1000, 1000, 64, 1, False),
    ("w63", 2, 8, 8, 1000, 1000, 64, 63, False),
    ("w64", 2, 8, 8, 1024, 1024, 64, 64, False),
    ("w100-ragged-L1000", 2, 8, 8, 1000, 1000, 64, 100, False),
    ("w256-L2048", 2, 8, 8, 2048, 2048, 64, 256, False),
    ("w-ge-L", 2, 8, 8, 512, 512, 64, 4096, False),
    ("lq-lt-lk-300x700-w100", 2, 8, 8, 300, 700, 64, 100, False),
    ("gqa-8q2kv-w128", 2, 8, 2, 512, 512, 64, 128, False),
    ("d16-w50", 2, 8, 8, 300, 300, 16, 50, False),
    ("d32-w100", 2, 8, 8, 512, 512, 32, 100, False),
    ("d128-w100", 2, 8, 8, 512, 512, 128, 100, False),
    ("seg-L1024", 2, 8, 8, 1024, 1024, 64, None, True),
    ("seg-gqa-d128", 2, 8, 2, 512, 512, 128, None, True),
    ("seg-d32-ragged", 2, 8, 8, 333, 333, 32, None, True),
    ("seg-w100", 2, 8, 8, 1024, 1024, 64, 100, True),
]


def masked_names(dtype, kernels):
    from tpu_flash_torch.kernels import flash_attention as fa

    return {fa._form_name(n, dtype, True): 1 for n in kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,B,H,Hkv,Lq,Lk,d,window,segmented",
                         MASK_CASES)
def test_masked_forms_match_plain(cuda_device, dtype, name, B, H, Hkv, Lq,
                                  Lk, d, window, segmented):
    """Each flash kernel's masked form (forward, fused backward, dK/dV and
    dQ passes) under a window, segments or both, against its plain version:
    bf16 out and gradients within BF16_ARMS, lse within 1e-4 of
    ``stepped_lse`` under the same masks; fp32 within FA_TOL (the two
    passes at 1e-3).  Each call launches its masked form once and nothing
    else; a window at or beyond L gives the unmasked causal form's bits."""
    from tpu_flash_torch.kernels import flash_attention as fa
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_dkv_plain, flash_attention_backward_dq_plain,
        flash_attention_backward_fused, flash_attention_backward_two_pass,
        flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(21)
    q, k, v, do = attention_case(gen, cuda_device, B, H, Hkv, Lq, Lk, d,
                                 dtype)
    seg = packed_segments(B, Lq, 5, cuda_device) if segmented else None
    kw = dict(causal=True, window=window, segment_ids=seg)
    before = dict(common.launch_counts)
    out, lse, m = flash_attention_forward(q, k, v, with_m=True, **kw)
    fused = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
    two = flash_attention_backward_two_pass(q, k, v, out, lse, do, **kw)
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    want = flash_attention_forward(q, k, v, with_m=True, impl="plain", **kw)
    ref = flash_attention_backward_fused(q, k, v, out, lse, do, impl="plain",
                                         **kw)
    ref_dk, ref_dv = flash_attention_backward_dkv_plain(q, k, v, out, lse,
                                                        do, **kw)
    ref_dq = flash_attention_backward_dq_plain(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert launched == masked_names(dtype, (fa.KERNEL_FWD, fa.KERNEL_BWD,
                                            fa.KERNEL_DKV, fa.KERNEL_DQ))
    fw_tol, bw_tol = FA_TOL[dtype]
    if dtype == torch.bfloat16:
        # a row of a short segment sees a few keys, so one bf16 P landing
        # an ulp the other side of a rounding boundary (the scores' sums
        # run in another order) moves its lse by up to ~5e-4: chip_smoke.py's
        # ATTN_TOL limit for lse, 1e-3
        torch.testing.assert_close(
            lse, stepped_lse(q, k, True, None, window, seg), atol=1e-3,
            rtol=1e-3)
        torch.testing.assert_close(m, want[2], atol=1e-4, rtol=1e-4)
        named = zip(("out", "dq", "dk", "dv", "dq", "dk", "dv"),
                    (out, *fused, *two),
                    (want[0], *ref, ref_dq, ref_dk, ref_dv))
        for name, a, b in named:
            assert a.dtype == b.dtype == dtype and a.shape == b.shape
            if window == 1 and name in ("dq", "dk"):
                # a row sees only its own key: P = 1, dS = P (dP - D) is 0
                # exactly, and both hold the noise of fp32 sums over d
                torch.testing.assert_close(a.float(), b.float(), atol=1e-4,
                                           rtol=0)
            else:
                assert_close_bf16(a, b)
    else:
        for a, b in zip((out, lse, m), want):
            torch.testing.assert_close(a, b, atol=fw_tol, rtol=fw_tol)
        for a, b in zip(fused, ref):
            torch.testing.assert_close(a, b, atol=bw_tol, rtol=bw_tol)
        for a, b in zip(two, (ref_dq, ref_dk, ref_dv)):
            torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
    if window is not None and window >= Lk and not segmented:
        unmasked = flash_attention_forward(q, k, v, causal=True,
                                           with_m=True)
        for a, b in zip((out, lse, m), unmasked):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,d,window,segmented", [
    (4, 8, 8, 2048, 64, 256, False),    # the timed windowed shape
    (2, 8, 2, 1000, 128, 100, False),   # d 128: 32-row fp32 chunks
    (1, 4, 4, 700, 32, 1, False),       # the narrowest band
    (2, 4, 2, 513, 64, 200, True),      # with segments
    (2, 4, 2, 400, 16, None, True)])
def test_masked_fused_backward_gives_the_same_bits(cuda_device, dtype, B, H,
                                                   Hkv, L, d, window,
                                                   segmented):
    """Under a window each key tile waits at a query chunk only for the key
    tiles below it whose band reaches the chunk: the adds stay in key-tile
    order (two calls give the same bits) and every wait is met (the launch
    ends, no trap)."""
    from tpu_flash_torch.kernels import flash_attention as fa
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused, flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(22)
    q, k, v, do = attention_case(gen, cuda_device, B, H, Hkv, L, L, d, dtype)
    seg = packed_segments(B, L, 6, cuda_device) if segmented else None
    kw = dict(causal=True, window=window, segment_ids=seg)
    out, lse, _ = flash_attention_forward(q, k, v, **kw)
    name = fa._form_name(fa.KERNEL_BWD, dtype, True)
    before = common.launch_counts[name]
    first = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
    second = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert common.launch_counts[name] == before + 2
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
def test_masked_kernels_refuse_a_window_without_causal(cuda_device):
    """The C entries refuse what the wrapper would have refused: a window
    without causal, segments with Lq != Lk."""
    from tpu_flash_torch.kernels import flash_attention as fa

    gen = torch.Generator(cuda_device).manual_seed(23)
    q, k, v, _ = attention_case(gen, cuda_device, 1, 2, 2, 64, 64, 64,
                                torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa._launch_forward(q, k, v, False, None, None, False, 8)
    q2 = q[:, :, :32].contiguous()
    seg = torch.zeros(1, 64, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa._launch_forward(q2, k, v, True, None, None, False, None, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("R,H", [(8192, 256), (8192, 512), (1000, 1024),
                                 (37, 32), (300, 100), (77, 200), (50, 4096),
                                 (65, 70), (40, 1030), (3000, 264)])
def test_layernorm_forward_forms_match_plain(cuda_device, xdt, gdt, R, H):
    """Every form of the LayerNorm forward's plan: held rows in 16-byte
    (and, bf16 at H % 8 != 0, 8-byte) vectors with one or two rows a warp
    at once, ragged H inside a vector's lanes, and the looped form (H % 4
    != 0, H > 1024), with x and gamma of either dtype; R beyond one wave
    of the grid (3000 x 264) has warps walk rows with the next pass's loads
    in flight.  Within FUSED_TOL of the plain version; one launch a call."""
    from tpu_flash_torch.kernels.layernorm import layernorm_forward

    gen = torch.Generator(cuda_device).manual_seed(24)
    x = (3 * torch.randn(R, H, generator=gen, device=cuda_device) + 1
         ).to(xdt)
    g, b = (torch.randn(H, generator=gen, device=cuda_device).to(gdt)
            for _ in range(2))
    before = common.launch_counts["layernorm_fwd"]
    y, mean, var = layernorm_forward(x, g, b)
    ref = layernorm_forward(x, g, b, impl="plain")
    torch.cuda.synchronize()
    assert common.launch_counts["layernorm_fwd"] == before + 1
    arms, rtol = FUSED_TOL[xdt]
    assert y.dtype == xdt
    assert_within(y, ref[0], arms, rtol)
    for a, w in zip((mean, var), ref[1:]):
        assert_within(a, w, *FUSED_TOL[torch.float32])


# --- attention dropout: the dropout forms ------------------------------------


def dropout_names(dtype, masked, kernels):
    from tpu_flash_torch.kernels import flash_attention as fa

    return {fa._form_name(n, dtype, masked, True): 1 for n in kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("mask", [None, "window", "segments"])
def test_dropout_forms_match_plain(cuda_device, dtype, d, mask):
    """Each flash kernel's dropout form (forward, fused backward, dK/dV and
    dQ passes; unmasked, and masked under a window or packed segments) at
    rate 0.1 against its plain version with the same seed, at each head dim
    (GQA 4:2, a ragged L): bf16 out and gradients within BF16_ARMS, lse at
    1e-4 (under dropout the normaliser sums the fp32 P in both); fp32
    within FA_TOL (the two passes at 1e-3).  Each call launches its dropout
    form once and nothing else."""
    from tpu_flash_torch.kernels import flash_attention as fa
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_dkv_plain, flash_attention_backward_dq_plain,
        flash_attention_backward_fused, flash_attention_backward_two_pass,
        flash_attention_forward)

    B, H, Hkv, L = 2, 4, 2, 300
    gen = torch.Generator(cuda_device).manual_seed(31)
    q, k, v, do = attention_case(gen, cuda_device, B, H, Hkv, L, L, d, dtype)
    seed = torch.tensor([-1234567, 1, 2], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(causal=mask is not None or d != 32, dropout_rate=0.1,
              dropout_seed=seed,
              window=77 if mask == "window" else None,
              segment_ids=(packed_segments(B, L, 7, cuda_device)
                           if mask == "segments" else None))
    before = dict(common.launch_counts)
    out, lse, _ = flash_attention_forward(q, k, v, **kw)
    fused = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
    two = flash_attention_backward_two_pass(q, k, v, out, lse, do, **kw)
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    want = flash_attention_forward(q, k, v, impl="plain", **kw)
    ref = flash_attention_backward_fused(q, k, v, out, lse, do, impl="plain",
                                         **kw)
    ref_dk, ref_dv = flash_attention_backward_dkv_plain(
        q, k, v, out, lse, do, causal=kw["causal"], window=kw["window"],
        segment_ids=kw["segment_ids"], drop=fa.check_dropout(q, 0.1, seed))
    ref_dq = flash_attention_backward_dq_plain(
        q, k, v, out, lse, do, causal=kw["causal"], window=kw["window"],
        segment_ids=kw["segment_ids"], drop=fa.check_dropout(q, 0.1, seed))
    torch.cuda.synchronize()
    assert launched == dropout_names(dtype, mask is not None,
                                     (fa.KERNEL_FWD, fa.KERNEL_BWD,
                                      fa.KERNEL_DKV, fa.KERNEL_DQ))
    torch.testing.assert_close(lse, want[1], atol=1e-4, rtol=1e-4)
    named = list(zip((out, *fused, *two),
                     (want[0], *ref, ref_dq, ref_dk, ref_dv)))
    if dtype == torch.bfloat16:
        for a, b in named:
            assert a.dtype == b.dtype == dtype and a.shape == b.shape
            assert_close_bf16(a, b)
    else:
        fw_tol, bw_tol = FA_TOL[dtype]
        for i, (a, b) in enumerate(named):
            tol = fw_tol if i == 0 else bw_tol if i < 4 else 1e-3
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)


def probe_bits(dtype, dev, seed, rate, B=2, H=4, d=64, window=None):
    """The keep bits each flash kernel applied, read back exactly, beside
    the hash's (``mask_probe`` of chip_smoke.py): with q = 0 and K = I
    (Lk = d) every score is 0 and P uniform, so the forward's out with
    V = I is ``P keep / (1 - rate)``; with V = 1, dO = I (Lq = d), O = 0
    (D = 0) and lse = log(d), dV is ``(P keep / (1 - rate))^T`` and dQ
    ``scale P keep / (1 - rate)``, in the fused backward and the two
    passes.  Returns {output: its bits} and the hash's bits [B, H, d, d]."""
    from tpu_flash_torch.kernels import flash_attention as fa

    eye = torch.eye(d, device=dev).expand(B, H, d, d).to(dtype)
    zero = torch.zeros(B, H, d, d, device=dev, dtype=dtype)
    kw = dict(causal=window is not None, window=window, dropout_rate=rate,
              dropout_seed=seed)
    out, lse, _ = fa.flash_attention_forward(zero, eye, eye, **kw)
    lse = torch.full((B, H, d), float(np.log(d)), device=dev)
    ones = torch.ones_like(eye)
    args = (zero, eye, ones, zero, lse, eye)
    dq_f, _, dv_f = fa.flash_attention_backward_fused(*args, **kw)
    dq_t, _, dv_t = fa.flash_attention_backward_two_pass(*args, **kw)
    torch.cuda.synchronize()
    s = fa.dropout_seed_array(seed, torch.device(dev)).tolist()
    r = torch.arange(d, device=dev)
    keep = fa.dropout_keep_mask(
        r[:, None], r[None, :],
        torch.arange(B, device=dev)[:, None, None, None] + s[1],
        torch.arange(H, device=dev)[None, :, None, None] + s[2], s[0], rate)
    if window is not None:
        keep &= (r[None, :] <= r[:, None]) & (r[None, :] > r[:, None] - window)
    return {"out": out != 0, "dv_fused": (dv_f != 0).transpose(-1, -2),
            "dq_fused": dq_f != 0, "dv_two_pass": (dv_t != 0).transpose(-1, -2),
            "dq_two_pass": dq_t != 0}, keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed,rate", [(-123456789, 0.5), ([7, 3, 5], 0.1),
                                       (2 ** 31 - 1, 0.9)])
def test_dropout_mask_probe_reads_the_hash_bits(cuda_device, dtype, seed,
                                                rate):
    """Every kernel's keep bits, read back exactly, equal the hash's bit
    for bit (the forward's, the fused backward's and both passes'; seed
    offsets shift the batch and head); and the masked forms' too under a
    window."""
    if isinstance(seed, list):
        seed = torch.tensor(seed, dtype=torch.int32, device=cuda_device)
    for window in (None, 20):
        bits, keep = probe_bits(dtype, cuda_device, seed, rate,
                                window=window)
        for name, got in bits.items():
            assert torch.equal(got, keep), (name, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_fused_backward_gives_the_same_bits(cuda_device, dtype):
    """The fused backward's dropout form twice on the same inputs (and the
    masked one under a window): the same bits."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused, flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(32)
    q, k, v, do = attention_case(gen, cuda_device, 2, 8, 8, 1000, 1000, 64,
                                 dtype)
    for window in (None, 100):
        kw = dict(causal=True, window=window, dropout_rate=0.1,
                  dropout_seed=99)
        out, lse, _ = flash_attention_forward(q, k, v, **kw)
        first = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
        second = flash_attention_backward_fused(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [256, 16384])
def test_dropout_op_makes_the_host_wait_nowhere(cuda_device, L):
    """``ops.flash_attention`` forward and backward with dropout and a
    device seed (the fused backward, and at L = 16384 the two passes) under
    torch's sync debug mode "error": the seed never goes to the host."""
    from tpu_flash_torch import ops as tops

    gen = torch.Generator(cuda_device).manual_seed(33)
    q, k, v, do = attention_case(gen, cuda_device, 1, 2, 2, L, L, 64,
                                 torch.bfloat16)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    tops.flash_attention(*leaves, causal=True, dropout_rate=0.1,
                         dropout_seed=seed).backward(do)   # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = tops.flash_attention(*leaves, causal=True, dropout_rate=0.1,
                                   dropout_seed=seed)
        out.backward(do)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


# --- quantized K/V: the kvq forms ---------------------------------------------


def kvq_case(gen, dev, B, H, Hkv, L, d, dtype, mode):
    """q, dO in ``dtype`` and K, V quantized by the op's quantizer (codes
    and fp32 scales, token or channel)."""
    from tpu_flash_torch.ops.attention import kv_quant_parts, quantize_kv

    q, k, v, do = attention_case(gen, dev, B, H, Hkv, L, L, d, dtype)
    kc, ks = quantize_kv(k, mode)
    vc, vs = quantize_kv(v, mode)
    return q, do, kc, vc, dict(k_scale=ks, v_scale=vs,
                               kv_scale_mode=kv_quant_parts(mode)[1])


def kvq_names(dtype, masked, dropped, gran, kernels):
    from tpu_flash_torch.kernels import flash_attention as fa

    return {fa._form_name(n, dtype, masked, dropped, gran): 1
            for n in kernels}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("mode", ["int8", "fp8", "int8_channel",
                                  "fp8_channel"])
@pytest.mark.parametrize("variant", ["causal", "window-dropout",
                                     "segments", "dropout"])
def test_quantized_forms_match_plain(cuda_device, dtype, d, mode, variant):
    """Each flash kernel's quantized form (forward, fused backward, dK/dV
    and dQ passes) on the same codes and scales as its plain version, per
    token or per channel, int8 or e4m3 codes, unmasked, under a window with
    dropout, under packed segments, and non-causal with dropout, at each
    head dim (GQA 4:2, a ragged L): bf16 out and gradients within
    BF16_ARMS, fp32 within FA_TOL (the two passes at 1e-3); lse at 1e-4
    (token scales: the normaliser sums the fp32 P in both), or in bf16 per
    channel below d = 128 at 1e-3 of ``stepped_lse`` on the folded q and the
    codes.  Each call launches its quantized form once and nothing else."""
    from tpu_flash_torch.kernels import flash_attention as fa
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_dkv_plain, flash_attention_backward_dq_plain,
        flash_attention_backward_fused, flash_attention_backward_two_pass,
        flash_attention_forward)

    B, H, Hkv, L = 2, 4, 2, 300
    gen = torch.Generator(cuda_device).manual_seed(41)
    q, do, kc, vc, quant = kvq_case(gen, cuda_device, B, H, Hkv, L, d, dtype,
                                    mode)
    dropped = "dropout" in variant
    kw = dict(causal=variant != "dropout",
              dropout_rate=0.1 if dropped else 0.0, dropout_seed=1234,
              window=77 if variant == "window-dropout" else None,
              segment_ids=(packed_segments(B, L, 7, cuda_device)
                           if variant == "segments" else None), **quant)
    before = dict(common.launch_counts)
    out, lse, _ = flash_attention_forward(q, kc, vc, **kw)
    fused = flash_attention_backward_fused(q, kc, vc, out, lse, do, **kw)
    two = flash_attention_backward_two_pass(q, kc, vc, out, lse, do, **kw)
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    want = flash_attention_forward(q, kc, vc, impl="plain", **kw)
    ref = flash_attention_backward_fused(q, kc, vc, out, lse, do,
                                         impl="plain", **kw)
    two_ref = flash_attention_backward_two_pass(q, kc, vc, out, lse, do,
                                                impl="plain", **kw)
    torch.cuda.synchronize()
    gran = quant["kv_scale_mode"]
    masked = kw["window"] is not None or kw["segment_ids"] is not None
    assert launched == kvq_names(dtype, masked, dropped, gran,
                                 (fa.KERNEL_FWD, fa.KERNEL_BWD,
                                  fa.KERNEL_DKV, fa.KERNEL_DQ))
    if dtype == torch.bfloat16 and gran == "channel" and d < 128 \
            and not dropped:
        qf = fa._channel(q, quant["k_scale"], H // Hkv)
        torch.testing.assert_close(
            lse, stepped_lse(qf, kc, kw["causal"], None, kw["window"],
                             kw["segment_ids"]), atol=1e-3, rtol=1e-3)
    else:
        torch.testing.assert_close(lse, want[1], atol=1e-4, rtol=1e-4)
    named = list(zip((out, *fused, *two), (want[0], *ref, *two_ref)))
    if dtype == torch.bfloat16:
        for a, b in named:
            assert a.dtype == b.dtype == dtype and a.shape == b.shape
            assert_close_bf16(a, b)
    else:
        fw_tol, bw_tol = FA_TOL[dtype]
        for i, (a, b) in enumerate(named):
            tol = fw_tol if i == 0 else bw_tol if i < 4 else 1e-3
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode,window", [("int8", None), ("fp8", 100),
                                         ("int8_channel", None),
                                         ("fp8_channel", 64)])
def test_quantized_fused_backward_gives_the_same_bits(cuda_device, dtype,
                                                      mode, window):
    """The fused backward's quantized forms keep dQ's adds in key-tile
    order: two calls give the same bits (B2 H8 Hkv4 L1000 d64)."""
    from tpu_flash_torch.kernels.flash_attention import (
        flash_attention_backward_fused, flash_attention_forward)

    gen = torch.Generator(cuda_device).manual_seed(42)
    q, do, kc, vc, quant = kvq_case(gen, cuda_device, 2, 8, 4, 1000, 64,
                                    dtype, mode)
    kw = dict(causal=True, window=window, **quant)
    out, lse, _ = flash_attention_forward(q, kc, vc, **kw)
    first = flash_attention_backward_fused(q, kc, vc, out, lse, do, **kw)
    second = flash_attention_backward_fused(q, kc, vc, out, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_op_launches_only_the_quantized_forms(cuda_device, dtype):
    """``ops.flash_attention(kv_quant=m)`` forward and backward launch the
    quantized forms of m's granularity, one forward and one fused backward,
    and leave the counts of every form without quantization as they were.
    Against the op through the plain versions: fp32 out and gradients at
    1e-3; bf16 out within BF16_ARMS and the gradients finite (each path's
    backward takes its own forward's bf16 out, so their gradients carry
    both paths' roundings; test_quantized_forms_match_plain holds the bf16
    gradients on shared inputs)."""
    from tpu_flash_torch import ops as tops
    from tpu_flash_torch.kernels import flash_attention as fa

    gen = torch.Generator(cuda_device).manual_seed(43)
    q, k, v, do = attention_case(gen, cuda_device, 2, 4, 2, 256, 256, 64,
                                 dtype)
    for mode in ("int8", "fp8_channel"):
        gran = "channel" if mode.endswith("channel") else "token"
        grads = {}
        for impl in ("kernel", "plain"):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            before = dict(common.launch_counts)
            out = tops.flash_attention(*leaves, causal=True, kv_quant=mode,
                                       impl=impl)
            out.backward(do)
            torch.cuda.synchronize()
            launched = {n: c - before.get(n, 0) for n, c in
                        common.launch_counts.items()
                        if c != before.get(n, 0)}
            grads[impl] = [out] + [x.grad for x in leaves]
            if impl == "kernel":
                assert launched == kvq_names(dtype, False, False, gran,
                                             (fa.KERNEL_FWD, fa.KERNEL_BWD))
            else:
                assert launched == {}
        for i, (a, b) in enumerate(zip(grads["kernel"], grads["plain"])):
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)
            elif i == 0:
                assert_close_bf16(a.detach(), b.detach())
            else:
                assert torch.isfinite(a).all()
