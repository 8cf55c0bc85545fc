"""The CUDA kernels (flash decode, flash-attention forward and backward,
fused LayerNorm and masked softmax forward and backward) against their
plain PyTorch versions, on the card.  Every test here needs a
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
from tpu_flash_torch.kernels import common
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
# differs by summation order and exp2f only (1e-4 on out/lse, 1e-3 on the
# gradients, whose sums run over up to 2048 rows, dQ in atomic order).  lse
# and m are fp32 in both dtypes and keep 1e-4.  bf16 out and gradients are
# rounded to bf16 and may land an ulp either side of a boundary (rtol 2e-2
# covers two), and the forward kernel rounds p relative to its running max
# where the plain version uses the row's final max: BF16_ARMS of the
# output's root mean square on top, chip_smoke.py's limit.

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
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert common.launch_counts[name] == before.get(name, 0) + 1
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
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
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
    with pytest.raises(NotImplementedError, match="A5"):
        flash_attention_forward(x, x, x, window=4)


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
@pytest.mark.parametrize("shape,causal,keep", [
    ((2, 3, 130, 70), True, None),        # rows that see no key
    ((2, 3, 70, 200), False, (150, 0)),   # a batch row with every key hidden
    ((2, 2, 64, 256), True, (256, 100)),
    ((1, 2, 4, 640), True, None),         # above 512: the chunked loop
])
def test_attn_softmax_kernels_match_plain(cuda_device, dtype, shape, causal,
                                          keep):
    from tpu_flash_torch.kernels.softmax import (attn_softmax_backward,
                                                 attn_softmax_forward)

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
    Lq, Lk = shape[2], shape[3]
    if causal and Lq > Lk:       # uniform over the TPU's padded width
        torch.testing.assert_close(
            p[:, :, :Lq - Lk].float(),
            torch.full_like(p[:, :, :Lq - Lk], 1 / 128, dtype=torch.float32))


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
