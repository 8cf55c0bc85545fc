"""Fused masked attention-softmax forward and backward, counterpart of
``tpu_flash/kernels/softmax.py``.

``attn_softmax_forward(x, pad_mask=None, *, mask_future=False)`` is the
softmax over the last axis of ``[B, H, Lq, Lk]`` scores with an optional
additive ``[B, Lk]`` pad mask and the causal mask at the bottom-right
diagonal (query row i sees keys ``<= i + Lk - Lq``); it returns ``x``'s
dtype.  ``attn_softmax_backward(prob, dprob)`` returns ``prob * (dprob -
rowsum(dprob * prob))`` in ``prob``'s dtype.  All arithmetic is fp32; only
the stores round.

Masking follows the TPU kernel, in this order: the pad mask is added, then
every causally masked score is *replaced* by ``MASK_VALUE`` (-1e7), so a row
that sees no key comes out uniform (the composed form in ``ops.reference``
adds the causal mask instead).  The TPU kernel also runs over ``Lk`` padded
to a multiple of 128 with the padded columns set to ``MASK_VALUE``; they
enter the max and the sum, which changes only rows whose every score is at
most about -1e7: such a row gives ``1 / round_up(Lk, 128)`` per visible
column, and a batch row whose pad mask hides every key (-1e9, say) gives 0.
Both versions here count those ``pad_cols`` columns the same way, without
storing them.  ``SOFTMAX_EPS`` (1e-8) is added to the denominator.

On CUDA tensors the forward launches ``csrc/attn_softmax_fwd.cu`` and the
backward ``csrc/attn_softmax_bwd.cu``; on CPU tensors they run
``attn_softmax_forward_plain`` / ``attn_softmax_backward_plain``, the same
arithmetic in plain PyTorch (``impl="kernel"|"plain"`` forces one).
"""

from __future__ import annotations

import ctypes

import torch

from tpu_flash_torch.kernels.common import (
    MASK_VALUE,
    call_on_stream,
    check_cuda,
    entry,
    kernel_input,
    launch_counts,
    resolve_impl,
    round_up,
)

KERNEL_FWD = "attn_softmax_fwd"
KERNEL_BWD = "attn_softmax_bwd"
SOFTMAX_EPS = 1e-8
TPU_LANES = 128    # the TPU kernel pads Lk to a multiple of this
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pad_cols(lk: int) -> int:
    """The TPU kernel's padded columns past ``lk``."""
    return round_up(lk, TPU_LANES) - lk


def _check_scores(x, pad_mask):
    if x.dim() != 4:
        raise ValueError(f"scores must be [B, H, Lq, Lk], got "
                         f"{tuple(x.shape)}")
    if pad_mask is not None and pad_mask.shape != (x.shape[0], x.shape[3]):
        raise ValueError(f"pad_mask must be [B, Lk] = "
                         f"{(x.shape[0], x.shape[3])}, got "
                         f"{tuple(pad_mask.shape)}")


def attn_softmax_forward_plain(x, pad_mask=None, *, mask_future=False):
    """The forward kernel's function in plain PyTorch."""
    _check_scores(x, pad_mask)
    Lq, Lk = x.shape[2], x.shape[3]
    s = x.float()
    if pad_mask is not None:
        s = s + pad_mask[:, None, None, :].float()
    if mask_future:
        rows = torch.arange(Lq, device=x.device)[:, None] + (Lk - Lq)
        cols = torch.arange(Lk, device=x.device)[None, :]
        s = torch.where(cols <= rows, s, MASK_VALUE)
    pad = pad_cols(Lk)
    m = s.amax(dim=-1, keepdim=True)
    if pad:
        m = m.clamp_min(MASK_VALUE)
    e = torch.exp(s - m)
    total = e.sum(dim=-1, keepdim=True)
    if pad:
        total = total + pad * torch.exp(MASK_VALUE - m)
    return (e / (total + SOFTMAX_EPS)).to(x.dtype)


def attn_softmax_backward_plain(prob, dprob):
    """The backward kernel's function in plain PyTorch."""
    p, dp = prob.float(), dprob.float()
    row = (dp * p).sum(dim=-1, keepdim=True)
    return (p * (dp - row)).to(prob.dtype)


def _check_dtype(t, what):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {t.dtype}")


def _launch_forward(x, pad_mask, mask_future):
    _check_scores(x, pad_mask)
    _check_dtype(x, "attn_softmax_forward")
    B, H, Lq, Lk = x.shape
    x = kernel_input(x, x.device)
    mask = (None if pad_mask is None
            else kernel_input(pad_mask.float(), x.device))
    out = torch.empty_like(x)
    lib, fn = entry(KERNEL_FWD, "tf_attn_softmax_fwd",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p])
    err = call_on_stream(fn, x.device, x.data_ptr(),
                         None if mask is None else mask.data_ptr(),
                         out.data_ptr(), B, H, Lq, Lk, int(mask_future),
                         Lk - Lq, pad_cols(Lk), _DTYPES[x.dtype])
    check_cuda(err, lib, "attn_softmax_fwd kernel")
    launch_counts[KERNEL_FWD] += 1
    return out


def _launch_backward(prob, dprob):
    _check_dtype(prob, "attn_softmax_backward")
    _check_dtype(dprob, "attn_softmax_backward")
    if dprob.shape != prob.shape or prob.dim() == 0:
        raise ValueError(f"prob and dprob must share one shape, got "
                         f"{tuple(prob.shape)} and {tuple(dprob.shape)}")
    p, dp = (kernel_input(t, prob.device) for t in (prob, dprob))
    Lk = prob.shape[-1]
    dx = torch.empty_like(p)
    lib, fn = entry(KERNEL_BWD, "tf_attn_softmax_bwd",
                    [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = call_on_stream(fn, prob.device, p.data_ptr(), dp.data_ptr(),
                         dx.data_ptr(), p.numel() // max(Lk, 1), Lk,
                         _DTYPES[prob.dtype], _DTYPES[dprob.dtype])
    check_cuda(err, lib, "attn_softmax_bwd kernel")
    launch_counts[KERNEL_BWD] += 1
    return dx


def attn_softmax_forward(x, pad_mask=None, *, mask_future: bool = False,
                         impl: str | None = None):
    """Masked softmax over the last axis of ``[B, H, Lq, Lk]`` scores, in
    ``x``'s dtype.  ``impl``: ``None`` launches the CUDA kernel for CUDA
    tensors and runs the plain version for CPU tensors; ``"plain"`` forces
    the plain one."""
    if resolve_impl(impl, x) == "plain":
        return attn_softmax_forward_plain(x, pad_mask,
                                          mask_future=mask_future)
    return _launch_forward(x, pad_mask, mask_future)


def attn_softmax_backward(prob, dprob, *, impl: str | None = None):
    """``prob * (dprob - rowsum(dprob * prob))`` in ``prob``'s dtype.
    ``impl`` as in the forward."""
    if resolve_impl(impl, prob) == "plain":
        return attn_softmax_backward_plain(prob, dprob)
    return _launch_backward(prob, dprob)
