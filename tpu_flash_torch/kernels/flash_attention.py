"""Flash-attention forward and backward, counterpart of the training half of
``tpu_flash/kernels/flash_attention.py``.

``flash_attention_forward`` and ``flash_attention_backward`` keep the JAX
package's signatures and layouts: q ``[B, H, Lq, d]``, k and v
``[B, Hkv, Lk, d]`` (query head h reads KV head ``h // (H // Hkv)``, no
repeat), fp32 or bf16; ``lse`` and ``m`` fp32 ``[B, H, Lq]`` in natural-log
units, ``m`` the row max of the scaled scores.  The causal diagonal sits at
the bottom right (``q_offset = Lk - Lq`` unless given).  A causal row that
sees no key gives out 0, lse -inf and zero gradients.

On CUDA tensors the forward launches ``csrc/flash_attention_fwd.cu`` and the
backward ``csrc/flash_attention_bwd.cu``; on CPU tensors they run
``flash_attention_forward_plain`` / ``flash_attention_backward_plain``, the
same arithmetic in plain PyTorch (``impl="kernel"|"plain"`` forces one).
The backward is the TPU's fused single pass in KV-outer order; dQ is added
with fp32 atomics into a zeroed workspace (the TPU's race-free full-sequence
scratch does not fit in a block's shared memory), and dK/dV are summed over
each GQA group inside the kernel, in fp32, before the one cast to the input
dtype.  ``D = rowsum(dO * O) - dlse`` is a torch op outside the kernel, as it
is plain XLA outside Pallas in the JAX package.

Numerics, in both versions: base-2 softmax with ``scale * log2(e)`` folded
into q; fp32 products are exact (never TF32); with bf16 inputs the scaled q,
p (before P.V and dV) and dS (before dK and dQ) are rounded to bf16, as the
TPU feeds its MXU in the input dtype, and every sum is fp32.  The TPU's tile
sizes, ``q_pack``, ``score_layout`` and ``interpret`` have no counterpart:
the kernels pick their own tiling.  Dropout, ``window``, ``segment_ids`` and
quantized K/V are not ported yet (ROADMAP.md A5, B3).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_flash_torch.kernels.common import (
    call_on_stream,
    check_cuda,
    entry,
    kernel_input,
    launch_counts,
    resolve_impl,
)

KERNEL_FWD = "flash_attention_fwd"
KERNEL_BWD = "flash_attention_bwd"
HEAD_DIMS = (16, 32, 64, 128)
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _not_ported(dropout_rate=0.0, window=None, segment_ids=None,
                k_scale=None, v_scale=None) -> None:
    for bad, what in ((dropout_rate > 0.0, "attention dropout"),
                      (window is not None, "window"),
                      (segment_ids is not None, "segment_ids"),
                      (k_scale is not None or v_scale is not None,
                       "quantized K/V")):
        if bad:
            raise NotImplementedError(
                f"{what} in the flash-attention kernels is not ported yet "
                f"(ROADMAP.md, queue A item A5 and queue B item B3)")


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, H, Lq, d] and k, v one "
                         f"[B, Hkv, Lk, d] shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Lq, d = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d:
        raise ValueError("k and v must share q's batch and head dim")
    if H % Hkv:
        raise ValueError(f"query heads ({H}) must be a multiple of KV "
                         f"heads ({Hkv})")
    return B, H, Hkv, Lq, Lk, d


def _defaults(d, Lq, Lk, scale, q_offset):
    return (1.0 / math.sqrt(d) if scale is None else float(scale),
            Lk - Lq if q_offset is None else int(q_offset))


def _expand(x, g):
    """KV heads -> query heads (the plain versions only)."""
    return x if g == 1 else x.repeat_interleave(g, dim=1)


def _scores2(q, k, scale, causal, q_offset):
    """Base-2 scores ``[B, H, Lq, Lk]`` in fp32, -inf where masked."""
    g = q.shape[1] // k.shape[1]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    s2 = qs @ _expand(k, g).float().transpose(-1, -2)
    if causal:
        Lq, Lk = q.shape[2], k.shape[2]
        rows = torch.arange(Lq, device=q.device)[:, None] + q_offset
        cols = torch.arange(Lk, device=q.device)[None, :]
        s2 = s2.masked_fill(cols > rows, -math.inf)
    return s2


def _delta(o, do, dlse):
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def flash_attention_forward_plain(q, k, v, *, causal=False, scale=None,
                                  q_offset=None, with_m=False):
    """The forward kernel's function in plain PyTorch: returns
    ``(out, lse, m)`` (``m`` None unless ``with_m``)."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    s2 = _scores2(q, k, scale, causal, q_offset)
    m2 = s2.amax(-1, keepdim=True)
    empty = m2 == -math.inf
    p = torch.exp2(s2 - torch.where(empty, 0.0, m2))
    l = p.sum(-1, keepdim=True)
    acc = p.to(q.dtype).float() @ _expand(v, H // Hkv).float()
    out = torch.where(empty, 0.0, acc / torch.where(empty, 1.0, l))
    m_nat = m2[..., 0] * (1.0 / LOG2E)
    lse = torch.where(empty[..., 0], -math.inf, m_nat + torch.log(l[..., 0]))
    return out.to(q.dtype), lse, (m_nat if with_m else None)


def flash_attention_backward_plain(q, k, v, o, lse, do, dlse=None, *,
                                   causal=False, scale=None, q_offset=None):
    """The backward kernel's function in plain PyTorch: returns
    ``(dq, dk, dv)``.  Rows with ``lse = -inf`` get P = 0, not
    ``exp(+inf)``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    g = H // Hkv
    s2 = _scores2(q, k, scale, causal, q_offset)
    lse2 = torch.where(torch.isneginf(lse), math.inf, lse.float() * LOG2E)
    p = torch.exp2(s2 - lse2[..., None])
    dp = do.float() @ _expand(v, g).float().transpose(-1, -2)
    ds = p * (dp - _delta(o, do, dlse)[..., None])
    pb, dsb = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = scale * (dsb @ _expand(k, g).float())
    dk = dsb.transpose(-1, -2) @ q.float()
    dv = pb.transpose(-1, -2) @ do.float()
    dk, dv = (x.reshape(B, Hkv, g, Lk, d).sum(2) for x in (dk, dv))
    return dq.to(q.dtype), (scale * dk).to(k.dtype), dv.to(v.dtype)


def _kernel_inputs(*tensors):
    """Contiguous, 16-byte aligned copies where needed; checks dtype,
    device and head dim."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if tensors[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {tensors[0].shape[-1]} not in "
                         f"{HEAD_DIMS}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("q, k, v (and o, do) must share one device and "
                             "dtype")
    return [kernel_input(t, dev) for t in tensors]


def _launch_forward(q, k, v, causal, scale, q_offset, with_m):
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    q, k, v = _kernel_inputs(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(lse) if with_m else None
    lib, fn = entry(KERNEL_FWD, "tf_flash_attention_fwd",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_void_p])
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                         None if m is None else m.data_ptr(),
                         B, H, Hkv, Lq, Lk, d, _DTYPES[q.dtype], int(causal),
                         q_offset, scale * LOG2E)
    check_cuda(err, lib, "flash_attention_fwd kernel")
    launch_counts[KERNEL_FWD] += 1
    return out, lse, m


def _launch_backward(q, k, v, o, lse, do, dlse, causal, scale, q_offset):
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    q, k, v, o, do = _kernel_inputs(q, k, v, o, do)
    if lse.shape != (B, H, Lq):
        raise ValueError(f"lse must be [B, H, Lq] = {(B, H, Lq)}")
    delta = _delta(o, do, dlse).contiguous()
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    dq = torch.zeros(B, H, Lq, d, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, fn = entry(KERNEL_BWD, "tf_flash_attention_bwd",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                         dv.data_ptr(), B, H, Hkv, Lq, Lk, d,
                         _DTYPES[q.dtype], int(causal), q_offset, scale,
                         scale * LOG2E)
    check_cuda(err, lib, "flash_attention_bwd kernel")
    launch_counts[KERNEL_BWD] += 1
    return dq.mul_(scale).to(q.dtype), dk, dv


def flash_attention_forward(q, k, v, *, causal=False, scale=None,
                            q_offset=None, with_m=False, dropout_rate=0.0,
                            window=None, segment_ids=None, k_scale=None,
                            v_scale=None, impl: str | None = None):
    """Flash-attention forward; returns ``(out, lse, m)`` with ``out`` in
    q's dtype and ``lse`` / ``m`` fp32 ``[B, H, Lq]`` (``m`` None unless
    ``with_m``).

    Query row r attends keys ``<= r + q_offset`` when ``causal``.
    ``impl``: ``None`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``"plain"`` forces the plain version."""
    _not_ported(dropout_rate, window, segment_ids, k_scale, v_scale)
    if resolve_impl(impl, q) == "plain":
        return flash_attention_forward_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            with_m=with_m)
    return _launch_forward(q, k, v, causal, scale, q_offset, with_m)


def flash_attention_backward(q, k, v, o, lse, do, dlse=None, *,
                             causal=False, scale=None, q_offset=None,
                             dropout_rate=0.0, window=None, segment_ids=None,
                             k_scale=None, v_scale=None,
                             impl: str | None = None):
    """Flash-attention backward; returns ``(dq, dk, dv)`` in the input
    dtype, dk and dv ``[B, Hkv, Lk, d]``.  ``dlse`` is a cotangent on the
    logsumexp output (it shifts ``D``).  ``impl`` as in the forward."""
    _not_ported(dropout_rate, window, segment_ids, k_scale, v_scale)
    if resolve_impl(impl, q) == "plain":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
            q_offset=q_offset)
    return _launch_backward(q, k, v, o, lse, do, dlse, causal, scale,
                            q_offset)
