"""Flash-decode attention over a (optionally quantized) KV cache.

Counterpart of ``tpu_flash/kernels/decode.py``: ``flash_decode_attention``
keeps its signature and layouts (q ``[B, Hq, Lq, d]``; a heads-minor cache
``[B, S, Hkv*d]`` or the legacy ``[B, Hkv, S, d]``; scales ``[B, Hkv, S]``
fp32; lengths ``[B]``).  On CUDA tensors it launches the hand-written kernel
in ``csrc/flash_decode.cu``; on CPU tensors it runs
``flash_decode_attention_plain``, the same function in plain PyTorch.  The
TPU version's ``block_s`` and ``interpret`` arguments have no counterpart:
the CUDA kernel picks its own tiling.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_flash_torch.kernels.common import (
    call_on_stream,
    check_cuda,
    entry,
    launch_counts,
    resolve_impl,
)

KERNEL = "flash_decode"
HEAD_DIMS = (16, 32, 64, 128)
# dtype codes of the C entry
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}


def _normalize(q, k_cache, v_cache, k_scale, v_scale, scale, window):
    """Shared argument handling: legacy layouts -> heads-minor, shape and
    dtype checks.  Returns (k, v, k_scale, v_scale, H, scale)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, Hq, Lq, d], got {tuple(q.shape)}")
    B, Hq, Lq, d = q.shape
    if k_cache.dim() == 4:
        # legacy [B, H, S, d]: one extra pass over the cache
        Bk, H, S, dk = k_cache.shape
        k_cache = k_cache.permute(0, 2, 1, 3).reshape(Bk, S, H * dk)
        v_cache = v_cache.permute(0, 2, 1, 3).reshape(Bk, S, H * dk)
    if k_cache.shape != v_cache.shape or k_cache.dim() != 3:
        raise ValueError("k_cache and v_cache must share a [B, S, H*d] shape")
    if k_cache.shape[0] != B:
        raise ValueError("cache batch does not match q")
    HD = k_cache.shape[-1]
    if HD % d:
        raise ValueError(f"cache feature dim {HD} not a multiple of d={d}")
    H = HD // d
    if Hq % H:
        raise ValueError(
            f"query heads ({Hq}) must be a multiple of KV heads ({H})")
    if k_scale is not None and k_scale.dim() == 4:   # legacy [B, H, 1, S]
        k_scale = k_scale[:, :, 0, :]
        v_scale = v_scale[:, :, 0, :]
    quantized = k_cache.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8/fp8 caches need k_scale and v_scale; "
                         "float caches take none")
    if quantized and (k_scale.shape != (B, H, k_cache.shape[1])
                      or v_scale.shape != k_scale.shape):
        raise ValueError(f"scales must be [B, H, S] = "
                         f"{(B, H, k_cache.shape[1])}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    return k_cache, v_cache, k_scale, v_scale, H, float(scale)


def flash_decode_attention_plain(q, k_cache, v_cache, lengths, k_scale=None,
                                 v_scale=None, *, scale=None, window=None):
    """The kernel's function in plain PyTorch: dequantize, mask each query
    row at its own limit, softmax with empty rows set to 0, matmul.

    Query token i of Lq attends positions ``< lengths - Lq + i + 1`` (and,
    with ``window``, ``>= that limit - window``).  fp8 codes convert with
    torch's exact e4m3 conversion."""
    k_cache, v_cache, k_scale, v_scale, H, scale = _normalize(
        q, k_cache, v_cache, k_scale, v_scale, scale, window)
    B, Hq, Lq, d = q.shape
    S = k_cache.shape[1]
    g = Hq // H

    def heads(codes, scales):                      # -> [B, H, S, d] fp32
        x = codes.reshape(B, S, H, d).float()
        if scales is not None:
            x = x * scales.transpose(1, 2)[..., None]
        return x.permute(0, 2, 1, 3)

    k, v = heads(k_cache, k_scale), heads(v_cache, v_scale)
    # scale folds into q in fp32 and is rounded to q's dtype, as on the TPU
    qs = (q.float() * scale).to(q.dtype).float()
    qs = qs.reshape(B, H, g * Lq, d)               # rows (u, i) per KV head
    s = qs @ k.transpose(-1, -2)                   # [B, H, g*Lq, S]
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    i = torch.arange(Lq, device=q.device).repeat(g)          # token of row
    limit = lengths[:, None, None, None] - Lq + 1 + i[None, None, :, None]
    pos = torch.arange(S, device=q.device)
    valid = pos < limit
    if window is not None:
        valid &= pos >= limit - window
    m = s.masked_fill(~valid, -math.inf).amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    denom = p.sum(-1, keepdim=True)
    out = torch.where(denom > 0, (p @ v) / denom, 0.0)
    return out.reshape(B, Hq, Lq, d).to(q.dtype)


def _launch(q, k_cache, v_cache, lengths, k_scale, v_scale, H, scale,
            window):
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype not in _KV_DTYPES:
        raise TypeError(f"cache dtype {k_cache.dtype} is not supported")
    B, Hq, Lq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    dev = q.device
    tensors = [q, k_cache, v_cache, lengths] + (
        [k_scale, v_scale] if k_scale is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("all kernel inputs must be on q's device")
    q = q.contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    if k_scale is not None:
        k_scale = k_scale.contiguous().float()
        v_scale = v_scale.contiguous().float()
    lengths = lengths.to(torch.int32).contiguous()
    if lengths.shape != (B,):
        raise ValueError(f"lengths must be [B] = [{B}]")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("cache buffers must be 16-byte aligned")
    out = torch.empty_like(q)
    lib, fn = entry(KERNEL, "tf_flash_decode",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = call_on_stream(fn, dev, q.data_ptr(), k_cache.data_ptr(),
                         v_cache.data_ptr(),
                         None if k_scale is None else k_scale.data_ptr(),
                         None if v_scale is None else v_scale.data_ptr(),
                         lengths.data_ptr(), out.data_ptr(),
                         B, Hq, H, Lq, k_cache.shape[1], d,
                         _Q_DTYPES[q.dtype], _KV_DTYPES[k_cache.dtype],
                         scale, window or 0)
    check_cuda(err, lib, "flash_decode kernel")
    launch_counts[KERNEL] += 1
    return out


def flash_decode_attention(q, k_cache, v_cache, lengths, k_scale=None,
                           v_scale=None, *, scale=None, window=None,
                           impl: str | None = None):
    """Attention of the last Lq tokens over the cache; returns
    ``[B, Hq, Lq, d]`` in q's dtype.

    Query token i attends positions ``< lengths - Lq + i + 1``; rows that
    see no position return 0.  ``impl``: ``None`` launches the CUDA kernel
    for CUDA tensors and runs the plain version for CPU tensors;
    ``"plain"`` forces the plain version (tests and comparisons)."""
    impl = resolve_impl(impl, q)
    if impl == "plain":
        return flash_decode_attention_plain(
            q, k_cache, v_cache, lengths, k_scale, v_scale, scale=scale,
            window=window)
    k_cache, v_cache, k_scale, v_scale, H, scale = _normalize(
        q, k_cache, v_cache, k_scale, v_scale, scale, window)
    return _launch(q, k_cache, v_cache, lengths, k_scale, v_scale, H, scale,
                   window)
