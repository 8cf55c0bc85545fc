"""Flash-attention forward and backward, counterpart of the training half of
``tpu_flash/kernels/flash_attention.py``.

``flash_attention_forward`` and ``flash_attention_backward`` keep the JAX
package's signatures and layouts: q ``[B, H, Lq, d]``, k and v
``[B, Hkv, Lk, d]`` (query head h reads KV head ``h // (H // Hkv)``, no
repeat), fp32 or bf16; ``lse`` and ``m`` fp32 ``[B, H, Lq]`` in natural-log
units, ``m`` the row max of the scaled scores.  The causal diagonal sits at
the bottom right (``q_offset = Lk - Lq`` unless given).  A causal row that
sees no key gives out 0, lse -inf and zero gradients.

On CUDA tensors the forward launches ``csrc/flash_attention_fwd.cu``; on
CPU tensors it runs ``flash_attention_forward_plain``, the same arithmetic in
plain PyTorch (``impl="kernel"|"plain"`` forces one).

The backward takes the form the JAX package takes for the same shapes
(``backward_form.two_pass``, a copy of its rule; the rule models a TPU's
VMEM and grid steps and is not retuned for the H100):
  * the fused single pass (``flash_attention_backward_fused``,
    ``csrc/flash_attention_bwd.cu``) below the rule's lengths: KV-outer, dK
    and dV summed over each GQA group in the block, dQ added into a zeroed
    fp32 workspace (the TPU's full-sequence scratch does not fit in a
    block's shared memory) by the blocks of a query chunk one after
    another, in a fixed order kept by a counter per chunk, so two calls
    give the same bits;
  * the two passes (``flash_attention_backward_two_pass``,
    ``csrc/flash_attention_bwd_two_pass.cu``) from there on (bf16 causal
    from L = 16384, fp32 from 8192 at d = 64): a dK/dV pass (KV-outer) and a
    dQ pass (one block per query tile, the loop over KV tiles ending at the
    causal limit).  Each output is written once, and two calls give the same
    bits.
Each kernel has a form for each dtype, picked by ``_form_name``, both on
the tensor cores: bf16 runs each product as one ``mma.sync`` bf16 product
with fp32 sums (launches counted under the kernel's name + ``TC``); fp32 as
six bf16 products of its operands split in three (``split3_bf16``,
``matmul_x6``: the TPU's Precision.HIGHEST algorithm; counted under the
name + ``X6``), its sums over the sequence (P.V, dK, dV, and dQ in the dQ
pass) each step's six products summed apart and added in fp32.  The plain
versions are ``flash_attention_backward_plain`` (fused) and its halves
``flash_attention_backward_dkv_plain`` / ``_dq_plain``,
which recompute P and dS the same way.  ``D = rowsum(dO * O) - dlse`` is a
torch op outside the kernels, as it is plain XLA outside Pallas in the JAX
package.

Sliding windows and packed segments, as in the JAX package: with
``window`` (requires ``causal``, >= 1) query row r attends only keys in
``(r + q_offset - window, r + q_offset]``, and tiles wholly behind that band
are never visited; with ``segment_ids`` (int ``[B, L]``, Lq == Lk) row r
attends only keys of its own segment.  Either launches each kernel's masked
form (the same C entry, a second template instantiation), counted under
the form's name + ``MASK``; a call with neither launches exactly the
unmasked form.

Numerics, in both versions: base-2 softmax with ``scale * log2(e)`` folded
into q; fp32 products are fp32-accurate (never TF32); with bf16 inputs the
scaled q, p (before P.V and dV) and dS (before dK and dQ) are rounded to
bf16, as the TPU feeds its MXU in the input dtype, and every sum is fp32.
Below d = 128 the bf16 forward's softmax normaliser is the sum of that bf16
p, as the JAX kernel's ones column rides its P.V product (``_fold_l``); at
d = 128, and in fp32, it sums the fp32 p.  The TPU's tile sizes, ``q_pack``,
``score_layout`` and ``interpret`` have no counterpart: the kernels pick
their own tiling.
Dropout and quantized K/V are not ported yet (ROADMAP.md A5, B3).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_flash_torch.kernels.backward_form import two_pass
from tpu_flash_torch.kernels.common import (
    TC,
    X6,
    call_on_stream,
    cdiv,
    check_cuda,
    entry,
    kernel_input,
    launch_counts,
    resolve_impl,
    split3_bf16,
)

KERNEL_FWD = "flash_attention_fwd"
KERNEL_BWD = "flash_attention_bwd"
# The two-pass backward: one source, two kernels counted apart.
SOURCE_TWO_PASS = "flash_attention_bwd_two_pass"
KERNEL_DKV = "flash_attention_bwd_dkv"
KERNEL_DQ = "flash_attention_bwd_dq"
HEAD_DIMS = (16, 32, 64, 128)
# A call with a window or segment ids counts its launches under the form's
# name + MASK (the kernel's masked instantiation).
MASK = "_mask"
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dq_chunk(dtype: torch.dtype, d: int) -> int:
    """Query rows a chunk of the fused backward's ordered dQ adds: the
    form's query tile (``kTcTile`` of flash_attention_tc.cuh; ``BwdX6``'s
    ``kQT`` of flash_attention_bwd.cuh in fp32, 32 at d = 128)."""
    return 32 if dtype == torch.float32 and d > 64 else 64


def _not_ported(dropout_rate=0.0, k_scale=None, v_scale=None) -> None:
    for bad, what in ((dropout_rate > 0.0, "attention dropout"),
                      (k_scale is not None or v_scale is not None,
                       "quantized K/V")):
        if bad:
            raise NotImplementedError(
                f"{what} in the flash-attention kernels is not ported yet "
                f"(ROADMAP.md, queue A item A5 and queue B item B3)")


def check_mask(q, k, causal, window=None, segment_ids=None):
    """``(window, segment_ids)`` validated as the JAX package validates them
    (ops/attention.py:295-313, kernels/flash_attention.py:795-799): window
    an int >= 1 that requires ``causal``; segment ids ``[B, L]`` with
    Lq == Lk, returned as a contiguous int32 tensor on q's device.  The
    entries (``flash_attention_forward`` and the backwards) call it once;
    the forms and plain versions below them take its result as it is."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        window = int(window)
        if window < 1:
            raise ValueError(
                f"window must be >= 1 (got {window}); use window=None to "
                f"disable sliding-window attention")
    if segment_ids is not None:
        if q.shape[-2] != k.shape[-2]:
            raise ValueError("segment_ids requires Lq == Lk")
        if tuple(segment_ids.shape) != (q.shape[0], q.shape[2]):
            raise ValueError(
                f"segment_ids must be [B, L] = {(q.shape[0], q.shape[2])}, "
                f"got {tuple(segment_ids.shape)}")
        segment_ids = torch.as_tensor(segment_ids).to(
            device=q.device, dtype=torch.int32).contiguous()
    return window, segment_ids


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


def _scores2(q, k, scale, causal, q_offset, window=None, seg=None):
    """Base-2 scores ``[B, H, Lq, Lk]`` in fp32, -inf where masked: above
    the causal diagonal, behind the window's band, across segments."""
    g = q.shape[1] // k.shape[1]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    s2 = qs @ _expand(k, g).float().transpose(-1, -2)
    if causal:
        Lq, Lk = q.shape[2], k.shape[2]
        rows = torch.arange(Lq, device=q.device)[:, None] + q_offset
        cols = torch.arange(Lk, device=q.device)[None, :]
        hide = cols > rows
        if window is not None:
            hide |= cols <= rows - window
        s2.masked_fill_(hide, -math.inf)
    if seg is not None:
        s2.masked_fill_(seg[:, None, :, None] != seg[:, None, None, :],
                        -math.inf)
    return s2


def _delta(o, do, dlse):
    delta = (do.float() * o.float()).sum(-1)
    return delta if dlse is None else delta - dlse.float()


def _fold_l(d: int) -> bool:
    """The JAX package's ``_fold_l`` (its forward, :403): below d = 128 the
    softmax normaliser rides the P.V product as a ones column of V, so it
    is the sum of the same P, in the input dtype, that multiplies V."""
    return d < 128


def matmul_x6(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 as the fp32 kernels form it (``mma_x6`` in
    csrc/mma.cuh): both split by ``split3_bf16`` and six of the nine
    products, each exact bf16 x bf16 with fp32 sums, added in the kernels'
    order, smallest first (hi.lo, mid.mid, lo.hi, hi.mid, mid.hi, hi.hi).
    The three left out are below 2^-24 of ``|a| |b|``.
    ``tests/test_torch_fp32_split.py`` holds it against JAX's ``_dot`` at
    Precision.HIGHEST and a float64 product."""
    ah, am, al = (t.float() for t in split3_bf16(a))
    bh, bm, bl = (t.float() for t in split3_bf16(b))
    out = ah @ bl
    for x, y in ((am, bm), (al, bh), (ah, bm), (am, bh), (ah, bh)):
        out += x @ y
    return out


def flash_attention_forward_plain(q, k, v, *, causal=False, scale=None,
                                  q_offset=None, with_m=False, window=None,
                                  segment_ids=None):
    """The forward kernel's function in plain PyTorch: returns
    ``(out, lse, m)`` (``m`` None unless ``with_m``).  ``window`` and
    ``segment_ids`` are taken as ``check_mask`` returns them, unchecked, as
    in every plain version."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    s2 = _scores2(q, k, scale, causal, q_offset, window, segment_ids)
    m2 = s2.amax(-1, keepdim=True)
    empty = m2 == -math.inf
    p = torch.exp2(s2 - torch.where(empty, 0.0, m2))
    pv = p.to(q.dtype).float()
    l = (pv if _fold_l(d) else p).sum(-1, keepdim=True)
    acc = pv @ _expand(v, H // Hkv).float()
    out = torch.where(empty, 0.0, acc / torch.where(empty, 1.0, l))
    m_nat = m2[..., 0] * (1.0 / LOG2E)
    lse = torch.where(empty[..., 0], -math.inf, m_nat + torch.log(l[..., 0]))
    return out.to(q.dtype), lse, (m_nat if with_m else None)


def _p_ds(q, k, v, do, lse, delta, causal, scale, q_offset, window=None,
          seg=None):
    """The recompute every backward shares: ``P = exp2(S2 - lse * log2e)``
    and ``dS = P * (dO V^T - D)``, fp32 ``[B, H, Lq, Lk]`` each, built in
    place (two such tensors live at a time).  Rows with ``lse = -inf`` get
    P = 0, not ``exp(+inf)``."""
    s2 = _scores2(q, k, scale, causal, q_offset, window, seg)
    lse2 = torch.where(torch.isneginf(lse), math.inf, lse.float() * LOG2E)
    p = s2.sub_(lse2[..., None]).exp2_()
    g = q.shape[1] // k.shape[1]
    dp = do.float() @ _expand(v, g).float().transpose(-1, -2)
    ds = dp.sub_(delta[..., None]).mul_(p)
    return p, ds


def _as_input_dtype(x, dtype):
    """``x`` rounded to ``dtype`` and widened back to fp32, in place (a
    no-op for fp32): the bf16 operands of the TPU's backward dots."""
    return x if dtype == torch.float32 else x.copy_(x.to(dtype))


def _dkv_plain(q, k, v, do, lse, delta, causal, scale, q_offset,
               window=None, seg=None):
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, q_offset, window,
                  seg)
    dv = _as_input_dtype(p, q.dtype).transpose(-1, -2) @ do.float()
    del p
    dk = _as_input_dtype(ds, q.dtype).transpose(-1, -2) @ q.float()
    g = H // Hkv
    dk, dv = (x.reshape(B, Hkv, g, Lk, d).sum(2) for x in (dk, dv))
    return (scale * dk).to(k.dtype), dv.to(v.dtype)


def _dq_plain(q, k, v, do, lse, delta, causal, scale, q_offset,
              window=None, seg=None):
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, q_offset, window,
                  seg)
    del p
    g = q.shape[1] // k.shape[1]
    dq = _as_input_dtype(ds, q.dtype) @ _expand(k, g).float()
    return (scale * dq).to(q.dtype)


def flash_attention_backward_plain(q, k, v, o, lse, do, dlse=None, *,
                                   causal=False, scale=None, q_offset=None,
                                   window=None, segment_ids=None):
    """The fused backward kernel's function in plain PyTorch: returns
    ``(dq, dk, dv)`` from one recompute of P and dS."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    g = H // Hkv
    p, ds = _p_ds(q, k, v, do, lse, _delta(o, do, dlse), causal, scale,
                  q_offset, window, segment_ids)
    pb, dsb = _as_input_dtype(p, q.dtype), _as_input_dtype(ds, q.dtype)
    dq = scale * (dsb @ _expand(k, g).float())
    dk = dsb.transpose(-1, -2) @ q.float()
    dv = pb.transpose(-1, -2) @ do.float()
    dk, dv = (x.reshape(B, Hkv, g, Lk, d).sum(2) for x in (dk, dv))
    return dq.to(q.dtype), (scale * dk).to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_dkv_plain(q, k, v, o, lse, do, dlse=None, *,
                                       causal=False, scale=None,
                                       q_offset=None, window=None,
                                       segment_ids=None):
    """The dK/dV pass in plain PyTorch: returns ``(dk, dv)``."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    return _dkv_plain(q, k, v, do, lse, _delta(o, do, dlse), causal, scale,
                      q_offset, window, segment_ids)


def flash_attention_backward_dq_plain(q, k, v, o, lse, do, dlse=None, *,
                                      causal=False, scale=None,
                                      q_offset=None, window=None,
                                      segment_ids=None):
    """The dQ pass in plain PyTorch: returns ``dq``."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    return _dq_plain(q, k, v, do, lse, _delta(o, do, dlse), causal, scale,
                     q_offset, window, segment_ids)


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


def _form_name(kernel: str, dtype: torch.dtype, masked: bool = False) -> str:
    """``kernel``'s launch-count name in its form for ``dtype`` (its C entry
    is ``tf_`` + the name without ``MASK``), at every head dim of
    ``HEAD_DIMS``: bf16 the tensor-core form, the name + ``TC``
    (``mma.sync`` bf16 products with fp32 sums, the TPU kernels' numerics);
    fp32 the six-product form, the name + ``X6`` (each fp32 product six
    ``mma.sync`` bf16 products, ``matmul_x6``, never TF32); + ``MASK`` for
    the masked instantiation a window or segment ids launch."""
    return (kernel + (TC if dtype == torch.bfloat16 else X6)
            + (MASK if masked else ""))


def _mask_args(window, seg):
    """The C entries' mask arguments: the window (0 for none) and the
    segment ids' pointer (None for none); and whether the masked form
    runs."""
    return (0 if window is None else window,
            None if seg is None else seg.data_ptr(),
            window is not None or seg is not None)


def _launch_forward(q, k, v, causal, scale, q_offset, with_m, window=None,
                    seg=None):
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    q, k, v = _kernel_inputs(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_FWD, q.dtype, masked)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(lse) if with_m else None
    lib, fn = entry(KERNEL_FWD, "tf_" + _form_name(KERNEL_FWD, q.dtype),
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p])
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                         None if m is None else m.data_ptr(),
                         B, H, Hkv, Lq, Lk, d, _DTYPES[q.dtype], int(causal),
                         q_offset, scale * LOG2E, win, seg_ptr)
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return out, lse, m


def _bwd_inputs(q, k, v, o, lse, do, dlse):
    """The kernels' inputs of a backward: q, k, v and dO contiguous and
    aligned, lse fp32, and ``D = rowsum(dO * O) - dlse``, one torch op
    outside the kernels as it is XLA outside Pallas in the JAX package."""
    B, H, _, Lq, _, _ = _shapes(q, k, v)
    q, k, v, o, do = _kernel_inputs(q, k, v, o, do)
    if lse.shape != (B, H, Lq):
        raise ValueError(f"lse must be [B, H, Lq] = {(B, H, Lq)}")
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    return q, k, v, do, lse, _delta(o, do, dlse).contiguous()


def _launch_backward(q, k, v, do, lse, delta, causal, scale, q_offset,
                     window=None, seg=None):
    """The fused backward in the form for q's dtype; returns
    ``(dq, dk, dv)``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_BWD, q.dtype, masked)
    dq = torch.zeros(B, H, Lq, d, dtype=torch.float32, device=q.device)
    # the dQ adds made to each chunk of query rows (the kernel's fixed
    # order of adds)
    dq_order = torch.zeros(B * H * cdiv(Lq, _dq_chunk(q.dtype, d)),
                           dtype=torch.int32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, fn = entry(KERNEL_BWD, "tf_" + _form_name(KERNEL_BWD, q.dtype),
                    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p])
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), dq_order.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Lq, Lk, d,
                         _DTYPES[q.dtype], int(causal), q_offset, scale,
                         scale * LOG2E, win, seg_ptr)
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return dq.mul_(scale).to(q.dtype), dk, dv


def _two_pass_args(n_pointers):
    return ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p])


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, q_offset,
                window=None, seg=None):
    """The dK/dV pass in the form for q's dtype; returns ``(dk, dv)``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_DKV, q.dtype, masked)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, fn = entry(SOURCE_TWO_PASS, "tf_" + _form_name(KERNEL_DKV, q.dtype),
                    _two_pass_args(8))
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         B, H, Hkv, Lq, Lk, d, _DTYPES[q.dtype], int(causal),
                         q_offset, scale, scale * LOG2E, win, seg_ptr)
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal, scale, q_offset,
               window=None, seg=None):
    """The dQ pass in the form for q's dtype; returns ``dq``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_DQ, q.dtype, masked)
    dq = torch.empty_like(q)
    lib, fn = entry(SOURCE_TWO_PASS, "tf_" + _form_name(KERNEL_DQ, q.dtype),
                    _two_pass_args(7))
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), B, H, Hkv, Lq, Lk,
                         d, _DTYPES[q.dtype], int(causal), q_offset, scale,
                         scale * LOG2E, win, seg_ptr)
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return dq


def flash_attention_forward(q, k, v, *, causal=False, scale=None,
                            q_offset=None, with_m=False, dropout_rate=0.0,
                            window=None, segment_ids=None, k_scale=None,
                            v_scale=None, impl: str | None = None):
    """Flash-attention forward; returns ``(out, lse, m)`` with ``out`` in
    q's dtype and ``lse`` / ``m`` fp32 ``[B, H, Lq]`` (``m`` None unless
    ``with_m``).

    Query row r attends keys ``<= r + q_offset`` when ``causal``, and with
    ``window`` only those ``> r + q_offset - window``; with ``segment_ids``
    (``[B, L]``, Lq == Lk) only keys of its own segment.
    ``impl``: ``None`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``"plain"`` forces the plain version."""
    _not_ported(dropout_rate, k_scale, v_scale)
    window, seg = check_mask(q, k, causal, window, segment_ids)
    return _forward(q, k, v, causal, scale, q_offset, with_m, window, seg,
                    impl)


def _forward(q, k, v, causal, scale, q_offset, with_m, window, seg, impl):
    """The forward on a validated mask (``check_mask``'s result)."""
    if resolve_impl(impl, q) == "plain":
        return flash_attention_forward_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            with_m=with_m, window=window, segment_ids=seg)
    return _launch_forward(q, k, v, causal, scale, q_offset, with_m, window,
                           seg)


def flash_attention_backward_fused(q, k, v, o, lse, do, dlse=None, *,
                                   causal=False, scale=None, q_offset=None,
                                   window=None, segment_ids=None,
                                   impl: str | None = None):
    """The fused single pass (``csrc/flash_attention_bwd.cu``): returns
    ``(dq, dk, dv)``.  Deterministic: dQ's adds run in a fixed order.
    ``window``, ``segment_ids`` and ``impl`` as in the forward."""
    window, seg = check_mask(q, k, causal, window, segment_ids)
    return _fused(q, k, v, o, lse, do, dlse, causal, scale, q_offset, window,
                  seg, impl)


def _fused(q, k, v, o, lse, do, dlse, causal, scale, q_offset, window, seg,
           impl):
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    if resolve_impl(impl, q) == "plain":
        return flash_attention_backward_plain(
            q, k, v, o, lse, do, dlse, causal=causal, scale=scale,
            q_offset=q_offset, window=window, segment_ids=seg)
    return _launch_backward(*_bwd_inputs(q, k, v, o, lse, do, dlse), causal,
                            scale, q_offset, window, seg)


def flash_attention_backward_two_pass(q, k, v, o, lse, do, dlse=None, *,
                                      causal=False, scale=None,
                                      q_offset=None, window=None,
                                      segment_ids=None,
                                      impl: str | None = None):
    """The two passes (``csrc/flash_attention_bwd_two_pass.cu``): the dK/dV
    pass, then the dQ pass, from one ``D``; returns ``(dq, dk, dv)``.
    Deterministic: no atomics, each output written once.  ``window``,
    ``segment_ids`` and ``impl`` as in the forward."""
    window, seg = check_mask(q, k, causal, window, segment_ids)
    return _two_pass(q, k, v, o, lse, do, dlse, causal, scale, q_offset,
                     window, seg, impl)


def _two_pass(q, k, v, o, lse, do, dlse, causal, scale, q_offset, window,
              seg, impl):
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    if resolve_impl(impl, q) == "plain":
        args = (q, k, v, do, lse, _delta(o, do, dlse), causal, scale,
                q_offset, window, seg)
        dk, dv = _dkv_plain(*args)
        return _dq_plain(*args), dk, dv
    args = (*_bwd_inputs(q, k, v, o, lse, do, dlse), causal, scale, q_offset,
            window, seg)
    dk, dv = _launch_dkv(*args)
    return _launch_dq(*args), dk, dv


def flash_attention_backward(q, k, v, o, lse, do, dlse=None, *,
                             causal=False, scale=None, q_offset=None,
                             dropout_rate=0.0, window=None, segment_ids=None,
                             k_scale=None, v_scale=None,
                             impl: str | None = None):
    """Flash-attention backward; returns ``(dq, dk, dv)`` in the input
    dtype, dk and dv ``[B, Hkv, Lk, d]``.  ``dlse`` is a cotangent on the
    logsumexp output (it shifts ``D``).  The form is the JAX package's for
    these shapes (``backward_form.two_pass``): the fused single pass, or the
    two passes.  ``window``, ``segment_ids`` and ``impl`` as in the
    forward (the rule takes the window)."""
    _not_ported(dropout_rate, k_scale, v_scale)
    window, seg = check_mask(q, k, causal, window, segment_ids)
    return _backward(q, k, v, o, lse, do, dlse, causal, scale, q_offset,
                     window, seg, impl)


def _backward(q, k, v, o, lse, do, dlse, causal, scale, q_offset, window,
              seg, impl):
    """The backward in the JAX rule's form on a validated mask
    (``check_mask``'s result)."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    form = (_two_pass if two_pass(Lq, Lk, d, q.element_size(), bool(causal),
                                  _defaults(d, Lq, Lk, scale, q_offset)[1],
                                  window)
            else _fused)
    return form(q, k, v, o, lse, do, dlse, causal, scale, q_offset, window,
                seg, impl)
