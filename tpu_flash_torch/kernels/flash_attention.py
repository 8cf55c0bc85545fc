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

Attention dropout, as in the JAX package (``dropout_rate``,
``dropout_seed``): the keep bit of (query row, key, batch, query head) is a
hash of those indices and the seed (``dropout_keep_mask``, the JAX
function's bits; rows and keys are the local indices, q_offset is not
added), so the backward regenerates the mask instead of storing it.  P.V
(and dV) sees ``P * keep / (1 - rate)``, the normaliser sums the undropped
P (so the bf16 forward sums the fp32 P at every d under dropout), and the
backward scales dP by the same mask before ``dS = P * (dP - D)`` with D
unchanged.  The seed reaches the kernels as a device tensor, int32
``[seed, batch offset, head offset]`` (``dropout_seed_array``; the host
never reads it), beside the keep threshold and the scale; each kernel's
dropout form (a third template instantiation, with or without the mask)
counts under the form's name + ``DROP``.

Numerics, in both versions: base-2 softmax with ``scale * log2(e)`` folded
into q; fp32 products are fp32-accurate (never TF32); with bf16 inputs the
scaled q, p (before P.V and dV) and dS (before dK and dQ) are rounded to
bf16, as the TPU feeds its MXU in the input dtype, and every sum is fp32.
Below d = 128 the bf16 forward's softmax normaliser is the sum of that bf16
p, as the JAX kernel's ones column rides its P.V product (``_fold_l``); at
d = 128, and in fp32, it sums the fp32 p.  The TPU's tile sizes, ``q_pack``,
``score_layout`` and ``interpret`` have no counterpart: the kernels pick
their own tiling.

Quantized K/V, as in the JAX package (``k_scale``, ``v_scale``,
``kv_layout``, ``kv_scale_mode``): k and v are int8 or float8_e4m3fn codes
with fp32 scales, and the kernels read the codes (1 byte an element) and
turn each tile into bf16 in shared memory (every int8 and e4m3 value is a
bf16; e4m3 subnormals are kept, where the JAX package's bit rebuild
flushes them).  Token scales (``[B, Hkv, Lk]``) multiply the fp32 scores
and P (``S2 = (q scale log2e . codes) * ks``, P.V on ``P * vs``) and, in
the backward, dP and dS (``dP = (dO . codes) * vs``, dQ on ``dS * ks``);
the normaliser sums the undropped fp32 P at every d (``fold_l`` is off).
Channel scales (``[B, Hkv, d]``) never reach the kernels: the entries fold
K's into q and V's into dO, and unfold out, dQ, dK and dV, as the JAX
entries do.  dK and dV are straight-through, against the dequantized K/V.
``"dl"`` codes (d-major, the TPU's layout) are transposed once by the
entry.  Each kernel's quantized forms (a fourth template value, token or
channel) are C entries of their own, built from ``<source>_kvq.cu`` (token)
and ``<source>_kvqc.cu`` (channel), and count under the form's name +
``KVQ[mode]``.  The fp32 forms multiply an
fp32 operand by codes as three bf16 products (a code is one exact bf16
plane), six where neither operand is a code (dK, dV).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

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
# name + MASK (the kernel's masked instantiation); a call with dropout
# under the name (+ MASK) + DROP (its dropout instantiation).
MASK = "_mask"
DROP = "_drop"
# A call with quantized K/V counts under the name (+ MASK, + DROP) + KVQ of
# its granularity, and launches the C entry ``tf_<form>`` + KVQ_ENTRY of
# the library of its granularity, ``<source>`` + KVQ (csrc/<source>_kvq.cu
# and _kvqc.cu).
KVQ = {"token": "_kvq", "channel": "_kvqc"}
KVQ_ENTRY = "_kvq"
CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)
LOG2E = 1.4426950408889634
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dq_chunk(dtype: torch.dtype, d: int) -> int:
    """Query rows a chunk of the fused backward's ordered dQ adds: the
    form's query tile (``kTcTile`` of flash_attention_tc.cuh; ``BwdX6``'s
    ``kQT`` of flash_attention_bwd.cuh in fp32, 32 at d = 128)."""
    return 32 if dtype == torch.float32 and d > 64 else 64


# --- quantized K/V ------------------------------------------------------------

class KvQuant(NamedTuple):
    """A call's quantized K/V below the entries (k and v being int8 or
    float8_e4m3fn codes ``[B, Hkv, Lk, d]``): ``mode`` "token" with the fp32
    scales ``[B, Hkv, Lk]`` that the kernels fold into the scores and P
    (dP and dS in the backward), or "channel", whose ``[B, Hkv, d]`` scales
    the entries fold outside the kernels (None below them)."""

    mode: str
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def token(self) -> bool:
        return self.mode == "token"

    def inside(self) -> "KvQuant":
        """What the kernels and plain versions take: channel scales
        stay with the entry."""
        return self if self.token else KvQuant("channel")


def check_kv_quant(q, k, v, k_scale=None, v_scale=None, kv_layout="ld",
                   kv_scale_mode="token"):
    """``(k, v, kvq)``: the JAX entries' checks of the quantized-K/V
    arguments (tpu_flash/kernels/flash_attention.py:783-791), "dl" codes
    transposed to ``[B, Hkv, Lk, d]``, the scales fp32 on q's device, and
    ``kvq`` a ``KvQuant`` (None without scales)."""
    if kv_scale_mode not in ("token", "channel"):
        raise ValueError(f"kv_scale_mode must be 'token' or 'channel', "
                         f"got {kv_scale_mode!r}")
    if kv_layout not in ("ld", "dl"):
        raise ValueError(f"kv_layout must be 'ld' or 'dl', got {kv_layout!r}")
    if k_scale is None:
        if v_scale is not None:
            raise ValueError("v_scale without k_scale: quantized K/V takes "
                             "both")
        return k, v, None
    if v_scale is None:
        raise ValueError("k_scale without v_scale: quantized K/V takes both")
    if k.dtype not in CODE_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"quantized K/V takes int8 or float8_e4m3fn codes "
                        f"of one dtype, got {k.dtype} and {v.dtype}")
    if kv_layout == "dl":
        k, v = k.transpose(-1, -2), v.transpose(-1, -2)
    B, Hkv, Lk, d = k.shape
    want = (B, Hkv, Lk) if kv_scale_mode == "token" else (B, Hkv, d)
    scales = []
    for name, x in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {list(want)} in "
                             f"{kv_scale_mode} mode, got {list(x.shape)}")
        scales.append(x.to(device=q.device, dtype=torch.float32)
                      .contiguous())
    return k, v, KvQuant(kv_scale_mode, *scales)


def _channel(x, s, g):
    """``x`` ``[B, H, L, d]`` times the channel scales ``s`` ``[B, Hkv, d]``
    of its KV heads (each taken by repeat), in fp32, rounded back to x's
    dtype: the JAX entries' folds (:800-806, :998-1003, :1843-1866)."""
    return (x.float() * _expand(s, g)[:, :, None, :]).to(x.dtype)


def _token_scales(kvq, g):
    """Token scales by query head, ``[B, H, 1, Lk]`` each, or Nones."""
    if kvq is None or not kvq.token:
        return None, None
    return tuple(_expand(x, g)[:, :, None, :] for x in (kvq.k_scale,
                                                         kvq.v_scale))


# --- attention dropout: the JAX package's counter-based hash ---------------

_U32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c`` mod 2**32 for x in [0, 2**32) held in int64 (a tensor or
    an int), without an int64 product past 2**63: c is taken in 16-bit
    halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _u32(x):
    """An int or int tensor as its uint32 bits (two's complement), in
    int64: what ``astype(jnp.uint32)`` gives an int32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _U32
    return int(x) & _U32


def dropout_threshold(rate: float) -> int:
    """Keep where the hash is at least this: ``round(rate * 2**32)``, at
    most ``2**32 - 1`` (Python's round, as the JAX function takes it)."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def dropout_keep_mask(rows, cols, b, h, seed, rate):
    """The JAX package's ``dropout_keep_mask``
    (tpu_flash/kernels/flash_attention.py:443) in plain PyTorch: bool keep
    bits, P(keep) = 1 - rate, of query rows ``rows`` and keys ``cols``
    (int tensors, broadcastable) of batch ``b`` and query head ``h``, from
    the int32 ``seed`` (ints or int tensors; negative values wrap as
    uint32).  uint32 multiply / xor / shift (a murmur3 finaliser), held in
    int64 and masked to 32 bits after every product."""
    u = (_mul32(_u32(rows), 0x9E3779B1) ^ _mul32(_u32(cols), 0x85EBCA77)
         ^ _mul32(_u32(b), 0xC2B2AE3D) ^ _mul32(_u32(h), 0x27D4EB2F)
         ^ _u32(seed))
    u = u ^ (u >> 16)
    u = _mul32(u, 0x7FEB352D)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 16)
    return u >= dropout_threshold(rate)


class Dropout(NamedTuple):
    """A call's attention dropout: the int32 ``[seed, batch offset, head
    offset]`` on the inputs' device (``dropout_seed_array``) and the rate."""

    seed: torch.Tensor
    rate: float

    @property
    def threshold(self) -> int:
        return dropout_threshold(self.rate)

    @property
    def scale(self) -> float:
        """``1 / (1 - rate)`` in Python's double, rounded to fp32 where it
        multiplies (as the JAX kernels take it)."""
        return 1.0 / (1.0 - self.rate)


def dropout_seed_array(seed, device) -> torch.Tensor:
    """``seed`` as the kernels read it: int32 ``[seed, batch offset, head
    offset]`` on ``device``, padded with zeros (the JAX package's
    ``seed_arr``).  An int seed wraps to int32 and is written by a fill
    (no copy from the host); a tensor seed of 1 to 3 values is copied on
    the device it is moved to.  Nothing here reads the seed back to the
    host."""
    if isinstance(seed, torch.Tensor):
        s = seed.to(device=device, dtype=torch.int32).reshape(-1)
        if not 1 <= s.numel() <= 3:
            raise ValueError(f"dropout_seed must hold 1 to 3 values "
                             f"([seed, batch offset, head offset]), got "
                             f"{tuple(seed.shape)}")
        # a copy: a later change to the caller's tensor cannot reach the
        # backward's mask
        return torch.cat([s, s.new_zeros(3 - s.numel())])
    s = torch.zeros(3, dtype=torch.int32, device=device)
    s[:1].fill_((int(seed) + 2 ** 31) % 2 ** 32 - 2 ** 31)
    return s


def check_dropout(q, dropout_rate=0.0, dropout_seed=0):
    """None without dropout, else ``Dropout(seed array on q's device,
    rate)``; the rate must lie in [0, 1)."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return None
    return Dropout(dropout_seed_array(dropout_seed, q.device), rate)


def dropout_keep_blocks(B, H, Lq, Lk, drop: Dropout, rows_per_block=None):
    """``(rows, keep)`` over blocks of query rows: ``keep`` the fp32
    ``[B, H, len(rows), Lk]`` multiplier, ``1 / (1 - rate)`` where kept
    and 0 where dropped, on the seed's device.  Blocks hold about 2**24
    scores, so that the hash's int64 temporaries stay small at any
    length."""
    dev = drop.seed.device
    if rows_per_block is None:
        rows_per_block = max(1, 2 ** 24 // max(1, B * H * Lk))
    b = (torch.arange(B, device=dev, dtype=torch.int64)
         + drop.seed[1].to(torch.int64))[:, None, None, None]
    h = (torch.arange(H, device=dev, dtype=torch.int64)
         + drop.seed[2].to(torch.int64))[None, :, None, None]
    cols = torch.arange(Lk, device=dev, dtype=torch.int64)[None, :]
    one = torch.full((), drop.scale, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for r0 in range(0, Lq, rows_per_block):
        rows = slice(r0, min(Lq, r0 + rows_per_block))
        r = torch.arange(rows.start, rows.stop, device=dev,
                         dtype=torch.int64)[:, None]
        keep = dropout_keep_mask(r, cols, b, h, drop.seed[0], drop.rate)
        yield rows, torch.where(keep, one, zero)


def _apply_keep(x, drop: Dropout):
    """``x`` ``[B, H, Lq, Lk]`` times the keep multiplier, in place, a block
    of rows at a time; returns x."""
    B, H, Lq, Lk = x.shape
    for rows, keep in dropout_keep_blocks(B, H, Lq, Lk, drop):
        x[:, :, rows].mul_(keep)
    return x


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


def _scores2(q, k, scale, causal, q_offset, window=None, seg=None,
             ks=None):
    """Base-2 scores ``[B, H, Lq, Lk]`` in fp32, -inf where masked: above
    the causal diagonal, behind the window's band, across segments.  With
    token scales ``ks`` (``[B, H, 1, Lk]``) k holds codes and the product
    is scaled by key (the JAX ``s2 * kscale``)."""
    g = q.shape[1] // k.shape[1]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    s2 = qs @ _expand(k, g).float().transpose(-1, -2)
    if ks is not None:
        s2.mul_(ks)
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
                                  segment_ids=None, drop=None, kvq=None):
    """The forward kernel's function in plain PyTorch: returns
    ``(out, lse, m)`` (``m`` None unless ``with_m``).  ``window`` and
    ``segment_ids`` are taken as ``check_mask`` returns them, ``drop`` as
    ``check_dropout`` does and ``kvq`` as ``KvQuant.inside`` (k and v
    codes, channel scales already folded), unchecked, as in every plain
    version.  Under dropout the normaliser sums the undropped fp32 P and
    P.V takes ``P * keep / (1 - rate)`` (in the input dtype); under token
    scales too, and P.V takes ``P (* keep / (1 - rate)) * vs``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    ks, vs = _token_scales(kvq, H // Hkv)
    s2 = _scores2(q, k, scale, causal, q_offset, window, segment_ids, ks)
    m2 = s2.amax(-1, keepdim=True)
    empty = m2 == -math.inf
    p = torch.exp2(s2 - torch.where(empty, 0.0, m2))
    if drop is None and vs is None:
        pv = p.to(q.dtype).float()
        l = (pv if _fold_l(d) else p).sum(-1, keepdim=True)
    else:
        l = p.sum(-1, keepdim=True)
        pv = p if drop is None else _apply_keep(p, drop)
        if vs is not None:
            pv.mul_(vs)
        pv = _as_input_dtype(pv, q.dtype)
    acc = pv @ _expand(v, H // Hkv).float()
    out = torch.where(empty, 0.0, acc / torch.where(empty, 1.0, l))
    m_nat = m2[..., 0] * (1.0 / LOG2E)
    lse = torch.where(empty[..., 0], -math.inf, m_nat + torch.log(l[..., 0]))
    return out.to(q.dtype), lse, (m_nat if with_m else None)


def _p_ds(q, k, v, do, lse, delta, causal, scale, q_offset, window=None,
          seg=None, drop=None, kvq=None):
    """The recompute every backward shares: ``P = exp2(S2 - lse * log2e)``
    and ``dS = P * (dP - D)``, fp32 ``[B, H, Lq, Lk]`` each, built in
    place (two such tensors live at a time).  Rows with ``lse = -inf`` get
    P = 0, not ``exp(+inf)``.  Under dropout dP is scaled by the keep
    multiplier before D is taken off (D unchanged), and the P returned is
    ``P * keep / (1 - rate)``, the operand of dV (the JAX ``_bwd_finish``,
    :1093-1105).  Under token scales S2 and dP are scaled by key
    (:1043-1066)."""
    g = q.shape[1] // k.shape[1]
    ks, vs = _token_scales(kvq, g)
    s2 = _scores2(q, k, scale, causal, q_offset, window, seg, ks)
    lse2 = torch.where(torch.isneginf(lse), math.inf, lse.float() * LOG2E)
    p = s2.sub_(lse2[..., None]).exp2_()
    dp = do.float() @ _expand(v, g).float().transpose(-1, -2)
    if vs is not None:
        dp.mul_(vs)
    if drop is not None:
        _apply_keep(dp, drop)
    ds = dp.sub_(delta[..., None]).mul_(p)
    if drop is not None:
        _apply_keep(p, drop)
    return p, ds


def _as_input_dtype(x, dtype):
    """``x`` rounded to ``dtype`` and widened back to fp32, in place (a
    no-op for fp32): the bf16 operands of the TPU's backward dots."""
    return x if dtype == torch.float32 else x.copy_(x.to(dtype))


def _dq_operand(ds, kvq, g, dtype):
    """dS as the dQ product's operand: ``dS * ks`` by key under token
    scales (a new tensor; JAX's ``dsk``, :1204-1210), rounded to the input
    dtype."""
    ks, _ = _token_scales(kvq, g)
    return _as_input_dtype(ds if ks is None else ds * ks, dtype)


def _dkv_plain(q, k, v, do, lse, delta, causal, scale, q_offset,
               window=None, seg=None, drop=None, kvq=None):
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, q_offset, window,
                  seg, drop, kvq)
    dv = _as_input_dtype(p, q.dtype).transpose(-1, -2) @ do.float()
    del p
    dk = _as_input_dtype(ds, q.dtype).transpose(-1, -2) @ q.float()
    g = H // Hkv
    dk, dv = (x.reshape(B, Hkv, g, Lk, d).sum(2) for x in (dk, dv))
    return (scale * dk).to(q.dtype), dv.to(q.dtype)


def _dq_plain(q, k, v, do, lse, delta, causal, scale, q_offset,
              window=None, seg=None, drop=None, kvq=None):
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, scale, q_offset, window,
                  seg, drop, kvq)
    del p
    g = q.shape[1] // k.shape[1]
    dq = _dq_operand(ds, kvq, g, q.dtype) @ _expand(k, g).float()
    return (scale * dq).to(q.dtype)


def flash_attention_backward_plain(q, k, v, o, lse, do, dlse=None, *,
                                   causal=False, scale=None, q_offset=None,
                                   window=None, segment_ids=None, drop=None,
                                   kvq=None, delta=None):
    """The fused backward kernel's function in plain PyTorch: returns
    ``(dq, dk, dv)`` from one recompute of P and dS.  ``kvq`` as in the
    forward's plain version (dK and dV in q's dtype); ``delta``, D formed
    by the caller, in place of ``o`` and ``dlse``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    g = H // Hkv
    p, ds = _p_ds(q, k, v, do, lse,
                  _delta(o, do, dlse) if delta is None else delta, causal,
                  scale, q_offset, window, segment_ids, drop, kvq)
    dq = scale * (_dq_operand(ds, kvq, g, q.dtype) @ _expand(k, g).float())
    pb, dsb = _as_input_dtype(p, q.dtype), _as_input_dtype(ds, q.dtype)
    dk = dsb.transpose(-1, -2) @ q.float()
    dv = pb.transpose(-1, -2) @ do.float()
    dk, dv = (x.reshape(B, Hkv, g, Lk, d).sum(2) for x in (dk, dv))
    return dq.to(q.dtype), (scale * dk).to(q.dtype), dv.to(q.dtype)


def flash_attention_backward_dkv_plain(q, k, v, o, lse, do, dlse=None, *,
                                       causal=False, scale=None,
                                       q_offset=None, window=None,
                                       segment_ids=None, drop=None,
                                       kvq=None):
    """The dK/dV pass in plain PyTorch: returns ``(dk, dv)``."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    return _dkv_plain(q, k, v, do, lse, _delta(o, do, dlse), causal, scale,
                      q_offset, window, segment_ids, drop, kvq)


def flash_attention_backward_dq_plain(q, k, v, o, lse, do, dlse=None, *,
                                      causal=False, scale=None,
                                      q_offset=None, window=None,
                                      segment_ids=None, drop=None, kvq=None):
    """The dQ pass in plain PyTorch: returns ``dq``."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    return _dq_plain(q, k, v, do, lse, _delta(o, do, dlse), causal, scale,
                     q_offset, window, segment_ids, drop, kvq)


def _kernel_inputs(*tensors, codes=()):
    """Contiguous, 16-byte aligned copies where needed; checks dtype,
    device and head dim (``codes``: quantized k and v, int8 or e4m3)."""
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
    for t in codes:
        if t.device != dev or t.dtype not in CODE_DTYPES:
            raise ValueError("quantized k and v must be int8 or e4m3 codes "
                             "on q's device")
    return [kernel_input(t, dev) for t in (*tensors, *codes)]


def _form_name(kernel: str, dtype: torch.dtype, masked: bool = False,
               dropped: bool = False, quant: str | None = None) -> str:
    """``kernel``'s launch-count name in its form for ``dtype`` (its C entry
    is ``tf_`` + the name without ``MASK``, ``DROP`` and ``KVQ``), at every
    head dim of ``HEAD_DIMS``: bf16 the tensor-core form, the name + ``TC``
    (``mma.sync`` bf16 products with fp32 sums, the TPU kernels' numerics);
    fp32 the six-product form, the name + ``X6`` (each fp32 product six
    ``mma.sync`` bf16 products, ``matmul_x6``, never TF32); + ``MASK`` for
    the masked instantiation a window or segment ids launch, + ``DROP`` for
    the dropout instantiation, + ``KVQ[quant]`` for the quantized-K/V one
    (``quant`` "token" or "channel")."""
    return (kernel + (TC if dtype == torch.bfloat16 else X6)
            + (MASK if masked else "") + (DROP if dropped else "")
            + (KVQ[quant] if quant else ""))


def _entry(source: str, kernel: str, dtype, argtypes, kvq):
    """The C entry of ``kernel``'s form for ``dtype``: in ``source``, or
    with quantized K/V its ``_kvq`` entry in the library of the
    granularity, ``source + KVQ[kvq.mode]``, which takes ``_KVQ_ARGS``
    before the stream."""
    symbol = "tf_" + _form_name(kernel, dtype)
    if kvq is None:
        return entry(source, symbol, argtypes)
    return entry(source + KVQ[kvq.mode], symbol + KVQ_ENTRY,
                 argtypes[:-1] + _KVQ_ARGS + argtypes[-1:])


def _mask_args(window, seg):
    """The C entries' mask arguments: the window (0 for none) and the
    segment ids' pointer (None for none); and whether the masked form
    runs."""
    return (0 if window is None else window,
            None if seg is None else seg.data_ptr(),
            window is not None or seg is not None)


# The C entries' last arguments before the stream: the window, the segment
# ids, and dropout's seed pointer (None for none), threshold and scale.
_MASK_DROP_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p]


def _drop_args(drop: Dropout | None):
    """The C entries' dropout arguments: the seed's device pointer (None
    for none: the form without dropout), the keep threshold and the
    scale."""
    if drop is None:
        return None, 0, 1.0
    return drop.seed.data_ptr(), drop.threshold, drop.scale


# The quantized entries' last arguments before the stream: the token
# scales' pointers (None for channel codes) and whether the codes are e4m3.
_KVQ_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]


def _kvq_args(kvq: KvQuant | None, k) -> tuple:
    """The quantized entries' arguments of a call (none without
    quantization)."""
    if kvq is None:
        return ()
    ks, vs = ((kvq.k_scale, kvq.v_scale) if kvq.token else (None, None))
    return (None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(),
            int(k.dtype == torch.float8_e4m3fn))


def _quant_name(kvq):
    return None if kvq is None else kvq.mode


def _launch_forward(q, k, v, causal, scale, q_offset, with_m, window=None,
                    seg=None, drop=None, kvq=None):
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    q, k, v = (_kernel_inputs(q, k, v) if kvq is None
               else _kernel_inputs(q, codes=(k, v)))
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_FWD, q.dtype, masked, drop is not None,
                      _quant_name(kvq))
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    m = torch.empty_like(lse) if with_m else None
    lib, fn = _entry(KERNEL_FWD, KERNEL_FWD, q.dtype,
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                     + [ctypes.c_float] + _MASK_DROP_ARGS, kvq)
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                         None if m is None else m.data_ptr(),
                         B, H, Hkv, Lq, Lk, d, _DTYPES[q.dtype], int(causal),
                         q_offset, scale * LOG2E, win, seg_ptr,
                         *_drop_args(drop), *_kvq_args(kvq, k))
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return out, lse, m


def _bwd_inputs(q, k, v, o, lse, do, dlse):
    """The kernels' inputs of a backward: q, k, v and dO contiguous and
    aligned, lse fp32, and ``D = rowsum(dO * O) - dlse``, one torch op
    outside the kernels as it is XLA outside Pallas in the JAX package."""
    _kernel_inputs(q, o)     # o's dtype and device
    return _delta_inputs(q, k, v, lse, do, _delta(o, do, dlse))


def _delta_inputs(q, k, v, lse, do, delta, quantized=False):
    """``_bwd_inputs`` from D formed by the caller (the channel-scaled
    backward takes D of the raw dO and O, then folds dO)."""
    B, H, _, Lq, _, _ = _shapes(q, k, v)
    q, do, k, v = (_kernel_inputs(q, do, codes=(k, v)) if quantized
                   else _kernel_inputs(q, do, k, v))
    if lse.shape != (B, H, Lq):
        raise ValueError(f"lse must be [B, H, Lq] = {(B, H, Lq)}")
    lse = lse.to(device=q.device, dtype=torch.float32).contiguous()
    return q, k, v, do, lse, delta.float().contiguous()


def _launch_backward(q, k, v, do, lse, delta, causal, scale, q_offset,
                     window=None, seg=None, drop=None, kvq=None):
    """The fused backward in the form for q's dtype; returns
    ``(dq, dk, dv)``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_BWD, q.dtype, masked, drop is not None,
                      _quant_name(kvq))
    dq = torch.zeros(B, H, Lq, d, dtype=torch.float32, device=q.device)
    # the dQ adds made to each chunk of query rows (the kernel's fixed
    # order of adds)
    dq_order = torch.zeros(B * H * cdiv(Lq, _dq_chunk(q.dtype, d)),
                           dtype=torch.int32, device=q.device)
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    lib, fn = _entry(KERNEL_BWD, KERNEL_BWD, q.dtype,
                     [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                     + [ctypes.c_float, ctypes.c_float] + _MASK_DROP_ARGS,
                     kvq)
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), dq_order.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Lq, Lk, d,
                         _DTYPES[q.dtype], int(causal), q_offset, scale,
                         scale * LOG2E, win, seg_ptr, *_drop_args(drop),
                         *_kvq_args(kvq, k))
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return dq.mul_(scale).to(q.dtype), dk, dv


def _two_pass_args(n_pointers):
    return ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_float] + _MASK_DROP_ARGS)


def _launch_dkv(q, k, v, do, lse, delta, causal, scale, q_offset,
                window=None, seg=None, drop=None, kvq=None):
    """The dK/dV pass in the form for q's dtype; returns ``(dk, dv)``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_DKV, q.dtype, masked, drop is not None,
                      _quant_name(kvq))
    dk, dv = (torch.empty(k.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    lib, fn = _entry(SOURCE_TWO_PASS, KERNEL_DKV, q.dtype,
                     _two_pass_args(8), kvq)
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                         B, H, Hkv, Lq, Lk, d, _DTYPES[q.dtype], int(causal),
                         q_offset, scale, scale * LOG2E, win, seg_ptr,
                         *_drop_args(drop), *_kvq_args(kvq, k))
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal, scale, q_offset,
               window=None, seg=None, drop=None, kvq=None):
    """The dQ pass in the form for q's dtype; returns ``dq``."""
    B, H, Hkv, Lq, Lk, d = _shapes(q, k, v)
    win, seg_ptr, masked = _mask_args(window, seg)
    name = _form_name(KERNEL_DQ, q.dtype, masked, drop is not None,
                      _quant_name(kvq))
    dq = torch.empty_like(q)
    lib, fn = _entry(SOURCE_TWO_PASS, KERNEL_DQ, q.dtype, _two_pass_args(7),
                     kvq)
    err = call_on_stream(fn, q.device, q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         delta.data_ptr(), dq.data_ptr(), B, H, Hkv, Lq, Lk,
                         d, _DTYPES[q.dtype], int(causal), q_offset, scale,
                         scale * LOG2E, win, seg_ptr, *_drop_args(drop),
                         *_kvq_args(kvq, k))
    check_cuda(err, lib, f"{name} kernel")
    launch_counts[name] += 1
    return dq


def flash_attention_forward(q, k, v, *, causal=False, scale=None,
                            q_offset=None, with_m=False, dropout_rate=0.0,
                            dropout_seed=0, window=None, segment_ids=None,
                            k_scale=None, v_scale=None, kv_layout="ld",
                            kv_scale_mode="token",
                            impl: str | None = None):
    """Flash-attention forward; returns ``(out, lse, m)`` with ``out`` in
    q's dtype and ``lse`` / ``m`` fp32 ``[B, H, Lq]`` (``m`` None unless
    ``with_m``).

    Query row r attends keys ``<= r + q_offset`` when ``causal``, and with
    ``window`` only those ``> r + q_offset - window``; with ``segment_ids``
    (``[B, L]``, Lq == Lk) only keys of its own segment.
    ``dropout_rate`` > 0 drops entries of the normalised P by the hash of
    ``dropout_seed`` (an int, or an int32 tensor of 1 to 3 values:
    ``[seed, batch offset, head offset]``); lse stays that of the undropped
    softmax.
    ``k_scale`` and ``v_scale`` make k and v int8 or float8_e4m3fn codes
    (``kv_layout`` "ld", ``[B, Hkv, Lk, d]``, or "dl", d-major) with fp32
    scales: ``kv_scale_mode`` "token", ``[B, Hkv, Lk]``, or "channel",
    ``[B, Hkv, d]``.
    ``impl``: ``None`` launches the CUDA kernel for CUDA tensors and runs the
    plain version for CPU tensors; ``"plain"`` forces the plain version."""
    k, v, kvq = check_kv_quant(q, k, v, k_scale, v_scale, kv_layout,
                               kv_scale_mode)
    window, seg = check_mask(q, k, causal, window, segment_ids)
    drop = check_dropout(q, dropout_rate, dropout_seed)
    return _forward(q, k, v, causal, scale, q_offset, with_m, window, seg,
                    impl, drop, kvq)


def _forward(q, k, v, causal, scale, q_offset, with_m, window, seg, impl,
             drop=None, kvq=None):
    """The forward on a validated mask, dropout and quantization
    (``check_mask``'s, ``check_dropout``'s and ``check_kv_quant``'s
    results): channel scales fold into q and unfold from out here."""
    g = q.shape[1] // k.shape[1]
    if kvq is not None and not kvq.token:
        q = _channel(q, kvq.k_scale, g)
    inside = None if kvq is None else kvq.inside()
    if resolve_impl(impl, q) == "plain":
        out, lse, m = flash_attention_forward_plain(
            q, k, v, causal=causal, scale=scale, q_offset=q_offset,
            with_m=with_m, window=window, segment_ids=seg, drop=drop,
            kvq=inside)
    else:
        out, lse, m = _launch_forward(q, k, v, causal, scale, q_offset,
                                      with_m, window, seg, drop, inside)
    if kvq is not None and not kvq.token:
        out = _channel(out, kvq.v_scale, g)
    return out, lse, m


def _backward_args(q, k, v, causal, dropout_rate, dropout_seed, window,
                   segment_ids, k_scale, v_scale, kv_layout, kv_scale_mode):
    k, v, kvq = check_kv_quant(q, k, v, k_scale, v_scale, kv_layout,
                               kv_scale_mode)
    window, seg = check_mask(q, k, causal, window, segment_ids)
    return k, v, window, seg, check_dropout(q, dropout_rate,
                                            dropout_seed), kvq


def flash_attention_backward_fused(q, k, v, o, lse, do, dlse=None, *,
                                   causal=False, scale=None, q_offset=None,
                                   dropout_rate=0.0, dropout_seed=0,
                                   window=None, segment_ids=None,
                                   k_scale=None, v_scale=None,
                                   kv_layout="ld", kv_scale_mode="token",
                                   impl: str | None = None):
    """The fused single pass (``csrc/flash_attention_bwd.cu``): returns
    ``(dq, dk, dv)``.  Deterministic: dQ's adds run in a fixed order.
    The other arguments as in ``flash_attention_backward``."""
    k, v, window, seg, drop, kvq = _backward_args(
        q, k, v, causal, dropout_rate, dropout_seed, window, segment_ids,
        k_scale, v_scale, kv_layout, kv_scale_mode)
    return _run_backward(_fused, q, k, v, o, lse, do, dlse, causal, scale,
                         q_offset, window, seg, impl, drop, kvq)


def _fused(q, k, v, lse, do, delta, causal, scale, q_offset, window, seg,
           impl, drop=None, kvq=None):
    if resolve_impl(impl, q) == "plain":
        return flash_attention_backward_plain(
            q, k, v, None, lse, do, causal=causal, scale=scale,
            q_offset=q_offset, window=window, segment_ids=seg, drop=drop,
            kvq=kvq, delta=delta)
    return _launch_backward(*_delta_inputs(q, k, v, lse, do, delta,
                                           kvq is not None),
                            causal, scale, q_offset, window, seg, drop, kvq)


def flash_attention_backward_two_pass(q, k, v, o, lse, do, dlse=None, *,
                                      causal=False, scale=None,
                                      q_offset=None, dropout_rate=0.0,
                                      dropout_seed=0, window=None,
                                      segment_ids=None, k_scale=None,
                                      v_scale=None, kv_layout="ld",
                                      kv_scale_mode="token",
                                      impl: str | None = None):
    """The two passes (``csrc/flash_attention_bwd_two_pass.cu``): the dK/dV
    pass, then the dQ pass, from one ``D``; returns ``(dq, dk, dv)``.
    Deterministic: no atomics, each output written once.
    The other arguments as in ``flash_attention_backward``."""
    k, v, window, seg, drop, kvq = _backward_args(
        q, k, v, causal, dropout_rate, dropout_seed, window, segment_ids,
        k_scale, v_scale, kv_layout, kv_scale_mode)
    return _run_backward(_two_pass, q, k, v, o, lse, do, dlse, causal,
                         scale, q_offset, window, seg, impl, drop, kvq)


def _two_pass(q, k, v, lse, do, delta, causal, scale, q_offset, window, seg,
              impl, drop=None, kvq=None):
    if resolve_impl(impl, q) == "plain":
        args = (q, k, v, do, lse, delta, causal, scale, q_offset, window,
                seg, drop, kvq)
        dk, dv = _dkv_plain(*args)
        return _dq_plain(*args), dk, dv
    args = (*_delta_inputs(q, k, v, lse, do, delta, kvq is not None),
            causal, scale, q_offset, window, seg, drop, kvq)
    dk, dv = _launch_dkv(*args)
    return _launch_dq(*args), dk, dv


def flash_attention_backward(q, k, v, o, lse, do, dlse=None, *,
                             causal=False, scale=None, q_offset=None,
                             dropout_rate=0.0, dropout_seed=0, window=None,
                             segment_ids=None, k_scale=None, v_scale=None,
                             kv_layout="ld", kv_scale_mode="token",
                             impl: str | None = None):
    """Flash-attention backward; returns ``(dq, dk, dv)`` in q's dtype, dk
    and dv ``[B, Hkv, Lk, d]``.  ``dlse`` is a cotangent on the logsumexp
    output (it shifts ``D``).  The form is the JAX package's for these
    shapes (``backward_form.two_pass``, on q's itemsize): the fused single
    pass, or the two passes.  ``dropout_rate`` and ``dropout_seed`` (the
    forward's, so that the mask is the same), ``window``, ``segment_ids``,
    the quantized K/V's codes and scales and ``impl`` as in the forward
    (the rule takes the window); with quantized K/V, dK and dV are the
    gradients of the dequantized K/V (straight-through)."""
    k, v, window, seg, drop, kvq = _backward_args(
        q, k, v, causal, dropout_rate, dropout_seed, window, segment_ids,
        k_scale, v_scale, kv_layout, kv_scale_mode)
    return _backward(q, k, v, o, lse, do, dlse, causal, scale, q_offset,
                     window, seg, impl, drop, kvq)


def _backward(q, k, v, o, lse, do, dlse, causal, scale, q_offset, window,
              seg, impl, drop=None, kvq=None):
    """The backward in the JAX rule's form on a validated mask, dropout and
    quantization (``check_mask``'s, ``check_dropout``'s and
    ``check_kv_quant``'s results)."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    form = (_two_pass if two_pass(Lq, Lk, d, q.element_size(), bool(causal),
                                  _defaults(d, Lq, Lk, scale, q_offset)[1],
                                  window)
            else _fused)
    return _run_backward(form, q, k, v, o, lse, do, dlse, causal, scale,
                         q_offset, window, seg, impl, drop, kvq)


def _run_backward(form, q, k, v, o, lse, do, dlse, causal, scale, q_offset,
                  window, seg, impl, drop, kvq):
    """``form`` (``_fused`` or ``_two_pass``) from D of the raw dO and O;
    channel scales fold into q and dO before it and unfold dQ, dK and dV
    after it (the JAX entry, :1843-1866)."""
    _, _, _, Lq, Lk, d = _shapes(q, k, v)
    scale, q_offset = _defaults(d, Lq, Lk, scale, q_offset)
    delta = _delta(o, do, dlse)
    if kvq is None or kvq.token:
        return form(q, k, v, lse, do, delta, causal, scale, q_offset, window,
                    seg, impl, drop, kvq)
    g = q.shape[1] // k.shape[1]
    dq, dk, dv = form(_channel(q, kvq.k_scale, g), k, v, lse,
                      _channel(do, kvq.v_scale, g), delta, causal, scale,
                      q_offset, window, seg, impl, drop, kvq.inside())
    return (_channel(dq, kvq.k_scale, g),
            (dk.float() / kvq.k_scale[:, :, None, :]).to(dk.dtype),
            (dv.float() / kvq.v_scale[:, :, None, :]).to(dv.dtype))
