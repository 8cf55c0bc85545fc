"""KV cache for incremental decode, counterpart of
``tpu_flash/inference/kv_cache.py``.

Layout and formats are the JAX package's:
  * fixed ``max_len`` buffers, HEADS-MINOR ``[B, max_len, H*d]``: one
    position's keys for all heads are one contiguous row, and one head's
    stripe is ``d`` contiguous values, which the decode kernel streams;
  * per-sequence ``lengths`` ``[B]`` (int32, on the device) for ragged
    batches;
  * storage in the compute dtype, or int8 / float8_e4m3fn codes with
    per-(sequence, head, position) fp32 scales ``[B, H, max_len]``.

Unlike the JAX cache, which is immutable, this one is updated IN PLACE:
``update`` and ``append`` write the new rows into the buffers and advance
``lengths``, and return the same object.  A write that would run past
``max_len`` starts at ``max_len - Lnew`` instead and overwrites the tail, as
``lax.dynamic_update_slice`` clamps its start; the serving engine relies on
that for idle slots.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from tpu_flash_torch.kernels.common import MASK_VALUE, resolve_device

QuantMode = Literal["none", "int8", "fp8"]

_INT8_MAX = 127.0
_FP8_MAX = 448.0  # max normal of float8_e4m3fn
_CODE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quantize(x: torch.Tensor, mode: QuantMode):
    """Symmetric quantization over the last (head_dim) axis: amax/127 or
    amax/448 per row, a zero scale replaced by 1, int8 rounded half to even.
    Returns (codes shaped like x, fp32 scales ``x.shape[:-1]``)."""
    if mode == "none":
        return x, None
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    if mode == "int8":
        scale = amax / _INT8_MAX
        safe = torch.where(scale == 0.0, 1.0, scale)
        codes = torch.clamp(torch.round(x / safe), -127, 127).to(torch.int8)
    elif mode == "fp8":
        scale = amax / _FP8_MAX
        safe = torch.where(scale == 0.0, 1.0, scale)
        codes = (x / safe).to(torch.float8_e4m3fn)
    else:
        raise ValueError(mode)
    return codes, scale[..., 0]


def _write_rows(buf: torch.Tensor, val: torch.Tensor, start: torch.Tensor,
                dim: int) -> None:
    """``buf[b, ..., start[b] + j, ...] = val[b, ..., j, ...]`` along
    ``dim`` for every sequence b, without a host sync.  1-byte codes are
    written through a uint8 view."""
    if buf.element_size() == 1:
        buf, val = buf.view(torch.uint8), val.view(torch.uint8)
    n = val.shape[dim]
    idx = start[:, None] + torch.arange(n, device=start.device)   # [B, n]
    shape = [1] * val.dim()
    shape[0], shape[dim] = idx.shape
    buf.scatter_(dim, idx.view(shape).expand_as(val), val)


@dataclasses.dataclass
class KVCache:
    """Single-layer cache: k/v ``[B, max_len, H*d]`` (heads-minor codes),
    optional scales ``[B, H, max_len]`` and lengths ``[B]``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None
    lengths: torch.Tensor              # [B] int32: tokens already cached
    quant: str = "none"
    compute_dtype: torch.dtype = torch.float32
    # KV heads: the fused [B, max_len, H*d] layout is uninterpretable
    # without it, so it has no default.
    n_head: int = dataclasses.field(kw_only=True)

    @classmethod
    def create(cls, batch: int, n_head: int, max_len: int, head_dim: int, *,
               quant: QuantMode = "none", compute_dtype=torch.float32,
               device=None) -> "KVCache":
        device = resolve_device(device)
        if quant == "none":
            store_dtype, scales = compute_dtype, None
        elif quant in _CODE_DTYPES:
            store_dtype = _CODE_DTYPES[quant]
            scales = torch.zeros((batch, n_head, max_len), dtype=torch.float32,
                                 device=device)
        else:
            raise ValueError(quant)
        shape = (batch, max_len, n_head * head_dim)
        return cls(
            k=torch.zeros(shape, dtype=store_dtype, device=device),
            v=torch.zeros(shape, dtype=store_dtype, device=device),
            k_scale=scales,
            v_scale=None if scales is None else scales.clone(),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            quant=quant,
            compute_dtype=compute_dtype,
            n_head=n_head,
        )

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    @property
    def head_dim(self) -> int:
        return self.k.shape[2] // self.n_head

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor):
        """Write k_new/v_new ``[B, H, Lnew, d]`` at each sequence's length
        (clamped to ``max_len - Lnew``) and advance the lengths, in place.
        Returns (k_full, v_full, self): dequantized ``[B, H, max_len, d]``
        views for the multi-token prefill path."""
        self.append(k_new, v_new)
        return self.read_k(), self.read_v(), self

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "KVCache":
        """Like :meth:`update` but skips the dequantized views: the decode
        kernel reads the codes directly."""
        B, H, Lnew, d = k_new.shape
        start = torch.clamp(self.lengths, max=self.max_len - Lnew).long()
        for new, buf, scales in ((k_new, self.k, self.k_scale),
                                 (v_new, self.v, self.v_scale)):
            codes, s = _quantize(new, self.quant)   # [B,H,Lnew,d] / [B,H,Lnew]
            rows = codes.transpose(1, 2).reshape(B, Lnew, H * d)
            _write_rows(buf, rows.to(buf.dtype), start, 1)
            if scales is not None:
                _write_rows(scales, s, start, 2)
        self.lengths += Lnew
        return self

    def _read(self, codes, scales) -> torch.Tensor:
        """Dequantize and de-interleave to ``[B, H, max_len, d]``."""
        B, S, HD = codes.shape
        H = self.n_head
        x = codes.view(B, S, H, HD // H).transpose(1, 2)
        if scales is None:
            return x.to(self.compute_dtype)
        return (x.float() * scales[..., None]).to(self.compute_dtype)

    def read_k(self) -> torch.Tensor:
        return self._read(self.k, self.k_scale)

    def read_v(self) -> torch.Tensor:
        return self._read(self.v, self.v_scale)

    def attention_mask(self, n_queries: int) -> torch.Tensor:
        """Additive mask ``[B, n_queries, max_len]``: query i (the i-th of
        the ``n_queries`` newest tokens) attends positions
        ``<= lengths - n_queries + i`` (lengths counted after the update)."""
        dev = self.lengths.device
        pos = torch.arange(self.max_len, device=dev)[None, None, :]
        qidx = torch.arange(n_queries, device=dev)[None, :, None]
        limit = (self.lengths[:, None, None] - n_queries) + qidx
        return torch.where(pos <= limit, 0.0, MASK_VALUE).float()
