"""Plain PyTorch oracles, counterpart of ``tpu_flash/ops/reference.py``:
the causal mask, naive attention, and the tiled FlashAttention-1 and -2
forward oracles (the executable specs the attention kernels are held
against).  Causal masking adds ``MASK_VALUE`` (-1e7), as the reference
does."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpu_flash_torch.kernels.common import MASK_VALUE


def default_scale(head_dim: int) -> float:
    """tau = sqrt(1/d)."""
    return 1.0 / math.sqrt(head_dim)


def causal_mask(seq_q: int, seq_k: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal mask ``[seq_q, seq_k]``: 0 on and below the
    bottom-right-aligned diagonal, ``MASK_VALUE`` above."""
    q_ids = torch.arange(seq_q, device=device)[:, None] + (seq_k - seq_q)
    k_ids = torch.arange(seq_k, device=device)[None, :]
    return torch.where(k_ids <= q_ids, 0.0, MASK_VALUE).to(dtype)


def naive_attention(q, k, v, *, causal: bool = False, mask=None,
                    scale: float | None = None) -> torch.Tensor:
    """Materialized ``softmax(q k^T * tau + mask) v`` over ``[..., L, d]``
    inputs; ``mask`` is additive and broadcasts against the scores.
    Differentiable with autograd."""
    if scale is None:
        scale = default_scale(q.shape[-1])
    s = (q @ k.transpose(-1, -2)) * scale
    if causal:
        s = s + causal_mask(q.shape[-2], k.shape[-2], s.dtype, s.device)
    if mask is not None:
        s = s + mask
    return torch.softmax(s, dim=-1) @ v


class FA1Residuals(NamedTuple):
    out: torch.Tensor  # [B, H, L, d]
    l: torch.Tensor    # [B, H, L] running row-sum of exp
    m: torch.Tensor    # [B, H, L] running row-max


class FA2Residuals(NamedTuple):
    out: torch.Tensor  # [B, H, L, d]
    lse: torch.Tensor  # [B, H, L] logsumexp L = m + log(l)


def _tile_scores(qi, kj, scale, causal, i0, j0):
    s = (qi @ kj.transpose(-1, -2)) * scale
    if causal:
        rows = i0 + torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = j0 + torch.arange(s.shape[-1], device=s.device)[None, :]
        s = s + torch.where(cols <= rows, 0.0, MASK_VALUE)
    return s


def flash_attention1_fw_reference(q, k, v, *, causal: bool = False,
                                  block_q: int = 16,
                                  block_k: int = 16) -> FA1Residuals:
    """FA1 forward: K/V tiles outer, Q tiles inner, rescale-and-accumulate
    of the already-normalized output.  q, k, v ``[B, H, L, d]``; a test
    oracle, not a production path."""
    B, H, L, d = q.shape
    scale = default_scale(d)
    q, k, v = (x.float() for x in (q, k, v))
    o = torch.zeros_like(q)
    l = torch.zeros(B, H, L, device=q.device)
    m = torch.full((B, H, L), -math.inf, device=q.device)
    for j0 in range(0, L, block_k):
        kj, vj = k[..., j0:j0 + block_k, :], v[..., j0:j0 + block_k, :]
        for i0 in range(0, L, block_q):
            if causal and j0 > i0 + block_q - 1:
                continue        # whole tile above the diagonal
            sl = slice(i0, i0 + block_q)
            s = _tile_scores(q[..., sl, :], kj, scale, causal, i0, j0)
            mij = s.amax(-1)
            pij = torch.exp(s - mij[..., None])
            lij = pij.sum(-1)
            mi, li = m[..., sl], l[..., sl]
            mi_new = torch.maximum(mi, mij)
            alpha = torch.exp(mi - mi_new)
            beta = torch.exp(mij - mi_new)
            li_new = alpha * li + beta * lij
            oi_new = ((li * alpha)[..., None] * o[..., sl, :]
                      + beta[..., None] * (pij @ vj)) / li_new[..., None]
            o[..., sl, :] = oi_new
            l[..., sl] = li_new
            m[..., sl] = mi_new
    return FA1Residuals(o, l, m)


def flash_attention2_fw_reference(q, k, v, *, causal: bool = False,
                                  block_q: int = 16,
                                  block_k: int = 16) -> FA2Residuals:
    """FA2 forward: per Q tile, stream K/V tiles into an unnormalized
    accumulator; divide by l once and store the logsumexp."""
    B, H, L, d = q.shape
    scale = default_scale(d)
    q, k, v = (x.float() for x in (q, k, v))
    out = torch.zeros_like(q)
    lse = torch.zeros(B, H, L, device=q.device)
    for i0 in range(0, L, block_q):
        sl = slice(i0, i0 + block_q)
        qi = q[..., sl, :]
        br = qi.shape[-2]
        oi = torch.zeros(B, H, br, d, device=q.device)
        li = torch.zeros(B, H, br, device=q.device)
        mi = torch.full((B, H, br), -math.inf, device=q.device)
        for j0 in range(0, L, block_k):
            if causal and j0 > i0 + block_q - 1:
                continue
            kj, vj = k[..., j0:j0 + block_k, :], v[..., j0:j0 + block_k, :]
            s = _tile_scores(qi, kj, scale, causal, i0, j0)
            mi_new = torch.maximum(mi, s.amax(-1))
            p = torch.exp(s - mi_new[..., None])
            alpha = torch.exp(mi - mi_new)
            li = alpha * li + p.sum(-1)
            oi = alpha[..., None] * oi + p @ vj
            mi = mi_new
        out[..., sl, :] = oi / li[..., None]
        lse[..., sl] = mi + torch.log(li)
    return FA2Residuals(out, lse)
