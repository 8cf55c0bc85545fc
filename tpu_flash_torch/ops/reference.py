"""Plain PyTorch oracles, counterpart of ``tpu_flash/ops/reference.py``:
the causal, sliding-window and segment masks, the attention-dropout keep
multiplier, naive attention, the tiled FlashAttention-1 and -2 forward and
backward oracles (the executable specs the attention kernels are held
against), and the composed masked softmax and LayerNorm that
``ops.fused`` takes above its size limits.  Causal masking adds
``MASK_VALUE`` (-1e7), as the reference does."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpu_flash_torch.kernels.common import MASK_VALUE
from tpu_flash_torch.kernels.flash_attention import (
    Dropout,
    dropout_keep_blocks,
    dropout_seed_array,
)
from tpu_flash_torch.kernels.layernorm import (
    LN_EPS,
    layernorm_backward_plain,
    layernorm_forward_plain,
)
from tpu_flash_torch.kernels.softmax import SOFTMAX_EPS


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


def window_mask(seq_q: int, seq_k: int, window: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive sliding-window lower-bound mask ``[seq_q, seq_k]`` (combine
    with ``causal_mask``): bottom-right-aligned row r attends keys in
    ``(r + offset - window, r + offset]``; -1e9 behind the band."""
    offset = seq_k - seq_q
    rows = torch.arange(seq_q, device=device)[:, None] + offset
    cols = torch.arange(seq_k, device=device)[None, :]
    return torch.where(cols > rows - window, 0.0, -1e9).to(dtype)


def apply_segment_mask(s: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Cross-segment scores of ``s`` ``[B, H, Lq, Lk]`` set to
    ``MASK_VALUE`` given segment ids ``seg`` ``[B, L]`` (packed-sequence
    attention; set rather than added, as the kernels mask in-tile)."""
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return torch.where(same, s, torch.tensor(MASK_VALUE, dtype=s.dtype,
                                             device=s.device))


def dropout_keep_oracle(B: int, H: int, Lq: int, Lk: int, seed, rate: float,
                        device=None) -> torch.Tensor:
    """The attention-dropout multiplier of the whole ``[B, H, Lq, Lk]``
    probability tensor, fp32: ``1 / (1 - rate)`` where the kernels keep an
    entry and 0 where they drop it (the JAX package's
    ``dropout_keep_oracle``, ops/reference.py:374).  ``seed`` as the ops
    take it: an int, or an int32 tensor ``[seed, batch offset, head
    offset]`` (1 to 3 values), whose offsets shift the batch and head
    indices as in the kernels.  On ``device``, else the seed tensor's
    device, else the CPU."""
    if device is None:
        device = seed.device if isinstance(seed, torch.Tensor) else "cpu"
    drop = Dropout(dropout_seed_array(seed, torch.device(device)),
                   float(rate))
    out = torch.empty(B, H, Lq, Lk, dtype=torch.float32, device=device)
    for rows, keep in dropout_keep_blocks(B, H, Lq, Lk, drop):
        out[:, :, rows] = keep
    return out


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


def flash_attention1_bw_reference(q, k, v, o, l, m, do, *,
                                  causal: bool = False, block_q: int = 16,
                                  block_k: int = 16):
    """FA1 backward: K/V tiles outer, Q tiles inner; S and ``P = exp(S -
    m) / l`` recomputed per tile from the saved ``l, m``, ``D =
    rowsum(dO * O)``.  Returns ``(dq, dk, dv)``, fp32."""
    return _bw_reference(q, k, v, o, do, causal, block_q, block_k,
                         lambda s, sl: (torch.exp(s - m[..., sl, None])
                                        / l[..., sl, None]))


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


def flash_attention2_bw_reference(q, k, v, o, lse, do, *,
                                  causal: bool = False, block_q: int = 16,
                                  block_k: int = 16):
    """FA2 backward: the same tile loops with ``P = exp(S - lse)`` from the
    saved logsumexp (the JAX oracle adds each tile's dQ where the reference
    kernel adds it atomically).  Returns ``(dq, dk, dv)``, fp32."""
    return _bw_reference(q, k, v, o, do, causal, block_q, block_k,
                         lambda s, sl: torch.exp(s - lse[..., sl, None]))


def _bw_reference(q, k, v, o, do, causal, block_q, block_k, probs):
    """The FA1/FA2 backward tile loops; ``probs(s, rows)`` recomputes a
    tile's P from its scores and the saved statistics of its rows."""
    B, H, L, d = q.shape
    scale = default_scale(d)
    q, k, v, o, do = (x.float() for x in (q, k, v, o, do))
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    D = (do * o).sum(-1)
    for j0 in range(0, L, block_k):
        cols = slice(j0, j0 + block_k)
        kj, vj = k[..., cols, :], v[..., cols, :]
        for i0 in range(0, L, block_q):
            if causal and j0 > i0 + block_q - 1:
                continue
            rows = slice(i0, i0 + block_q)
            qi, doi = q[..., rows, :], do[..., rows, :]
            p = probs(_tile_scores(qi, kj, scale, causal, i0, j0), rows)
            dv[..., cols, :] += p.transpose(-1, -2) @ doi
            ds = p * (doi @ vj.transpose(-1, -2) - D[..., rows, None])
            dq[..., rows, :] += scale * (ds @ kj)
            dk[..., cols, :] += scale * (ds.transpose(-1, -2) @ qi)
    return dq, dk, dv


# --- fused masked attention-softmax and LayerNorm (composed forms) ---------
# SOFTMAX_EPS (1e-8) is added to the softmax denominator, LN_EPS (1e-8) sits
# inside the fused LayerNorm's rsqrt, as in the kernels.


def attn_softmax_reference(x, pad_mask=None, *, mask_future: bool = False):
    """Masked softmax over the last axis of ``[B, H, Lq, Lk]`` scores, in
    fp32 (the result is fp32 whatever ``x``'s dtype).  ``pad_mask`` is an
    additive ``[B, Lk]`` mask broadcast over heads and query rows;
    ``mask_future`` adds the causal mask (bottom-right diagonal).
    ``SOFTMAX_EPS`` is added to the denominator."""
    x = x.float()
    if pad_mask is not None:
        x = x + pad_mask[:, None, None, :].float()
    if mask_future:
        x = x + causal_mask(x.shape[-2], x.shape[-1], device=x.device)
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp(x - m)
    return e / (e.sum(dim=-1, keepdim=True) + SOFTMAX_EPS)


def attn_softmax_bw_reference(prob, dprob):
    """``dx = P * (dP - sum(dP * P))`` per row."""
    row = (dprob * prob).sum(dim=-1, keepdim=True)
    return prob * (dprob - row)


class LNResiduals(NamedTuple):
    out: torch.Tensor   # y, fp32
    mean: torch.Tensor  # [...] fp32
    var: torch.Tensor   # [...] fp32, E[x^2] - mean^2


def layernorm_fw_reference(x, gamma, beta) -> LNResiduals:
    """Row LayerNorm over the last axis in fp32, returning ``(y, mean,
    var)`` with ``var = E[x^2] - mean^2`` and ``LN_EPS`` in the rsqrt: the
    kernel's plain version on the fp32 input, differentiable with
    autograd."""
    return LNResiduals(*layernorm_forward_plain(x.float(), gamma, beta))


def layernorm_bw_reference(dy, x, gamma, mean, var):
    """Backward of the row LayerNorm from the saved ``(mean, var)``:
    ``dx = (dxhat - (sum(dxhat) + xhat * sum(dxhat * xhat)) / H) * rstd``,
    and ``dgamma``, ``dbeta`` summed over every row.  Returns ``(dx,
    dgamma, dbeta)``, fp32."""
    return layernorm_backward_plain(dy.float(), x.float(), gamma.float(),
                                    mean, var)
