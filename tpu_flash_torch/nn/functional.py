"""Functional ops, counterpart of ``tpu_flash/nn/functional.py``: softmax,
logsumexp and logsoftmax, tanh-GELU, ``one_hot``, dropout, the
cross-entropy loss, ``chunked_softmax_loss``, the fused lm_head +
cross-entropy that never materializes the logits, and ``apply_rope``."""

from __future__ import annotations

import math

import torch


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=dim, keepdim=True)


def logsumexp(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable logsumexp over ``dim`` (which is dropped)."""
    m = x.amax(dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.exp(x - m).sum(dim=dim))


def logsoftmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x - logsumexp(x, dim).unsqueeze(dim)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU, the JAX package's formula."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def one_hot(ids: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    """One-hot encoding, ``jax.nn.one_hot``'s: an id outside ``[0,
    num_classes)`` gives a row of zeros (``F.one_hot`` would raise)."""
    classes = torch.arange(num_classes, device=ids.device)
    return (ids[..., None] == classes).to(dtype)


def dropout(x: torch.Tensor, p: float, *,
            generator: torch.Generator | None = None, training: bool = True,
            rescale: bool = True) -> torch.Tensor:
    """Dropout; identity when not training, ``p == 0``, or no generator is
    given (the JAX package's rule for a missing key).

    The keep mask is drawn from ``generator`` (on ``x``'s device), keeping
    each entry with probability ``1 - p``; ``rescale`` divides the kept
    entries by ``1 - p``.  ``jax.random`` bits cannot be reproduced in
    torch, so the port drops other entries than the JAX package for the same
    seed: only the keep rate and the scaling are the same."""
    if not training or p <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    y = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return y / (1.0 - p) if rescale else y


def softmax_loss(logits: torch.Tensor,
                 target_ids: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy ``logsumexp(logits) - logits[target]``,
    with a gather rather than a one-hot."""
    picked = torch.gather(logits, -1, target_ids.long()[..., None])[..., 0]
    return logsumexp(logits, dim=-1) - picked


def chunked_softmax_loss(hidden: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None, labels: torch.Tensor, *,
                         n_chunks: int = 8, axis_name=None,
                         batch_axis=None) -> torch.Tensor:
    """Per-token ``softmax_loss(hidden @ weight^T + bias, labels)`` without
    the ``[N, V]`` logits: the vocab is taken in ``n_chunks`` slices with an
    online (max, sumexp, picked) triple, and the backward recomputes each
    slice's logits (``tpu_flash/nn/functional.py:82-280``).  Peak memory
    holds one ``[N, V / n_chunks]`` slice instead of the logits.

    ``hidden`` [..., E], ``weight`` [V, E] (the port's ``Linear`` layout,
    so dW lands in ``lm_head.weight.grad`` with no transposed copy),
    ``bias`` [V] or None, ``labels`` int [...].  Returns fp32 losses shaped
    like ``labels``.  Logits are fp32 products of the input dtype's values,
    as the JAX package's ``preferred_element_type=float32`` dots; the last
    chunk is padded to the chunk width with columns of -inf bias, which add
    exactly 0.  The ``axis_name`` / ``batch_axis`` (vocab- and data-parallel)
    forms are not ported yet (ROADMAP.md, queue A item A8)."""
    if axis_name is not None or batch_axis is not None:
        raise NotImplementedError(
            "the axis_name / batch_axis (sharded) forms of "
            "chunked_softmax_loss are not ported yet (ROADMAP.md, queue A "
            "item A8)")
    x = hidden.reshape(-1, hidden.shape[-1])
    y = labels.reshape(-1).long()
    if bias is None:
        bias = torch.zeros(weight.shape[0], device=weight.device)
    losses = _ChunkedSoftmaxLoss.apply(x, weight, bias, y,
                                       max(int(n_chunks), 1))
    return losses.reshape(labels.shape)


def _chunks(V: int, n_chunks: int):
    """``C = ceil(V / n_chunks)`` and the ``(c0, width)`` of each vocab
    slice: ``C`` columns each, the last one short where ``C`` does not
    divide ``V``."""
    C = -(-V // n_chunks)
    return C, [(c0, min(C, V - c0)) for c0 in range(0, n_chunks * C, C)
               if c0 < V]


def _chunk_logits(x32, w, b32, c0, width, C):
    """fp32 logits ``[N, C]`` of one slice; a short last slice is padded
    with -inf columns (the JAX package's -inf bias on its padded chunk)."""
    logits = x32 @ w[c0:c0 + width].float().T + b32[c0:c0 + width]
    if width < C:
        logits = torch.nn.functional.pad(logits, (0, C - width),
                                         value=-math.inf)
    return logits


class _ChunkedSoftmaxLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, y, n_chunks):
        C, chunks = _chunks(w.shape[0], n_chunks)
        x32, b32 = x.float(), b.float()
        N = x.shape[0]
        m = torch.full((N,), -math.inf, device=x.device)
        s = torch.zeros(N, device=x.device)
        picked = torch.zeros(N, device=x.device)
        for c0, width in chunks:
            logits = _chunk_logits(x32, w, b32, c0, width, C)
            new_m = torch.maximum(m, logits.amax(-1))
            shift = torch.where(torch.isneginf(new_m), 0.0, new_m)
            s = s * torch.exp(m - shift) + torch.exp(
                logits - shift[:, None]).sum(-1)
            rel = y - c0
            inside = (rel >= 0) & (rel < C)
            pc = torch.gather(logits, 1, rel.clamp(0, C - 1)[:, None])[:, 0]
            picked = torch.where(inside, pc, picked)
            m = new_m
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, b, y, lse)
        ctx.n_chunks = n_chunks
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        """Each slice's logits again; dW and db are written slice by slice
        (disjoint rows of ``weight``'s gradient, each computed once in fp32
        and cast once), dx summed in fp32 over the slices."""
        x, w, b, y, lse = ctx.saved_tensors
        C, chunks = _chunks(w.shape[0], ctx.n_chunks)
        x32, b32, g32 = x.float(), b.float(), g.float()
        dx = torch.zeros_like(x32)
        dw = torch.empty_like(w)
        db = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
        cols = torch.arange(C, device=x.device)
        for c0, width in chunks:
            logits = _chunk_logits(x32, w, b32, c0, width, C)
            p = torch.exp(logits - lse[:, None])
            rel = y - c0
            inside = (rel >= 0) & (rel < C)
            onehot = (cols[None, :] == rel.clamp(0, C - 1)[:, None]) \
                & inside[:, None]
            dlogits = ((p - onehot.float()) * g32[:, None])[:, :width]
            dx += dlogits @ w[c0:c0 + width].float()
            dw[c0:c0 + width] = (dlogits.to(x.dtype).float().T @ x32
                                 ).to(w.dtype)
            db[c0:c0 + width] = dlogits.sum(0)
        return dx.to(x.dtype), dw, db.to(b.dtype), None, None


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10_000.0) -> torch.Tensor:
    """Rotary position embedding over ``x`` [B, H, L, d] at ``positions``
    [B, L] (absolute token positions: a decode step passes the cache
    length), the JAX package's: the halves ``x[..., :d/2]`` and ``x[...,
    d/2:]`` (not interleaved pairs) rotate by ``positions * base **
    (-i / (d/2))``, the angles and the rotation in fp32, the result cast
    back to ``x.dtype``."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)
