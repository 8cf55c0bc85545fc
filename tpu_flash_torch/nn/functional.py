"""Functional ops, counterpart of ``tpu_flash/nn/functional.py``: softmax,
logsumexp and logsoftmax, tanh-GELU, dropout and the cross-entropy loss.
``chunked_softmax_loss`` is not ported yet (ROADMAP.md, queue A item A4)."""

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
