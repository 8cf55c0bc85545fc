"""Functional ops, counterpart of ``tpu_flash/nn/functional.py`` (the part
the serving path uses)."""

from __future__ import annotations

import math

import torch


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    m = x.amax(dim=dim, keepdim=True)
    e = torch.exp(x - m)
    return e / e.sum(dim=dim, keepdim=True)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximate GELU, the JAX package's formula."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def dropout(x: torch.Tensor, p: float, *, training: bool = False
            ) -> torch.Tensor:
    """Identity at inference.  Training dropout comes with the training
    step (ROADMAP.md, queue A item A3)."""
    if training and p > 0.0:
        raise NotImplementedError(
            "training dropout is not ported yet (ROADMAP.md, queue A item A3)")
    return x
