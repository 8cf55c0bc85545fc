"""Basic layers, counterpart of ``tpu_flash/nn/layers.py``.

The JAX package keeps parameters in an external tree; here they live in
``torch.nn`` modules.  Initial values follow the same distributions
(``nn.module.init_params``): Linear weight and bias ~ U(-1/sqrt(in),
1/sqrt(in)), Embedding ~ N(0, 1), LayerNorm gamma = 1 and beta = 0.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.nn import functional as F


class Linear(torch.nn.Linear):
    """``y = x @ W^T + b`` with ``W`` stored ``[out, in]``: the transpose of
    the JAX package's ``[in, out]`` weight (``nn.module.load_jax_params``
    transposes on load)."""


class Embedding(torch.nn.Embedding):
    """Row gather.  (The JAX package's one-hot matmul variant is not
    ported: ROADMAP.md, queue A item A7.)"""


class Dropout(torch.nn.Module):
    """Inverted dropout; active only with ``training=True`` and a
    ``generator`` (``functional.dropout``)."""

    def __init__(self, p_dropout: float = 0.1):
        super().__init__()
        self.p = float(p_dropout)

    def forward(self, x: torch.Tensor, *, training: bool = False,
                generator: torch.Generator | None = None):
        return F.dropout(x, self.p, generator=generator, training=training)


class LayerNorm(torch.nn.Module):
    """Row LayerNorm over the last axis, composed of tensor ops with the
    given ``eps``: ``var = mean((x - mean)^2)``.  The fused kernel
    (``fused=True``) is not ported yet (ROADMAP.md, queue A item A2)."""

    def __init__(self, dim: int, eps: float = 1e-5, fused: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        if fused:
            raise NotImplementedError(
                "the fused LayerNorm kernel is not ported yet "
                "(ROADMAP.md, queue A item A2)")
        self.dim = dim
        self.eps = eps
        self.gamma = torch.nn.Parameter(
            torch.ones(dim, dtype=dtype, device=device))
        self.beta = torch.nn.Parameter(
            torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mean).mean(dim=-1, keepdim=True)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return xhat * self.gamma + self.beta
