"""Basic layers, counterpart of ``tpu_flash/nn/layers.py``.

The JAX package keeps parameters in an external tree; here they live in
``torch.nn`` modules.  Initial values follow the same distributions
(``nn.module.init_params``): Linear weight and bias ~ U(-1/sqrt(in),
1/sqrt(in)), Embedding ~ N(0, 1), LayerNorm gamma = 1 and beta = 0.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.ops.fused import layer_norm as fused_layer_norm


class Linear(torch.nn.Linear):
    """``y = x @ W^T + b`` with ``W`` stored ``[out, in]``: the transpose of
    the JAX package's ``[in, out]`` weight (``nn.module.load_jax_params``
    transposes on load).  An input of another dtype than the weight is
    computed in the promoted dtype, as JAX's ``x @ W + b`` is: an fp32
    activation (the fused ops' composed route) meets bf16 weights."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return torch.nn.functional.linear(x.to(dt), self.weight.to(dt), bias)


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
    """Row LayerNorm over the last axis.  ``fused=False`` composes tensor
    ops with the given ``eps``: ``var = mean((x - mean)^2)``.
    ``fused=True`` runs ``ops.fused.layer_norm`` (the fused kernels, or the
    composed fp32 route above its size limit), whose eps is pinned to 1e-8
    and whose ``var = E[x^2] - mean^2``, whatever ``eps`` says, as in the
    JAX package."""

    def __init__(self, dim: int, eps: float = 1e-5, fused: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.fused = fused
        self.gamma = torch.nn.Parameter(
            torch.ones(dim, dtype=dtype, device=device))
        self.beta = torch.nn.Parameter(
            torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, *, impl=None) -> torch.Tensor:
        """``impl`` reaches the fused kernels' wrappers."""
        if self.fused:
            return fused_layer_norm(x, self.gamma, self.beta, impl=impl)
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mean).mean(dim=-1, keepdim=True)
        xhat = (x - mean) * torch.rsqrt(var + self.eps)
        return xhat * self.gamma + self.beta
