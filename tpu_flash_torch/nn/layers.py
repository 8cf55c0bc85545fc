"""Basic layers, counterpart of ``tpu_flash/nn/layers.py``.

The JAX package keeps parameters in an external tree; here they live in
``torch.nn`` modules.  Initial values follow the same distributions
(``nn.module.init_params``): Linear weight and bias ~ U(-1/sqrt(in),
1/sqrt(in)), Embedding ~ N(0, 1), LayerNorm gamma = 1 and beta = 0.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.kernels.quant import (
    QuantizedLinearWeights,
    QuantizedLinearWeights4,
    int4_linear,
    int8_linear,
    quantize_weight,
    quantize_weight_int4,
)
from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.ops.fused import layer_norm as fused_layer_norm


class Linear(torch.nn.Linear):
    """``y = x @ W^T + b`` with ``W`` stored ``[out, in]``: the transpose of
    the JAX package's ``[in, out]`` weight (``nn.module.load_jax_params``
    transposes on load).  An input of another dtype than the weight is
    computed in the promoted dtype, as JAX's ``x @ W + b`` is: an fp32
    activation (the fused ops' composed route) meets bf16 weights."""

    def forward(self, x: torch.Tensor, *, impl=None) -> torch.Tensor:
        """``impl`` is taken for the model's uniform call and ignored: the
        float product is cuBLAS's, outside any ported kernel."""
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


class QuantizedLinear(torch.nn.Module):
    """A Linear with weight-only int8 or packed-int4 weights, the port of
    the JAX package's ``{"codes" | "codes4", "scales", "bias"}`` Linear.

    ``codes`` (int8 ``[in, out]``) or ``codes4`` (uint8
    ``[ceil(in/2), out]``) and ``scales`` (fp32 ``[out]``, or ``[in/g,
    out]`` by group) are buffers in the JAX layout; ``bias`` stays a
    parameter, as in the JAX tree.  ``in_size`` is the true K of a packed
    weight.  Made by ``quantize_linear_params``."""

    def __init__(self, in_size: int, codes: torch.Tensor,
                 scales: torch.Tensor, bias: torch.Tensor | None):
        super().__init__()
        self.in_size = in_size
        self.out_size = codes.shape[1]
        self.bits = 8 if codes.dtype == torch.int8 else 4
        self.register_buffer("codes" if self.bits == 8 else "codes4",
                             codes.contiguous())
        self.register_buffer("scales", scales.float().contiguous())
        self.bias = None if bias is None else torch.nn.Parameter(bias)

    def forward(self, x: torch.Tensor, *, impl=None) -> torch.Tensor:
        """``x [..., in] -> [..., out]`` in x's dtype, the bias added in
        the promoted dtype.  ``impl`` reaches the matmul kernels' wrappers."""
        if self.bits == 8:
            return int8_linear(x, QuantizedLinearWeights(
                self.codes, self.scales, self.bias), impl=impl)
        return int4_linear(x, QuantizedLinearWeights4(
            self.codes4, self.scales, self.in_size, self.bias), impl=impl)


@torch.no_grad()
def quantize_linear_params(linear: Linear, *, bits: int = 8,
                           group_size: int | None = None,
                           allow_small_groups: bool = False
                           ) -> QuantizedLinear:
    """One Linear to its int8 (``bits=8``) or packed-int4 (``bits=4``,
    optionally by ``group_size``) weight-only form, quantizing the JAX
    layout ``W^T [in, out]``.  A layer whose K does not divide into whole
    groups per half takes per-column int4 scales, as in the JAX package."""
    # contiguous: codes computed from the transposed view would keep its
    # column-major strides, and every launch would copy them
    w = linear.weight.detach().T.contiguous()
    if bits == 4:
        g = group_size
        if g is not None and w.shape[0] % (2 * g):
            g = None               # indivisible layer: per-column fallback
        codes, scales, _ = quantize_weight_int4(
            w, group_size=g, allow_small_groups=allow_small_groups)
    elif bits == 8:
        codes, scales = quantize_weight(w, axis=0)
    else:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    bias = None if linear.bias is None else linear.bias.detach().clone()
    return QuantizedLinear(linear.in_features, codes, scales, bias)


def quantize_model_linears(model: torch.nn.Module, *, skip=("ln",),
                           bits: int = 8, group_size: int | None = None,
                           allow_small_groups: bool = False
                           ) -> torch.nn.Module:
    """Replace, in place, every ``Linear`` of ``model`` that the JAX
    package's ``quantize_model_linears`` would quantize by its
    ``QuantizedLinear``, and return ``model``.  (The JAX function is pure
    and returns a new parameter tree; here the module is changed.)  As
    there, a layer is left alone when its dotted name contains one of
    ``skip`` or ``"embedding"``: every projection, the feed-forward layers
    and ``lm_head`` are quantized, embeddings and LayerNorms are not."""
    for name, m in list(model.named_modules()):
        key = f".{name}"
        if (not name or not isinstance(m, Linear)
                or any(s in key for s in skip) or "embedding" in key):
            continue
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        setattr(parent, child, quantize_linear_params(
            m, bits=bits, group_size=group_size,
            allow_small_groups=allow_small_groups))
    return model
