"""Differentiable fused masked softmax and LayerNorm, counterpart of
``tpu_flash/ops/fused.py``.

``attn_softmax`` and ``layer_norm`` are ``torch.autograd.Function``s (the
JAX package's ``custom_vjp``s) over the kernels of ``kernels.softmax`` and
``kernels.layernorm``: the softmax saves its output probabilities and its
backward runs ``attn_softmax_backward`` (the additive pad mask gets no
gradient); LayerNorm saves ``(x, gamma, mean, var)`` and its backward runs
``layernorm_backward``.  ``layer_norm_with_stats`` is the forward's full
``(y, mean, var)``, not differentiable.

Size dispatch, as in the JAX package: with ``impl=None`` and no process
default (``ops.registry``), a last axis longer than
``_FUSED_SOFTMAX_PALLAS_MAX`` (softmax) or ``_FUSED_LN_PALLAS_MAX``
(LayerNorm) takes the composed route, the fp32
oracles of ``ops.reference`` under autograd, whose result is fp32 whatever
the input dtype; at or below it the kernel route runs (the CUDA kernel for
CUDA tensors, its plain version for CPU tensors), in the input dtype.
``impl="kernel"`` or ``"plain"`` forces that route at any size.  The
sharded form under a parallel context (``shard_map``) is not ported yet
(ROADMAP.md, queue A item A8).
"""

from __future__ import annotations

import torch

from tpu_flash_torch.kernels.layernorm import (
    layernorm_backward,
    layernorm_forward,
)
from tpu_flash_torch.kernels.softmax import (
    attn_softmax_backward,
    attn_softmax_forward,
)
from tpu_flash_torch.ops import reference as ref
from tpu_flash_torch.ops.registry import resolve_impl

# Above these last-axis sizes impl=None takes the composed route.  The JAX
# package chose 512 from TPU timings; the port keeps the split for parity
# with its outputs there (fp32 activations, the causal mask added rather
# than replaced), not for speed: on the H100 the composed route is the
# slower one above 512 (chip_smoke.py's fused_dispatch phase, PERF.md).
_FUSED_SOFTMAX_PALLAS_MAX = 512
_FUSED_LN_PALLAS_MAX = 512


class _AttnSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pad_mask, mask_future, impl):
        prob = attn_softmax_forward(x, pad_mask, mask_future=mask_future,
                                    impl=impl)
        ctx.save_for_backward(prob)
        ctx.impl = impl
        return prob

    @staticmethod
    def backward(ctx, dprob):
        (prob,) = ctx.saved_tensors
        dx = attn_softmax_backward(prob, dprob, impl=ctx.impl)
        return dx, None, None, None


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, impl):
        y, mean, var = layernorm_forward(x, gamma, beta, impl=impl)
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.impl = impl
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, var = ctx.saved_tensors
        return (*layernorm_backward(dy, x, gamma, mean, var, impl=ctx.impl),
                None)


def attn_softmax(x, pad_mask=None, *, mask_future: bool = False,
                 impl: str | None = None) -> torch.Tensor:
    """Fused masked softmax over ``[B, H, Lq, Lk]`` scores; differentiable
    in ``x``.  ``pad_mask`` is an additive ``[B, Lk]`` mask,
    ``mask_future`` the causal mask (``kernels.softmax`` for the masking
    rules of the kernel route)."""
    impl = resolve_impl(impl)
    if impl is None and x.shape[-1] > _FUSED_SOFTMAX_PALLAS_MAX:
        return ref.attn_softmax_reference(x, pad_mask,
                                          mask_future=mask_future)
    return _AttnSoftmax.apply(x, pad_mask, mask_future, impl)


def layer_norm(x, gamma, beta, *, impl: str | None = None) -> torch.Tensor:
    """Fused row LayerNorm over the last axis (eps 1e-8, ``var = E[x^2] -
    mean^2``); differentiable in ``x``, ``gamma`` and ``beta``."""
    impl = resolve_impl(impl)
    if impl is None and x.shape[-1] > _FUSED_LN_PALLAS_MAX:
        return ref.layernorm_fw_reference(x, gamma, beta).out
    return _LayerNorm.apply(x, gamma, beta, impl)


@torch.no_grad()
def layer_norm_with_stats(x, gamma, beta, *, impl: str | None = None):
    """The forward's ``(y, mean, var)`` on the kernel route at any size;
    not differentiable."""
    return layernorm_forward(x, gamma, beta, impl=impl)
