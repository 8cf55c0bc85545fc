"""The differentiable flash-attention op, counterpart of
``tpu_flash/ops/attention.py``.

``flash_attention`` is a ``torch.autograd.Function`` (the JAX package's
``custom_vjp``, ops/attention.py:219-240): the forward runs
``kernels.flash_attention_forward`` and saves ``(q, k, v, out, lse)``; the
backward runs ``kernels.flash_attention_backward`` (both past their checks,
which ``flash_attention`` makes once), which recomputes
``P = exp(S - lse)`` in the form the JAX package takes for the shape
(``kernels.backward_form``, the TPU's rule, not retuned for the H100): the
fused single pass below its lengths, the two passes (dK/dV, then dQ) from
there on (bf16 causal from L = 16384, fp32 from 8192 at d = 64).  Both
are deterministic: two calls give the same bits.  ``version=1|2``
selects the FA1 ``(l, m)`` or FA2 ``lse`` residual convention of
``flash_attention_with_residuals``; both run the same kernels.
``impl``: ``None`` launches the CUDA kernels for CUDA tensors and runs
their plain versions for CPU tensors; ``"kernel"`` or
``"plain"`` forces one (the JAX package's ``"pallas"`` and
``"reference"``/``"xla"``).  ``window`` (sliding-window attention, requires
``causal``) and ``segment_ids`` (packed sequences, ``[B, L]``) reach every
kernel, forward and backward, validated as the JAX package validates them.
``dropout_rate`` and ``dropout_seed`` (attention dropout) reach every kernel
too: the forward saves the seed tensor, and the backward regenerates the
same keep mask from it.  Quantized K/V and the parallel (sharded) form are
not ported yet.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.kernels.flash_attention import (
    Dropout,
    _backward,
    _forward,
    check_dropout,
    check_mask,
    flash_attention_forward,
)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, impl, window, seg, seed, rate):
        # window and seg as flash_attention's check_mask returned them; seed
        # the int32 [3] device tensor of check_dropout (None: no dropout)
        q, k, v = (x.contiguous() for x in (q, k, v))
        drop = None if seed is None else Dropout(seed, rate)
        out, lse, _ = _forward(q, k, v, causal, None, None, False, window,
                               seg, impl, drop)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.impl, ctx.window, ctx.seg = causal, impl, window, seg
        ctx.drop = drop
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, do, None, ctx.causal,
                               None, None, ctx.window, ctx.seg, ctx.impl,
                               ctx.drop)
        return dq, dk, dv, None, None, None, None, None, None


def _check_version(version: int) -> None:
    if version not in (1, 2):
        raise ValueError(f"version must be 1 or 2, got {version}")


def flash_attention(q, k, v, *, causal: bool = False, version: int = 2,
                    impl: str | None = None, kv_quant: str = "none",
                    dropout_rate: float = 0.0, dropout_seed=0,
                    window: int | None = None,
                    segment_ids=None) -> torch.Tensor:
    """Flash attention over ``[B, H, L, d]`` inputs (k, v may carry fewer
    heads: GQA); differentiable.  Returns ``[B, H, Lq, d]`` in q's dtype.
    ``window`` (requires ``causal``): row r attends keys in
    ``(r - window, r]``; ``segment_ids`` (``[B, L]`` int, Lq == Lk): row r
    attends only keys of its own segment (composed with causal and
    window).  ``dropout_rate`` > 0: attention dropout on the softmax
    probabilities by the kernels' hash of ``dropout_seed`` (an int, or an
    int32 tensor ``[seed, batch offset, head offset]`` of 1 to 3 values,
    best on q's device, where nothing reads it back to the host); derive a
    fresh seed each step."""
    _check_version(version)
    if kv_quant != "none":
        raise NotImplementedError(
            "kv_quant in flash_attention is not ported yet (ROADMAP.md, "
            "queue A item A5, queue B item B3c)")
    window, seg = check_mask(q, k, causal, window, segment_ids)
    drop = check_dropout(q, dropout_rate, dropout_seed)
    seed, rate = (None, 0.0) if drop is None else drop
    return _FlashAttention.apply(q, k, v, causal, impl, window, seg, seed,
                                 rate)


@torch.no_grad()
def flash_attention_with_residuals(q, k, v, *, causal: bool = False,
                                   version: int = 2,
                                   impl: str | None = None):
    """Non-differentiable forward that also returns the saved residuals:
    ``(out, lse)`` for version 2, ``(out, l, m)`` for version 1 with
    ``l = exp(lse - m)``."""
    _check_version(version)
    out, lse, m = flash_attention_forward(q, k, v, causal=causal,
                                          with_m=version == 1, impl=impl)
    if version == 2:
        return out, lse
    return out, torch.exp(lse - m), m


# --- reference-parity aliases (Tensor.flash_attn*) --------------------------

def flash_attn(q, k, v, *, impl: str | None = None):
    """FA1, non-causal."""
    return flash_attention(q, k, v, causal=False, version=1, impl=impl)


def flash_attn_causal(q, k, v, *, impl: str | None = None):
    """FA1 with causal masking."""
    return flash_attention(q, k, v, causal=True, version=1, impl=impl)


def flash_attn2(q, k, v, *, causal: bool = False, impl: str | None = None):
    """FA2 (logsumexp residual)."""
    return flash_attention(q, k, v, causal=causal, version=2, impl=impl)
