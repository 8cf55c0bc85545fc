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
same keep mask from it.  ``kv_quant`` ("int8", "fp8", "int8_channel",
"fp8_channel") quantizes K and V once (``quantize_kv``, JAX's training
quantizer) and runs the kernels' quantized forms on the codes, forward and
backward, saving the codes and scales instead of K and V (the JAX
package's ``_flash_attention_quantkv``); dK and dV are straight-through.
The parallel (sharded) form is not ported yet (ROADMAP.md A8).
"""

from __future__ import annotations

import torch

from tpu_flash_torch.kernels.flash_attention import (
    Dropout,
    KvQuant,
    _backward,
    _forward,
    check_dropout,
    check_mask,
    flash_attention_forward,
)

KV_QUANT_MODES = ("int8", "fp8", "int8_channel", "fp8_channel")
_INT8_MAX, _FP8_MAX = 127.0, 448.0   # float8_e4m3fn's largest normal


def kv_quant_parts(mode: str) -> tuple[str, str]:
    """A kv_quant mode as ``(base, granularity)``: "int8" ->
    ("int8", "token"), "fp8_channel" -> ("fp8", "channel") (the JAX
    package's ``_kv_quant_parts``)."""
    base, _, gran = mode.partition("_")
    return base, (gran or "token")


def quantize_kv(x: torch.Tensor, mode: str = "int8"):
    """Symmetric quantization of K or V ``[B, H, L, d]`` for training, the
    JAX package's ``_quantize_kv`` (tpu_flash/ops/attention.py:44-74):
    returns ``(codes, scales)``, scales fp32 ``[B, H, L]`` (token modes,
    the amax over d) or ``[B, H, d]`` (channel modes, the amax over the
    sequence).  A zero amax gives scale 1 (so the channel backward's
    ``dk / ks`` stays finite; the serving cache's quantizer gives 0
    there).  int8 codes are ``round(x / s)`` (half to even) clamped to
    +-127; fp8 codes are ``x / s`` cast to float8_e4m3fn.  The division is
    in fp32."""
    base, gran = kv_quant_parts(mode)
    xf = x.float()
    axis = -2 if gran == "channel" else -1
    amax = xf.abs().amax(dim=axis)
    top = _INT8_MAX if base == "int8" else _FP8_MAX
    scales = torch.where(amax == 0.0, torch.ones_like(amax), amax / top)
    y = xf / (scales[..., None, :] if gran == "channel"
              else scales[..., None])
    if base == "int8":
        codes = torch.round(y).clamp_(-127, 127).to(torch.int8)
    else:
        codes = y.to(torch.float8_e4m3fn)
    return codes, scales


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor,
                  mode: str = "int8") -> torch.Tensor:
    """Inverse of ``quantize_kv`` in fp32 (JAX's ``dequantize_kv``, :77-85;
    e4m3 subnormals kept, where JAX's bit rebuild flushes them)."""
    _, gran = kv_quant_parts(mode)
    return codes.float() * (scales[..., None, :] if gran == "channel"
                            else scales[..., None])


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


class _FlashAttentionQuantKV(torch.autograd.Function):
    """The JAX package's ``_flash_attention_quantkv`` (ops/attention.py:
    88-131): K and V are quantized once, the forward and the backward's
    recompute run on the codes, and the saved tensors are the codes and
    scales (with q, out, lse and the seed), not K and V."""

    @staticmethod
    def forward(ctx, q, k, v, causal, impl, window, seg, seed, rate, mode):
        q = q.contiguous()
        gran = kv_quant_parts(mode)[1]
        kc, ks = quantize_kv(k, mode)
        vc, vs = quantize_kv(v, mode)
        kvq = KvQuant(gran, ks, vs)
        drop = None if seed is None else Dropout(seed, rate)
        out, lse, _ = _forward(q, kc, vc, causal, None, None, False, window,
                               seg, impl, drop, kvq)
        ctx.save_for_backward(q, kc, ks, vc, vs, out, lse)
        ctx.causal, ctx.impl, ctx.window, ctx.seg = causal, impl, window, seg
        ctx.drop, ctx.gran = drop, gran
        return out

    @staticmethod
    def backward(ctx, do):
        q, kc, ks, vc, vs, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, kc, vc, out, lse, do, None, ctx.causal,
                               None, None, ctx.window, ctx.seg, ctx.impl,
                               ctx.drop, KvQuant(ctx.gran, ks, vs))
        return dq, dk, dv, None, None, None, None, None, None, None


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
    fresh seed each step.  ``kv_quant`` (one of ``KV_QUANT_MODES``)
    quantizes K and V per token ("int8", "fp8") or per channel
    ("int8_channel", "fp8_channel") and runs the kernels' quantized forms
    on the codes, forward and backward; dK and dV are straight-through."""
    _check_version(version)
    if kv_quant != "none" and kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"kv_quant must be 'none', 'int8', 'fp8', 'int8_channel' "
            f"or 'fp8_channel', got {kv_quant!r}")
    window, seg = check_mask(q, k, causal, window, segment_ids)
    drop = check_dropout(q, dropout_rate, dropout_seed)
    seed, rate = (None, 0.0) if drop is None else drop
    if kv_quant != "none":
        return _FlashAttentionQuantKV.apply(q, k, v, causal, impl, window,
                                            seg, seed, rate, kv_quant)
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
