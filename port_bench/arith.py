"""Operation and byte counts from shapes, and the card's published peaks.

Frozen here so that the yardstick does not move with the program: the
closed forms are those of ``tpu_flash_torch/utils/timing.py``
(``attention_flops``) and ``utils/roofline.py`` (the ceilings,
``decode_attention_bytes``).  A count is of the work the algorithm needs
for the call, whatever implements it: causal attention counts half the
square, a decode step the keys and values of the live positions only."""

from __future__ import annotations

# NVIDIA H100 SXM5 80GB data sheet, dense, at the full 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def attention_gemm_flops(B: int, H: int, L: int, d: int, *, causal: bool,
                         backward: bool) -> float:
    """Matmul FLOPs of one attention call: QK^T and PV forward, and the
    backward's five (S recomputed, dP, dV, dQ, dK), 2 B H L^2 d each;
    causal halves them."""
    per_gemm = 2.0 * B * H * L * L * d
    total = per_gemm * (7 if backward else 2)
    return total * 0.5 if causal else total


def train_step_flops(shape, B: int, L: int) -> float:
    """A training step's model FLOPs: 6 per matmul parameter per token,
    and every layer's causal attention forward and backward (no
    recomputation counted)."""
    tokens = B * L
    attn = shape.n_layer * attention_gemm_flops(
        B, shape.n_head, L, shape.head_dim, causal=True, backward=True)
    return 6.0 * shape.matmul_params() * tokens + attn


def prefill_flops(shape, P: int) -> float:
    """A prompt of ``P`` tokens: 2 per matmul parameter per token and
    causal attention over the prompt."""
    attn = shape.n_layer * attention_gemm_flops(
        1, shape.n_head, P, shape.head_dim, causal=True, backward=False)
    return 2.0 * shape.matmul_params() * P + attn


def decode_token_flops(shape, keys: int) -> float:
    """One decoded token that attends over ``keys`` positions (itself
    included)."""
    attn = shape.n_layer * 4.0 * shape.n_head * shape.head_dim * keys
    return 2.0 * shape.matmul_params() + attn


def decode_call_bytes(shape, live_keys: list[int], *, cache_bytes: int = 2,
                      act_bytes: int = 2) -> float:
    """One decode step's attention traffic over all layers: K and V of
    each active slot at its live length read once, and its q and output
    (``decode_attention_bytes`` with the lengths of the active slots)."""
    kv = 2.0 * sum(live_keys) * shape.kv_dim * cache_bytes
    q_out = 2.0 * len(live_keys) * shape.n_embd * act_bytes
    return shape.n_layer * (kv + q_out)


def flash_train_bytes(shape, B: int, L: int, dtype_bytes: int = 2) -> float:
    """A training step's flash-attention traffic over all layers: the
    forward reads q, k, v and writes out; the backward reads q, k, v, out,
    dO and writes dQ, dK, dV (``attention_bytes`` with the K/V heads)."""
    q_like = B * L * shape.n_embd * dtype_bytes
    kv_like = B * L * shape.kv_dim * dtype_bytes
    fwd = 2 * q_like + 2 * kv_like
    bwd = (3 * q_like + 2 * kv_like) + (q_like + 2 * kv_like)
    return shape.n_layer * (fwd + bwd)


def roofline_share(flops: float, nbytes: float,
                   seconds: float) -> float | None:
    """The least time the card could take for the work, over the time
    taken, in %; None where no time was measured."""
    if seconds <= 0:
        return None
    least = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    return 100.0 * least / seconds
