"""Roofline accounting, counterpart of ``tpu_flash/utils/roofline.py``:
judge a measured kernel time against the least time the card could take
for the op's FLOPs and memory bytes.

An op needing F FLOPs and moving B bytes cannot finish faster than
``max(F / peak_flops, B / peak_bandwidth)``; the achieved fraction of that
bound says how good a kernel is, and which term is larger says whether
compute or traffic bounds it.

The ceilings are the data sheet's for one NVIDIA H100 SXM5 80GB (dense,
without sparsity, at the full 700 W power limit): 989 TFLOP/s bf16 and
3.35 TB/s HBM3.  The port's fp32 kernels form each fp32 product from bf16
products on the tensor cores, six in the flash kernels' ``_x6`` forms and
three in the quantized matmuls' ``_x3`` forms, so their compute ceilings
are 989 / 6 and 989 / 3.  A card set below 700 W runs slower under load:
state its power limit beside a fraction.  The JAX package's ceilings are
a TPU's and have no place here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Ceiling:
    name: str
    tflops: float          # peak usable compute, TFLOP/s
    gbs: float             # peak usable memory bandwidth, GB/s


H100_SXM5 = Ceiling("h100-sxm5-80gb-bf16", tflops=989.0, gbs=3350.0)
H100_SXM5_X6 = Ceiling("h100-sxm5-80gb-x6", tflops=989.0 / 6, gbs=3350.0)
H100_SXM5_X3 = Ceiling("h100-sxm5-80gb-x3", tflops=989.0 / 3, gbs=3350.0)


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    time_ms: float
    flops: float
    bytes: float
    ceiling: Ceiling

    def _times(self) -> tuple[float, float]:
        return (self.flops / (self.ceiling.tflops * 1e12),
                self.bytes / (self.ceiling.gbs * 1e9))

    @property
    def ideal_ms(self) -> float:
        """Fastest possible time: the compute or the bandwidth floor."""
        return max(self._times()) * 1e3

    @property
    def bound(self) -> str:
        t_flops, t_bytes = self._times()
        return "compute" if t_flops >= t_bytes else "memory"

    @property
    def fraction(self) -> float:
        """Achieved fraction of the roofline bound (1.0 = speed of light)."""
        return self.ideal_ms / self.time_ms if self.time_ms > 0 else 0.0

    @property
    def achieved_tflops(self) -> float:
        return self.flops / (self.time_ms * 1e-3) / 1e12

    @property
    def achieved_gbs(self) -> float:
        return self.bytes / (self.time_ms * 1e-3) / 1e9

    def summary(self) -> dict:
        return {
            "time_ms": round(self.time_ms, 4),
            "tflops": round(self.achieved_tflops, 2),
            "gbs": round(self.achieved_gbs, 1),
            "bound": self.bound,
            "roofline_frac": round(self.fraction, 3),
            "ceiling": self.ceiling.name,
        }


def roofline(time_ms: float, flops: float, bytes_: float,
             ceiling: Ceiling = H100_SXM5) -> RooflinePoint:
    return RooflinePoint(time_ms, flops, bytes_, ceiling)


# --------------------------------------------------------------------- ops
def attention_bytes(B: int, H: int, L: int, d: int, *, dtype_bytes: int = 2,
                    fwd_and_bwd: bool = False) -> float:
    """Memory traffic of flash attention: Q/K/V read and O written (and in
    the backward Q/K/V/O/dO read and dQ/dK/dV written; the logsumexp is
    left out).  Flash never materializes [L, L], so traffic is linear in L."""
    qkv_o = 4.0 * B * H * L * d * dtype_bytes
    if not fwd_and_bwd:
        return qkv_o
    return qkv_o + 8.0 * B * H * L * d * dtype_bytes


def decode_attention_bytes(B: int, H: int, S: int, d: int, *,
                           cache_bytes: int = 2, scale_heads: int = 0
                           ) -> float:
    """A decode step's traffic ~= the K and V cache read once (the query
    and output, [B, H, d], are noise).  ``scale_heads``: per-position fp32
    scale rows of a quantized cache."""
    kv = 2.0 * B * S * H * d * cache_bytes
    scales = 2.0 * B * scale_heads * S * 4.0
    return kv + scales


def weight_matmul_bytes(M: int, K: int, N: int, *, weight_bytes: float,
                        act_bytes: int = 2) -> float:
    """Weight-dominated matmul traffic (decode: M small, the weights read
    once); ``weight_bytes`` may be fractional (0.5 for int4)."""
    return K * N * weight_bytes + (M * K + M * N) * act_bytes
