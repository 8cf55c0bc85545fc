"""The flash-attention kernels' share of their roofline in the traced
training steps: every layer's causal attention forward and backward,
counted from shapes (``port_bench.arith``), over the device time of the
kernels whose names match ``KERNELS``.  Nothing is returned where no such
kernel ran."""

import re

from port_bench import arith
from port_bench.trace import kernel_seconds

KERNELS = re.compile(r"flash_attention_")


def read(run):
    steps = run.counters.get("traced_steps")
    if run.traced is None or not steps:
        return None
    seconds = kernel_seconds(run.traced, KERNELS)
    if seconds <= 0:
        return None
    s, tr = run.shape, run.traffic
    B, L = tr["batch"], tr["seq_len"]
    flops = steps * s.n_layer * arith.attention_gemm_flops(
        B, s.n_head, L, s.head_dim, causal=True, backward=True)
    nbytes = steps * arith.flash_train_bytes(s, B, L)
    return arith.roofline_share(flops, nbytes, seconds)
