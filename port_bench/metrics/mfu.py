"""The model FLOPs of the window's work over what the cards could do in the
window at their bf16 peak (``port_bench.arith``): training 6 per matmul
parameter per token plus attention forward and backward; serving 2 per
matmul parameter per prompt and output token plus attention over the live
lengths."""

from port_bench.arith import PEAK_BF16_FLOPS


def read(run):
    c = run.counters
    if not c.get("model_flops") or not c.get("window_s"):
        return None
    return 100.0 * c["model_flops"] / (c["window_s"] * run.chips
                                       * PEAK_BF16_FLOPS)
