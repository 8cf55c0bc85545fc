"""The flash-decode kernel's share of its roofline in the traced part of a
serving window: the keys and values of each active slot at its live length,
and its q and output, read once a decode step and layer (the harness's own
record of the lengths; idle slots' rows are not counted), over the device
time of the kernels whose names match ``KERNELS``.  Nothing is returned
where no such kernel ran."""

import re

from port_bench import arith
from port_bench.trace import kernel_seconds

KERNELS = re.compile(r"flash_decode")


def read(run):
    nbytes = run.counters.get("decode_bytes")
    if run.traced is None or not nbytes:
        return None
    seconds = kernel_seconds(run.traced, KERNELS)
    if seconds <= 0:
        return None
    return arith.roofline_share(0.0, nbytes, seconds)
