"""Count the profiler traces of short kernel calls that hold no device
event, and how many traces of the same calls it takes to get one that is
not empty, with no pause before each new trace or with
``TRACE_PAUSE_S``: the evidence for ``chip_smoke.py``'s ``device_events``,
which pauses and takes an empty trace again (``TRACE_TRIES``).  At each
linear of the 176M serving model, for int8, int4 and int4 in groups of 128
at M 8 bf16 x (the tensor-core decode form), each round times the call on
weights rotating past the L2 (as ``chip_smoke.py``'s ``quant_times`` does
between its traces), then traces three calls once; after an empty trace
it traces again until one is not empty (at most 10 traces), the empty
traces taking turns at no pause and at ``TRACE_PAUSE_S``.

    PYTHONPATH=. python3 tools/torch_profiler_empty_traces.py [--rounds 40]

Prints one JSON line a round and one for each empty trace (with
``device_events``' own), then the totals and the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time

import torch

import chip_smoke
from tpu_flash_torch.utils.timing import past_l2, rotating_ms

KINDS = (("int8_matmul", 8, None), ("int4_matmul", 4, None),
         ("int4_matmul_group", 4, 128))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_empty_traces: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator("cuda").manual_seed(0)
    calls = []
    for kind, bits, group in KINDS:
        for K, N in chip_smoke.SERVING_LINEARS:
            q = chip_smoke.quantized(torch.randn(K, N, generator=gen,
                                                 device="cuda"), bits, group)
            x = torch.randn(8, K, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            calls.append((kind, x, past_l2(*q)))
    counts = collections.Counter()

    def empty(fn) -> bool:
        try:
            chip_smoke.device_events(fn, 3, tries=1)
        except RuntimeError:
            return True
        return False

    for rnd in range(args.rounds):
        for kind, x, qs in calls:
            def fn(*w, kind=kind, x=x, w0=qs[0]):
                return chip_smoke.quant_matmul(kind, x, w or w0, "kernel")

            rotating_ms(fn, qs)
            counts["traces"] += 1
            if not empty(fn):
                continue
            counts["empty"] += 1
            pause = (0.0, chip_smoke.TRACE_PAUSE_S)[counts["empty"] % 2]
            traces, found = 1, False
            while traces < 10 and not found:
                time.sleep(pause)
                traces += 1
                found = not empty(fn)
            print(json.dumps({"empty_trace": kind, "pause_s": pause,
                              "traces": traces, "found_one": found}),
                  flush=True)
            counts[f"retraces_at_pause_{pause}"] += traces - 1
        print(json.dumps({"round": rnd, **counts}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({**counts, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
