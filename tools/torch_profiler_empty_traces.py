"""Count the profiler traces of short kernel calls that hold no device
event (empty) or fewer of the form's own kernel than its calls (short):
the evidence for ``chip_smoke.py``'s ``device_events``, which pauses and
takes an empty trace again (``TRACE_TRIES``) and retakes one short trace
a run (``SHORT_TRACES_ALLOWED``).  At each linear of the 176M serving
model, for int8, int4 and int4 in groups of 128 at M 8, bf16 x (the
tensor-core decode form) and fp32 x (int8 and grouped int4: the fp32
tensor-core decode form; int4 per column: the CUDA-core one and its
reduction), each round times the call on weights rotating past the L2 (as
``chip_smoke.py``'s ``quant_times`` does between its traces), then takes
two traces of three calls with ``chip_smoke.trace``:

* as ``chip_smoke.kernels_run`` takes them;
* checked: before each call a tensor of out's size is filled with NaN and
  freed, so that the call's out, where the allocator hands it the same
  block, holds NaN unless the kernel wrote it; each out is then held
  bitwise against a call outside the trace.

Every empty or short trace prints a JSON line with its device kernels by
name, the host's launch calls in the same trace and, checked, whether each
out took the poisoned block and was right.  After an empty trace it
traces again until one is not empty (at most 10 traces), the empty traces
taking turns at no pause and at ``TRACE_PAUSE_S``.

    PYTHONPATH=. python3 tools/torch_profiler_empty_traces.py [--rounds 40]

Prints one JSON line a round, then the totals and the card's name and
power limit.  Needs a CUDA device.
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
CALLS = 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profiler_empty_traces: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator("cuda").manual_seed(0)
    cases = []
    for kind, bits, group in KINDS:
        for K, N in chip_smoke.SERVING_LINEARS:
            q = chip_smoke.quantized(torch.randn(K, N, generator=gen,
                                                 device="cuda"), bits, group)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(8, K, generator=gen, device="cuda",
                                dtype=dtype)
                name = chip_smoke.quant_form(kind, 8, N, dtype)
                cases.append((name, f"M8 K{K} N{N} {dtype}", kind, x,
                              past_l2(*q)))
    counts = collections.Counter()

    def report(what, case, events, launches, **extra):
        print(json.dumps({what: case[0], "shape": case[1],
                          "kernels": {e.key[:90]: e.count for e in events},
                          "host_launches": launches, **extra}), flush=True)

    for rnd in range(args.rounds):
        for case in cases:
            name, _, kind, x, qs = case

            def fn(*w, kind=kind, x=x, w0=qs[0]):
                return chip_smoke.quant_matmul(kind, x, w or w0, "kernel")

            rotating_ms(fn, qs)
            want = fn()
            torch.cuda.synchronize()
            # As kernels_run takes them.
            counts["traces"] += 1
            events, launches = chip_smoke.trace(fn, CALLS)
            seen = sum(e.count for e in events)
            ours = sum(e.count for e in events if name + "_kernel" in e.key)
            if seen and ours < CALLS:
                counts["short"] += 1
                report("short_trace", case, events, launches)
            elif not seen:
                counts["empty"] += 1
                report("empty_trace", case, events, launches)
                pause = (0.0, chip_smoke.TRACE_PAUSE_S)[counts["empty"] % 2]
                traces = 1
                while traces < 10 and not seen:
                    time.sleep(pause)
                    traces += 1
                    events = chip_smoke.trace(fn, CALLS)[0]
                    seen = sum(e.count for e in events)
                print(json.dumps({"empty_trace_retaken": name,
                                  "pause_s": pause, "traces": traces,
                                  "found_one": bool(seen)}), flush=True)
                counts[f"retraces_at_pause_{pause}"] += traces - 1
            # Checked: each out poisoned first, then held against want.
            outs = []

            def checked(fn=fn, want=want, outs=outs):
                poison = torch.full_like(want, float("nan"))
                block = poison.data_ptr()
                del poison
                out = fn()
                outs.append((out, out.data_ptr() == block))

            counts["checked_traces"] += 1
            events, launches = chip_smoke.trace(checked, CALLS)
            ours = sum(e.count for e in events if name + "_kernel" in e.key)
            right = [bool(torch.equal(o, want)) for o, _ in outs]
            poisoned = [p for _, p in outs]
            counts["checked_calls"] += len(outs)
            counts["checked_calls_poisoned"] += sum(poisoned)
            counts["checked_calls_wrong"] += right.count(False)
            if ours < CALLS:
                counts["checked_" + ("short" if ours else "empty")] += 1
                report("checked_" + ("short" if ours else "empty") + "_trace",
                       case, events, launches, right=right,
                       poisoned=poisoned)
        print(json.dumps({"round": rnd, **counts}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({**counts, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
