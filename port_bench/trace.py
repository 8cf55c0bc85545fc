"""The profiler over the last part of the measured window (``--trace 1``),
and the reduction of its trace to what the per-layer readers take: kernels by name with their device time, the device's busy
time, and the longest idle gaps named by what the host was doing.

The trace is written as Chrome JSON under the checkout's ``port_bench/out/``,
read back and deleted: a run keeps only the numbers."""

from __future__ import annotations

import collections
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
LEAD_S = 5.0      # the profiler starts this long before the window's end:
                  # it has taken up to ~3 s to come up on the H100's host


class Tracer:
    """``start()`` and ``stop()`` around the traced part; ``stop`` leaves
    the reduction in ``result`` (None until then)."""

    def __init__(self, out_dir: Path, tag: str, device):
        self.path = out_dir / f"trace-{tag}.json"
        self.device = device
        self.prof = None
        self.span = None
        self.result = None

    @property
    def active(self) -> bool:
        return self.prof is not None

    def elapsed(self) -> float:
        """Seconds traced so far, from when the profiler was up."""
        return time.perf_counter() - self.t0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function("pb.window")
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize(self.device)
        host_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        self.result = reduce(events)
        if abs(self.result["window_s"] - host_s) > 0.1 * host_s:
            raise RuntimeError(
                f"the trace spans {self.result['window_s']:.4f} s of the "
                f"{host_s:.4f} s traced: the profiler dropped records")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(names, starts, ends, keep, t):
    """The name of the shortest host event among ``keep`` that holds the
    instant ``t``, or None."""
    hold = keep & (starts <= t) & (ends >= t)
    if not hold.any():
        return None
    idx = np.flatnonzero(hold)
    return names[idx[np.argmin(ends[idx] - starts[idx])]]


def reduce(events: list[dict]) -> dict:
    """The traced window's numbers (times in seconds): ``window_s``,
    ``busy_s`` (the union of device operations inside it), ``kernels``
    (name -> summed device seconds), ``breakdown`` (the top device
    operations and idle gaps)."""
    win = [e for e in events if e.get("name") == "pb.window"
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no pb.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, by_name = [], collections.Counter()
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s = float(e["ts"])
            t = s + float(e.get("dur", 0.0))
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                by_name[e["name"]] += (t - s) * 1e-6
    if not dev:
        raise RuntimeError("the trace holds no device operation: the "
                           "profiler recorded no CUDA activity")
    busy = _union(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and e.get("name") != "pb.window"]
    names = [e["name"] for e in host]
    starts = np.array([float(e["ts"]) for e in host])
    ends = starts + np.array([float(e["dur"]) for e in host])
    is_span = np.array([n.startswith("pb.") for n in names], bool)
    idle = []
    for s, t in gaps[:TOP]:
        mid = 0.5 * (s + t)
        where = [_innermost(names, starts, ends, is_span, mid) or "host",
                 _innermost(names, starts, ends, ~is_span, mid)]
        label = "/".join(dict.fromkeys(x for x in where if x))
        idle.append([label[:200], (t - s) * 1e-6])
    return dict(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s, kernels=dict(by_name),
        breakdown=dict(
            device_ops=[[n[:200], s] for n, s in by_name.most_common(TOP)],
            idle_gaps=idle))


def kernel_seconds(trace: dict, pattern) -> float:
    """Device seconds of the kernels whose names match ``pattern`` (a
    compiled regular expression)."""
    return sum(s for n, s in trace["kernels"].items() if pattern.search(n))
