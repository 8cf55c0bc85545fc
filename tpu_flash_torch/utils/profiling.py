"""Profiling, tracing and numerics checks, counterpart of
``tpu_flash/utils/profiling.py``:

  * ``trace(logdir)``  — a ``torch.profiler`` trace of the host and, where
                         there is a card, its kernels, written into
                         ``logdir`` as Chrome / Perfetto JSON (TensorBoard's
                         ``<worker>.<ns>.pt.trace.json`` naming);
  * ``annotate(name)`` — a named range in that trace
                         (``torch.profiler.record_function``);
  * ``PhaseTimer``     — wall time per named phase, each phase closed only
                         after its output's device has finished, so it
                         measures execution, not the host's launch rate;
  * ``checked(fn)``    — raises where an output of ``fn`` holds a NaN or an
                         infinity.  JAX's ``checkify`` also traps integer
                         division by zero and out-of-bounds indexing inside
                         the function; PyTorch has no such check, so this
                         one reads the outputs only (ROADMAP.md, C).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import Callable

import torch

from tpu_flash_torch.utils.checkpoint import _flatten_with_paths


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the ``with`` body (CPU activity, and CUDA where a card is
    present) and write the trace into ``logdir`` when it ends, also on an
    exception.  Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range inside a trace (a context manager)."""
    return torch.profiler.record_function(name)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of nested dicts (by sorted key), lists and tuples."""
    return [t for _, t in _flatten_with_paths(tree) if torch.is_tensor(t)]


def _sync(out) -> None:
    """Wait for the devices of ``out``'s CUDA tensors to finish."""
    for device in {t.device for t in _tensors(out) if t.is_cuda}:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall time per named phase.

    with timer.phase("forward", out=loss): ...
    The phase ends only after ``out``'s device has finished the work queued
    so far, so the measurement covers device execution, not dispatch."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, out=None):
        t0 = time.perf_counter()
        yield
        if out is not None:
            _sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def measure(self, name: str, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> dict[str, float]:
        return {k: self.totals[k] / max(1, self.counts[k])
                for k in self.totals}

    def report(self) -> str:
        parts = [f"{k}: {v * 1e3:.2f} ms/call" for k, v in
                 sorted(self.summary().items())]
        return ", ".join(parts)


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped to raise ``FloatingPointError`` naming the first
    floating output (dict keys sorted) that holds a NaN or an infinity;
    one host read a call, of a flag per floating output."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        floats = [t for t in _tensors(out) if t.is_floating_point()]
        if floats:
            finite = torch.stack([torch.isfinite(t).all().to(floats[0].device)
                                  for t in floats]).tolist()
            if not all(finite):
                i = finite.index(False)
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: output {i} of "
                    f"{len(floats)} (shape {tuple(floats[i].shape)}) holds "
                    f"a non-finite value")
        return out

    return wrapper
