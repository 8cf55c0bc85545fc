"""Device timing with CUDA events, counterpart of
``tpu_flash/utils/timing.py``.

``device_ms`` runs a function a few times to warm up, then times batches of
calls between two CUDA events and returns the median time per call.  Before
each batch the stream is held by a short spin kernel, so the host has
queued the whole batch before the first event runs: the events then measure
back-to-back device time, not the host's launch rate.  ``rotating_ms`` times
a function on operands that rotate past the L2 (``past_l2``), as each
layer's own weights would be read; ``host_us`` times the host's side of a
call.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

L2_BYTES = 50e6     # an H100's L2 cache


def device_ms(fn, *, warmup: int = 3, iters: int = 20, reps: int = 5,
              hold_cycles: int = 20_000_000) -> float:
    """Median over ``reps`` batches of the device time of one ``fn()`` call
    in a batch of ``iters``, in milliseconds."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)     # hold the stream while we queue
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def past_l2(*tensors) -> list[tuple]:
    """``tensors`` and clones of them, enough (at least two) that calls on
    each in turn read twice the L2: each call then finds its operands in
    device memory, not in the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = max(2, math.ceil(2 * L2_BYTES / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def rotating_ms(fn, operands, **kwargs) -> float:
    """``device_ms`` of ``fn(*operands[i])``, i advancing by one a call."""
    tick = [0]

    def call():
        tick[0] = (tick[0] + 1) % len(operands)
        return fn(*operands[tick[0]])

    return device_ms(call, **kwargs)


def host_us(fn, *, warmup: int = 3, iters: int = 100, reps: int = 5,
            hold_cycles: int = 200_000_000) -> float:
    """Median over ``reps`` batches of the host's time to issue one
    ``fn()`` call in a batch of ``iters``, in microseconds.  A spin kernel
    holds the stream while the batch is queued, so the host never waits
    for the device; raises if the spin ended before the batch was queued."""
    if not torch.cuda.is_available():
        raise RuntimeError("host_us needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(hold_cycles)
        held = torch.cuda.Event()
        held.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = time.perf_counter() - t0
        if held.query():
            raise RuntimeError("host_us: the stream was released before "
                               "the batch was queued; raise hold_cycles")
        torch.cuda.synchronize()
        times.append(t / iters * 1e6)
    return statistics.median(times)
