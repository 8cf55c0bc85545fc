"""Device timing with CUDA events, counterpart of
``tpu_flash/utils/timing.py``.

``device_ms`` runs a function a few times to warm up, then times batches of
calls between two CUDA events and returns the median time per call.  Before
each batch the stream is held by a short spin kernel, so the host has
queued the whole batch before the first event runs: the events then measure
back-to-back device time, not the host's launch rate.
"""

from __future__ import annotations

import statistics

import torch


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
