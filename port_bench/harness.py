"""What one run of one cell carries between the entry point, its driver,
the comparison with the reference and the per-layer readers."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import torch

from port_bench.spec import Shape

OUT = Path(__file__).resolve().parent / "out"


@dataclasses.dataclass
class Run:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    shape: Shape
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int = 1
    out_dir: Path = OUT
    # filled by the cell's driver (port_bench/drivers/)
    setup_parts: dict = dataclasses.field(default_factory=dict)
    t_window: float | None = None       # perf_counter at the window's start
    e2e: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    traced: dict | None = None          # trace.reduce's numbers
    checks: dict = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)
    sample: list = dataclasses.field(default_factory=list)  # (prompt, served)

    @classmethod
    def of_cell(cls, cell: dict, config: dict, traffic: dict, limits: dict,
                *, seed: int, seconds: float, trace: bool, device) -> "Run":
        from port_bench.spec import shape_of

        return cls(workload=cell, config=config, traffic=traffic,
                   limits=limits, shape=shape_of(config), seed=seed,
                   seconds=seconds, trace=trace, device=torch.device(device),
                   chips=cell["chips"])

    @property
    def name(self) -> str:
        return self.workload["name"]

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a part of set-up (import, build, weights, warm-up)."""
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.setup_parts[name] = (self.setup_parts.get(name, 0.0)
                                      + time.perf_counter() - t0)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start_window(self) -> float:
        """Set-up ends here: the peak memory is taken from this point."""
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t_window = time.perf_counter()
        return self.t_window

    def close_window(self) -> None:
        """Read the window's peak memory, before the program is freed and
        the reference runs."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def check(self, name: str, value: float, limit) -> None:
        """A number compared with its limit: the run is correct only where
        every such number is at most its limit."""
        self.checks[name] = dict(value=value, limit=limit)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["limit"] is not None and c["value"] == c["value"]
            and c["value"] <= c["limit"] for c in self.checks.values())

    def free(self) -> None:
        """Give the device's memory back after the program's objects are
        dropped, so the reference has room."""
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def span(name: str):
    """A span of the benchmark's own around a call into the program,
    recorded when the profiler runs."""
    return torch.profiler.record_function(name)
