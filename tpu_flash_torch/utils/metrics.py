"""Structured training metrics, counterpart of ``tpu_flash/utils/metrics.py``:
an append-only JSONL logger with the wall time of each record.

Every record carries ``step`` (one past the last if omitted), ``wall``
(seconds since the logger was made) and the caller's scalars; tensors and
numpy scalars become Python numbers, and NaN and infinities ``null``, so
that the file is strict JSON.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import IO, Any


class MetricsLogger:
    """``with MetricsLogger(workdir / "metrics.jsonl", run={...}) as m:
    m.log(step=1, loss=2.3)``.  With no path the records are printed."""

    def __init__(self, path: str | Path | None, *,
                 run: dict[str, Any] | None = None, echo: bool = False):
        self.path = Path(path) if path is not None else None
        self.echo = echo
        self._fh: IO[str] | None = None
        self._t0 = time.perf_counter()
        self._step = 0
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        if run is not None:
            self._write({"event": "run_start", **_jsonable(run)})

    def log(self, step: int | None = None, **scalars) -> dict[str, Any]:
        if step is None:
            step = self._step + 1
        self._step = step
        rec = {"step": step,
               "wall": round(time.perf_counter() - self._t0, 4),
               **_jsonable(scalars)}
        self._write(rec)
        return rec

    def _write(self, rec: dict[str, Any]) -> None:
        line = json.dumps(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo or self._fh is None:
            print(line)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _jsonable(d: dict[str, Any]) -> dict[str, Any]:
    out = {}
    for k, v in d.items():
        if hasattr(v, "item"):          # a tensor or numpy scalar
            v = v.item()
        elif isinstance(v, dict):
            v = _jsonable(v)
        if isinstance(v, float) and (v != v or v in (float("inf"),
                                                     float("-inf"))):
            v = None                    # strict JSON has no NaN/Infinity
        out[k] = v
    return out


def read_metrics(path: str | Path) -> list[dict[str, Any]]:
    """The records of a metrics.jsonl, in order."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]
