"""Run one cell of the benchmark of ``tpu_flash_torch`` on the card(s) of
this machine and print its result as the last line of standard output.

    python3 -m port_bench.run --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration is ``port_bench/configs/<config>.json``,
its traffic ``port_bench/traffic/<traffic>.json``, whose ``driver`` names
``port_bench/drivers/<driver>.py``, and its limits
``port_bench/limits/<workload>.json``.  Each per-layer metric is read by
``port_bench/metrics/<name before the first dot>.py``.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones.

Without as many CUDA cards as the cell asks for, or if JAX or the JAX
package was loaded, the run exits non-zero and prints no result."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_flash")


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), so that set-up
    counts the interpreter's start too."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str) -> tuple[dict, dict, dict, dict, dict]:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / cfg["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits_file = ROOT / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text())["limits"]
              if limits_file.exists() else {})
    return spec, cell, config, traffic, limits


def applies(metric: dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: ``setup_s`` everywhere,
    every other metric in the cells of its ``workloads`` list."""
    return metric["name"] == "setup_s" or cell in metric["workloads"]


def result_line(run, spec: dict, setup_s: float) -> dict:
    cell = run.name
    e2e = [m for m in spec["end_to_end"] if applies(m, cell)]
    metrics = {}
    if not run.trace:
        values = dict(run.e2e, setup_s=setup_s)
        for m in e2e:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    else:
        for m in spec["per_layer"]:
            if not applies(m, cell):
                continue
            reader = importlib.import_module(
                f"port_bench.metrics.{m['name'].split('.', 1)[0]}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    import torch

    device = dict(platform="gpu", kind=torch.cuda.get_device_name(run.device),
                  count=run.chips, memory_peak_bytes=run.memory_peak_bytes)
    out = dict(correct=run.correct, attempted=run.attempted,
               failed=run.failed, metrics=metrics, device=device)
    if run.trace and run.traced is not None:
        device.update(busy_s=run.traced["busy_s"],
                      window_s=run.traced["window_s"])
        out["breakdown"] = run.traced["breakdown"]
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    age = process_age()
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec, cell, config, traffic, limits = load_cell(args.workload)
    # every kernel cache lands at a fixed path inside the checkout (the
    # port's own nvcc builds go to tpu_flash_torch/kernels/_build/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "out" / "cache" / sub)

    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2
    from port_bench.harness import Run

    run = Run.of_cell(cell, config, traffic, limits, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda:0")
    driver = importlib.import_module(f"port_bench.drivers.{traffic['driver']}")
    run.setup_parts["interpreter"] = age + (time.perf_counter() - t_main)
    driver.run(run)
    setup_s = age + (run.t_window - t_main)

    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded {', '.join(found)}: the benchmark runs "
              f"the port alone", file=sys.stderr)
        return 3
    line = result_line(run, spec, setup_s)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in run.setup_parts.items())
    print(f"setup_s {setup_s:.3f}: {parts}", file=sys.stderr)
    print(f"counters: {json.dumps(run.counters)}", file=sys.stderr)
    print(f"notes: {json.dumps(run.notes)}", file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
