"""The readings that the limits of ``port_bench/limits/`` are set from,
beside the benchmark's own runs (which give the program's readings):

- training cells: the control, the reference in float8_e4m3fn in the
  program's place (``reference.gpt``'s ``quant="fp8"``), and the fault of
  half the batch left out (the reference on the first half of the batch's
  tokens, the mean taken over them), each held to the float32 reference by the
  cell's numbers, at the cell's own size;
- serving cells: a short window of the cell at its own load, then on the
  same sample of finished requests the program's widest gap and the
  control's (at each position the token that the fp8 reference puts first,
  judged by the float32 reference).

    python3 -m port_bench.control --workload <name> --seeds <n> ... \
        [--seconds <s>]

on the card(s) the cell asks for; one JSON line a seed."""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from port_bench import compare, weights
from port_bench.harness import Run
from port_bench.run import load_cell


def train_readings(run: Run) -> dict:
    from port_bench.drivers.train import CHECK_STEPS, make_data

    data = make_data(run)[:CHECK_STEPS]
    ref = compare.train_reference(run, data, capture=True)
    out = {}
    for what, kw in (("control_fp8", dict(quant="fp8")),
                     ("half_batch", dict(half=True))):
        side = compare.train_reference(run, data, judge=ref["grads"], **kw)
        got = compare.train_numbers(side, ref, side["grad_dists"])
        out[what] = {k: got[k] for k in ("loss_gap", "grad_gap", "change_gap",
                                         "grad_dist", "grad_leaf",
                                         "change_leaf", "dist_leaf")}
        run.free()
    out["reference_losses"] = ref["losses"]
    return out


def serve_readings(run: Run) -> dict:
    driver = importlib.import_module(
        f"port_bench.drivers.{run.traffic['driver']}")
    driver.run(run)
    w = weights.make(run.shape, run.seed, run.device)
    w32 = {n: t.float() for n, t in w.items()}
    del w
    control = max(float(compare.serve_reference(
        run, w32, p, t, control="fp8").max()) for p, t in run.sample)
    return dict(program=run.checks["token_gap"]["value"], control_fp8=control,
                checked_tokens=run.notes.get("checked_tokens"),
                serve_tokens_per_s=run.e2e.get("serve_tokens_per_s"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    _, cell, config, traffic, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA card", file=sys.stderr)
        return 2
    dev = "cuda:0"
    for seed in args.seeds:
        run = Run.of_cell(cell, config, traffic, {}, seed=seed,
                          seconds=args.seconds, trace=False, device=dev)
        got = (train_readings(run) if traffic["driver"] == "train"
               else serve_readings(run))
        print(json.dumps(dict(workload=args.workload, seed=seed, **got)),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
