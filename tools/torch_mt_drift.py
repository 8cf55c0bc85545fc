"""How far apart the MT app's step losses drift in runs that are equal in
exact arithmetic: ``main()`` at the JAX CLI's defaults on the repository's
corpus (dropout off, no BLEU, one epoch of 22 steps at batch 130), every
step's loss, in the single-process run, its repeat, the run with
``--accum-steps 2``, the run on the plain route (``ops.set_default_impl(
"plain")``), and on 4 spawned ranks as ``chip_smoke.py``'s (p8) mesh
(``--dp 2 --tp 2 --zero1 --sequence-parallel``), as dp2 x tp2 and as tp4.
Prints the first run's losses and each other run's relative distance from
them a step; ``chip_smoke.py``'s ``PAR_MT_EXACT_STEPS`` and
``PAR_MT_DRIFT`` are set from these.

    PYTHONPATH=. python3 tools/torch_mt_drift.py [--device cpu] [--tiny]

On the card (the default) the ranks share it over gloo (~3 min with the
build).  ``--device cpu`` runs the same on the CPU (~6 min); ``--tiny``
cuts the widths to a rehearsal's (E32, 1 layer, 3 steps).  Writes
``chiprun_out/mt_drift.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from tpu_flash_torch import ops
from tpu_flash_torch.apps import machine_translation as app
from tpu_flash_torch.parallel import dryrun as pdry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MT = ["--dataset", "local", "--p-dropout", "0", "--skip-bleu"]
TINY = ["--n-embd", "32", "--n-layer", "1", "--n-vocab", "400",
        "--max-iters-per-epoch", "3"]
SINGLE = {
    "A": (["--batch-size", "130"], None),
    "A again": (["--batch-size", "130"], None),
    "B accum2": (["--batch-size", "130", "--accum-steps", "2"], None),
    "P plain": (["--batch-size", "130"], "plain"),
}
MESHES = {
    "M (p8)": ["--dp", "2", "--tp", "2", "--zero1", "--sequence-parallel"],
    "M0 dp2tp2": ["--dp", "2", "--tp", "2"],
    "T4 tp4": ["--tp", "4", "--batch-size", "130"],
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="tools/torch_mt_drift.py")
    p.add_argument("--device", default=None, choices=("cpu", "cuda"))
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    cpu = args.device == "cpu"
    mt = MT + (TINY if args.tiny else [])
    wd = os.path.join(ROOT, "workdir_mt_drift")
    shutil.rmtree(wd, ignore_errors=True)
    if not cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        pdry.build_kernels()
    res, secs = {}, {}
    for name, (extra, impl) in SINGLE.items():
        ops.set_default_impl(impl)
        t = time.perf_counter()
        out = app.main(mt + extra + ["--workdir", os.path.join(wd, name)],
                       device=args.device)
        secs[name] = time.perf_counter() - t
        res[name] = out["losses"][0]
        del out
        if not cpu:
            torch.cuda.empty_cache()
    ops.set_default_impl(None)
    calls = [("rank_mt_main", dict(argv=mt + flags + [
        "--workdir", os.path.join(wd, name.split()[0])]))
        for name, flags in MESHES.items()]
    t = time.perf_counter()
    ranks = pdry.run_world("tpu_flash_torch.parallel.dryrun.rank_many", 4,
                           device=args.device, timeout=1500, calls=calls)
    secs["world"] = time.perf_counter() - t
    for i, name in enumerate(MESHES):
        res[name] = ranks[0][i]["losses"][0]
        if any(r[i]["losses"][0] != res[name] for r in ranks):
            raise AssertionError(f"{name}: the ranks logged other losses")
    ref = res["A"]
    drift = {n: [abs(x - y) / abs(y) for x, y in zip(v, ref)]
             for n, v in res.items() if n != "A"}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "mt_drift.json"), "w") as f:
        json.dump({"losses": res, "drift": drift, "seconds": secs}, f)
    print("A", " ".join(f"{x:.5f}" for x in ref))
    for n, d in drift.items():
        print(f"{n:>10}", " ".join(f"{x:.1e}" for x in d), flush=True)
    print("seconds", json.dumps(secs))
    shutil.rmtree(wd, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
