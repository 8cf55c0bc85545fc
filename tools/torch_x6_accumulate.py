"""How the fp32 flash kernels' six-product sums accumulate, measured: the
forward and the fused backward (``flash_attention_fwd_x6`` /
``flash_attention_bwd_x6``) built from this tree's sources in three forms,

* ``shipped``: as the sources stand (sums over the sequence, P.V in the
  forward and dK, dV in the backward, through ``mma_x6_add``; sums over the
  head dim and a tile's dQ through ``mma_x6``);
* ``in_place``: every sum through ``mma_x6``, each product added into the
  running accumulator by the tensor cores (which truncate);
* ``fresh``: every sum through ``mma_x6_add``,

each in a process of its own, in turns (shipped, in_place, fresh, fresh,
in_place, shipped): the largest error of out, lse, dq, dk and dv against a
float64 attention (causal, d 64, fp32 inputs, the fused backward) at B4 H8
L2048 and B1 H8 L8192, the plain fp32 version's errors beside them, the
registers and spills ptxas reports, and the kernels' times at B4 H8 L2048
(CUDA events, the median of 5 batches).

    PYTHONPATH=. python3 tools/torch_x6_accumulate.py

The forms other than ``shipped`` are copies of ``tpu_flash_torch/`` with
the call sites rewritten, under ``workdir_x6_forms/`` (git-ignored).  It
prints one JSON line a turn and a summary with the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "workdir_x6_forms"
# the files holding the forward's and the fused backward's products (the
# backward's body is shared with the two-pass dK/dV pass, which is not built)
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cuh")
SHAPES = ((4, 8, 2048), (1, 8, 8192))     # (B, H, L): causal, d 64
FORMS = ("shipped", "in_place", "fresh")
OUTPUTS = ("out", "lse", "dq", "dk", "dv")


def form_root(form: str) -> Path:
    """A tree whose ``tpu_flash_torch`` sums as ``form`` says."""
    if form == "shipped":
        return ROOT
    root = WORK / form
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "tpu_flash_torch", root / "tpu_flash_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = root / "tpu_flash_torch" / "kernels" / "csrc"
    for name in SOURCES:
        text = (csrc / name).read_text()
        text = text.replace("mma_x6_add(", "mma_x6(")
        if form == "fresh":
            text = text.replace("mma_x6(", "mma_x6_add(")
        (csrc / name).write_text(text)
    return root


def errors(torch, fa, attention_fp64, q, k, v, do, impl):
    out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True, impl=impl)
    grads = fa.flash_attention_backward_fused(q, k, v, out, lse, do,
                                              causal=True, impl=impl)
    ref = attention_fp64(q, k, v, do)
    return {n: float((a.double() - b).abs().max())
            for n, a, b in zip(OUTPUTS, (out, lse, *grads), ref)}


def one(form: str, root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from tpu_flash_torch.kernels import common, flash_attention as fa
    from tpu_flash_torch.utils.timing import device_ms

    assert Path(root).resolve() in Path(fa.__file__).resolve().parents
    sys.path.append(str(ROOT))
    from chip_smoke import attention_fp64, ptxas_report

    torch.backends.cuda.matmul.allow_tf32 = False
    built = common.build([fa.KERNEL_FWD, fa.KERNEL_BWD], rebuild=True)
    regs = {k: (r["registers"], r.get("spill_stores", 0))
            for b in built.values() for k, r in ptxas_report(b.log).items()
            if "_x6_kernel" in k}
    gen = torch.Generator("cuda").manual_seed(0)
    row = {"form": form, "registers_spill_bytes": regs, "errors": {},
           "plain_errors": {}}
    for B, H, L in SHAPES:
        q, k, v, do = (torch.randn(B, H, L, 64, generator=gen, device="cuda")
                       for _ in range(4))
        shape = f"B{B} H{H} L{L} d64 causal"
        row["errors"][shape] = errors(torch, fa, attention_fp64, q, k, v, do,
                                      "kernel")
        row["plain_errors"][shape] = errors(torch, fa, attention_fp64, q, k,
                                            v, do, "plain")
        torch.cuda.empty_cache()
    B, H, L = SHAPES[0]
    q, k, v, do = (torch.randn(B, H, L, 64, generator=gen, device="cuda")
                   for _ in range(4))
    out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True)
    kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True,
           1 / math.sqrt(64), 0)
    row["fwd_ms"] = device_ms(lambda: fa._launch_forward(
        q, k, v, True, None, None, False), warmup=1, iters=10, reps=5)
    row["bwd_ms"] = device_ms(lambda: fa._launch_backward(*kin), warmup=1,
                              iters=10, reps=5)
    return row


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(one(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    roots = {f: str(form_root(f)) for f in FORMS}
    runs = []
    for form in FORMS + FORMS[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--one", form,
                               roots[form]], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    summary = {f: {"fwd_ms": statistics.mean(r["fwd_ms"] for r in runs
                                             if r["form"] == f),
                   "bwd_ms": statistics.mean(r["bwd_ms"] for r in runs
                                             if r["form"] == f),
                   "errors": next(r["errors"] for r in runs
                                  if r["form"] == f)}
               for f in FORMS}
    print(json.dumps({"summary": summary,
                      "plain_errors": runs[0]["plain_errors"],
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
