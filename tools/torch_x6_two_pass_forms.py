"""The fp32 two-pass backward's kernels (``flash_attention_bwd_dkv_x6`` /
``flash_attention_bwd_dq_x6``) and the fused ``flash_attention_bwd_x6``,
which shares the dK/dV pass's body, built from this tree's sources in three
forms,

* ``shipped``: as the sources stand (the dK/dV pass on 32-row query tiles
  and the dQ pass on 32-key tiles, two blocks an SM below d = 128; the
  shared body ``kv_outer_x6_body`` takes its parameters by value);
* ``by_reference``: the shared body takes ``const BwdParams&``;
* ``one_block_an_sm``: the dK/dV pass on the fused kernel's tiles (64 query
  rows, 32 a step below d = 128) and the dQ pass on 64-key tiles below
  d = 128, neither bounded to two blocks an SM,

each in a process of its own, in turns (shipped, by_reference,
one_block_an_sm, then the reverse): the registers and spills ptxas reports
for the ``_x6`` backward kernels, the three kernels' times at B1 H8 L8192
and B4 H8 L2048 (causal, d 64, fp32; CUDA events, the median of 5
batches), and each pass's largest error against its plain half at B4 H8
L2048.

    PYTHONPATH=. python3 tools/torch_x6_two_pass_forms.py

The forms other than ``shipped`` are copies of ``tpu_flash_torch/`` with
the sources rewritten, under ``workdir_x6_two_pass/`` (git-ignored).  It
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
WORK = ROOT / "workdir_x6_two_pass"
CSRC = Path("tpu_flash_torch") / "kernels" / "csrc"
BODY = CSRC / "flash_attention_bwd.cuh"
PASSES = CSRC / "flash_attention_bwd_two_pass.cu"
# form: (file, shipped text, the form's text), each text once in its file
EDITS = {
    "by_reference": [
        (BODY, "void kv_outer_x6_body(const BwdParams p)",
         "void kv_outer_x6_body(const BwdParams& p)")],
    "one_block_an_sm": [
        (BODY, "kQT = D <= 64 && kDQ ? 64 : 32;", "kQT = D <= 64 ? 64 : 32;"),
        (BODY, "NQ = D <= 64 && kDQ ? 32 : 16;", "NQ = D <= 64 ? 32 : 16;"),
        (PASSES, "kKT = 32;", "kKT = D <= 64 ? 64 : 32;"),
        (PASSES, "__launch_bounds__(kTcThreads, 2)\n"
                 "flash_attention_bwd_dkv_x6_kernel",
         "__launch_bounds__(kTcThreads)\nflash_attention_bwd_dkv_x6_kernel"),
        (PASSES, "__launch_bounds__(kTcThreads, 2)\n"
                 "flash_attention_bwd_dq_x6_kernel",
         "__launch_bounds__(kTcThreads)\nflash_attention_bwd_dq_x6_kernel")],
}
FORMS = ("shipped", "by_reference", "one_block_an_sm")
SHAPES = ((1, 8, 8192), (4, 8, 2048))     # (B, H, L): causal, d 64, fp32


def form_root(form: str) -> Path:
    """A tree whose ``tpu_flash_torch`` is built as ``form`` says."""
    if form == "shipped":
        return ROOT
    root = WORK / form
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(ROOT / "tpu_flash_torch", root / "tpu_flash_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for path, old, new in EDITS[form]:
        text = (root / path).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{form}: {old!r} is not once in {path}")
        (root / path).write_text(text.replace(old, new))
    return root


def one(form: str, root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from tpu_flash_torch.kernels import common, flash_attention as fa
    from tpu_flash_torch.utils.timing import device_ms

    assert Path(root).resolve() in Path(fa.__file__).resolve().parents
    sys.path.append(str(ROOT))
    from chip_smoke import ptxas_report

    torch.backends.cuda.matmul.allow_tf32 = False
    built = common.build([fa.KERNEL_BWD, fa.SOURCE_TWO_PASS], rebuild=True)
    row = {"form": form, "registers_spill_bytes": {
        k: (r["registers"], r.get("spill_stores", 0))
        for b in built.values() for k, r in ptxas_report(b.log).items()
        if "bwd" in k and "_x6_kernel" in k}, "ms": {}}
    gen = torch.Generator("cuda").manual_seed(0)
    for B, H, L in SHAPES:
        q, k, v, do = (torch.randn(B, H, L, 64, generator=gen, device="cuda")
                       for _ in range(4))
        out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True)
        kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True,
               1 / math.sqrt(64), 0)
        iters = max(1, round(4 * 2048 ** 2 * 10 / (B * L * L)))
        shape = f"B{B} H{H} L{L} d64 causal"
        row["ms"][shape] = {
            name: device_ms(fn, warmup=1, iters=iters, reps=5)
            for name, fn in (("dkv", lambda: fa._launch_dkv(*kin)),
                             ("dq", lambda: fa._launch_dq(*kin)),
                             ("fused", lambda: fa._launch_backward(*kin)))}
        if L == 2048:
            pin = (q, k, v, do, lse, kin[5], True, 1 / math.sqrt(64), 0)
            got = (*fa._launch_dkv(*kin), fa._launch_dq(*kin))
            want = (*fa._dkv_plain(*pin), fa._dq_plain(*pin))
            row["err_vs_plain"] = dict(zip(
                ("dk", "dv", "dq"),
                (float((a - b).abs().max()) for a, b in zip(got, want))))
        del q, k, v, do, out, lse, kin
        torch.cuda.empty_cache()
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
    summary = {}
    for f in FORMS:
        mine = [r for r in runs if r["form"] == f]
        summary[f] = {
            "ms": {s: {n: statistics.mean(r["ms"][s][n] for r in mine)
                       for n in mine[0]["ms"][s]} for s in mine[0]["ms"]},
            "registers_spill_bytes": mine[0]["registers_spill_bytes"],
            "err_vs_plain": mine[0]["err_vs_plain"]}
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
