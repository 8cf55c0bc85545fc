"""Registers, stack and spills of every flash-attention kernel, this tree's
against another tree's (the parent's), from ptxas's report.

Builds this tree's flash sources (the forms without quantized K/V and the
``_kvq`` / ``_kvqc`` libraries of the quantized ones) with
``kernels/common.py``'s flags and, at the same time, the other tree's
forms without quantization; prints a line for each source (seconds of its
nvcc, kernels reported, ptxas's warnings), one for each quantized kernel,
then the kernels without quantization whose report differs from the other
tree's (a kernel ``name<D,mask,drop>`` there is ``name<D,mask,drop,0>``
here) and every kernel that spills.  Needs the CUDA toolkit (run it on the
machine with the card):

    PYTHONPATH=. python3 tools/torch_flash_registers.py _archive/parent
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels import flash_attention as fa

NAMES = ("flash_attention_fwd", "flash_attention_bwd", fa.SOURCE_TWO_PASS)


def main(other: str) -> int:
    t0 = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp())
    theirs = {
        n: subprocess.Popen(
            [common.find_nvcc(), *common.NVCC_FLAGS, "-o",
             str(out_dir / f"{n}.so"),
             str(Path(other) / "tpu_flash_torch/kernels/csrc" / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in NAMES}
    built = common.build(NAMES + tuple(n + s for n in NAMES
                                       for s in fa.KVQ.values()),
                         rebuild=True)
    mine = {}
    for n, r in built.items():
        report = chip_smoke.ptxas_report(r.log)
        mine.update(report)
        print(json.dumps({"source": n, "seconds": r.seconds,
                          "kernels": len(report),
                          "warnings": [ln for ln in r.log.splitlines()
                                       if "warning" in ln][:20]}),
              flush=True)
        if n not in NAMES:
            for k, v in sorted(report.items()):
                print(json.dumps({"kvq_kernel": k, **v}), flush=True)
    old = {}
    for n, p in theirs.items():
        stdout, stderr = p.communicate()
        if p.returncode:
            print(json.dumps({"other_tree_build_failed": n,
                              "log": stderr[-2000:]}))
            return 1
        old.update(chip_smoke.ptxas_report(stdout + stderr))
    differ = {k: {"other": v, "this": mine.get(k[:-1] + ",0>")}
              for k, v in sorted(old.items())
              if mine.get(k[:-1] + ",0>") != v}
    spilling = {k: v for k, v in mine.items()
                if v.get("spill_stores", 0) or v.get("spill_loads", 0)}
    print(json.dumps({"seconds": time.perf_counter() - t0,
                      "unquantized_kernels": len(old), "differ": differ,
                      "spilling": spilling,
                      "card": chip_smoke.torch.cuda.get_device_name(0)}),
          flush=True)
    return 0 if not differ and not spilling else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
