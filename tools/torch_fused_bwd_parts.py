"""Where the fused tensor-core backward's time goes: the kernel as it is,
without the ordered wait on its dQ chunk (the adds then land in any order,
so the bits change from call to call), and without that wait and the dQ
adds (the dQ product, inline assembly the compiler keeps, still runs), each
timed by ``tools/torch_ab.py``'s rows at B4 H8 L2048 and B1 H8 L16384 bf16,
beside the dK/dV pass alone.

    PYTHONPATH=. python3 tools/torch_fused_bwd_parts.py

Each variant is a copy of ``tpu_flash_torch`` under ``_archive/`` (listed in
``.gitignore``) with one edit to ``csrc/flash_attention_bwd.cuh``, built and
timed in a process of its own.  Prints one JSON line a variant and the card's
name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HEADER = "tpu_flash_torch/kernels/csrc/flash_attention_bwd.cuh"
WAIT = "await_turn(order_of(it), tile);"
ADD = "        add(n0);\n"
VARIANTS = {
    "as_is": [],
    "no_ordered_wait": [(WAIT, "__syncthreads();")],
    "no_dq_adds": [(WAIT, "__syncthreads();"), (ADD, "\n")],
}


def variant_root(name: str, edits) -> Path:
    root = Path("_archive") / f"fused_bwd_{name}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree("tpu_flash_torch", root / "tpu_flash_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = root / HEADER
    src = header.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} not in {HEADER}")
        src = src.replace(old, new)
    header.write_text(src)
    return root


def main() -> int:
    for name, edits in VARIANTS.items():
        root = variant_root(name, edits)
        proc = subprocess.run(
            [sys.executable, "tools/torch_ab.py", "--one", str(root)],
            capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        rows = json.loads(proc.stdout.strip().splitlines()[-1])["rows"]
        print(json.dumps({"variant": name, "rows": [
            r for r in rows if r["dtype"] == "bfloat16"
            and r["what"] in ("bwd_fused", "dkv")]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
