"""Time the LayerNorm forward kernel at the plan ``kernels/layernorm.py``
``_fwd_plan`` picks and at grids of other sizes (blocks of 8 warps an SM
of the card, the rows a warp loads at once fixed by the kernel's form), at
the training shapes R8192 H256 and H512 in bf16 and fp32: the evidence for
the plan's ``LN_FWD_BLOCKS_PER_SM`` (2).  At 1 or 2 blocks an SM a warp
walks several passes of rows, the next pass's loads in flight while it
finishes this one; from 4 every warp takes one pass at R8192 H256.  Each
plan's output is held to ``chip_smoke.py``'s limits against the plain
version before it is timed; inputs rotate through enough copies to read
past the 50 MB L2 (CUDA events, the median of 5 batches of 20 calls).

    PYTHONPATH=. python3 tools/torch_ln_fwd_plans.py

Prints one JSON line a (dtype, H, blocks an SM), with the bound (bytes at
3.35 TB/s), and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from tpu_flash_torch.kernels import layernorm
from tpu_flash_torch.utils.timing import past_l2, rotating_ms

R = 8192
SHAPES = ((torch.bfloat16, 256), (torch.float32, 256),
          (torch.bfloat16, 512), (torch.float32, 512))
PER_SM = (1, 2, 3, 4, 6, 8)
HBM_BYTES_PER_S = 3.35e12
# chip_smoke.py's FUSED_TOL for y: (arms, rtol) by dtype
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}


def within(got, want, arms, rtol) -> bool:
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt())
    return bool(((got - want).abs() <= arms * rms + rtol * want.abs()).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator("cuda").manual_seed(0)
    chosen = layernorm.LN_FWD_BLOCKS_PER_SM
    for dtype, H in SHAPES:
        x = torch.randn(R, H, generator=gen, device="cuda").to(dtype)
        g = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(H, generator=gen, device="cuda")).to(dtype)
        want = layernorm.layernorm_forward(x, g, b, impl="plain")
        nbytes = 2 * x.numel() * x.element_size() + 2 * R * 4
        for per_sm in PER_SM:
            layernorm.LN_FWD_BLOCKS_PER_SM = per_sm
            try:
                got = layernorm.layernorm_forward(x, g, b)
                torch.cuda.synchronize()
                ok = within(got[0], want[0], *TOL[dtype]) and all(
                    within(a, w, *TOL[torch.float32])
                    for a, w in zip(got[1:], want[1:]))
                ms = rotating_ms(lambda x: layernorm.layernorm_forward(
                    x, g, b), past_l2(x), iters=20, reps=5)
                plan = layernorm._fwd_plan(
                    R, H, dtype, layernorm.sm_count(x.device))
            finally:
                layernorm.LN_FWD_BLOCKS_PER_SM = chosen
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(json.dumps({
                "dtype": str(dtype).split(".")[1], "shape": f"R{R} H{H}",
                "blocks_per_sm": per_sm, "plan": plan._asdict(),
                "the_plan": per_sm == chosen, "ms": ms, "bound_ms": bound,
                "of_bound": bound / ms, "agrees": ok}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
