"""Time the quantized matmuls' tensor-core decode form (bf16 x, M 8) at
the plan ``kernels/quant.py`` ``_plan`` picks and at other plans of the
same form, beside the library call (``x @ W`` with W dequantized to bf16,
cuBLAS), on each linear of the 176M serving model: the evidence for the
plan's tile widths, clusters and ring depth.  Each plan's output is held
to chip_smoke.py's bf16 limit against the plain version before it is
timed; weights rotate through enough copies to read past the 50 MB L2
(CUDA events, the median of 5 batches of 20 calls).

    PYTHONPATH=. python3 tools/torch_decode_plans.py

Prints one JSON line a (kind, shape, plan) and the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from tpu_flash_torch.kernels import common, quant
from tpu_flash_torch.kernels.common import cdiv
from tpu_flash_torch.utils.timing import past_l2, rotating_ms

KINDS = (("int8", None), ("int4", None), ("int4_g128", 128))
# (K, N) and other plans as (bn, cluster, stages, stage_rows), each range a
# whole number of 64 rows and each stage at most a warp's quarter of it:
# the projections, FF in, FF out, lm_head
SHAPES = {
    (1024, 1024): ((32, 4, 1, 64), (64, 8, 1, 32)),
    (1024, 4096): ((128, 8, 1, 32), (32, 4, 1, 64), (64, 8, 1, 32)),
    (4096, 1024): ((64, 8, 2, 64),),
    (1024, 32768): ((128, 1, 1, 32), (128, 1, 3, 32), (128, 1, 4, 32),
                    (128, 1, 4, 16), (64, 1, 2, 64)),
}


def plan_of(N, rows, bn, cluster, stages, stage_rows):
    """A ``decode_tc`` plan: ``cluster`` ranges of the code rows."""
    chunk = common.round_up(cdiv(rows, cluster), 64)
    stage_rows = min(stage_rows, chunk // 4)
    return quant.Plan("decode_tc", 8, bn, cdiv(rows, chunk), chunk,
                      cdiv(N, bn) * cdiv(rows, chunk),
                      min(stages, cdiv(chunk // 4, stage_rows)), stage_rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_plans: no CUDA device", file=sys.stderr)
        return 2
    picked = quant._plan
    gen = torch.Generator("cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, group in KINDS:
        for (K, N), others in SHAPES.items():
            w = torch.randn(K, N, generator=gen, device="cuda")
            if kind == "int8":
                q, rows = quant.quantize_weight(w), K

                def call(x, *q, impl=None):
                    return quant.int8_matmul(x, *q, impl=impl)
            else:
                q = quant.quantize_weight_int4(w, group_size=group)[:2]
                rows = q[0].shape[0]

                def call(x, *q, impl=None):
                    return quant.int4_matmul(x, *q, k_dim=K, impl=impl)
            x = torch.randn(8, K, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            qs = past_l2(*q)
            deqs = past_l2(quant.dequantize(*q, K).to(torch.bfloat16))
            library_ms = rotating_ms(lambda d: x @ d, deqs)
            want = call(x, *q, impl="plain").float()
            plans = [("picked", picked(8, N, rows, sms, torch.bfloat16,
                                       group))]
            plans += [("other", plan_of(N, rows, *o)) for o in others]
            for label, plan in plans:
                quant._plan = lambda *a, plan=plan: plan
                try:
                    got = call(x, *q).float()
                    rms = float(want.square().mean().sqrt())
                    ok = bool(((got - want).abs() <= 1e-2 * rms
                               + 2e-2 * want.abs()).all())
                    ms = rotating_ms(lambda *w: call(x, *w), qs)
                finally:
                    quant._plan = picked
                print(json.dumps({
                    "kind": kind, "shape": f"M8 K{K} N{N}", "plan": label,
                    "bn": plan.bn, "cluster": plan.splits,
                    "blocks": plan.blocks, "stages": plan.stages,
                    "stage_rows": plan.stage_rows, "ms": ms,
                    "library_ms": library_ms, "ok": ok}), flush=True)
            del w, q, qs, deqs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
