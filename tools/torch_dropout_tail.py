"""How far the bf16 flash forward's dropout form sits from its plain version
at mode (f)'s shape (B1 H8 L16384 d64 causal), beside the form without
dropout on the same inputs: for dropout rates 0 (the form without dropout),
1e-6, 0.1 and 0.5, the largest excess of |kernel - plain| over
``chip_smoke.py``'s rtol (0.02 |plain|) as a share of the output's rms (the
"arms" its limits take), overall and by rows 0-64, 64-1024 and 1024-16384,
and where the worst element sits.  The kernel rounds P keep / (1 - rate) to
bf16 against its running max, the plain version against the row's final
max; this shows how that difference's tail moves with dropout.

    PYTHONPATH=. python3 tools/torch_dropout_tail.py

Inputs from a seed, ``chip_smoke.py``'s dropout seed.  Prints one JSON line
a rate and the card's name and power limit.  Needs a CUDA device (~1 min).
"""

from __future__ import annotations

import json
import subprocess

import torch

from chip_smoke import DROP_SEED
from tpu_flash_torch.kernels import flash_attention as fa

B, H, L, D = 1, 8, 16384, 64
ROWS = ((0, 64), (64, 1024), (1024, L))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn(B, H, L, D, generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    for rate in (0.0, 1e-6, 0.1, 0.5):
        kw = dict(causal=True, dropout_rate=rate, dropout_seed=DROP_SEED)
        got = fa.flash_attention_forward(q, k, v, impl="kernel", **kw)[0]
        want = fa.flash_attention_forward(q, k, v, impl="plain", **kw)[0]
        got, want = got.float(), want.float()
        rms = float(want.square().mean().sqrt())
        excess = (got - want).abs() - 0.02 * want.abs()
        i = int(excess.argmax())
        print(json.dumps({
            "rate": rate, "rms": rms,
            "arms_needed": float(excess.max()) / rms,
            "arms_needed_by_rows": {
                f"rows {lo}-{hi}": float(excess[:, :, lo:hi].max()) / rms
                for lo, hi in ROWS},
            "worst": {"head": i // (L * D), "row": i // D % L, "col": i % D,
                      "kernel": float(got.flatten()[i]),
                      "plain": float(want.flatten()[i])}}), flush=True)
        del got, want, excess
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
