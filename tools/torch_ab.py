"""Time two trees of the port on one card, in turns (A, B, B, A), each turn
in a process of its own:

  * the fused flash-attention backward kernel at the shapes below (CUDA
    events, the median of 5 batches), with a check that two calls give the
    same bits;
  * the prefill of one 1024-token prompt through the 176M serving decoder
    (``chip_smoke.py``'s SERVING: V 32768, E 1024, 8 layers, FF 4096,
    bf16, random weights from a seed) with int8, int4 and int4-in-groups-
    of-128 weights: the forward's device time (CUDA events) and the
    quantized matmul kernels' share of it (``torch.profiler``).

    PYTHONPATH=. python3 tools/torch_ab.py A_ROOT B_ROOT

A_ROOT and B_ROOT are checkouts of the repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists,
and ``.``).  Each turn imports ``tpu_flash_torch`` from its root and builds
that tree's kernels there.  It prints one JSON line a turn and a summary
with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
from pathlib import Path

# (dtype, B, H, L): causal, d 64.  B4 H8 L2048 is the production training
# shape; B1 H8 L16384 the long-context shape, where the fused arm is timed
# beside the two passes the JAX rule picks.
SHAPES = (("bfloat16", 4, 8, 2048), ("float32", 4, 8, 2048),
          ("bfloat16", 1, 8, 16384))
SERVING = dict(n_vocab=32768, n_embd=1024, n_head=16, n_positions=8192,
               n_layer=8, ff_middle_dim=4096, p_dropout=0.0,
               attention_kind="flash")
QUANTS = (("int8", 8, None), ("int4", 4, None), ("int4_g128", 4, 128))
PROMPT = 1024


def backward_rows(torch, fa, device_ms) -> list[dict]:
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []
    for dname, B, H, L in SHAPES:
        dtype = getattr(torch, dname)
        q, k, v, do = (torch.randn(B, H, L, 64, generator=gen, device="cuda"
                                   ).to(dtype) for _ in range(4))
        out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True)

        def bwd():
            return fa.flash_attention_backward_fused(q, k, v, out, lse, do,
                                                     causal=True)

        first, second = bwd(), bwd()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        iters = max(1, round(4 * 2048 ** 2 * 10 / (B * L * L)))
        ms = device_ms(bwd, warmup=1, iters=iters, reps=5)
        rows.append({"what": "fused_backward", "dtype": dname,
                     "shape": f"B{B} H{H} L{L} d64 causal", "ms": ms,
                     "two_calls_same_bits": same})
        del q, k, v, do, out, lse, first, second
        torch.cuda.empty_cache()
    return rows


def prefill_rows(torch, nn, device_ms) -> list[dict]:
    from torch.profiler import ProfilerActivity, profile

    model = nn.DecoderLM(nn.DecoderConfig(**SERVING, dtype=torch.bfloat16),
                         device="cuda")
    nn.init_params(model, torch.Generator("cuda").manual_seed(0))
    prompt = torch.randint(1, SERVING["n_vocab"], (1, PROMPT), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    rows = []
    for name, bits, group in QUANTS:
        qmodel = nn.quantize_model_linears(copy.deepcopy(model), bits=bits,
                                           group_size=group)
        with torch.no_grad():
            ms = device_ms(lambda: qmodel(prompt), warmup=2, iters=5, reps=5)
            matmul_ms = []
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    qmodel(prompt)
                    torch.cuda.synchronize()
                matmul_ms.append(sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if "matmul" in e.key) / 1e3)
        rows.append({"what": "prefill", "weights": name,
                     "prompt_tokens": PROMPT, "forward_ms": ms,
                     "quant_matmul_ms": statistics.median(matmul_ms)})
        del qmodel
        torch.cuda.empty_cache()
    return rows


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from tpu_flash_torch import nn
    from tpu_flash_torch.kernels import common, flash_attention as fa
    from tpu_flash_torch.utils.timing import device_ms

    where = Path(fa.__file__).resolve()
    assert Path(root).resolve() in where.parents, where
    common.build([fa.KERNEL_FWD, fa.KERNEL_BWD, "int8_matmul",
                  "int4_matmul"])
    return {"root": root, "rows": backward_rows(torch, fa, device_ms)
            + prefill_rows(torch, nn, device_ms)}


def main() -> int:
    if sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])), flush=True)
        return 0
    a, b = sys.argv[1], sys.argv[2]
    runs = []
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    summary = []
    for i, row in enumerate(runs[0]["rows"]):
        key = "ms" if row["what"] == "fused_backward" else "forward_ms"
        vals = {r: [x["rows"][i][key] for x in runs if x["root"] == r]
                for r in (a, b)}
        dropped = (key, "quant_matmul_ms", "two_calls_same_bits")
        entry = {k: v for k, v in row.items() if k not in dropped}
        entry.update({"a_" + key: vals[a], "b_" + key: vals[b],
                      "b_over_a": statistics.mean(vals[b])
                      / statistics.mean(vals[a])})
        if row["what"] == "prefill":
            entry["a_quant_matmul_ms"], entry["b_quant_matmul_ms"] = (
                [x["rows"][i]["quant_matmul_ms"] for x in runs
                 if x["root"] == r] for r in (a, b))
        else:
            entry["same_bits"] = [x["rows"][i]["two_calls_same_bits"]
                                  for x in runs]
        summary.append(entry)
    print(json.dumps({"summary": summary, "turns": [r["root"] for r in runs],
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
