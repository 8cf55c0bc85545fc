"""Host time of one decode step of the PyTorch/CUDA port with quantized
linears, and what two host-side shortcuts would save, on one CUDA card.

The shortcuts, applied here by patching ``tpu_flash_torch.kernels``; the
package itself takes neither:

* ``direct``: the quantized Linear calls its matmul itself, not its
  autograd Function (serving needs no gradient);
* ``lazy_guard``: a launch enters ``torch.cuda.device`` only when another
  device is current (``common.call_on_stream`` enters it every time).

``both`` takes the two, ``shipped`` neither, and ``bf16`` is the same step
with the float weights (cuBLAS linears) as a yardstick.  The model is the
176M serving decoder (V 32768, E 1024, 16 heads, 8 layers, FF 4096, bf16,
random weights from seed 0), int8 weights, 8 slots filled with prompts of
16 to 1024 tokens, an int8 KV cache.  A step's host time is the wall time
to queue ``DecodeEngine._decode_step`` (the card is synchronized before
and after, outside it).  The variants run interleaved, in order and then
in reverse, ``--rounds`` times; each pass takes the median of ``--steps``
steps after 3 untimed.  Prints one JSON line per pass and a summary line:

    PYTHONPATH=. python3 tools/torch_decode_host_cost.py --rounds 4 \
        --steps 40
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from tpu_flash_torch.inference import DecodeEngine, SamplingConfig
from tpu_flash_torch.inference.engine import Request
from tpu_flash_torch.kernels import (common, decode, flash_attention,
                                     layernorm, quant, softmax)
from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, init_params,
                                quantize_model_linears)

SERVING = dict(n_vocab=32768, n_embd=1024, n_head=16, n_positions=8192,
               n_layer=8, ff_middle_dim=4096, p_dropout=0.0,
               attention_kind="flash", dtype=torch.bfloat16)
VARIANTS = ("shipped", "direct", "lazy_guard", "both", "bf16")
LAUNCHING = (decode, flash_attention, layernorm, quant, softmax)
DIRECT = {
    quant._Int8Linear: lambda x, codes, scales, impl: quant.int8_matmul(
        x, codes, scales, impl=impl),
    quant._Int4Linear: lambda x, packed, scales, k, impl: quant.int4_matmul(
        x, packed, scales, k_dim=k, impl=impl)}


def lazy_call_on_stream(fn, device, *args):
    """``call_on_stream`` entering the device guard only when another
    device is current."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return lazy_call_on_stream(fn, device, *args)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)


@contextlib.contextmanager
def variant(name: str):
    linear, calls = quant._linear, [m.call_on_stream for m in LAUNCHING]
    if name in ("direct", "both"):
        quant._linear = lambda fn, *a: linear(DIRECT[fn.__self__], *a)
    if name in ("lazy_guard", "both"):
        for m in LAUNCHING:
            m.call_on_stream = lazy_call_on_stream
    try:
        yield
    finally:
        quant._linear = linear
        for m, c in zip(LAUNCHING, calls):
            m.call_on_stream = c


def filled_engine(model, prompts) -> DecodeEngine:
    eng = DecodeEngine(model, n_slots=8, max_len=8192,
                       sampling=SamplingConfig(max_new_tokens=4096),
                       kv_quant="int8")
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p))
    eng.admit()
    return eng


@torch.no_grad()
def step_ms(eng: DecodeEngine, steps: int) -> float:
    """Median host ms to queue one decode step, over ``steps`` steps."""
    live = torch.ones(8, dtype=torch.bool, device=eng.device)
    tok = eng.last_tokens
    for _ in range(3):
        tok = eng._decode_step(tok, live)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok = eng._decode_step(tok, live)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0]}), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    common.build(["flash_decode", "int8_matmul"])

    model = DecoderLM(DecoderConfig(**SERVING), device="cuda")
    init_params(model, torch.Generator("cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, SERVING["n_vocab"], n).tolist()
               for n in rng.integers(16, 1025, 8)]
    engines = {"bf16": filled_engine(model, prompts)}
    engines["int8"] = filled_engine(
        quantize_model_linears(copy.deepcopy(model), bits=8), prompts)

    passes = {v: [] for v in VARIANTS}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for r in range(args.rounds):
        for v in order:
            with variant(v):
                ms = step_ms(engines["bf16" if v == "bf16" else "int8"],
                             args.steps)
            passes[v].append(ms)
            print(json.dumps({"round": r, "variant": v,
                              "host_ms_per_step": ms}), flush=True)
    print(json.dumps({"summary": {
        v: {"median": statistics.median(m), "min": min(m), "max": max(m),
            "passes": len(m)} for v, m in passes.items()},
        "steps_a_pass": args.steps, "card": smi.splitlines()[0]}))


if __name__ == "__main__":
    main()
