"""Smoke test of the PyTorch/CUDA port (``tpu_flash_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every kernel of the serving path from ``tpu_flash_torch/kernels/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card, times it, serves requests through ``DecodeEngine`` at the full width
of the 176M serving configuration, lists the kernels of one decode step
under ``torch.profiler``, and checks the engine against
``generate`` and the kernel against the plain path end to end.  Each phase
prints one JSON line; any failure raises and the script exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device it
exits with code 2 and prints no result.  It imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_flash_torch.inference import DecodeEngine, KVCache, SamplingConfig
from tpu_flash_torch.inference.engine import Request
from tpu_flash_torch.inference.sampler import generate, prefill_prompt
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels.decode import flash_decode_attention
from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, init_params,
                                num_parameters)
from tpu_flash_torch.utils.timing import device_ms

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM data sheet, CUDA cores
SERVING = dict(n_vocab=32768, n_embd=1024, n_head=16, n_positions=8192,
               n_layer=8, ff_middle_dim=4096, p_dropout=0.0,
               attention_kind="flash", dtype=torch.bfloat16)
# kernel vs plain: bf16 outputs differ by up to one bf16 ulp (1.6e-2 at
# |out| < 4) and the kernel rounds p to bf16 before P.V where the plain
# version keeps fp32; fp32 differs only by summation order and __expf.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def filled_cache(gen, B, Hkv, S, d, quant, dtype, lengths):
    """A KVCache holding S random positions (written through append), with
    the given lengths."""
    cache = KVCache.create(B, Hkv, S, d, quant=quant, compute_dtype=dtype,
                           device=DEV)
    k = torch.randn(B, Hkv, S, d, generator=gen, device=DEV).to(dtype)
    v = torch.randn(B, Hkv, S, d, generator=gen, device=DEV).to(dtype)
    cache.append(k, v)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def kernel_cases(gen) -> float:
    """Phase 3: the kernel against its plain version; returns the largest
    error."""
    serving_lengths = [0, 1, 7, 1023, 1024, 1025, 8191, 8192]
    cases = [
        # name, B, Hq, Hkv, Lq, S, d, dtype, quant, lengths, window
        ("serving-bf16", 8, 16, 16, 1, 8192, 64, torch.bfloat16, "none",
         serving_lengths, None),
        ("serving-int8", 8, 16, 16, 1, 8192, 64, torch.bfloat16, "int8",
         serving_lengths, None),
        ("serving-fp8", 8, 16, 16, 1, 8192, 64, torch.bfloat16, "fp8",
         serving_lengths, None),
        ("gqa-16q4kv-lq4", 8, 16, 4, 4, 2048, 64, torch.bfloat16, "none",
         [0, 2, 3, 4, 5, 100, 2047, 2048], None),
        ("window256", 8, 16, 16, 1, 8192, 64, torch.bfloat16, "int8",
         serving_lengths, 256),
        ("fp32", 4, 16, 16, 1, 4096, 64, torch.float32, "none",
         [1, 129, 4000, 4096], None),
        ("d128-int8-lq2", 4, 8, 8, 2, 1024, 128, torch.bfloat16, "int8",
         [1, 2, 500, 1024], None),
        ("mqa-d32-lq8-fp32", 2, 16, 1, 8, 512, 32, torch.float32, "none",
         [5, 512], None),
        ("d16-fp8-window", 3, 4, 2, 3, 300, 16, torch.bfloat16, "fp8",
         [2, 150, 300], 5),
    ]
    worst = 0.0
    for (name, B, Hq, Hkv, Lq, S, d, dtype, quant, lengths,
         window) in cases:
        cache = filled_cache(gen, B, Hkv, S, d, quant, dtype, lengths)
        q = torch.randn(B, Hq, Lq, d, generator=gen, device=DEV).to(dtype)
        args = (q, cache.k, cache.v, cache.lengths, cache.k_scale,
                cache.v_scale)
        out = flash_decode_attention(*args, window=window, impl="kernel")
        ref = flash_decode_attention(*args, window=window, impl="plain")
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        err = float((out - ref).abs().max())
        tol = TOL[dtype]
        ok = bool(torch.isfinite(out).all()) and bool(
            ((out - ref).abs() <= tol + tol * ref.abs()).all())
        log({"phase": "kernel_vs_plain", "case": name, "max_abs_err": err,
             "tol": f"atol {tol} + rtol {tol}", "ok": ok})
        check(ok, f"flash_decode disagrees with its plain version: {name}")
        worst = max(worst, err)
        del cache
    return worst


def kernel_times(gen) -> list[dict]:
    """Phase 4: kernel, plain and library times at the serving shape.
    Four copies of the cache rotate so that no call finds the previous
    call's data in L2, as each layer's own cache would not be there."""
    B, H, d, S, R = 8, 16, 64, 8192, 4
    rows = []
    for quant in ("none", "int8"):
        dtype = torch.bfloat16
        if quant == "none":
            k = torch.randn(R * B, S, H * d, generator=gen, device=DEV,
                            dtype=dtype)
            v = torch.randn(R * B, S, H * d, generator=gen, device=DEV,
                            dtype=dtype)
            ks = vs = None
        else:
            k = torch.randint(-127, 128, (R * B, S, H * d), generator=gen,
                              device=DEV, dtype=torch.int8)
            v = torch.randint(-127, 128, (R * B, S, H * d), generator=gen,
                              device=DEV, dtype=torch.int8)
            ks = torch.rand(R * B, H, S, generator=gen, device=DEV) / 64
            vs = torch.rand(R * B, H, S, generator=gen, device=DEV) / 64
        q = torch.randn(B, H, 1, d, generator=gen, device=DEV, dtype=dtype)
        for L in (8192, 1024):
            lengths = torch.full((R * B,), L, dtype=torch.int32, device=DEV)

            def part(x, i):
                return None if x is None else x[i * B:(i + 1) * B]

            def dense(x, s, i):   # [B, H, L, d] dequantized view
                x = part(x, i)[:, :L].view(B, L, H, d).float()
                if s is not None:
                    x = x * part(s, i)[:, :, :L].transpose(1, 2)[..., None]
                return x.to(dtype).transpose(1, 2).contiguous()

            views = [dense(k, ks, i) for i in range(R)]
            vviews = [dense(v, vs, i) for i in range(R)]
            tick = [0]

            def call(impl):
                i = tick[0] = (tick[0] + 1) % R
                return flash_decode_attention(
                    q, part(k, i), part(v, i), part(lengths, i), part(ks, i),
                    part(vs, i), impl=impl)

            def library():
                i = tick[0] = (tick[0] + 1) % R
                return torch.nn.functional.scaled_dot_product_attention(
                    q, views[i], vviews[i])

            ms = device_ms(lambda: call("kernel"))
            plain_ms = device_ms(lambda: call("plain"), iters=5)
            library_ms = device_ms(library)
            itemsize = k.element_size()
            nbytes = (2 * B * H * L * d * itemsize           # K and V codes
                      + (2 * B * H * L * 4 if ks is not None else 0)
                      + 2 * B * H * d * q.element_size()     # q and out
                      + B * 4)                               # lengths
            flops = 4 * B * H * L * d
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": flops / FP32_FLOPS * 1e3}
            bound_by = max(bound, key=bound.get)
            row = {"cache": "bf16" if quant == "none" else quant,
                   "length": L, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bytes": nbytes,
                   "bound_ms": bound[bound_by], "bound_by": bound_by,
                   "hbm_GBps": nbytes / (ms * 1e-3) / 1e9}
            log({"phase": "kernel_time", "kernel": "flash_decode",
                 "shape": f"B{B} Hq{H} Hkv{H} Lq1 d{d} S{S}", **row})
            rows.append(row)
            del views, vviews
        del k, v, ks, vs
    return rows


def step_profile(eng, steps: int = 4) -> dict:
    """Kernels of one decode step (all slots live) under torch.profiler:
    launches per step, their summed device time, and the eight largest."""
    from torch.profiler import ProfilerActivity, profile

    live = torch.ones(eng.n_slots, dtype=torch.bool, device=DEV)
    eng._decode_step(eng.last_tokens, live)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng._decode_step(eng.last_tokens, live)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"kernels_per_step": sum(e.count for e in kernels) / steps,
            "kernel_ms_per_step": total_us / steps / 1e3,
            "top": [{"name": e.key[:80], "count_per_step": e.count / steps,
                     "ms_per_step": e.self_device_time_total / steps / 1e3,
                     "share": e.self_device_time_total / total_us
                     if total_us else None} for e in top]}


def serving(model, n_layer: int) -> int:
    """Phase 5: 16 requests through the engine in three modes; returns the
    kernel launches counted while the engines ran."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, 16)
    prompts = [rng.integers(1, model.cfg.n_vocab, n).tolist() for n in lens]
    sampling = SamplingConfig(max_new_tokens=64)
    finite = torch.ones((), dtype=torch.bool, device=DEV)

    def watch(_mod, _inp, out):
        finite.logical_and_(torch.isfinite(out).all())

    # warm-up: library load, cuBLAS handles, allocator
    warm = DecodeEngine(model, n_slots=8, max_len=8192, sampling=SamplingConfig(
        max_new_tokens=4), kv_quant="int8", device=DEV)
    warm.submit(Request(0, prompts[0]))
    warm.run()
    del warm
    torch.cuda.synchronize()

    total = 0
    hook = model.lm_head.register_forward_hook(watch)
    try:
        for quant, chunk, drive in (("int8", None, "run_many(8)"),
                                    ("none", None, "run()"),
                                    ("int8", 256, "run_many(8)")):
            eng = DecodeEngine(model, n_slots=8, max_len=8192,
                               sampling=sampling, kv_quant=quant,
                               prefill_chunk=chunk, device=DEV)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid, p))
            common.launch_counts.clear()
            t0 = time.perf_counter()
            done = eng.run_many(8) if drive == "run_many(8)" else eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = common.launch_counts["flash_decode"]
            steps = eng.stats["decode_steps"]
            n_tok = sum(len(c.tokens) for c in done)
            step_ms = eng.stats["decode_s"] / steps * 1e3
            # device time of one decode step (8 slots), the stream held
            # until the host has queued the whole step
            live = torch.ones(8, dtype=torch.bool, device=DEV)
            step_device_ms = device_ms(
                lambda: eng._decode_step(eng.last_tokens, live), warmup=1,
                iters=1, reps=5, hold_cycles=100_000_000)
            log({"phase": "serving", "kv_quant": quant,
                 "prefill_chunk": chunk, "drive": drive,
                 "requests": len(done), "tokens": n_tok, "wall_s": wall,
                 "tok_s": n_tok / wall, "decode_steps": steps,
                 "decode_ms_per_step": step_ms,
                 "decode_device_ms_per_step": step_device_ms,
                 "decode_device_idle_share": 1 - step_device_ms / step_ms,
                 "admit_s": eng.stats["admit_s"],
                 "flash_decode_launches": launches,
                 "card": torch.cuda.get_device_name(0)})
            check(sorted(c.uid for c in done) == list(range(len(prompts))),
                  f"{drive}/{quant}: not every request completed")
            check(all(len(c.tokens) == 64 and c.finished_reason == "length"
                      for c in done), f"{drive}/{quant}: short completion")
            check(steps > 0 and launches == n_layer * steps,
                  f"{drive}/{quant}: {launches} kernel launches for {steps} "
                  f"decode steps of {n_layer} layers")
            check(bool(finite), f"{drive}/{quant}: non-finite logits")
            total += launches
            log({"phase": "decode_profile", "kv_quant": quant,
                 "drive": drive, **step_profile(eng)})
            del eng, done
    finally:
        hook.remove()
    return total


def end_to_end() -> None:
    """Phase 6: full width, 2 layers, fp32 with TF32 off: engine tokens
    against generate's and the uncached forward's, and one decode step's
    logits with the kernel against the plain path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DecoderConfig(**{**SERVING, "n_layer": 2, "dtype": torch.float32,
                           "attention_kind": "naive"})
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(1))
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 200, 8)
    n_new, max_len = 16, 1024
    ids = np.zeros((8, int(lens.max())), np.int64)
    prompts = []
    for i, n in enumerate(lens):
        prompts.append(rng.integers(1, cfg.n_vocab, n).tolist())
        ids[i, :n] = prompts[-1]
    sampling = SamplingConfig(max_new_tokens=n_new)
    ref, _ = generate(model, ids, lens, sampling, max_len=max_len,
                      device=DEV)
    ref = ref.cpu().numpy()
    eng = DecodeEngine(model, n_slots=8, max_len=max_len, sampling=sampling,
                       device=DEV)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid, p))
    got = {c.uid: c.tokens for c in eng.run()}
    # A token may differ only where the uncached forward's top-2 gap is a
    # near tie; the comparison of that sequence stops there.
    compared = ties = 0
    with torch.no_grad():
        for i, p in enumerate(prompts):
            full = torch.tensor([p + ref[i].tolist()], device=DEV)
            logits = model(full)[0, len(p) - 1:len(p) - 1 + n_new]
            top2 = logits.topk(2, dim=-1)
            gap = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            arg = top2.indices[:, 0].cpu().numpy()
            for t in range(n_new):
                if got[i][t] == ref[i][t] == arg[t]:
                    compared += 1
                    continue
                check(gap[t] < 1e-3, f"sequence {i} step {t}: engine "
                      f"{got[i][t]}, generate {ref[i][t]}, uncached {arg[t]}"
                      f" with top-2 gap {gap[t]}")
                ties += 1
                break
    check(compared >= 0.9 * 8 * n_new, f"only {compared} tokens compared")

    with torch.no_grad():
        dev_ids = torch.from_numpy(ids).to(DEV)
        dev_lens = torch.from_numpy(lens).to(DEV)
        last, caches = prefill_prompt(model, dev_ids, dev_lens,
                                      max_len=max_len)
        tok = last.argmax(-1)[:, None]
        pos = caches[0].lengths[:, None].long()
        out = {}
        for impl in ("kernel", "plain"):
            copies = [dataclasses.replace(
                c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone())
                for c in caches]
            out[impl], _ = model(tok, kv_caches=copies, positions=pos,
                                 impl=impl)
        err = float((out["kernel"] - out["plain"]).abs().max())
    tol = 1e-4   # fp32 logits of |x| ~ 1: summation order and __expf
    log({"phase": "end_to_end", "tokens_compared": compared,
         "near_ties": ties, "logits_max_abs_err": err,
         "logits_tol": tol})
    check(err <= tol, f"kernel vs plain decode logits differ by {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log({"phase": "device", "name": name, "count": count,
         "nvidia_smi": smi.splitlines()[0], "torch": torch.__version__,
         "cuda": torch.version.cuda})

    built = common.build(["flash_decode"])
    log({"phase": "build", **{n: {"seconds": r.seconds, "log": r.log[-2000:]}
                              for n, r in built.items()}})

    gen = torch.Generator(DEV).manual_seed(0)
    worst = kernel_cases(gen)
    rows = kernel_times(gen)

    cfg = DecoderConfig(**SERVING)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    log({"phase": "model", "params": num_parameters(model),
         "config": {k: str(v) for k, v in SERVING.items()}})
    launches = serving(model, cfg.n_layer)
    del model
    torch.cuda.empty_cache()
    end_to_end()

    main_row = next(r for r in rows if r["cache"] == "int8"
                    and r["length"] == 1024)
    log({"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "tpu_flash_torch/kernels/csrc/flash_decode.cu",
        "replaces": "tpu_flash/kernels/decode.py:93",
        "launches": launches, "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B8 Hq16 Hkv16 Lq1 d64 S8192 int8 cache, lengths 1024"}]})
    print(smi.splitlines()[0], flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
