"""Smoke test of the PyTorch/CUDA port (``tpu_flash_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every kernel of the port from ``tpu_flash_torch/kernels/csrc``
with nvcc (one process per source, all started together), then drives both
ported paths:

* serving: the flash-decode kernel against its plain PyTorch version and its
  times; 16 requests through ``DecodeEngine`` at the full width of the 176M
  serving configuration in three modes, with the kernels of one decode step
  under ``torch.profiler``; the engine against ``generate`` and the kernel
  against the plain path end to end;
* training: the flash-attention forward and backward kernels against their
  plain versions (fp32 and bf16, causal or not, L 64 to 2048, Lq != Lk with
  empty rows, GQA, d 32/64/128; each error beside its limit and the
  output's rms, and a check that the limit fails a dropped key tile) and
  their times at B4 H8 L2048 d64; the fused LayerNorm and masked-softmax
  kernels against their plain versions (fp32 and bf16, the reference MT
  shapes, ragged widths, rows that see no key, a fully padded batch row,
  widths above 512; each limit checked against a perturbed row), their
  times at the reference MT shapes, and ``ops.fused``'s kernel route
  against its composed route (forward plus backward) at last axes 640 and
  1024, above its 512 limits; ``train_epoch`` in five modes: the E=512
  L=2048 decoder (``bench/bench_train.py``'s production config) with flash
  attention in fp32 with Adam (a) and in bf16 with mixed-precision Adam and
  dropout (b), the reference MT config (``bench_train.py``'s "ref" row,
  fused attention and fused LayerNorm) in fp32 (c) and in bf16 with mixed
  precision and dropout (d), and the production config with flash attention
  and fused LayerNorm in bf16 (e), each with step times, device idle share,
  the kernels of a step, the check that each kernel ran its expected
  number of times a step, and the check that a step from a host batch
  makes the host wait nowhere; and one fp32 step with the kernels against
  one with the plain versions (loss, gradients, updated parameters) at the
  production flash config and at the reference fused config.

Each phase prints JSON lines; any failure raises and the script exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits with code 2 and prints no result.  It imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from tpu_flash_torch.apps.machine_translation import (make_train_step,
                                                     place_batch, train_epoch)
from tpu_flash_torch.inference import DecodeEngine, KVCache, SamplingConfig
from tpu_flash_torch.inference.engine import Request
from tpu_flash_torch.inference.sampler import generate, prefill_prompt
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels.decode import flash_decode_attention
from tpu_flash_torch.kernels.flash_attention import (flash_attention_backward,
                                                     flash_attention_forward)
from tpu_flash_torch.kernels.layernorm import (layernorm_backward,
                                               layernorm_forward)
from tpu_flash_torch.kernels.softmax import (attn_softmax_backward,
                                             attn_softmax_forward)
from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, adam, init_params,
                                mixed_precision, num_parameters)
from tpu_flash_torch.ops import fused
from tpu_flash_torch.ops.reference import causal_mask
from tpu_flash_torch.utils.timing import device_ms

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM data sheet, CUDA cores
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense tensor cores
L2_BYTES = 50e6                # H100 L2 cache
ATTENTION = ("flash_attention_fwd", "flash_attention_bwd")
FUSED = ("layernorm_fwd", "layernorm_bwd", "attn_softmax_fwd",
         "attn_softmax_bwd")
TRAINING_KERNELS = ATTENTION + FUSED
KERNELS = ("flash_decode",) + TRAINING_KERNELS
SERVING = dict(n_vocab=32768, n_embd=1024, n_head=16, n_positions=8192,
               n_layer=8, ff_middle_dim=4096, p_dropout=0.0,
               attention_kind="flash", dtype=torch.bfloat16)
# kernel vs plain: bf16 outputs differ by up to one bf16 ulp (1.6e-2 at
# |out| < 4) and the kernel rounds p to bf16 before P.V where the plain
# version keeps fp32; fp32 differs only by summation order and __expf.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# The production training config (bench/bench_train.py:28-33, "big"):
# full width and depth.  Batches as bench/bench_train.py:37-39.
TRAIN = dict(n_vocab=10_000, n_embd=512, n_head=8, n_positions=2048,
             n_layer=4, ff_middle_dim=256, attention_kind="flash")
TRAIN_B, TRAIN_L = 4, 2048
# The reference MT config (bench/bench_train.py:30,40-48, "ref" with
# kind="fused" and use_fused_kernel=True): full width and depth.  L = 256
# and E = 256 are under ops.fused's 512 limits, so every LayerNorm and every
# attention softmax runs on the fused kernels.
REF = dict(n_vocab=10_000, n_embd=256, n_head=8, n_positions=256, n_layer=4,
           ff_middle_dim=256, attention_kind="fused", use_fused_kernel=True)
REF_B, REF_L = 32, 256
# Fused kernels, kernel vs plain on the same inputs: each output x is held
# to |x - ref| <= arms * rms(ref) + rtol * |ref| (compare()).  fp32: the
# two differ by summation order, rsqrtf and expf: 1e-5 and 1e-5; dgamma
# and dbeta are sums over 8192 rows in another order: 1e-4 of their rms.
# bf16: the stores may round to the neighbouring bf16 (rtol 2e-2 covers two
# ulps) on top of 1e-2 of the rms; mean and var stay fp32 and take the fp32
# limit.  Every dtype and kernel also checks that its limit fails an output
# with 1 % of one row's absolute sum added to one value of that row.
_F32 = (0.0, 1e-5, 1e-5)
FUSED_TOL = {
    torch.float32: {"y": _F32, "mean": _F32, "var": _F32, "dx": _F32,
                    "dgamma": (0.0, 1e-4, 1e-5), "dbeta": (0.0, 1e-4, 1e-5),
                    "p": _F32},
    torch.bfloat16: {"mean": _F32, "var": _F32, **dict.fromkeys(
        ("y", "dx", "dgamma", "dbeta", "p"), (0.0, 1e-2, 2e-2))},
}
LN_CASES = [
    # name, x shape, impl
    ("ref-R8192-H256", (REF_B, REF_L, 256), None),
    ("prod-R8192-H512", (TRAIN_B, TRAIN_L, 512), None),
    ("ragged-R37-H200", (37, 200), None),
    ("above-512-R8192-H640", (8192, 640), "kernel"),
]
SOFTMAX_CASES = [
    # name, shape, mask_future, keys each batch row keeps (pad mask) or None
    ("ref-32x8x256x256-causal", (REF_B, 8, REF_L, REF_L), True, None),
    ("no-key-rows-2x8x130x70", (2, 8, 130, 70), True, None),
    ("pad-all-masked-2x3x70x200", (2, 3, 70, 200), False, (150, 0)),
    ("full-4x8x256x256", (4, 8, 256, 256), False, None),
    ("above-512-2x8x640x640", (2, 8, 640, 640), True, None),
]
# Last axes above ops.fused's 512 limits at which its two routes are timed.
DISPATCH_WIDTHS = (640, 1024)
# Flash attention, kernel vs plain on the same inputs: each output x of the
# kernel is held to |x - ref| <= atol + arms * rms(ref) + rtol * |ref|, with
# rms(ref) the root mean square of the plain output over the whole case.
# fp32: the JAX package's tolerances as atol and rtol (forward 1e-3,
# backward 1e-2); the two versions differ only by summation order, exp2f
# and, for dQ, atomic order.  bf16: out, dq, dk and dv are rounded to bf16,
# and an fp32 value near a rounding boundary may land an ulp either side
# (two ulps are at most 2^-6 of |x|: rtol 2e-2).  On top, the forward
# kernel rounds p to bf16 relative to its running max where the plain
# version rounds it relative to the row's final max, an error of a
# fraction of an ulp of p per key, and a few gradient entries sit where the
# roundings of dS compound: arms, 3e-2 of the output's rms, above the
# largest reading on an H100 (PERF.md).  The L = 2048 causal cases also
# check that the limit fails an output with one 64-key tile dropped from
# its last 128 rows, as a faulty kernel would give it.  lse stays fp32 in
# both dtypes and takes the fp32 limit.
ATTN_TOL = {   # output: (atol, arms, rtol)
    torch.float32: {"out": (1e-3, 0.0, 1e-3), "lse": (1e-3, 0.0, 1e-3),
                    **dict.fromkeys(("dq", "dk", "dv"), (1e-2, 0.0, 1e-2))},
    torch.bfloat16: {"lse": (1e-3, 0.0, 1e-3), **dict.fromkeys(
        ("out", "dq", "dk", "dv"), (0.0, 3e-2, 2e-2))},
}
ATTN_CASES = [
    # name, B, H, Hkv, Lq, Lk, d, causal
    ("train-L2048", 4, 8, 8, 2048, 2048, 64, True),
    ("L2048-full", 1, 8, 8, 2048, 2048, 64, False),
    ("L200", 2, 8, 8, 200, 200, 64, True),
    ("L200-full", 2, 8, 8, 200, 200, 64, False),
    ("L64", 2, 8, 8, 64, 64, 64, True),
    ("L64-full", 2, 8, 8, 64, 64, 64, False),
    ("empty-rows-130x70", 2, 8, 8, 130, 70, 64, True),
    ("gqa-8q2kv", 2, 8, 2, 512, 512, 64, True),
    ("d32", 2, 8, 8, 256, 256, 32, True),
    ("d128", 2, 8, 8, 256, 256, 128, True),
]


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
    """The decode kernel against its plain version; returns the largest
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
    """Decode kernel, plain and library times at the serving shape.
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


def compare(a, b, tol):
    """``a`` against the plain output ``b`` under ``tol = (atol, arms,
    rtol)``: returns (largest error, rms of b, the arms that ``a`` needs
    beside atol and rtol, whether it agrees).  Infinities must match."""
    atol, arms, rtol = tol
    a, b = a.float(), b.float()
    inf = torch.isinf(b)
    same_inf = bool((torch.isinf(a) == inf).all() and (a[inf] == b[inf]).all())
    a, b = a[~inf], b[~inf]
    if not b.numel():
        return 0.0, 0.0, 0.0, same_inf
    diff = (a - b).abs()
    r = float(b.square().mean().sqrt())
    excess = float((diff - atol - rtol * b.abs()).max())
    need = max(0.0, excess / r) if r > 0 else (0.0 if excess <= 0 else math.inf)
    ok = same_inf and bool(torch.isfinite(a).all()) and bool(
        (diff <= atol + arms * r + rtol * b.abs()).all())
    return float(diff.max()), r, need, ok


def dropped_tile(q, k, v, out):
    """``out`` as a faulty causal forward would give it at L = 2048: keys
    1024-1087 left out of rows 1920-2047 (the plain version on the rest)."""
    keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
    keep[1024:1088] = False
    part, _, _ = flash_attention_forward(
        q[:, :, 1920:], k[:, :, keep], v[:, :, keep], causal=True,
        q_offset=1920 - 64, impl="plain")
    bad = out.clone()
    bad[:, :, 1920:] = part
    return bad


def attention_cases(gen) -> dict:
    """The flash-attention forward and backward kernels against their
    plain versions on the same inputs; returns the largest error of each
    kernel over every case.  Every case is logged before a disagreement
    fails the phase, and a last line gives, per dtype and output, the
    largest error over its case's rms and the largest arms a case needed."""
    worst = dict.fromkeys(ATTENTION, 0.0)
    failed, summary = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        tols = ATTN_TOL[dtype]
        largest = summary[str(dtype).split(".")[1]] = {
            n: {"err_over_rms": 0.0, "arms_needed": 0.0, "limit": t}
            for n, t in tols.items()}
        for name, B, H, Hkv, Lq, Lk, d, causal in ATTN_CASES:
            q = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
            k, v = (torch.randn(B, Hkv, Lk, d, generator=gen,
                                device=DEV).to(dtype) for _ in range(2))
            do = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
            out, lse, _ = flash_attention_forward(q, k, v, causal=causal,
                                                  impl="kernel")
            ref_out, ref_lse, _ = flash_attention_forward(
                q, k, v, causal=causal, impl="plain")
            grads = flash_attention_backward(q, k, v, out, lse, do,
                                             causal=causal, impl="kernel")
            ref_grads = flash_attention_backward(q, k, v, out, lse, do,
                                                 causal=causal, impl="plain")
            torch.cuda.synchronize()
            errs, rms, need, ok = {}, {}, {}, True
            pairs = [("out", out, ref_out), ("lse", lse, ref_lse)] + list(
                zip(("dq", "dk", "dv"), grads, ref_grads))
            for n, a, b in pairs:
                errs[n], rms[n], need[n], agree = compare(a, b, tols[n])
                ok &= agree
            if causal and Lq > Lk:      # rows that see no key: exact
                e = Lq - Lk
                ok &= (int(torch.count_nonzero(out[:, :, :e])) == 0
                       and bool(torch.isneginf(lse[:, :, :e]).all())
                       and int(torch.count_nonzero(grads[0][:, :, :e])) == 0)
            log({"phase": "attention_vs_plain", "case": name,
                 "dtype": str(dtype).split(".")[1],
                 "shape": f"B{B} H{H} Hkv{Hkv} Lq{Lq} Lk{Lk} d{d}",
                 "causal": causal, "max_abs_err": errs, "rms": rms,
                 "arms_needed": need,
                 "tol": {n: "atol {} + {} * rms + rtol {}".format(*t)
                         for n, t in tols.items()},
                 "ok": ok})
            if not ok:
                failed.append(f"{name} {dtype}")
            if causal and Lq == Lk == 2048:
                dropped = compare(dropped_tile(q, k, v, ref_out), ref_out,
                                  tols["out"])
                log({"phase": "attention_limit_power", "case": name,
                     "dtype": str(dtype).split(".")[1],
                     "fault": "keys 1024-1087 dropped from rows 1920-2047",
                     "max_abs_err": dropped[0], "arms_needed": dropped[2],
                     "caught": not dropped[3]})
                if dropped[3]:
                    failed.append(f"{name} {dtype}: the limit passes a "
                                  f"dropped tile")
            for n in errs:
                big = largest[n]
                if rms[n] > 0:
                    big["err_over_rms"] = max(big["err_over_rms"],
                                              errs[n] / rms[n])
                big["arms_needed"] = max(big["arms_needed"], need[n])
            worst["flash_attention_fwd"] = max(
                worst["flash_attention_fwd"], errs["out"], errs["lse"])
            worst["flash_attention_bwd"] = max(
                worst["flash_attention_bwd"], errs["dq"], errs["dk"],
                errs["dv"])
    log({"phase": "attention_tolerance", "limit": "(atol, arms, rtol)",
         **summary})
    check(not failed, f"flash attention disagrees with its plain version: "
                      f"{failed}")
    return worst


def attention_times(gen, B=4, H=8, L=2048, d=64) -> dict:
    """Forward and backward times at the training shape (B4 H8 L2048 d64,
    causal): kernel, plain and library, with the bound."""
    rows = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS),
                        (torch.float32, FP32_FLOPS)):
        q, k, v, do = (torch.randn(B, H, L, d, generator=gen, device=DEV
                                   ).to(dtype) for _ in range(4))
        out, lse, _ = flash_attention_forward(q, k, v, causal=True)

        def fwd(impl):
            return flash_attention_forward(q, k, v, causal=True, impl=impl)

        def bwd(impl):
            return flash_attention_backward(q, k, v, out, lse, do,
                                            causal=True, impl=impl)

        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=True)

        def lib_fwdbwd():
            o = sdpa(*leaves, is_causal=True)
            return torch.autograd.grad(o, leaves, do)

        item = q.element_size()
        act = B * H * L * d * item                  # one [B, H, L, d] tensor
        lse_b = B * H * L * 4
        work = {   # useful causal flops; bytes read once and written once
            "flash_attention_fwd": (2 * B * H * L * L * d, 4 * act + lse_b),
            "flash_attention_bwd": (5 * B * H * L * L * d,
                                    8 * act + 2 * lse_b)}
        timed = {
            "flash_attention_fwd": (
                device_ms(lambda: fwd("kernel"), iters=10),
                device_ms(lambda: fwd("plain"), iters=5),
                device_ms(lambda: sdpa(q, k, v, is_causal=True), iters=10)),
            "flash_attention_bwd": (
                device_ms(lambda: bwd("kernel"), iters=10),
                device_ms(lambda: bwd("plain"), iters=5),
                device_ms(lambda: torch.autograd.grad(
                    lib_out, leaves, do, retain_graph=True), iters=10))}
        lib_fwdbwd_ms = device_ms(lib_fwdbwd, iters=10)
        for name, (ms, plain_ms, library_ms) in timed.items():
            flops, nbytes = work[name]
            bound = {"operations": flops / peak * 1e3,
                     "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
            bound_by = max(bound, key=bound.get)
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound[bound_by], "bound_by": bound_by,
                   "of_bound": bound[bound_by] / ms, "flops": flops,
                   "bytes": nbytes, "tflops": flops / (ms * 1e-3) / 1e12}
            log({"phase": "kernel_time", "kernel": name,
                 "dtype": str(dtype).split(".")[1],
                 "shape": f"B{B} H{H} L{L} d{d} causal",
                 "library": "scaled_dot_product_attention(is_causal=True)"
                            + (" backward" if name.endswith("bwd") else ""),
                 "library_fwd_bwd_ms": lib_fwdbwd_ms, **row})
            rows[(name, dtype)] = row
        del q, k, v, do, out, lse, leaves, lib_out
    return rows


def perturbed(t):
    """``t`` with 1 % of its last row's absolute sum added to that row's
    first value: a faulty row a limit must catch."""
    bad = t.detach().clone().float()
    row = bad.reshape(-1, bad.shape[-1])[-1]
    row[0] += 0.01 * row.abs().sum()
    return bad


def fused_cases(gen) -> dict:
    """The fused LayerNorm and masked-softmax kernels against their plain
    versions on the same inputs; returns the largest error of each kernel.
    Every case is logged before a disagreement fails the phase; the first
    case of each kernel and dtype checks the limit's power."""
    worst = dict.fromkeys(FUSED, 0.0)
    failed, summary = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        tols = FUSED_TOL[dtype]
        dname = str(dtype).split(".")[1]
        largest = summary[dname] = dict.fromkeys(tols, 0.0)
        power_checked = set()

        def judge(kernel, case, pairs, extra_ok=True):
            errs, need, ok = {}, {}, extra_ok
            for n, a, b in pairs:
                errs[n], _, need[n], agree = compare(a, b, tols[n])
                ok &= agree and a.dtype == b.dtype
                largest[n] = max(largest[n], need[n])
            log({"phase": "fused_vs_plain", "kernel": kernel, "case": case,
                 "dtype": dname, "max_abs_err": errs, "arms_needed": need,
                 "tol": {n: "{1} * rms + rtol {2}".format(*tols[n])
                         for n in errs}, "ok": ok})
            if not ok:
                failed.append(f"{kernel} {case} {dname}")
            worst[kernel] = max(worst[kernel], *errs.values())
            if kernel not in power_checked:
                power_checked.add(kernel)
                n, a, b = pairs[0]
                caught = not compare(perturbed(b), b.float(), tols[n])[3]
                log({"phase": "fused_limit_power", "kernel": kernel,
                     "case": case, "dtype": dname, "output": n,
                     "fault": "1 % of the last row's |sum| added to its "
                              "first value", "caught": caught})
                if not caught:
                    failed.append(f"{kernel} {dname}: the limit passes a "
                                  f"perturbed row")

        for name, shape, impl in LN_CASES:
            H = shape[-1]
            x, dy = (torch.randn(*shape, generator=gen, device=DEV
                                 ).to(dtype) for _ in range(2))
            g = (1 + 0.1 * torch.randn(H, generator=gen, device=DEV)
                 ).to(dtype)
            b = (0.1 * torch.randn(H, generator=gen, device=DEV)).to(dtype)
            got = layernorm_forward(x, g, b, impl=impl or "kernel")
            ref = layernorm_forward(x, g, b, impl="plain")
            mean, var = ref[1], ref[2]
            grads = layernorm_backward(dy, x, g, mean, var,
                                       impl=impl or "kernel")
            ref_grads = layernorm_backward(dy, x, g, mean, var,
                                           impl="plain")
            torch.cuda.synchronize()
            judge("layernorm_fwd", name,
                  list(zip(("y", "mean", "var"), got, ref)))
            judge("layernorm_bwd", name,
                  list(zip(("dx", "dgamma", "dbeta"), grads, ref_grads)))
        for name, shape, causal, keep in SOFTMAX_CASES:
            x, dp = (torch.randn(*shape, generator=gen, device=DEV
                                 ).to(dtype) for _ in range(2))
            mask = None
            if keep is not None:
                cols = torch.arange(shape[3], device=DEV)[None, :]
                kept = torch.tensor(keep, device=DEV)[:, None]
                mask = torch.where(cols < kept, 0.0, -1e9)
            p = attn_softmax_forward(x, mask, mask_future=causal,
                                     impl="kernel")
            ref = attn_softmax_forward(x, mask, mask_future=causal,
                                       impl="plain")
            dx = attn_softmax_backward(ref, dp, impl="kernel")
            ref_dx = attn_softmax_backward(ref, dp, impl="plain")
            torch.cuda.synchronize()
            Lq, Lk = shape[2], shape[3]
            empty_ok = True
            if causal and Lq > Lk:      # rows that see no key: 1/128 each
                empty_ok = bool((p[:, :, :Lq - Lk].float() == 1 / 128).all())
            judge("attn_softmax_fwd", name, [("p", p, ref)], empty_ok)
            judge("attn_softmax_bwd", name, [("dx", dx, ref_dx)])
            del x, dp, p, ref, dx, ref_dx
    log({"phase": "fused_tolerance", "arms_needed_beside_rtol": summary})
    check(not failed, f"fused kernels disagree with their plain versions: "
                      f"{failed}")
    return worst


def causal_visible(Lq: int, Lk: int) -> int:
    """Scores of one [Lq, Lk] causal block that a query sees: key c is
    visible to row i when c <= i + Lk - Lq."""
    return sum(min(Lk, max(0, i + Lk - Lq + 1)) for i in range(Lq))


def fused_times(gen) -> dict:
    """Fused kernels' times at the reference MT shapes (LayerNorm R = 8192,
    H = 256; softmax [32, 8, 256, 256] causal), fp32 and bf16: kernel,
    plain and library, with the bound.  Inputs rotate through enough copies
    that each call reads past the 50 MB L2."""
    F = torch.nn.functional
    R, H = REF_B * REF_L, REF["n_embd"]
    shape = (REF_B, REF["n_head"], REF_L, REF_L)
    N = math.prod(shape)
    visible = REF_B * REF["n_head"] * causal_visible(REF_L, REF_L)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        it = torch.tensor([], dtype=dtype).element_size()
        # bytes each function must move (inputs read once, outputs written
        # once) and its fp32 operations; the causal softmax forward needs
        # only the visible scores, and writes every probability
        work = {
            "layernorm_fwd": (2 * R * H * it + 2 * H * it + 2 * R * 4,
                              7 * R * H),
            "layernorm_bwd": (3 * R * H * it + 3 * H * it + 2 * R * 4,
                              17 * R * H),
            "attn_softmax_fwd": ((visible + N) * it, 6 * visible),
            "attn_softmax_bwd": (3 * N * it, 4 * N),
        }
        copies = {n: max(2, math.ceil(2 * L2_BYTES / b)) for n, (b, _) in
                  work.items()}
        g = (1 + 0.1 * torch.randn(H, generator=gen, device=DEV)).to(dtype)
        b = (0.1 * torch.randn(H, generator=gen, device=DEV)).to(dtype)
        nl = copies["layernorm_fwd"]
        xs = [torch.randn(R, H, generator=gen, device=DEV).to(dtype)
              for _ in range(nl)]
        dys = [torch.randn(R, H, generator=gen, device=DEV).to(dtype)
               for _ in range(nl)]
        stats = [layernorm_forward(x, g, b)[1:] for x in xs]
        ns = copies["attn_softmax_fwd"]
        ss = [torch.randn(*shape, generator=gen, device=DEV).to(dtype)
              for _ in range(ns)]
        ps = [attn_softmax_forward(s, mask_future=True) for s in ss]
        dps = [torch.randn(*shape, generator=gen, device=DEV).to(dtype)
               for _ in range(ns)]
        cmask = causal_mask(REF_L, REF_L, dtype, DEV)
        leaves = [[t.detach().requires_grad_() for t in (x, g, b)]
                  for x in xs]
        lib_ys = [F.layer_norm(x, (H,), gl, bl, eps=1e-8)
                  for x, gl, bl in leaves]
        tick = [0]

        def nxt(n):
            tick[0] = (tick[0] + 1) % n
            return tick[0]

        def ln_fwd(impl):
            return layernorm_forward(xs[nxt(nl)], g, b, impl=impl)

        def ln_fwd_lib():
            return F.layer_norm(xs[nxt(nl)], (H,), g, b, eps=1e-8)

        def ln_bwd(impl):
            i = nxt(nl)
            return layernorm_backward(dys[i], xs[i], g, *stats[i], impl=impl)

        def ln_bwd_lib():
            i = nxt(nl)
            return torch.autograd.grad(lib_ys[i], leaves[i], dys[i],
                                       retain_graph=True)

        def sm_fwd(impl):
            return attn_softmax_forward(ss[nxt(ns)], mask_future=True,
                                        impl=impl)

        def sm_fwd_lib():
            return torch.softmax(ss[nxt(ns)] + cmask, -1)

        def sm_bwd(impl):
            i = nxt(ns)
            return attn_softmax_backward(ps[i], dps[i], impl=impl)

        def sm_bwd_lib():
            i = nxt(ns)
            return torch._softmax_backward_data(dps[i], ps[i], -1, dtype)

        calls = {"layernorm_fwd": (ln_fwd, ln_fwd_lib),
                 "layernorm_bwd": (ln_bwd, ln_bwd_lib),
                 "attn_softmax_fwd": (sm_fwd, sm_fwd_lib),
                 "attn_softmax_bwd": (sm_bwd, sm_bwd_lib)}
        library = {
            "layernorm_fwd": "F.layer_norm(eps=1e-8)",
            "layernorm_bwd": "autograd of F.layer_norm (dx, dgamma, dbeta)",
            "attn_softmax_fwd": "torch.softmax(x + causal mask, -1)",
            "attn_softmax_bwd": "torch._softmax_backward_data"}
        for name, (fn, lib) in calls.items():
            ms = device_ms(lambda: fn("kernel"), iters=20)
            plain_ms = device_ms(lambda: fn("plain"), iters=5)
            library_ms = device_ms(lib, iters=20)
            nbytes, flops = work[name]
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": flops / FP32_FLOPS * 1e3}
            bound_by = max(bound, key=bound.get)
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound[bound_by], "bound_by": bound_by,
                   "of_bound": bound[bound_by] / ms, "bytes": nbytes,
                   "flops": flops, "hbm_GBps": nbytes / (ms * 1e-3) / 1e9,
                   "copies": copies[name]}
            log({"phase": "kernel_time", "kernel": name,
                 "dtype": str(dtype).split(".")[1],
                 "shape": (f"R{R} H{H}" if name.startswith("layernorm")
                           else "B{} H{} Lq{} Lk{} causal".format(*shape)),
                 "library": library[name], **row})
            rows[(name, dtype)] = row
        del xs, dys, stats, ss, ps, dps, leaves, lib_ys
    return rows


def fused_dispatch_times(gen) -> None:
    """``ops.fused``'s two routes above its 512 limits, forward plus
    backward: the kernel route (``impl="kernel"``) against the composed
    fp32 route that ``impl=None`` takes there, for LayerNorm over the
    production config's 8192 rows and the causal softmax over [4, 8, W, W]
    scores, at W = 640 and 1024, fp32 and bf16.  A record of what the
    limits cost on this card; nothing is held to a limit."""
    for dtype in (torch.float32, torch.bfloat16):
        for W in DISPATCH_WIDTHS:
            g, b = ((s * torch.randn(W, generator=gen, device=DEV) + o
                     ).to(dtype).requires_grad_() for s, o in
                    ((0.1, 1.0), (0.1, 0.0)))
            ops = {
                "layer_norm": ((TRAIN_B * TRAIN_L, W), (g, b),
                               lambda x, impl: fused.layer_norm(
                                   x, g, b, impl=impl)),
                "attn_softmax": ((4, 8, W, W), (),
                                 lambda x, impl: fused.attn_softmax(
                                     x, mask_future=True, impl=impl)),
            }
            for op, (shape, params, fn) in ops.items():
                nbytes = math.prod(shape) * g.element_size()
                n = max(2, math.ceil(2 * L2_BYTES / nbytes))
                xs = [torch.randn(*shape, generator=gen, device=DEV)
                      .to(dtype).requires_grad_() for _ in range(n)]
                # the composed route's output is fp32, the kernel's x's dtype
                dys = {impl: [torch.randn(*shape, generator=gen, device=DEV)
                              .to(fn(xs[0], impl).dtype) for _ in range(n)]
                       for impl in ("kernel", None)}
                tick = [0]

                def fwd_bwd(impl):
                    i = tick[0] = (tick[0] + 1) % n
                    return torch.autograd.grad(fn(xs[i], impl),
                                               (xs[i], *params), dys[impl][i])

                kernel_ms = device_ms(lambda: fwd_bwd("kernel"), iters=10)
                composed_ms = device_ms(lambda: fwd_bwd(None), iters=10)
                log({"phase": "fused_dispatch", "op": op, "shape": shape,
                     "dtype": str(dtype).split(".")[1],
                     "kernel_route_fwd_bwd_ms": kernel_ms,
                     "composed_route_fwd_bwd_ms": composed_ms,
                     "composed_over_kernel": composed_ms / kernel_ms})
                del xs, dys


def kernel_profile(fn, steps: int = 4) -> dict:
    """Kernels of ``fn()`` under torch.profiler, per call: launches, their
    summed device time, each of the port's kernels' time, and the eight
    largest."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ours = {n: sum(e.self_device_time_total for e in kernels
                   if f"{n}_kernel" in e.key) / steps / 1e3
            for n in KERNELS}
    return {"kernels_per_step": sum(e.count for e in kernels) / steps,
            "kernel_ms_per_step": total_us / steps / 1e3,
            "port_kernel_ms_per_step": ours,
            "top": [{"name": e.key[:80], "count_per_step": e.count / steps,
                     "ms_per_step": e.self_device_time_total / steps / 1e3,
                     "share": e.self_device_time_total / total_us
                     if total_us else None} for e in top]}


def train_batch(seed: int = 0, shape=(TRAIN_B, TRAIN_L),
                n_vocab: int = TRAIN["n_vocab"]) -> dict:
    """Token ids and 0/1 loss weights from a seed (bench_train.py:37-39)."""
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, n_vocab, shape),
            "labels": rng.integers(0, n_vocab, shape),
            "label_token_weights": (rng.random(shape) > 0.5
                                    ).astype(np.float32)}


def syncs_in_a_step(step, state, batch, gen):
    """One training step from a host batch (``place_batch`` included) under
    torch's sync debug mode, which warns at every operation that makes the
    host wait for the card; returns the new state and those warnings."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, place_batch(batch, DEV), gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, [str(w.message)[:300] for w in caught
                   if "called a synchronizing" in str(w.message)]


def training(mode: str, config: dict, shape, dtype, p_dropout: float, opt,
             per_step: dict) -> dict:
    """``train_epoch`` at the full width and depth of ``config`` on one
    repeated batch of ``shape``: 3 warm-up steps, then 11 (the first of
    them opens the loop's first timing window, which it leaves out).
    ``per_step`` gives each training kernel's launches a step (0 where
    absent); returns every training kernel's launches in the timed run."""
    cfg = DecoderConfig(**config, p_dropout=p_dropout, dtype=dtype)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    state = opt.init(dict(model.named_parameters()))
    batch = train_batch(0, shape, cfg.n_vocab)
    gen = torch.Generator(DEV).manual_seed(1)
    step = make_train_step(model, opt)

    def epoch(state, n, log_every):
        return train_epoch(model, opt, state, list(range(n)),
                           lambda _: batch, 1, generator=gen,
                           log_every=log_every, train_step=step, log=None)

    torch.cuda.reset_peak_memory_stats()
    state, warm_losses, _, _ = epoch(state, 3, 1)
    torch.cuda.synchronize()
    common.launch_counts.clear()
    state, losses, step_times, tokens = epoch(state, 11, 5)
    torch.cuda.synchronize()
    launches = {n: common.launch_counts[n] for n in TRAINING_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.mean(step_times) * 1e3
    state, syncs = syncs_in_a_step(step, state, batch, gen)

    holder = [state]
    dev_batch = place_batch(batch, DEV)

    def one_step():
        holder[0], _ = step(holder[0], dev_batch, gen)

    # device time of one step, the stream held until the host has queued it
    device_step_ms = device_ms(one_step, warmup=1, iters=1, reps=3,
                               hold_cycles=400_000_000)
    prof = kernel_profile(one_step, steps=2)
    all_losses = warm_losses + losses
    log({"phase": "training", "mode": mode,
         "config": {**config, "p_dropout": p_dropout,
                    "dtype": str(dtype).split(".")[1],
                    "batch": shape[0], "seq_len": shape[1]},
         "params": num_parameters(model), "steps_timed": len(step_times),
         "step_ms": step_ms, "step_ms_each": [t * 1e3 for t in step_times],
         "device_ms_per_step": device_step_ms,
         "device_idle_share": 1 - device_step_ms / step_ms,
         "tokens_per_s": tokens / (step_ms * 1e-3),
         "peak_memory_GiB": peak_gb, "losses": all_losses,
         "launches": launches, "launches_per_step_expected": per_step,
         "host_syncs_in_a_step": syncs,
         **prof, "card": torch.cuda.get_device_name(0)})
    check(all(math.isfinite(x) for x in all_losses),
          f"{mode}: non-finite loss")
    check(not syncs, f"{mode}: a training step made the host wait: {syncs}")
    check(all_losses[-1] < all_losses[0],
          f"{mode}: the loss did not fall on a repeated batch")
    check(len(step_times) == 10, f"{mode}: {len(step_times)} timed steps")
    for n, c in launches.items():
        want = per_step.get(n, 0) * len(losses)
        check(c == want, f"{mode}: {n} launched {c} times in {len(losses)} "
                         f"steps, not {want}")
    del model, state, holder
    torch.cuda.empty_cache()
    return launches


def training_end_to_end(name: str, config: dict, shape) -> dict:
    """One Adam step of the fp32 model of ``config`` (TF32 off) through the
    kernels and one through their plain versions, from the same
    parameters: loss, every gradient, every updated parameter, and the
    kernels launched by the first step only."""
    cfg = DecoderConfig(**config, p_dropout=0.0, dtype=torch.float32)
    batch = place_batch(train_batch(1, shape, cfg.n_vocab), DEV)
    lr = 1e-3
    runs, launched = {}, {}
    for impl in ("kernel", "plain"):
        model = DecoderLM(cfg, device=DEV)
        init_params(model, torch.Generator(DEV).manual_seed(2))
        opt = adam(lr=lr)
        state = opt.init(dict(model.named_parameters()))
        torch.cuda.synchronize()
        common.launch_counts.clear()
        _, loss = make_train_step(model, opt, impl=impl)(state, batch)
        launched[impl] = {n: c for n, c in common.launch_counts.items() if c}
        runs[impl] = (float(loss), {n: (p.detach(), p.grad)
                                    for n, p in model.named_parameters()})
    (loss_k, got), (loss_p, want) = runs["kernel"], runs["plain"]
    # Gradients: fp32 sums in another order (at the production config 4
    # layers of attention over 2048 positions, dQ in atomic order; at the
    # reference config the fused kernels' row sums, rsqrtf and expf): 1e-3
    # of the tensor's largest
    # gradient, plus 1e-5 of the model's largest for tensors whose exact
    # gradient is 0 (the K projection's bias: softmax ignores a shift of a
    # row's scores) and so hold rounding noise only.  Updated parameters:
    # Adam's first step moves each weight by ~lr * sign(g), so where |g|
    # lies within the gradient tolerance of 0 a sign may flip (up to 2 lr
    # apart); elsewhere the steps agree to 1e-6.
    g_max = max(float(g.abs().max()) for _, g in want.values())
    ok = abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    grad_errs, param_err, flips = [], 0.0, 0
    for n, (p_p, g_p) in want.items():
        p_k, g_k = got[n]
        tol = 1e-3 * float(g_p.abs().max()) + 1e-5 * g_max
        err = float((g_k - g_p).abs().max())
        grad_errs.append((err / tol, n, err, tol))
        near0 = g_p.abs() <= tol
        diff = (p_k - p_p).abs()
        if bool((~near0).any()):
            param_err = max(param_err, float(diff[~near0].max()))
        ok &= (err <= tol and bool((diff[~near0] <= 1e-6).all())
               and bool((diff[near0] <= 2 * lr + 1e-6).all()))
        flips += int((diff[near0] > 1e-6).sum())
    worst = sorted(grad_errs, reverse=True)[:3]
    ok &= bool(launched["kernel"]) and not launched["plain"]
    row = {"phase": "training_end_to_end", "config": name,
           "launches": launched, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_tol": "rtol 1e-5",
           "grad_worst": [{"param": n, "max_abs_err": e, "tol": t}
                          for _, n, e, t in worst],
           "grad_tol": "1e-3 * max|g| of the tensor + 1e-5 * max|g| of all",
           "param_max_err": param_err, "param_tol": 1e-6,
           "near_zero_grad_params_moved_apart": flips,
           "near_zero_tol": f"2 lr = {2 * lr}", "ok": bool(ok)}
    log(row)
    check(ok, f"{name}: the training step through the kernels disagrees "
              f"with the plain versions")
    return row


@torch.no_grad()
def serving(model, n_layer: int) -> int:
    """16 requests through the engine in three modes; returns the kernel
    launches counted while the engines ran."""
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
                 "drive": drive, **kernel_profile(
                     lambda: eng._decode_step(eng.last_tokens, live))})
            del eng, done
    finally:
        hook.remove()
    return total


def end_to_end() -> None:
    """Serving end to end at full width, 2 layers, fp32 with TF32 off:
    engine tokens against generate's and the uncached forward's, and one
    decode step's logits with the kernel against the plain path."""
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = common.build(KERNELS)
    log({"phase": "build", **{
        n: {"seconds": r.seconds, "log": r.log[-2000:],
            "spill_lines": [ln for ln in r.log.splitlines() if "spill" in ln]}
        for n, r in built.items()}})

    gen = torch.Generator(DEV).manual_seed(0)
    worst = kernel_cases(gen)
    rows = kernel_times(gen)

    attn_worst = attention_cases(gen)
    attn_rows = attention_times(gen)
    fused_worst = fused_cases(gen)
    fused_rows = fused_times(gen)
    fused_dispatch_times(gen)

    cfg = DecoderConfig(**SERVING)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    log({"phase": "model", "params": num_parameters(model),
         "config": {k: str(v) for k, v in SERVING.items()}})
    launches = {"flash_decode": serving(model, cfg.n_layer)}
    del model
    torch.cuda.empty_cache()
    end_to_end()

    # launches a step, both configs having 4 layers: each attention kernel
    # once a layer; each LayerNorm kernel twice a layer and once before
    # lm_head
    flash = dict.fromkeys(ATTENTION, 4)
    fused_sm = dict.fromkeys(("attn_softmax_fwd", "attn_softmax_bwd"), 4)
    fused_ln = dict.fromkeys(("layernorm_fwd", "layernorm_bwd"), 9)
    prod, ref = (TRAIN_B, TRAIN_L), (REF_B, REF_L)
    train_launches = [
        training("(a) prod-flash-fp32-adam", TRAIN, prod, torch.float32,
                 0.0, adam(lr=1e-3), flash),
        training("(b) prod-flash-bf16-mixed-precision-adam-dropout", TRAIN,
                 prod, torch.bfloat16, 0.1, mixed_precision(adam(lr=1e-3)),
                 flash),
        training("(c) ref-fused-fused-ln-fp32-adam", REF, ref, torch.float32,
                 0.0, adam(lr=1e-3), {**fused_sm, **fused_ln}),
        training("(d) ref-fused-fused-ln-bf16-mixed-precision-adam-dropout",
                 REF, ref, torch.bfloat16, 0.1,
                 mixed_precision(adam(lr=1e-3)), {**fused_sm, **fused_ln}),
        training("(e) prod-flash-fused-ln-bf16-mixed-precision-adam-dropout",
                 {**TRAIN, "use_fused_kernel": True}, prod, torch.bfloat16,
                 0.1, mixed_precision(adam(lr=1e-3)), {**flash, **fused_ln}),
    ]
    for n in TRAINING_KERNELS:
        launches[n] = sum(t[n] for t in train_launches)
    training_end_to_end("prod-flash", TRAIN, prod)
    training_end_to_end("ref-fused-fused-ln", REF, ref)

    main_row = next(r for r in rows if r["cache"] == "int8"
                    and r["length"] == 1024)
    entries = [{
        "name": "flash_decode", "route": "cuda",
        "source": "tpu_flash_torch/kernels/csrc/flash_decode.cu",
        "replaces": "tpu_flash/kernels/decode.py:93",
        "launches": launches["flash_decode"], "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B8 Hq16 Hkv16 Lq1 d64 S8192 int8 cache, lengths 1024"}]
    replaces = {"flash_attention_fwd": "flash_attention.py:498",
                "flash_attention_bwd": "flash_attention.py:1228"}
    for n in ATTENTION:
        r = attn_rows[(n, torch.bfloat16)]
        entries.append({
            "name": n, "route": "cuda",
            "source": f"tpu_flash_torch/kernels/csrc/{n}.cu",
            "replaces": f"tpu_flash/kernels/{replaces[n]}",
            "launches": launches[n],
            "max_abs_err": attn_worst[n], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": "B4 H8 L2048 d64 causal bf16"})
    replaces.update({"layernorm_fwd": "layernorm.py:42",
                     "layernorm_bwd": "layernorm.py:102",
                     "attn_softmax_fwd": "softmax.py:48",
                     "attn_softmax_bwd": "softmax.py:116"})
    for n in FUSED:
        r = fused_rows[(n, torch.float32)]
        entries.append({
            "name": n, "route": "cuda",
            "source": f"tpu_flash_torch/kernels/csrc/{n}.cu",
            "replaces": f"tpu_flash/kernels/{replaces[n]}",
            "launches": launches[n], "max_abs_err": fused_worst[n],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": ("R8192 H256 fp32" if n.startswith("layernorm")
                      else "B32 H8 Lq256 Lk256 causal fp32")})
    log({"kernels": entries})
    print(smi.splitlines()[0], flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
