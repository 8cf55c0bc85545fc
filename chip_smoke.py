"""Smoke test of the PyTorch/CUDA port (``tpu_flash_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds every kernel of the port from ``tpu_flash_torch/kernels/csrc``
with nvcc (one process per source, all started together), then drives both
ported paths:

* serving: the flash-decode kernel against its plain PyTorch version (the
  serving shape's lengths 0, 1 and below the cluster it splits over,
  windows that leave blocks of the cluster nothing to read, GQA and Lq up
  to 8, fp32 / bf16 / int8 / fp8 caches; each case called twice for the
  same bits) and its times over bf16 and int8 caches at lengths 1024 and
  8192; 16 requests through ``DecodeEngine`` at the full width of the 176M
  serving configuration in three modes, with the kernels of one decode step
  under ``torch.profiler``; the engine against ``generate`` and the kernel
  against the plain path end to end;
* quantized serving: the int8, packed-int4 and grouped-int4 matmul kernels
  in their forms (for bf16 x the tensor-core decode form at M <= 8 and
  the tensor-core prefill form above; for fp32 x the fp32 tensor-core
  decode form at M <= 8 and above the fp32 tensor-core prefill form, three
  bf16 products a product; the CUDA-core decode form at N not a multiple
  of 16 and past the decode forms' code rows) against their plain
  versions (fp32 and bf16 x, M 1 to 1024, the serving model's linears and
  ragged shapes; each call checked to launch its form, the
  tensor-core decode and fp32 forms to give the same bits twice; each
  form's limit checked against a perturbed row), the fp32 tensor-core forms
  and the plain fp32 version each against a float64 product at M1024 and
  M8 K4096 N1024, and their times at decode and at 256- and 1024-token
  prefills of every serving linear (fp32 prefills at K1024 N4096), each
  tensor-core decode call checked under the profiler to run one kernel; the
  176M model converted by ``quantize_model_linears`` (int8, int4, int4 in
  groups of 128) serving the same 16 requests, each decode step checked to
  launch its matmul kernel once a Linear in the tensor-core decode form and
  each prefill in the tensor-core prefill form, with the logits' error
  against the bf16 model; and the engine against ``generate`` and kernel
  against plain end to end for each of the three in fp32 (decode steps in
  the fp32 tensor-core decode form, prefills in the fp32 tensor-core
  form);
* training: the flash-attention forward and fused backward kernels, in the
  six-product form for fp32 (each fp32 product six bf16 products on the
  tensor cores) and the tensor-core form for bf16 (each call checked to
  launch its form), against their plain versions (causal or not, L 64 to
  2048, Lq != Lk with empty rows, GQA, d 32/64/128; each error beside its
  limit and the output's rms, and a check that the limit fails a dropped
  key tile), the fp32 kernels and the plain version each against a float64
  attention at B4 H8 L2048 d64 (the fused backward) and B1 H8 L8192 d64
  (the two passes), and their times at B4 H8 L2048; the fused
  backward called twice there (bf16 and fp32) giving the same bits; the
  fused LayerNorm and masked-softmax kernels against their plain versions (fp32 and bf16, the reference MT
  shapes, ragged widths, rows that see no key, a fully padded batch row,
  widths above 512; each limit checked against a perturbed row; the
  LayerNorm backward's dx, dgamma and dbeta the same bits on two calls),
  their times at the reference MT shapes in both dtypes (and the
  LayerNorm forward's and backward's at the production width, R8192
  H512), and ``ops.fused``'s kernel route
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
  production flash config and at the reference fused config;
* sliding windows and packed segments: every flash kernel's masked form
  (both dtypes) against its plain version over ``MASK_CASES`` (windows 1 to
  past L, Lq < Lk, GQA, ragged L, each head dim, packed segment ids with
  length-1 runs and a pad tail, both together), the fused backward twice
  under a window for the same bits, and the masked forms held against
  their plain versions and timed at ``MASK_TIMED`` (modes (g)'s and (h)'s
  shapes among them) beside the causal forms on the same inputs; ``train_epoch``
  in mode (g), mode (f)'s config under a sliding window of 2048 (the masked
  forward and two passes), and mode (h), the production config over 4
  packed rows of 2048 tokens of the synthetic translation corpus
  (``collate_packed`` through a stand-in word tokenizer; the masked forward
  and fused backward), each checking its masked kernels' launches a step;
  and one fp32 step of each against its plain version (the six-product
  masked forms);
* attention dropout: every flash kernel's dropout form (both dtypes,
  unmasked and masked) held against its plain version at rate 0.1 and a
  fixed seed at the main path's shapes (``DROP_TIMED``: mode (i)'s B4 H8
  L2048 in both dtypes, mode (f)'s B1 H8 L16384 and it under mode (g)'s
  window 2048, mode (h)'s packed segments, and the fp32 steps' shapes)
  and timed beside the form without dropout on the same inputs and SDPA
  with ``dropout_p``; every kernel's keep bits read back exactly and held
  bit for bit against the hash (``mask_probe``); the fused backward's
  dropout forms twice for the same bits; ``train_epoch`` in mode (i),
  mode (b) with ``attn_dropout=0.1`` on the dropout forms; one bf16 step
  each of (f) and (g) at 2 layers, (h) and (d) with attention dropout, and
  four fp32 steps with it against their plain versions (mode (h)'s packed
  rows under window 256, the production config, and the long config at 2
  layers and L=8192, alone and under window 2048);
* quantized K/V (``kv_quant``): every flash kernel's quantized forms (both
  dtypes; token scales and channel codes; unmasked, masked and dropped)
  held against their plain versions on the same codes and scales over
  ``KVQ_CASES`` (ragged L, GQA, each head dim, windows, segments,
  dropout) in the four modes, int8 and e4m3 codes; the fused backward's
  quantized forms twice for the same bits; the fp32 quantized forms and
  the plain fp32 version against a float64 attention on the dequantized
  K and V at B4 H8 L2048 and B1 H8 L8192; each form held against plain
  and timed at the shape of the run that launches it (``KVQ_TIMED``)
  beside the form without quantization on the dequantized K and V and
  SDPA on them (the dequantization timed apart); ``train_epoch`` in mode
  (j), (b) with int8 K/V (JAX's ``--kv-quant-train int8``), beside (b);
  one step each of every other quantized configuration the kernels line
  needs (fp8, int8_channel, fp8_channel at (b)'s widths, attention
  dropout, mode (h)'s packed rows alone and under window 256 with
  dropout, the long configs alone, with dropout and under window 2048,
  in bf16 and fp32), and four fp32 steps against their plain versions
  ((a) with int8 and int8_channel, the long config at L=8192 with int8,
  (h)'s rows under window 256 with dropout and int8);
* long-context training: the two-pass backward's dK/dV and dQ kernels,
  in the six-product form for fp32 and the tensor-core form for bf16 (each
  call checked to launch its form), against their plain halves (causal or
  not, GQA, Lq != Lk with empty rows, ragged L, d 32/64/128; each limit
  checked against a dropped tile; two calls the same bits); at mode (f)'s
  attention shape,
  B1 H8 L16384 d64 bf16, the forward kernel and both passes against their
  plain versions, the two passes against the fused kernel, and two calls
  of each backward form giving the same bits, all in the tensor-core form;
  their times
  beside the fused kernel's at B1 H8 L16384 bf16, L8192 fp32 and B4 H8
  L2048 bf16; ``train_epoch`` in mode (f): the production widths at
  L=16384 with remat, the chunked-vocab loss and bf16 mixed precision (8
  forward, 4 dK/dV and 4 dQ launches a step in the tensor-core form, the
  GEMMs' time by operand
  type); peak memory a step with remat and the chunked loss on and off,
  and from the same runs the check that remat on and off give the same
  bits with dropout from one CUDA generator; and the fp32 kernel-vs-plain
  step at 2 layers and L=8192, where fp32 takes the two passes in their
  six-product form, with the kernels of a step and their time.

The build phase logs each kernel's registers, stack and spills as ptxas
reports them, and fails if a flash-attention kernel's tensor-core or
six-product form (unmasked or masked, without or with dropout, without or
with quantized K/V), a
quantized matmul's tensor-core
decode, fp32 decode or fp32 prefill form, a form of the masked-softmax
forward or of either LayerNorm kernel, or a flash-decode kernel spills.
Modes (b) and (e) run the forward and the fused backward in their
tensor-core form, mode (a) in their six-product form.

Each phase prints JSON lines; any failure raises and the script exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA device it exits with code 2 and prints no result.  It imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from tpu_flash_torch.apps.machine_translation import (make_train_step,
                                                     place_batch, train_epoch)
from tpu_flash_torch.data.mt import (WordTokenizer, collate_packed,
                                     synthetic_translation_dataset)
from tpu_flash_torch.inference import DecodeEngine, KVCache, SamplingConfig
from tpu_flash_torch.inference.engine import Request
from tpu_flash_torch.inference.sampler import generate, prefill_prompt
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels.backward_form import two_pass
from tpu_flash_torch.kernels import decode
from tpu_flash_torch.kernels.decode import flash_decode_attention
from tpu_flash_torch.kernels import flash_attention as fa
from tpu_flash_torch.kernels.flash_attention import (
    flash_attention_backward, flash_attention_backward_dkv_plain,
    flash_attention_backward_dq_plain, flash_attention_backward_fused,
    flash_attention_backward_two_pass, flash_attention_forward)
from tpu_flash_torch.kernels import quant
from tpu_flash_torch.kernels.layernorm import (layernorm_backward,
                                               layernorm_forward)
from tpu_flash_torch.kernels.softmax import (attn_softmax_backward,
                                             attn_softmax_forward, pad_cols)
from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, adam, init_params,
                                mixed_precision, num_parameters,
                                quantize_model_linears)
from tpu_flash_torch.ops import fused
from tpu_flash_torch.ops.attention import (dequantize_kv, kv_quant_parts,
                                           quantize_kv)
from tpu_flash_torch.ops.reference import causal_mask
from tpu_flash_torch.utils.timing import (L2_BYTES, device_ms, past_l2,
                                          rotating_ms)

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense tensor cores
# An fp32-accurate product: six bf16 products on the tensor cores (the
# flash kernels' fp32 form, the TPU's Precision.HIGHEST), 164.8 TFLOP/s, the
# least time the card takes for one; the bound of every fp32 product here.
FP32_FLOPS = BF16_FLOPS / 6
# A product of an fp32 x and an integer code exact in bf16: three bf16
# products on the tensor cores (the quantized matmuls' fp32-x prefill form,
# x split in three), 329.7 TFLOP/s; the bound of that form alone.
FP32_X3_FLOPS = BF16_FLOPS / 3
CUDA_CORE_FLOPS = 67e12        # H100 SXM data sheet, fp32 on the CUDA cores
# Every flash-attention kernel has a form for each dtype (fa._form_name):
# bf16 the tensor-core form, counted under the name + common.TC; fp32 the
# six-product form, the name + common.X6.  The forward and the fused
# backward: a source each.
ATTENTION = (fa.KERNEL_FWD, fa.KERNEL_BWD)
ATTENTION_TC = tuple(fa._form_name(n, torch.bfloat16) for n in ATTENTION)
ATTENTION_X6 = tuple(fa._form_name(n, torch.float32) for n in ATTENTION)
# The two-pass backward: one source, two kernels with their own counts,
# each in its fp32 form (TWO_PASS) and its bf16 form (TWO_PASS_TC).
TWO_PASS_SOURCE = fa.SOURCE_TWO_PASS
TWO_PASS_KERNELS = (fa.KERNEL_DKV, fa.KERNEL_DQ)
TWO_PASS = tuple(fa._form_name(n, torch.float32) for n in TWO_PASS_KERNELS)
TWO_PASS_TC = tuple(fa._form_name(n, torch.bfloat16)
                    for n in TWO_PASS_KERNELS)
# Each flash kernel's masked form (a call with a window or segment ids; the
# same C entry, the kernel's kMask instantiation), counted under the form's
# name + fa.MASK: bf16 (MASKED_TC) and fp32 (MASKED_X6), in the order
# forward, fused backward, dK/dV pass, dQ pass.
FLASH_KERNELS = ATTENTION + TWO_PASS_KERNELS
MASKED_TC = tuple(fa._form_name(n, torch.bfloat16, True)
                  for n in FLASH_KERNELS)
MASKED_X6 = tuple(fa._form_name(n, torch.float32, True)
                  for n in FLASH_KERNELS)
MASKED = MASKED_TC + MASKED_X6
# Each flash kernel's dropout forms (a call with dropout; the same C entry,
# the kernel's kDrop instantiation, with and without the mask), counted
# under the form's name (+ fa.MASK) + fa.DROP, in FLASH_KERNELS' order.
DROPPED_TC = tuple(fa._form_name(n, torch.bfloat16, False, True)
                   for n in FLASH_KERNELS)
DROPPED_X6 = tuple(fa._form_name(n, torch.float32, False, True)
                   for n in FLASH_KERNELS)
MASK_DROPPED_TC = tuple(fa._form_name(n, torch.bfloat16, True, True)
                        for n in FLASH_KERNELS)
MASK_DROPPED_X6 = tuple(fa._form_name(n, torch.float32, True, True)
                        for n in FLASH_KERNELS)
DROPPED = DROPPED_TC + DROPPED_X6 + MASK_DROPPED_TC + MASK_DROPPED_X6
# Each flash kernel's quantized-K/V forms (k and v one-byte codes; the C
# entries of the <source>_kvq library for token scales and _kvqc for
# channel codes, the kernel's kQuant instantiations), counted under the
# form's name (+ fa.MASK, + fa.DROP) + fa.KVQ[granularity]: QUANTIZED[(g,
# dtype, masked, dropped)] the four kernels' names in FLASH_KERNELS' order.
KVQ_GRANS = ("token", "channel")
QUANTIZED = {(g, dt, m, dr): tuple(fa._form_name(n, dt, m, dr, g)
                                   for n in FLASH_KERNELS)
             for g in KVQ_GRANS for dt in (torch.bfloat16, torch.float32)
             for m in (False, True) for dr in (False, True)}
KVQ_FORMS = tuple(n for names in QUANTIZED.values() for n in names)
FLASH_SOURCES = ATTENTION + (fa.SOURCE_TWO_PASS,)
KVQ_SOURCES = tuple(s + fa.KVQ[g] for s in FLASH_SOURCES for g in KVQ_GRANS)
FUSED = ("layernorm_fwd", "layernorm_bwd", "attn_softmax_fwd",
         "attn_softmax_bwd")
TRAINING_KERNELS = (ATTENTION_X6 + ATTENTION_TC + TWO_PASS + TWO_PASS_TC
                    + MASKED + DROPPED + KVQ_FORMS + FUSED)
QUANT_SOURCES = ("int8_matmul", "int4_matmul")
# The quantized matmul kernels by launch count, with (bits, group size) and
# the TPU kernel each replaces; bf16 x runs the tensor-core forms, counted
# under the name + common.DEC (decode, M <= 8) and + common.TC (prefill);
# fp32 x above M = 8 the fp32 tensor-core form (every group here is a
# multiple of 16), the name + common.X3; fp32 x at M <= 8 the fp32
# tensor-core decode form, the name + common.DEC_X3; the CUDA-core decode
# form (N not a multiple of 16, more code rows than the decode forms take)
# counts under the name.
QUANT = {"int8_matmul": (8, None, "quant.py:49"),
         "int4_matmul": (4, None, "quant.py:228"),
         "int4_matmul_group": (4, 128, "quant.py:258")}
QUANT_TC = tuple(n + common.TC for n in QUANT)
QUANT_DEC = tuple(n + common.DEC for n in QUANT)
QUANT_X3 = tuple(n + common.X3 for n in QUANT)
QUANT_DEC_X3 = tuple(n + common.DEC_X3 for n in QUANT)
# Launch-count (and profiler) names, and the sources built from csrc/.
KERNELS = (("flash_decode",) + TRAINING_KERNELS + tuple(QUANT) + QUANT_TC
           + QUANT_DEC + QUANT_X3 + QUANT_DEC_X3)
SOURCES = (("flash_decode",) + ATTENTION + (TWO_PASS_SOURCE,) + KVQ_SOURCES
           + FUSED + QUANT_SOURCES)
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
# Long-context training: the production widths at full depth, one sequence
# of 16384 tokens (the JAX package's long-context attention shape, B1 H8
# L16384 d64, bench/exp_bw_residual.py:463), where the backward takes the
# two-pass form in bf16; remat per layer and the chunked-vocab loss.
TRAIN_LONG = {**TRAIN, "n_positions": 16384, "remat": True}
LONG_B, LONG_L, LONG_CHUNKS = 1, 16384, 8
# The fp32 kernel-vs-plain training step: 2 layers at L = 8192, where fp32
# takes the two passes (d 64) and the plain attention still fits.
LONG_E2E_L = 8192
# Two-pass kernels against their plain halves (name, B, H, Hkv, Lq, Lk, d,
# causal), each in fp32 and bf16 at ATTN_TOL's limits.
TWO_PASS_CASES = [
    ("B2-H8-L2048", 2, 8, 8, 2048, 2048, 64, True),
    ("gqa-8q2kv", 2, 8, 2, 1024, 1024, 64, True),
    ("empty-rows-130x70", 2, 8, 8, 130, 70, 64, True),
    ("lq-lt-lk-70x130", 2, 8, 8, 70, 130, 64, True),
    ("ragged-L1000", 2, 8, 8, 1000, 1000, 64, True),
    ("d32", 2, 8, 8, 512, 512, 32, True),
    ("d128", 2, 8, 8, 512, 512, 128, True),
    ("full-L1024", 2, 8, 8, 1024, 1024, 64, False),
]
# Where the two forms are timed: (dtype, B, H, L); causal, d 64.  The JAX
# rule picks two passes at the first two, the fused pass at the third.
TWO_PASS_TIMED = [(torch.bfloat16, 1, 8, 16384), (torch.float32, 1, 8, 8192),
                  (torch.bfloat16, 4, 8, 2048)]
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
    # Lk not a multiple of the kernel's 16-byte vectors (single values),
    # two chunks held, the pad mask with the causal mask
    ("ragged-pad-causal-2x8x100x257", (2, 8, 100, 257), True, (257, 120)),
    # rows that see no key in vectors, two chunks held, a batch row hidden
    ("no-key-rows-pad-2x4x300x264", (2, 4, 300, 264), True, (264, 0)),
]
# Last axes above ops.fused's 512 limits at which its two routes are timed.
DISPATCH_WIDTHS = (640, 1024)
# Flash attention, kernel vs plain on the same inputs: each output x of the
# kernel is held to |x - ref| <= atol + arms * rms(ref) + rtol * |ref|, with
# rms(ref) the root mean square of the plain output over the whole case.
# fp32: the JAX package's tolerances as atol and rtol (forward 1e-3,
# backward 1e-2); the two versions differ only by summation order, exp2f
# and, in the six-product form, the products it leaves out (below 2^-24 of
# each).  bf16: out, dq, dk and dv are rounded to bf16,
# and an fp32 value near a rounding boundary may land an ulp either side
# (two ulps are at most 2^-6 of |x|: rtol 2e-2).  On top, the forward
# kernel rounds p to bf16 relative to its running max where the plain
# version rounds it relative to the row's final max, an error of a
# fraction of an ulp of p per key, and a few gradient entries sit where the
# roundings of dS compound: arms, 3e-2 of the output's rms, above the
# largest reading on an H100 (PERF.md).  The L = 2048 causal cases also
# check that the limit fails an output with one 64-key tile dropped from
# its last 128 rows, as a faulty kernel would give it.  lse stays fp32 in
# both dtypes and takes the fp32 limit; below d = 128 the bf16 normaliser
# sums P rounded to bf16 (the JAX rule), against the running max in the
# kernel and the final max in the plain version: up to an ulp of each key's
# P apart, inside the same limit (PERF.md).
ATTN_TOL = {   # output: (atol, arms, rtol)
    torch.float32: {"out": (1e-3, 0.0, 1e-3), "lse": (1e-3, 0.0, 1e-3),
                    **dict.fromkeys(("dq", "dk", "dv"), (1e-2, 0.0, 1e-2))},
    torch.bfloat16: {"lse": (1e-3, 0.0, 1e-3), **dict.fromkeys(
        ("out", "dq", "dk", "dv"), (0.0, 3e-2, 2e-2))},
}
# The dropout forms take ATTN_TOL, but for bf16 out an arms of 4e-2: the
# kernel rounds P keep / (1 - rate) against its running max, the plain
# version against the row's final max, and over the fewer kept terms of a
# row the tail of that difference is longer (at mode (f)'s shape a reading
# of 0.0336; on other inputs there 0.0295 where the form without dropout
# reads 0.0228, the worst elements in rows 64-1024, where the running max
# moves; PERF.md §6).
DROP_ATTN_TOL = {
    torch.float32: ATTN_TOL[torch.float32],
    torch.bfloat16: {**ATTN_TOL[torch.bfloat16], "out": (0.0, 4e-2, 2e-2)},
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
# The masked forms against their plain versions, each form of every flash
# kernel at ATTN_TOL (name, B, H, Hkv, Lq, Lk, d, window, segments): windows
# of one key, just under, at and off a 64-key tile, and past L (equal to
# causal); Lq < Lk; GQA; ragged L; each head dim; packed segment ids (runs
# of length 1 among them and a pad tail, segment_ids()), alone and under a
# window.
MASK_CASES = [
    ("w1", 2, 8, 8, 1000, 1000, 64, 1, False),
    ("w63", 2, 8, 8, 1000, 1000, 64, 63, False),
    ("w64", 2, 8, 8, 1024, 1024, 64, 64, False),
    ("w100-ragged-L1000", 2, 8, 8, 1000, 1000, 64, 100, False),
    ("w256-L2048", 2, 8, 8, 2048, 2048, 64, 256, False),
    ("w-ge-L", 2, 8, 8, 512, 512, 64, 4096, False),
    ("lq-lt-lk-300x700-w100", 2, 8, 8, 300, 700, 64, 100, False),
    ("gqa-8q2kv-w128", 2, 8, 2, 512, 512, 64, 128, False),
    ("d16-w50", 2, 8, 8, 300, 300, 16, 50, False),
    ("d32-w100", 2, 8, 8, 512, 512, 32, 100, False),
    ("d128-w100", 2, 8, 8, 512, 512, 128, 100, False),
    ("seg-L1024", 2, 8, 8, 1024, 1024, 64, None, True),
    ("seg-gqa-d128", 2, 8, 2, 512, 512, 128, None, True),
    ("seg-d32-ragged", 2, 8, 8, 333, 333, 32, None, True),
    ("seg-w100", 2, 8, 8, 1024, 1024, 64, 100, True),
]
# Under a window of 1 a row sees only its own key: P is 1 and dS = P (dP -
# D) is exactly 0, so dq and dk are 0 and both versions hold the rounding
# noise of fp32 sums over d (~3e-6 at d64 on an H100); they are held to
# this absolute limit there instead of ATTN_TOL's share of their rms.
W1_GRAD_ATOL = 1e-4
# The masked forms' timed shapes (label, dtype, B, H, L, window, segments
# from the packed batch of mode (h)), d 64, causal: each with its causal
# unmasked forms beside it.  The windowed training shape in both dtypes;
# mode (h)'s packed rows; mode (g)'s shape (L16384, window 2048, the JAX
# rule's two passes); the fp32 two-pass shape under the same window.
MASK_TIMED = [
    ("window 256", torch.bfloat16, 4, 8, 2048, 256, False),
    ("window 256", torch.float32, 4, 8, 2048, 256, False),
    ("segments of mode (h)", torch.bfloat16, 4, 8, 2048, None, True),
    ("segments of mode (h)", torch.float32, 4, 8, 2048, None, True),
    ("mode (g): window 2048", torch.bfloat16, 1, 8, 16384, 2048, False),
    ("window 2048", torch.float32, 1, 8, 8192, 2048, False),
]
# Attention dropout at the main path's shapes: the rate of mode (i) and the
# shorter dropout steps (DecoderConfig.attn_dropout), one fixed seed.  The
# dropout forms are held against their plain versions and timed at
# DROP_TIMED (label, dtype, B, H, L, window, segments; d 64, causal): mode
# (i)'s shape in both dtypes (the unmasked forward and fused backward),
# mode (f)'s (the unmasked forward and two passes in bf16) and under mode
# (g)'s window (masked), mode (h)'s packed rows (the masked forward and
# fused backward in bf16) and, in fp32, those rows under a window of 256,
# B1 L8192 (the two passes) and it under a window of 2048: the shapes of
# the dropout steps that launch each form.
DROP_RATE, DROP_SEED = 0.1, -20260
DROP_TIMED = [
    ("mode (i)", torch.bfloat16, 4, 8, 2048, None, False),
    ("mode (i)", torch.float32, 4, 8, 2048, None, False),
    ("mode (f)", torch.bfloat16, 1, 8, 16384, None, False),
    ("mode (g): window 2048", torch.bfloat16, 1, 8, 16384, 2048, False),
    ("segments of mode (h)", torch.bfloat16, 4, 8, 2048, None, True),
    ("window 256, segments of mode (h)", torch.float32, 4, 8, 2048, 256,
     True),
    ("L8192", torch.float32, 1, 8, 8192, None, False),
    ("window 2048", torch.float32, 1, 8, 8192, 2048, False),
]
# Mode (g): TRAIN_LONG under the long-context demo's sliding window
# (bench/demo_long_context.py:34).  Mode (h): TRAIN's widths over packed
# rows of the synthetic translation corpus (collate_packed).
LONG_WINDOW = 2048
PACK_ROWS, PACK_L = 4, 2048
# The serving model's linears, K x N: q, k, v and out projections, FF in,
# FF out, lm_head.
SERVING_LINEARS = ((1024, 1024), (1024, 4096), (4096, 1024), (1024, 32768))
# Quantized matmuls, kernel vs plain on the same inputs, M rows of x each
# (1 and 8 the decode forms, above 8 the prefill forms; bf16 the
# tensor-core forms, fp32 the fp32 tensor-core decode form and above 8 the
# fp32 tensor-core form): the serving linears, a ragged K and N (K odd for
# int4 per column, where the fp32 tensor-core forms take x by single
# values; grouped, K = 256 in groups of 64), and groups of 64 at 1024 x
# 1024.  N 304 ends in a ragged tile of the tensor-core decode forms; N
# 300, not a multiple of 16, takes the CUDA-core decode form at M <= 8 in
# both dtypes, as does fp32 x past the fp32 decode form's 8 x 1024 code
# rows (int8 K8320, int4 per column K16400, grouped K16640).
QUANT_M = (1, 8, 9, 100, 256, 1024)
QUANT_CASES = {
    "int8_matmul": [(K, N, None) for K, N in SERVING_LINEARS]
    + [(255, 304, None), (255, 300, None), (8320, 1024, None)],
    "int4_matmul": [(K, N, None) for K, N in SERVING_LINEARS]
    + [(255, 304, None), (255, 300, None), (16400, 1024, None)],
    "int4_matmul_group": [(K, N, 128) for K, N in SERVING_LINEARS]
    + [(1024, 1024, 64), (256, 304, 64), (256, 300, 64),
       (16640, 1024, 128)],
}
# Code rows a call at M <= 8 takes the tensor-core decode forms up to
# (quant._plan's cap: 8 blocks of x's slice), by x's dtype.
QUANT_DEC_ROWS = {torch.bfloat16: 8 * 2048, torch.float32: 8 * 1024}
# Each output x held to |x - ref| <= arms * rms(ref) + rtol * |ref|
# (compare()).  fp32 with TF32 off: the same products summed in another
# order (1e-5, 1e-5).  bf16: out may round to the neighbouring bf16 (rtol
# 2e-2 covers two ulps) on top of 1e-2 of the rms.
QUANT_TOL = {torch.float32: (0.0, 1e-5, 1e-5),
             torch.bfloat16: (0.0, 1e-2, 2e-2)}
# bf16 x: decode (M = 8) and prefills of 256 and 1024 tokens (a chunk of
# prefill_chunk=256, the longest bucket) at each serving linear; fp32 x:
# decode at each serving linear (the fp32 tensor-core decode form) and the
# same two prefills at K1024 N4096 (the fp32 tensor-core form).
QUANT_TIMED = [(M, K, N, torch.bfloat16) for M in (8, 256, 1024)
               for K, N in SERVING_LINEARS] + [
                   (8, K, N, torch.float32) for K, N in SERVING_LINEARS] + [
                   (M, 1024, 4096, torch.float32) for M in (256, 1024)]
# the kernels line's shapes: bf16 decode for the tensor-core decode form, a
# 1024-token bf16 prefill for the tensor-core prefill form, fp32 decode for
# the fp32 tensor-core decode form (run by the fp32 end-to-end serving
# checks), a 1024-token fp32 prefill for the fp32 tensor-core form
QUANT_MAIN_SHAPE = (8, 1024, 4096, torch.bfloat16)
QUANT_TC_SHAPE = (1024, 1024, 4096, torch.bfloat16)
QUANT_FP32_DECODE_SHAPE = (8, 1024, 4096, torch.float32)
QUANT_X3_SHAPE = (1024, 1024, 4096, torch.float32)
# The fp32 tensor-core forms against float64, beside the plain fp32
# version, at a 1024-token prefill and a decode step of 8 rows: the largest
# error at most X3_FP64_RATIO times the plain one's.
QUANT_FP64_SHAPES, X3_FP64_RATIO = ((1024, 4096, 1024), (8, 4096, 1024)), 2.0
# The quantized serving modes: weights, KV cache, chunked prefill, drive,
# and the JAX tests' limit on the logits' error against the float model
# (tests/test_quant.py:80, :218).
QUANT_SERVING = (("int8_matmul", "int8", None, "run_many(8)", 0.05),
                 ("int4_matmul", "none", None, "run()", 0.15),
                 ("int4_matmul_group", "int8", 256, "run_many(8)", 0.15))


# Profiler traces taken of the same calls before an empty one fails, and
# the pause before each new one: now and then a trace holds no device event
# at all (tools/torch_profiler_empty_traces.py).  A short trace, some
# device events but fewer than its calls' kernels, is retaken at most
# SHORT_TRACES_ALLOWED times in a run; the next one fails the run.
TRACE_TRIES, TRACE_PAUSE_S = 5, 0.5
SHORT_TRACES_ALLOWED = 1
short_traces: list[dict] = []   # this run's short traces, as logged


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel symbol: the last identifier of
    its (nested) name and its integer and bool template arguments."""
    i, ident, rest = (3 if mangled.startswith("_ZN") else 2), mangled, ""
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        ident, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        rest = mangled[i:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    return ident + ("<{}>".format(",".join(re.findall(r"L[ib](\d+)E",
                                                      args[1])))
                    if args else "")


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel, from the
    ``-Xptxas -v`` lines of an nvcc log."""
    report, entry, props = {}, None, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = m[1]
        elif m := re.search(r"Function properties for (\w+)", line):
            props = m[1]
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            report.setdefault(props, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            report.setdefault(entry, {})["registers"] = int(m[1])
    return {kernel_name(n): r for n, r in report.items()
            if n and "registers" in r}


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
    """The decode kernel against its plain version, each case called twice
    for the same bits; returns the largest error."""
    serving_lengths = [0, 1, 7, 1023, 1024, 1025, 8191, 8192]
    # the serving shape's cluster: lengths below it leave blocks of the
    # cluster no position, and so do windows of 1 and 5
    C = decode._plan(8, 16, 1, 64, torch.int8,
                     common.sm_count(torch.device(DEV))).cluster
    split_lengths = [0, 1, C - 1, C, C + 1, 1000, 8191, 8192]
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
        ("split-below-cluster-int8", 8, 16, 16, 1, 8192, 64,
         torch.bfloat16, "int8", split_lengths, None),
        ("split-empty-shares-window1", 8, 16, 16, 1, 8192, 64,
         torch.bfloat16, "int8", split_lengths, 1),
        ("split-empty-shares-window5-bf16", 8, 16, 16, 1, 8192, 64,
         torch.bfloat16, "none", split_lengths, 5),
        ("gqa-8q2kv-lq8-window", 4, 8, 2, 8, 2048, 64, torch.bfloat16,
         "int8", [3, C - 1, 1000, 2048], 100),
    ]
    worst = 0.0
    for (name, B, Hq, Hkv, Lq, S, d, dtype, quant, lengths,
         window) in cases:
        cache = filled_cache(gen, B, Hkv, S, d, quant, dtype, lengths)
        q = torch.randn(B, Hq, Lq, d, generator=gen, device=DEV).to(dtype)
        args = (q, cache.k, cache.v, cache.lengths, cache.k_scale,
                cache.v_scale)
        out = flash_decode_attention(*args, window=window, impl="kernel")
        again = flash_decode_attention(*args, window=window, impl="kernel")
        ref = flash_decode_attention(*args, window=window, impl="plain")
        torch.cuda.synchronize()
        same = torch.equal(out, again)
        out, ref = out.float(), ref.float()
        err = float((out - ref).abs().max())
        tol = TOL[dtype]
        ok = same and bool(torch.isfinite(out).all()) and bool(
            ((out - ref).abs() <= tol + tol * ref.abs()).all())
        log({"phase": "kernel_vs_plain", "case": name, "max_abs_err": err,
             "tol": f"atol {tol} + rtol {tol}",
             "two_calls_same_bits": same, "ok": ok})
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
                     "operations": flops / CUDA_CORE_FLOPS * 1e3}
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
    worst = dict.fromkeys(ATTENTION_X6 + ATTENTION_TC, 0.0)
    failed, summary = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        tols = ATTN_TOL[dtype]
        fwd_name, bwd_name = (fa._form_name(n, dtype) for n in ATTENTION)
        largest = summary[str(dtype).split(".")[1]] = {
            n: {"err_over_rms": 0.0, "arms_needed": 0.0, "limit": t}
            for n, t in tols.items()}
        for name, B, H, Hkv, Lq, Lk, d, causal in ATTN_CASES:
            q = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
            k, v = (torch.randn(B, Hkv, Lk, d, generator=gen,
                                device=DEV).to(dtype) for _ in range(2))
            do = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
            before = dict(common.launch_counts)
            out, lse, _ = flash_attention_forward(q, k, v, causal=causal,
                                                  impl="kernel")
            grads = flash_attention_backward(q, k, v, out, lse, do,
                                             causal=causal, impl="kernel")
            launched = {n: c - before.get(n, 0) for n, c in
                        common.launch_counts.items() if c != before.get(n, 0)}
            ref_out, ref_lse, _ = flash_attention_forward(
                q, k, v, causal=causal, impl="plain")
            ref_grads = flash_attention_backward(q, k, v, out, lse, do,
                                                 causal=causal, impl="plain")
            torch.cuda.synchronize()
            # each call launched its dtype's form (the fused backward at
            # these lengths)
            errs, rms, need = {}, {}, {}
            ok = launched == {fwd_name: 1, bwd_name: 1}
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
                 "arms_needed": need, "launches": launched,
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
            worst[fwd_name] = max(worst[fwd_name], errs["out"], errs["lse"])
            worst[bwd_name] = max(worst[bwd_name], errs["dq"], errs["dk"],
                                  errs["dv"])
    log({"phase": "attention_tolerance", "limit": "(atol, arms, rtol)",
         **summary})
    check(not failed, f"flash attention disagrees with its plain version: "
                      f"{failed}")
    return worst


def attention_fp64(q, k, v, do):
    """Causal attention's forward and backward in float64 (H = Hkv, Lq =
    Lk), the exact values the fp32 forms approach: out, lse, dq, dk, dv."""
    q, k, v, do = (x.double() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    L = q.shape[2]
    s = (q @ k.transpose(-1, -2)).mul_(scale)
    s.masked_fill_(torch.ones(L, L, dtype=torch.bool, device=q.device
                              ).triu_(1), -math.inf)
    lse = torch.logsumexp(s, -1)
    p = s.sub_(lse[..., None]).exp_()
    out = p @ v
    ds = (do @ v.transpose(-1, -2)).sub_(
        (do * out).sum(-1, keepdim=True)).mul_(p)
    return (out, lse, scale * (ds @ k), scale * (ds.transpose(-1, -2) @ q),
            p.transpose(-1, -2) @ do)


# fp32 against float64: (B, H, L), causal, d 64.  The JAX rule takes the
# fused backward at the training shape (train-L2048) and the two passes at
# the fp32 two-pass shape (the long-two-pass step's, ~13 GB in float64).
FP64_SHAPES = ((4, 8, 2048), (1, 8, LONG_E2E_L))


def attention_vs_fp64(gen, d=64) -> dict:
    """fp32 at ``FP64_SHAPES``: out, lse, dq, dk and dv of the six-product
    kernels (the forward, then the backward form the JAX rule takes there)
    and of the plain version (its halves where the rule takes two passes)
    each against a float64 attention on the same inputs, each within
    ATTN_TOL's fp32 limits of it.  Returns, by L, the kernels' largest
    error by output."""
    dtype = torch.float32
    names = ("out", "lse", "dq", "dk", "dv")
    worst = {}
    for B, H, L in FP64_SHAPES:
        q, k, v, do = (torch.randn(B, H, L, d, generator=gen, device=DEV)
                       for _ in range(4))
        ref = attention_fp64(q, k, v, do)
        kernels = (ATTENTION_X6[0],) + (
            TWO_PASS if two_pass(L, L, d, 4, True) else ATTENTION_X6[1:])
        errs, rms, ok = {}, {}, True
        for impl in ("kernel", "plain"):
            before = dict(common.launch_counts)
            out, lse, _ = flash_attention_forward(q, k, v, causal=True,
                                                  impl=impl)
            grads = flash_attention_backward(q, k, v, out, lse, do,
                                             causal=True, impl=impl)
            torch.cuda.synchronize()
            launched = {n: c - before.get(n, 0) for n, c in
                        common.launch_counts.items() if c != before.get(n, 0)}
            ok &= launched == (dict.fromkeys(kernels, 1)
                               if impl == "kernel" else {})
            errs[impl] = {}
            for n, a, b in zip(names, (out, lse, *grads), ref):
                finite = torch.isfinite(b)
                errs[impl][n] = float((a.double() - b)[finite].abs().max())
                rms[n] = float(b[finite].square().mean().sqrt())
                ok &= compare(a, b, ATTN_TOL[dtype][n])[3]
            del out, lse, grads
            torch.cuda.empty_cache()
        log({"phase": "attention_vs_fp64", "dtype": "float32",
             "shape": f"B{B} H{H} L{L} d{d} causal", "max_abs_err": errs,
             "rms": rms, "kernel_over_plain": {
                 n: errs["kernel"][n] / errs["plain"][n]
                 if errs["plain"][n] else None for n in names},
             "kernels": list(kernels), "ok": ok})
        check(ok, f"fp32 attention strays from float64 at L{L}: {errs}")
        worst[L] = errs["kernel"]
        del q, k, v, do, ref
        torch.cuda.empty_cache()
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
        fwd_name, bwd_name = (fa._form_name(n, dtype) for n in ATTENTION)
        work = {   # useful causal flops; bytes read once and written once
            fwd_name: (2 * B * H * L * L * d, 4 * act + lse_b),
            bwd_name: (5 * B * H * L * L * d, 8 * act + 2 * lse_b)}
        timed = {
            fwd_name: (
                device_ms(lambda: fwd("kernel"), iters=10),
                device_ms(lambda: fwd("plain"), iters=5),
                device_ms(lambda: sdpa(q, k, v, is_causal=True), iters=10)),
            bwd_name: (
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
                            + (" backward" if name == bwd_name else ""),
                 "library_fwd_bwd_ms": lib_fwdbwd_ms, **row})
            rows[(name, dtype)] = row
        del q, k, v, do, out, lse, leaves, lib_out
    return rows


def fused_backward_bits(gen, B=4, H=8, L=2048, d=64, window=None,
                        rate=0.0, mode=None) -> None:
    """The fused backward kernel called twice on the same inputs at the
    training shape (B4 H8 L2048 d64 causal) in bf16 (its tensor-core form)
    and fp32 (its six-product form): dq, dk and dv the same bits (its dQ is
    added in a fixed order; under a window each key tile waits only for the
    tiles that reach its chunk, in the same order; under dropout at
    ``rate`` both calls regenerate the same mask; with ``mode``, on the
    codes of quantized K/V, its quantized form)."""
    for dtype in (torch.bfloat16, torch.float32):
        if mode is None:
            args = attention_inputs(gen, B, H, H, L, L, d, dtype, True,
                                    window, None, rate)
            kw = dict(causal=True, window=window, dropout_rate=rate,
                      dropout_seed=DROP_SEED, impl="kernel")
        else:
            q, kc, vc, do, kw = kvq_inputs(gen, B, H, H, L, d, dtype, mode,
                                           window, None, rate)
            kw["impl"] = "kernel"
            out, lse, _ = flash_attention_forward(q, kc, vc, **kw)
            args = (q, kc, vc, out, lse, do)
        name = fa._form_name(fa.KERNEL_BWD, dtype, window is not None,
                             rate > 0, None if mode is None
                             else kv_quant_parts(mode)[1])
        before = common.launch_counts[name]
        first = flash_attention_backward_fused(*args, **kw)
        second = flash_attention_backward_fused(*args, **kw)
        torch.cuda.synchronize()
        same = {n: torch.equal(a, b)
                for n, a, b in zip(("dq", "dk", "dv"), first, second)}
        log({"phase": "fused_backward_bits", "dtype": str(dtype).split(".")[1],
             "kernel": name, "shape": f"B{B} H{H} L{L} d{d} causal",
             "window": window, "dropout_rate": rate, "kv_quant": mode,
             "launches": common.launch_counts[name] - before,
             "two_calls_same_bits": same})
        check(all(same.values()), f"the fused backward gives other bits on "
                                  f"a second call ({dtype}): {same}")
        check(common.launch_counts[name] == before + 2,
              f"the fused backward did not launch {name} twice")
        del args, first, second


def attention_inputs(gen, B, H, Hkv, Lq, Lk, d, dtype, causal, window=None,
                     seg=None, rate=0.0):
    """q, k, v, the forward kernel's out and lse (under dropout at ``rate``
    with ``DROP_SEED``), and dO."""
    q = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
    k, v = (torch.randn(B, Hkv, Lk, d, generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    do = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
    out, lse, _ = flash_attention_forward(q, k, v, causal=causal,
                                          window=window, segment_ids=seg,
                                          dropout_rate=rate,
                                          dropout_seed=DROP_SEED,
                                          impl="kernel")
    return q, k, v, out, lse, do


def mask_probe(B=2, H=8, d=64) -> dict:
    """Each flash kernel's keep bits, read back exactly and held bit for
    bit against the hash (``fa.dropout_keep_mask``), in both dtypes, in
    the unmasked and (under a window of 20) the masked dropout forms, at
    rates 0.5, 0.1 and 0.9 with seeds that wrap, seed offsets among them.
    With q = 0 and K = I (Lk = d) every score is 0 and P uniform, so the
    forward's out with V = I is ``P keep / (1 - rate)``; with V = 1,
    dO = I (Lq = d), O = 0 (D = 0) and lse = log(d), dV is
    ``(P keep / (1 - rate))^T`` and dQ ``scale P keep / (1 - rate)``, in
    the fused backward and in the dK/dV and dQ passes.  Returns the
    number of bits compared."""
    compared, failed = 0, []
    r = torch.arange(d, device=DEV)
    eye = {}
    for dtype in (torch.bfloat16, torch.float32):
        eye[dtype] = torch.eye(d, device=DEV).expand(B, H, d, d).to(dtype)
    for dtype, window, (seed, rate) in (
            (dt, w, sr) for dt in (torch.bfloat16, torch.float32)
            for w in (None, 20)
            for sr in ((-123456789, 0.5), ((7, 3, 5), 0.1),
                       (2 ** 31 - 1, 0.9))):
        seed_t = (torch.tensor(seed, dtype=torch.int32, device=DEV)
                  if isinstance(seed, tuple) else seed)
        kw = dict(causal=window is not None, window=window,
                  dropout_rate=rate, dropout_seed=seed_t, impl="kernel")
        i, zero = eye[dtype], torch.zeros(B, H, d, d, device=DEV,
                                          dtype=dtype)
        before = dict(common.launch_counts)
        out, _, _ = flash_attention_forward(zero, i, i, **kw)
        lse = torch.full((B, H, d), math.log(d), device=DEV)
        args = (zero, i, torch.ones_like(i), zero, lse, i)
        dq_f, _, dv_f = flash_attention_backward_fused(*args, **kw)
        dq_t, _, dv_t = flash_attention_backward_two_pass(*args, **kw)
        torch.cuda.synchronize()
        launched = {n: c - before.get(n, 0) for n, c in
                    common.launch_counts.items() if c != before.get(n, 0)}
        s = [int(x) for x in fa.dropout_seed_array(seed_t, DEV).tolist()]
        keep = fa.dropout_keep_mask(
            r[:, None], r[None, :],
            torch.arange(B, device=DEV)[:, None, None, None] + s[1],
            torch.arange(H, device=DEV)[None, :, None, None] + s[2], s[0],
            rate)
        if window is not None:
            keep &= (r[None, :] <= r[:, None]) & (r[None, :] > r[:, None]
                                                  - window)
        bits = {"out": out != 0, "dv_fused": (dv_f != 0).transpose(-1, -2),
                "dq_fused": dq_f != 0,
                "dv_two_pass": (dv_t != 0).transpose(-1, -2),
                "dq_two_pass": dq_t != 0}
        differ = {n: int((b != keep).sum()) for n, b in bits.items()}
        names = [fa._form_name(n, dtype, window is not None, True)
                 for n in FLASH_KERNELS]
        ok = not any(differ.values()) and launched == dict.fromkeys(names, 1)
        compared += keep.numel() * len(bits)
        log({"phase": "mask_probe", "dtype": str(dtype).split(".")[1],
             "window": window, "seed": list(s), "rate": rate,
             "shape": f"B{B} H{H} L{d} d{d}",
             "kept_share": float(keep.float().mean()),
             "bits_differing": differ, "launches": launched, "ok": ok})
        if not ok:
            failed.append((str(dtype), window, rate))
    check(not failed, f"a flash kernel's keep bits differ from the hash's: "
                      f"{failed}")
    return compared


def segment_ids(B, L, seed=0):
    """Segment ids [B, L] on the card as a packed batch gives them: runs of
    1 to 40 positions from a seed (a fifth of them of length 1), then a
    pad-tail segment of its own id in every row but the last, which ends in
    a run of length 1."""
    rng = np.random.default_rng(seed)
    rows = []
    for b in range(B):
        ids, sid = [], 0
        tail = 0 if b == B - 1 else int(rng.integers(1, L // 4))
        while len(ids) < L - tail:
            n = 1 if rng.random() < 0.2 else int(rng.integers(2, 41))
            ids += [sid] * min(n, L - tail - len(ids))
            sid += 1
        if b == B - 1:
            ids[-1] = sid
        rows.append(ids + [sid + 1] * tail)
    return torch.tensor(rows, dtype=torch.int32, device=DEV)


def packed_batch(rows=PACK_ROWS, length=PACK_L) -> dict:
    """Mode (h)'s batch: the synthetic translation corpus's examples packed
    into ``rows`` rows of ``length`` tokens by ``collate_packed`` through
    the stand-in word tokenizer (segment ids, positions, next-token labels
    inside each example, the targets weighted)."""
    data = synthetic_translation_dataset(n_train=rows * length // 8,
                                         n_validation=1, n_test=1)["train"]
    batch = collate_packed(data, "de", "en", WordTokenizer(data), length,
                           fixed_rows=rows)
    return {n: batch[n] for n in ("input_ids", "labels",
                                  "label_token_weights", "segment_ids",
                                  "positions")}


def masked_cases(gen) -> dict:
    """The four flash kernels' masked forms against their plain versions on
    the same inputs (fp32 and bf16, ``MASK_CASES``, ATTN_TOL): the forward,
    the fused backward and both passes, each call launching its masked form
    once; a window past L checked against the unmasked causal kernel
    (within ATTN_TOL; same bits logged).  Returns each masked form's
    largest error."""
    worst = dict.fromkeys(MASKED, 0.0)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        tols = ATTN_TOL[dtype]
        dname = str(dtype).split(".")[1]
        names = [fa._form_name(n, dtype, True) for n in FLASH_KERNELS]
        for name, B, H, Hkv, Lq, Lk, d, window, seg_on in MASK_CASES:
            seg = segment_ids(B, Lq, 1) if seg_on else None
            kw = dict(causal=True, window=window, segment_ids=seg)
            q = torch.randn(B, H, Lq, d, generator=gen, device=DEV).to(dtype)
            k, v = (torch.randn(B, Hkv, Lk, d, generator=gen,
                                device=DEV).to(dtype) for _ in range(2))
            do = torch.randn(B, H, Lq, d, generator=gen,
                             device=DEV).to(dtype)
            before = dict(common.launch_counts)
            out, lse, _ = flash_attention_forward(q, k, v, impl="kernel",
                                                  **kw)
            fused = flash_attention_backward_fused(q, k, v, out, lse, do,
                                                   impl="kernel", **kw)
            two = flash_attention_backward_two_pass(q, k, v, out, lse, do,
                                                    impl="kernel", **kw)
            launched = {n: c - before.get(n, 0) for n, c in
                        common.launch_counts.items() if c != before.get(n, 0)}
            ref_out, ref_lse, _ = flash_attention_forward(q, k, v,
                                                          impl="plain", **kw)
            ref = flash_attention_backward_fused(q, k, v, out, lse, do,
                                                 impl="plain", **kw)
            torch.cuda.synchronize()
            ok = launched == dict.fromkeys(names, 1)
            errs = {}
            pairs = ([("out", out, ref_out), ("lse", lse, ref_lse)]
                     + list(zip(("dq", "dk", "dv"), fused, ref))
                     + list(zip(("dq_two_pass", "dk_two_pass",
                                 "dv_two_pass"), two, ref)))
            for n, a, b in pairs:
                tol = tols[n.split("_")[0]]
                if window == 1 and n[:2] in ("dq", "dk"):
                    tol = (W1_GRAD_ATOL, 0.0, 0.0)
                errs[n], _, _, agree = compare(a, b, tol)
                ok &= agree
            row = {"phase": "masked_vs_plain", "case": name, "dtype": dname,
                   "shape": f"B{B} H{H} Hkv{Hkv} Lq{Lq} Lk{Lk} d{d} causal",
                   "window": window, "segments": seg_on,
                   "max_abs_err": errs, "launches": launched}
            if window is not None and window >= Lk and not seg_on:
                unmasked = flash_attention_forward(q, k, v, causal=True,
                                                   impl="kernel")
                row["same_bits_as_causal"] = (
                    torch.equal(out, unmasked[0])
                    and torch.equal(lse, unmasked[1]))
                ok &= compare(out, unmasked[0], tols["out"])[3]
            row["ok"] = ok
            log(row)
            if not ok:
                failed.append(f"{name} {dname}")
            for n, outs in zip(names, (("out", "lse"), ("dq", "dk", "dv"),
                                       ("dk_two_pass", "dv_two_pass"),
                                       ("dq_two_pass",))):
                worst[n] = max(worst[n], *(errs[o] for o in outs))
            del q, k, v, do, out, lse, fused, two, ref
    check(not failed, f"a masked flash form disagrees with its plain "
                      f"version: {failed}")
    return worst


def visible_pairs(B, Lq, Lk, window=None, seg=None) -> int:
    """Scores one head sees over the B batch rows under the causal limit
    (q_offset = Lk - Lq), the window's band and the segments: the work the
    masked forms' bounds count."""
    rows = torch.arange(Lq, device=DEV)[:, None] + (Lk - Lq)
    cols = torch.arange(Lk, device=DEV)[None, :]
    keep = cols <= rows
    if window is not None:
        keep &= cols > rows - window
    if seg is None:
        return B * int(keep.sum())
    return int((keep[None] & (seg[:, :, None] == seg[:, None, :])).sum())


def masked_times(gen, cases=MASK_TIMED, rate: float = 0.0) -> dict:
    """At ``cases`` (causal, d 64; the shapes the main path gives the
    forms, ``MASK_TIMED`` by default, modes (g) and (h) among them): the
    masked forward and the masked backward form the JAX rule takes there
    (the fused kernel, or the dK/dV and dQ passes), each held against its
    plain version on the same inputs at ATTN_TOL (one launch of each form)
    and timed: kernel, plain and library (``scaled_dot_product_attention``
    with an explicit boolean mask, a yardstick only), each bound on the
    pairs the masks leave visible; beside them the unmasked causal forms
    on the same q, k, v (the masked forward's time over the causal one's).
    With ``rate`` the same for the dropout forms (``DROP_SEED``; masked
    where the case has a window or segments): SDPA with ``dropout_p`` the
    yardstick, the bound that of the undropped form (dropout removes no
    work), and beside them the forms without dropout under the same masks
    (``dropout_over_undropped``).  CUDA events, the median of 5 batches.
    Each row carries its kernel's ``max_abs_err`` at that shape."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    packed = None
    failed = []
    for label, dtype, B, H, L, window, seg_on in cases:
        d = 64
        tols = (DROP_ATTN_TOL if rate else ATTN_TOL)[dtype]
        if seg_on:
            if packed is None:
                packed = torch.as_tensor(packed_batch()["segment_ids"],
                                         device=DEV)
            seg = packed[:B, :L].contiguous()
        else:
            seg = None
        args = attention_inputs(gen, B, H, H, L, L, d, dtype, True, window,
                                seg, rate)
        q, k, v, out, lse, do = args
        drop = fa.check_dropout(q, rate, DROP_SEED)
        masked = window is not None or seg is not None
        scale = 1.0 / math.sqrt(d)
        kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True, scale, 0,
               window, seg, drop)
        # the forms beside: under dropout the same masks without it; else
        # the causal unmasked forms
        base_kin = kin[:-1] if drop else kin[:-3]
        vis = visible_pairs(B, L, L, window, seg)
        causal_vis = B * causal_visible(L, L)
        iters = max(1, round(64 * 2048 ** 2 / (B * L * L)))
        two = two_pass(L, L, d, q.element_size(), True, 0, window)
        names = [fa._form_name(n, dtype, masked, drop is not None)
                 for n in FLASH_KERNELS]
        bwd_names = names[2:] if two else names[1:2]
        outs_of = dict(zip(names, (("out", "lse"), ("dq", "dk", "dv"),
                                   ("dk", "dv"), ("dq",))))

        def timed(fn, n=iters):
            return device_ms(fn, warmup=1, iters=n, reps=5)

        ms = {names[0]: timed(lambda: fa._launch_forward(
            q, k, v, True, scale, 0, False, window, seg, drop))}
        if two:
            ms[names[2]] = timed(lambda: fa._launch_dkv(*kin))
            ms[names[3]] = timed(lambda: fa._launch_dq(*kin))
        else:
            ms[names[1]] = timed(lambda: fa._launch_backward(*kin))
        base_fwd_ms = timed(lambda: fa._launch_forward(
            q, k, v, True, scale, 0, False, *base_kin[9:]))
        if two:
            base_bwd_ms = timed(lambda: (fa._launch_dkv(*base_kin),
                                         fa._launch_dq(*base_kin)))
        else:
            base_bwd_ms = timed(lambda: fa._launch_backward(*base_kin))
        # the library's yardstick: SDPA under the same boolean mask (or
        # is_causal where there is none), dropping at the same rate
        if masked:
            rr = torch.arange(L, device=DEV)
            keep = rr[None, :] <= rr[:, None]
            if window is not None:
                keep &= rr[None, :] > rr[:, None] - window
            keep = keep[None, None]
            if seg is not None:
                keep = keep & (seg[:, None, :, None]
                               == seg[:, None, None, :])
            lib_kw = dict(attn_mask=keep, dropout_p=rate)
        else:
            lib_kw = dict(is_causal=True, dropout_p=rate)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_fwd_ms = timed(lambda: sdpa(q, k, v, **lib_kw))
        lib_out = sdpa(*leaves, **lib_kw)
        lib_bwd_ms = timed(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        del lib_out, leaves, lib_kw
        torch.cuda.empty_cache()
        # the plain versions (a few fp32 [B, H, L, L] tensors each, ~30 GB
        # at L = 16384; dropout's multiplier a block of rows at a time)
        pin = (q, k, v, do, lse, kin[5], True, scale, 0, window, seg, drop)
        plain = {names[0]: lambda: fa.flash_attention_forward_plain(
            q, k, v, causal=True, window=window, segment_ids=seg,
            drop=drop)}
        if two:
            plain[names[2]] = lambda: fa._dkv_plain(*pin)
            plain[names[3]] = lambda: fa._dq_plain(*pin)
        else:
            plain[names[1]] = lambda: fa.flash_attention_backward_plain(
                q, k, v, out, lse, do, causal=True, window=window,
                segment_ids=seg, drop=drop)
        # each kernel against its plain version at this shape, ATTN_TOL
        before = dict(common.launch_counts)
        got = {"out": out, "lse": lse}
        if two:
            got["dk"], got["dv"] = fa._launch_dkv(*kin)
            got["dq"] = fa._launch_dq(*kin)
        else:
            got["dq"], got["dk"], got["dv"] = fa._launch_backward(*kin)
        launched = {n: c - before.get(n, 0) for n, c in
                    common.launch_counts.items() if c != before.get(n, 0)}
        want = {}
        for n, f in plain.items():
            res = f()
            want.update(zip(outs_of[n], res if isinstance(res, tuple)
                            else (res,)))
            del res
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        errs, need = {}, {}
        ok = launched == dict.fromkeys(bwd_names, 1)
        for o, a in got.items():
            errs[o], _, need[o], agree = compare(a, want[o], tols[o])
            ok &= agree
        del got, want
        plain_ms = {n: device_ms(f, warmup=1, iters=1, reps=3)
                    for n, f in plain.items()}
        torch.cuda.empty_cache()
        item = q.element_size()
        act = B * H * L * d * item
        lse_b = B * H * L * 4
        seg_b = 0 if seg is None else B * L * 4
        product = 2 * H * vis * d        # one product over the visible pairs
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        work = {   # (flops, bytes: inputs read once, outputs written once)
            names[0]: (2 * product, 4 * act + lse_b + seg_b),
            names[1]: (5 * product, 8 * act + 2 * lse_b + seg_b),
            names[2]: (4 * product, 6 * act + 2 * lse_b + seg_b),
            names[3]: (3 * product, 5 * act + 2 * lse_b + seg_b)}
        dname = str(dtype).split(".")[1]
        shape = (f"B{B} H{H} L{L} d{d} causal"
                 + (f" window {window}" if window else "")
                 + (" segments of mode (h)" if seg_on else "")
                 + (f" dropout {rate}" if drop else ""))
        lib_name = ("scaled_dot_product_attention("
                    + ("attn_mask=bool [.., L, L]" if masked
                       else "is_causal=True")
                    + (f", dropout_p={rate}" if drop else "") + ")")
        for n in ms:
            flops, nbytes = work[n]
            bound = {"operations": flops / peak * 1e3,
                     "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
            bound_by = max(bound, key=bound.get)
            lib = lib_fwd_ms if n == names[0] else lib_bwd_ms
            row = {"ms": ms[n], "plain_ms": plain_ms[n],
                   "shape": f"{shape} {dname}",
                   "max_abs_err": max(errs[o] for o in outs_of[n]),
                   "library_ms": lib, "bound_ms": bound[bound_by],
                   "bound_by": bound_by, "of_bound": bound[bound_by] / ms[n],
                   "flops": flops, "bytes": nbytes,
                   "visible_pairs_per_head": vis,
                   "causal_pairs_per_head": causal_vis,
                   "tflops": flops / (ms[n] * 1e-3) / 1e12}
            log({"phase": "kernel_time", "kernel": n, "dtype": dname,
                 "label": label,
                 "library": lib_name + (" backward, the pair's yardstick"
                                        if two and n != names[0] else
                                        " backward" if n != names[0]
                                        else ""), **row})
            rows[(n, label)] = row
        over = "dropout_over_undropped" if drop else "masked_over_causal"
        base = "undropped" if drop else "causal"
        log({"phase": over, "dtype": dname, "shape": shape,
             "label": label, "forward_ms": ms[names[0]],
             f"{base}_forward_ms": base_fwd_ms,
             f"forward_over_{base}": ms[names[0]] / base_fwd_ms,
             "backward_ms": sum(ms[n] for n in bwd_names),
             f"{base}_backward_ms": base_bwd_ms,
             f"backward_over_{base}": (sum(ms[n] for n in bwd_names)
                                       / base_bwd_ms),
             **({"each_over_undropped": {
                 n: ms[n] / timed(fn) for n, fn in (
                     (names[2], lambda: fa._launch_dkv(*base_kin)),
                     (names[3], lambda: fa._launch_dq(*base_kin)))}}
                if drop and two else {}),
             "visible_over_causal_pairs": vis / causal_vis,
             "backward_form": "two-pass" if two else "fused",
             "card": torch.cuda.get_device_name(0)})
        log({"phase": "dropout_vs_plain" if drop else "masked_vs_plain",
             "case": label, "dtype": dname,
             "shape": shape, "max_abs_err": errs, "arms_needed": need,
             "tol": {o: "atol {} + {} * rms + rtol {}".format(*tols[o])
                     for o in errs},
             "launches": launched, "ok": ok})
        if not ok:
            failed.append(f"{label} {dname}")
        del args, kin, base_kin, pin, q, k, v, out, lse, do, plain
        torch.cuda.empty_cache()
    check(not failed, f"at a timed shape a {'dropout' if rate else 'masked'} "
                      f"flash form disagrees with its plain version or did "
                      f"not launch once: {failed}")
    return rows


# --- quantized K/V (kv_quant): the kvq forms ---------------------------------

# The quantized forms take ATTN_TOL (DROP_ATTN_TOL under dropout), but for
# bf16 lse with channel codes below d = 128 without dropout an atol of
# 2e-3: there the normaliser sums P rounded to bf16 (fold_l, as without
# quantization), in the kernel against its running max and in the plain
# version against the row's final max, so the two l differ by at most one
# bf16 rounding, 2^-9 of l (lse 1.95e-3); a row of a short packed segment
# under a window of 100, whose few keys straddle a step, read 1.62e-3
# (ATTN_TOL's 1e-3 held the unquantized masked forms, their rows' largest
# reading ~5e-4).  And bf16 out with token scales takes DROP_ATTN_TOL's
# (arms 4e-2): P.V takes P vs rounded to bf16 against the kernel's running
# max and the plain version's final max, the dropout forms' case; mode
# (g)'s shape read 0.0312 of the rms.
def kvq_tols(dtype, gran: str, rate: float, d: int) -> dict:
    tols = (DROP_ATTN_TOL if rate else ATTN_TOL)[dtype]
    if dtype == torch.bfloat16 and gran == "token":
        return {**tols, "out": DROP_ATTN_TOL[dtype]["out"]}
    if dtype == torch.bfloat16 and not rate and d < 128:
        return {**tols, "lse": (2e-3, 0.0, 1e-3)}
    return tols


# The modes the main path's quantized runs and the timed shapes take (the
# forms are the granularity's: int8 and e4m3 codes share them), and the
# four modes of the correctness sweep.
KVQ_MODE = {"token": "int8", "channel": "int8_channel"}
KVQ_MODES = ("int8", "fp8", "int8_channel", "fp8_channel")
# Each quantized form against its plain version on the same codes and
# scales at ATTN_TOL (DROP_ATTN_TOL under dropout), in both dtypes and the
# four modes (name, B, H, Hkv, L, d, window, segments, rate; causal): a
# ragged L, GQA, each head dim, a window, packed segments, dropout.
KVQ_CASES = [
    ("L1000", 2, 8, 8, 1000, 64, None, False, 0.0),
    ("gqa-8q2kv-L512-drop", 2, 8, 2, 512, 64, None, False, DROP_RATE),
    ("d16-w50", 2, 8, 8, 300, 16, 50, False, 0.0),
    ("d32-seg-ragged-drop", 2, 8, 8, 333, 32, None, True, DROP_RATE),
    ("d128-gqa-w100-drop", 2, 8, 4, 512, 128, 100, False, DROP_RATE),
    ("seg-w100", 2, 8, 8, 1024, 64, 100, True, 0.0),
]
# The quantized forms' timed shapes (label, dtype, B, H, L, window,
# segments of mode (h), rate; d 64, causal), each the shape of the
# main-path run that launches its form: mode (j) and mode (a) (the
# unmasked forward and fused backward), with attention dropout, mode
# (h)'s packed rows, those under a window of 256 with dropout, mode (f)'s
# L16384 in bf16 and the fp32 two-pass L8192 (the two passes), with
# dropout, under a window of 2048, and both; for each granularity.
KVQ_TIMED = [
    ("mode (j)", torch.bfloat16, 4, 8, 2048, None, False, 0.0),
    ("mode (j), attention dropout", torch.bfloat16, 4, 8, 2048, None, False,
     DROP_RATE),
    ("segments of mode (h)", torch.bfloat16, 4, 8, 2048, None, True, 0.0),
    ("window 256, segments of mode (h), attention dropout", torch.bfloat16,
     4, 8, 2048, 256, True, DROP_RATE),
    ("mode (f)", torch.bfloat16, 1, 8, 16384, None, False, 0.0),
    ("mode (f), attention dropout", torch.bfloat16, 1, 8, 16384, None,
     False, DROP_RATE),
    ("mode (g): window 2048", torch.bfloat16, 1, 8, 16384, 2048, False,
     0.0),
    ("mode (g): window 2048, attention dropout", torch.bfloat16, 1, 8,
     16384, 2048, False, DROP_RATE),
    ("mode (a)", torch.float32, 4, 8, 2048, None, False, 0.0),
    ("mode (a), attention dropout", torch.float32, 4, 8, 2048, None, False,
     DROP_RATE),
    ("segments of mode (h)", torch.float32, 4, 8, 2048, None, True, 0.0),
    ("window 256, segments of mode (h), attention dropout", torch.float32,
     4, 8, 2048, 256, True, DROP_RATE),
    ("L8192", torch.float32, 1, 8, 8192, None, False, 0.0),
    ("L8192, attention dropout", torch.float32, 1, 8, 8192, None, False,
     DROP_RATE),
    ("window 2048", torch.float32, 1, 8, 8192, 2048, False, 0.0),
    ("window 2048, attention dropout", torch.float32, 1, 8, 8192, 2048,
     False, DROP_RATE),
]


def kvq_inputs(gen, B, H, Hkv, L, d, dtype, mode, window=None, seg=None,
               rate=0.0):
    """q and dO in ``dtype``, the codes of normal K and V
    (``ops.quantize_kv``, as the op quantizes them), and the entries'
    keywords: causal, the scales and their granularity, window, segments,
    dropout at ``rate`` with ``DROP_SEED``."""
    q = torch.randn(B, H, L, d, generator=gen, device=DEV).to(dtype)
    k, v = (torch.randn(B, Hkv, L, d, generator=gen, device=DEV).to(dtype)
            for _ in range(2))
    do = torch.randn(B, H, L, d, generator=gen, device=DEV).to(dtype)
    (kc, ks), (vc, vs) = quantize_kv(k, mode), quantize_kv(v, mode)
    kw = dict(causal=True, window=window, segment_ids=seg,
              dropout_rate=rate, dropout_seed=DROP_SEED, k_scale=ks,
              v_scale=vs, kv_scale_mode=kv_quant_parts(mode)[1])
    return q, kc, vc, do, kw


def kvq_cases(gen) -> dict:
    """Every quantized form (the forward, the fused backward and both
    passes; unmasked, masked, dropped; token and channel) against its
    plain version on the same codes and scales over ``KVQ_CASES``, in both
    dtypes and the four modes, through the entries (the channel forms with
    their folds), at ``kvq_tols``; each call checked to launch exactly its
    form.  Returns each form's largest error."""
    worst = dict.fromkeys(KVQ_FORMS, 0.0)
    failed = []
    for name, B, H, Hkv, L, d, window, seg_on, rate in KVQ_CASES:
        seg = segment_ids(B, L) if seg_on else None
        for dtype in (torch.float32, torch.bfloat16):
            for mode in KVQ_MODES:
                q, kc, vc, do, kw = kvq_inputs(gen, B, H, Hkv, L, d, dtype,
                                               mode, window, seg, rate)
                tols = kvq_tols(dtype, kw["kv_scale_mode"], rate, d)
                names = QUANTIZED[(kw["kv_scale_mode"], dtype,
                                   window is not None or seg_on, rate > 0)]
                before = dict(common.launch_counts)
                out, lse, _ = flash_attention_forward(q, kc, vc,
                                                      impl="kernel", **kw)
                fused = flash_attention_backward_fused(
                    q, kc, vc, out, lse, do, impl="kernel", **kw)
                two = flash_attention_backward_two_pass(
                    q, kc, vc, out, lse, do, impl="kernel", **kw)
                launched = {n: c - before.get(n, 0) for n, c in
                            common.launch_counts.items()
                            if c != before.get(n, 0)}
                ref = flash_attention_forward(q, kc, vc, impl="plain", **kw)
                ref_fused = flash_attention_backward_fused(
                    q, kc, vc, out, lse, do, impl="plain", **kw)
                ref_two = flash_attention_backward_two_pass(
                    q, kc, vc, out, lse, do, impl="plain", **kw)
                torch.cuda.synchronize()
                ok = launched == dict.fromkeys(names, 1)
                errs = {}
                for form, outs, got, want in (
                        (names[0], ("out", "lse"), (out, lse), ref[:2]),
                        (names[1], ("dq", "dk", "dv"), fused, ref_fused),
                        (names[2], ("dk", "dv"), two[1:], ref_two[1:]),
                        (names[3], ("dq",), two[:1], ref_two[:1])):
                    for o, a, b in zip(outs, got, want):
                        err, _, _, agree = compare(a, b, tols[o])
                        errs[f"{form}:{o}"] = err
                        worst[form] = max(worst[form], err)
                        ok &= agree
                log({"phase": "kvq_vs_plain", "case": name, "mode": mode,
                     "dtype": str(dtype).split(".")[1],
                     "shape": f"B{B} H{H} Hkv{Hkv} L{L} d{d} causal"
                              + (f" window {window}" if window else "")
                              + (" segments" if seg_on else "")
                              + (f" dropout {rate}" if rate else ""),
                     "max_abs_err": errs, "launches": launched, "ok": ok})
                if not ok:
                    failed.append(f"{name} {mode} {dtype}")
                del q, kc, vc, do, kw, out, lse, fused, two, ref, ref_fused
                del ref_two
        torch.cuda.empty_cache()
    check(not failed, f"a quantized flash form disagrees with its plain "
                      f"version or launched another form: {failed}")
    return worst


def dequantized(codes, scales, mode, dtype=torch.float64):
    """K or V as the codes and scales give them, in ``dtype``."""
    return dequantize_kv(codes, scales, mode).to(dtype)


def kvq_vs_fp64(gen, d=64) -> dict:
    """The six-product quantized forms (fp32 q, int8 codes, token and
    channel) at ``FP64_SHAPES`` against a float64 attention on the
    dequantized K and V, beside the plain fp32 version on the same codes:
    out, lse and the gradients (dK and dV those of the dequantized K and
    V), each within ATTN_TOL's fp32 limits of float64.  Returns the
    kernels' largest error by (granularity, L) and output."""
    names = ("out", "lse", "dq", "dk", "dv")
    worst = {}
    for B, H, L in FP64_SHAPES:
        for g, mode in KVQ_MODE.items():
            q, kc, vc, do, kw = kvq_inputs(gen, B, H, H, L, d,
                                           torch.float32, mode)
            ref = attention_fp64(q, dequantized(kc, kw["k_scale"], mode),
                                 dequantized(vc, kw["v_scale"], mode), do)
            forms = QUANTIZED[(g, torch.float32, False, False)]
            kernels = (forms[0],) + (forms[2:] if two_pass(L, L, d, 4, True)
                                     else forms[1:2])
            errs, ok = {}, True
            for impl in ("kernel", "plain"):
                before = dict(common.launch_counts)
                out, lse, _ = flash_attention_forward(q, kc, vc, impl=impl,
                                                      **kw)
                grads = flash_attention_backward(q, kc, vc, out, lse, do,
                                                 impl=impl, **kw)
                torch.cuda.synchronize()
                launched = {n: c - before.get(n, 0) for n, c in
                            common.launch_counts.items()
                            if c != before.get(n, 0)}
                ok &= launched == (dict.fromkeys(kernels, 1)
                                   if impl == "kernel" else {})
                errs[impl] = {}
                for n, a, b in zip(names, (out, lse, *grads), ref):
                    finite = torch.isfinite(b)
                    errs[impl][n] = float((a.double() - b)[finite].abs().max())
                    ok &= compare(a, b, ATTN_TOL[torch.float32][n])[3]
                del out, lse, grads
                torch.cuda.empty_cache()
            log({"phase": "kvq_vs_fp64", "dtype": "float32", "mode": mode,
                 "shape": f"B{B} H{H} L{L} d{d} causal",
                 "max_abs_err": errs, "kernel_over_plain": {
                     n: errs["kernel"][n] / errs["plain"][n]
                     if errs["plain"][n] else None for n in names},
                 "kernels": list(kernels), "ok": ok})
            check(ok, f"quantized fp32 attention strays from float64 "
                      f"({mode}, L{L}): {errs}")
            worst[(g, L)] = errs["kernel"]
            del q, kc, vc, do, kw, ref
            torch.cuda.empty_cache()
    return worst


def kvq_times(gen, cases=KVQ_TIMED) -> dict:
    """At each of ``cases`` for each granularity (``KVQ_MODE``'s modes), the
    quantized forward and the backward form the JAX rule takes there, each
    held against its plain version on the same codes and scales at
    ``kvq_tols`` (one launch of each form), and
    timed: the kernel, the plain version, and the library's yardstick,
    ``scaled_dot_product_attention`` on the dequantized K and V in q's
    dtype (the mask, or is_causal; dropout_p) with the dequantization's own
    time apart; beside them the forms without quantization on those
    dequantized K and V (``quantized_over_unquantized``).  The kernels are
    launched as the entries launch them (the channel forms on q and dO
    with K's and V's scales folded in; the folds are the entry's and are
    not timed).  Bounds: the flops of the visible pairs at the peak of
    each product (bf16: 989 TFLOP/s; fp32: a product with codes as one
    operand three bf16 products, FP32_X3_FLOPS, else FP32_FLOPS) and the
    bytes of q, dO, out, dQ, dK, dV in q's dtype, K and V at one byte an
    element, the scales, lse, D and the segment ids, each read or written
    once.  CUDA events, the median of 5 batches (plain: 1 at L >= 8192)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    packed = None
    failed = []
    for g, mode in KVQ_MODE.items():
        for label, dtype, B, H, L, window, seg_on, rate in cases:
            d = 64
            tols = kvq_tols(dtype, g, rate, d)
            if seg_on:
                if packed is None:
                    packed = torch.as_tensor(packed_batch()["segment_ids"],
                                             device=DEV)
                seg = packed[:B, :L].contiguous()
            else:
                seg = None
            q, kc, vc, do, kw = kvq_inputs(gen, B, H, H, L, d, dtype, mode,
                                           window, seg, rate)
            drop = fa.check_dropout(q, rate, DROP_SEED)
            kvq = fa.KvQuant(g, kw["k_scale"], kw["v_scale"])
            inside = kvq.inside()
            masked = window is not None or seg is not None
            scale = 1.0 / math.sqrt(d)
            # the kernels' inputs as the entries give them: the channel
            # forms take q and dO with the scales folded in, and D of the
            # raw dO and out
            qk = q if kvq.token else fa._channel(q, kvq.k_scale, 1)
            dok = do if kvq.token else fa._channel(do, kvq.v_scale, 1)
            out, lse, _ = fa._launch_forward(qk, kc, vc, True, scale, 0,
                                             False, window, seg, drop,
                                             inside)
            raw_out = out if kvq.token else fa._channel(out, kvq.v_scale, 1)
            kin = (*fa._delta_inputs(qk, kc, vc, lse, dok,
                                     fa._delta(raw_out, do, None), True),
                   True, scale, 0, window, seg, drop, inside)
            two = two_pass(L, L, d, q.element_size(), True, 0, window)
            names = QUANTIZED[(g, dtype, masked, drop is not None)]
            bwd_names = names[2:] if two else names[1:2]
            outs_of = dict(zip(names, (("out", "lse"), ("dq", "dk", "dv"),
                                       ("dk", "dv"), ("dq",))))
            long = L >= 8192
            iters = max(1, round(64 * 2048 ** 2 / (B * L * L)))

            def timed(fn, n=iters):
                return device_ms(fn, warmup=1, iters=n, reps=5)

            ms = {names[0]: timed(lambda: fa._launch_forward(
                qk, kc, vc, True, scale, 0, False, window, seg, drop,
                inside))}
            if two:
                ms[names[2]] = timed(lambda: fa._launch_dkv(*kin))
                ms[names[3]] = timed(lambda: fa._launch_dq(*kin))
            else:
                ms[names[1]] = timed(lambda: fa._launch_backward(*kin))
            # the forms without quantization on the dequantized K and V
            kd, vd = (dequantized(c, s, mode, dtype) for c, s in
                      ((kc, kvq.k_scale), (vc, kvq.v_scale)))
            dequant_ms = timed(lambda: (dequantized(kc, kvq.k_scale, mode,
                                                    dtype),
                                        dequantized(vc, kvq.v_scale, mode,
                                                    dtype)))
            base_out, base_lse, _ = fa._launch_forward(
                q, kd, vd, True, scale, 0, False, window, seg, drop)
            base_kin = (*fa._bwd_inputs(q, kd, vd, base_out, base_lse, do,
                                        None), True, scale, 0, window, seg,
                        drop)
            base_fwd_ms = timed(lambda: fa._launch_forward(
                q, kd, vd, True, scale, 0, False, window, seg, drop))
            if two:
                base_bwd_ms = timed(lambda: (fa._launch_dkv(*base_kin),
                                             fa._launch_dq(*base_kin)))
            else:
                base_bwd_ms = timed(lambda: fa._launch_backward(*base_kin))
            del base_out, base_lse, base_kin
            # the library's yardstick on the dequantized K and V
            if masked:
                rr = torch.arange(L, device=DEV)
                keep = rr[None, :] <= rr[:, None]
                if window is not None:
                    keep &= rr[None, :] > rr[:, None] - window
                keep = keep[None, None]
                if seg is not None:
                    keep = keep & (seg[:, None, :, None]
                                   == seg[:, None, None, :])
                lib_kw = dict(attn_mask=keep, dropout_p=rate)
            else:
                lib_kw = dict(is_causal=True, dropout_p=rate)
            leaves = [x.detach().requires_grad_() for x in (q, kd, vd)]
            lib_fwd_ms = timed(lambda: sdpa(q, kd, vd, **lib_kw))
            lib_out = sdpa(*leaves, **lib_kw)
            lib_bwd_ms = timed(lambda: torch.autograd.grad(
                lib_out, leaves, do, retain_graph=True))
            del lib_out, leaves, lib_kw, kd, vd
            torch.cuda.empty_cache()
            # the plain versions on the kernels' inputs
            pin = (qk, kc, vc, dok, lse, kin[5], True, scale, 0, window, seg,
                   drop, inside)
            plain = {names[0]: lambda: fa.flash_attention_forward_plain(
                qk, kc, vc, causal=True, window=window, segment_ids=seg,
                drop=drop, kvq=inside)}
            if two:
                plain[names[2]] = lambda: fa._dkv_plain(*pin)
                plain[names[3]] = lambda: fa._dq_plain(*pin)
            else:
                plain[names[1]] = lambda: fa.flash_attention_backward_plain(
                    qk, kc, vc, None, lse, dok, causal=True, scale=scale,
                    q_offset=0, window=window, segment_ids=seg, drop=drop,
                    kvq=inside, delta=kin[5])
            before = dict(common.launch_counts)
            got = {"out": out, "lse": lse}
            if two:
                got["dk"], got["dv"] = fa._launch_dkv(*kin)
                got["dq"] = fa._launch_dq(*kin)
            else:
                got["dq"], got["dk"], got["dv"] = fa._launch_backward(*kin)
            launched = {n: c - before.get(n, 0) for n, c in
                        common.launch_counts.items() if c != before.get(n, 0)}
            want = {}
            for n, f in plain.items():
                res = f()
                want.update(zip(outs_of[n], res if isinstance(res, tuple)
                                else (res,)))
                del res
                torch.cuda.empty_cache()
            torch.cuda.synchronize()
            errs, need = {}, {}
            ok = launched == dict.fromkeys(bwd_names, 1)
            for o, a in got.items():
                errs[o], _, need[o], agree = compare(a, want[o], tols[o])
                ok &= agree
            del got, want
            plain_ms = {n: device_ms(f, warmup=0 if long else 1, iters=1,
                                     reps=1 if long else 3)
                        for n, f in plain.items()}
            torch.cuda.empty_cache()
            item = q.element_size()
            act = B * H * L * d * item
            codes = B * H * L * d            # K or V, a byte an element
            scales = 4 * B * H * (L if kvq.token else d)
            lse_b = B * H * L * 4
            seg_b = 0 if seg is None else B * L * 4
            vis = visible_pairs(B, L, L, window, seg)
            product = 2 * H * vis * d        # one product's flops
            if dtype == torch.bfloat16:
                coded = plain_peak = BF16_FLOPS
            else:
                coded, plain_peak = FP32_X3_FLOPS, FP32_FLOPS
            work = {   # (seconds of flops at peak, bytes)
                names[0]: (2 * product / coded,
                           2 * act + 2 * codes + 2 * scales + lse_b + seg_b),
                names[1]: (3 * product / coded + 2 * product / plain_peak,
                           6 * act + 2 * codes + 2 * scales + 2 * lse_b
                           + seg_b),
                names[2]: (2 * product / coded + 2 * product / plain_peak,
                           4 * act + 2 * codes + 2 * scales + 2 * lse_b
                           + seg_b),
                names[3]: (3 * product / coded,
                           3 * act + 2 * codes + 2 * scales + 2 * lse_b
                           + seg_b)}
            flop_count = {names[0]: 2 * product, names[1]: 5 * product,
                          names[2]: 4 * product, names[3]: 3 * product}
            dname = str(dtype).split(".")[1]
            shape = (f"B{B} H{H} L{L} d{d} causal {mode}"
                     + (f" window {window}" if window else "")
                     + (" segments of mode (h)" if seg_on else "")
                     + (f" dropout {rate}" if drop else ""))
            lib_name = ("scaled_dot_product_attention on the dequantized K "
                        "and V (" + ("attn_mask=bool [.., L, L]" if masked
                                     else "is_causal=True")
                        + (f", dropout_p={rate}" if drop else "") + ")")
            for n in ms:
                op_s, nbytes = work[n]
                bound = {"operations": op_s * 1e3,
                         "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
                bound_by = max(bound, key=bound.get)
                lib = lib_fwd_ms if n == names[0] else lib_bwd_ms
                row = {"ms": ms[n], "plain_ms": plain_ms[n],
                       "shape": f"{shape} {dname}",
                       "max_abs_err": max(errs[o] for o in outs_of[n]),
                       "library_ms": lib, "dequant_ms": dequant_ms,
                       "bound_ms": bound[bound_by], "bound_by": bound_by,
                       "of_bound": bound[bound_by] / ms[n],
                       "flops": flop_count[n], "bytes": nbytes,
                       "visible_pairs_per_head": vis,
                       "tflops": flop_count[n] / (ms[n] * 1e-3) / 1e12}
                log({"phase": "kernel_time", "kernel": n, "dtype": dname,
                     "label": label, "library": lib_name + (
                         " backward, the pair's yardstick"
                         if two and n != names[0] else
                         " backward" if n != names[0] else ""),
                     **row})
                rows[(n, label)] = row
            log({"phase": "quantized_over_unquantized", "dtype": dname,
                 "shape": shape, "label": label,
                 "forward_ms": ms[names[0]],
                 "unquantized_forward_ms": base_fwd_ms,
                 "forward_over_unquantized": ms[names[0]] / base_fwd_ms,
                 "backward_ms": sum(ms[n] for n in bwd_names),
                 "unquantized_backward_ms": base_bwd_ms,
                 "backward_over_unquantized": (
                     sum(ms[n] for n in bwd_names) / base_bwd_ms),
                 "dequant_ms": dequant_ms,
                 "backward_form": "two-pass" if two else "fused",
                 "card": torch.cuda.get_device_name(0)})
            log({"phase": "kvq_timed_vs_plain", "case": label, "mode": mode,
                 "dtype": dname, "shape": shape, "max_abs_err": errs,
                 "arms_needed": need,
                 "tol": {o: "atol {} + {} * rms + rtol {}".format(*tols[o])
                         for o in errs},
                 "launches": launched, "ok": ok})
            if not ok:
                failed.append(f"{label} {mode} {dname}")
            del q, kc, vc, do, kw, kin, pin, out, lse, raw_out, qk, dok, plain
            torch.cuda.empty_cache()
    check(not failed, f"at a timed shape a quantized flash form disagrees "
                      f"with its plain version or did not launch once: "
                      f"{failed}")
    return rows


def dropped_two_pass_tile(q, k, v, out, lse, do, dq, dk, dv):
    """The two-pass gradients at L = 2048 causal as a faulty kernel would
    give them: the pairs of rows 1920-2047 with keys 1024-1087 left out of
    dQ of those rows and of dK and dV of those keys."""
    delta = fa._delta(out, do, None)
    rows = slice(1920, 2048)
    keep = torch.ones(k.shape[2], dtype=torch.bool, device=k.device)
    keep[1024:1088] = False
    part = (q[:, :, rows], do[:, :, rows], lse[:, :, rows],
            delta[:, :, rows])
    scale = 1.0 / math.sqrt(q.shape[-1])
    bad_dq = dq.clone()
    bad_dq[:, :, rows] = fa._dq_plain(part[0], k[:, :, keep], v[:, :, keep],
                                      part[1], part[2], part[3], True, scale,
                                      1920 - 64)
    ddk, ddv = fa._dkv_plain(part[0], k[:, :, 1024:1088], v[:, :, 1024:1088],
                             part[1], part[2], part[3], True, scale,
                             1920 - 1024)
    bad_dk, bad_dv = dk.clone(), dv.clone()
    bad_dk[:, :, 1024:1088] = (dk[:, :, 1024:1088].float() - ddk.float()
                               ).to(dk.dtype)
    bad_dv[:, :, 1024:1088] = (dv[:, :, 1024:1088].float() - ddv.float()
                               ).to(dv.dtype)
    return bad_dq, bad_dk, bad_dv


def two_pass_cases(gen) -> dict:
    """The dK/dV and dQ kernels against their plain halves on the same
    inputs (fp32 and bf16, ``TWO_PASS_CASES``), each call checked to launch
    its dtype's form, a second call checked to give the same bits, and at
    B2 H8 L2048 causal a check that each limit fails gradients with one
    (128 rows x 64 keys) tile of pairs dropped; returns the largest error
    of each kernel of each form."""
    worst = dict.fromkeys(TWO_PASS + TWO_PASS_TC, 0.0)
    failed = []
    for dtype in (torch.float32, torch.bfloat16):
        tols = ATTN_TOL[dtype]
        dname = str(dtype).split(".")[1]
        dkv_name, dq_name = names = tuple(
            fa._form_name(n, dtype) for n in TWO_PASS_KERNELS)
        for name, B, H, Hkv, Lq, Lk, d, causal in TWO_PASS_CASES:
            args = attention_inputs(gen, B, H, Hkv, Lq, Lk, d, dtype, causal)
            before = {n: common.launch_counts[n]
                      for n in TWO_PASS + TWO_PASS_TC}
            got = flash_attention_backward_two_pass(*args, causal=causal,
                                                    impl="kernel")
            again = flash_attention_backward_two_pass(*args, causal=causal,
                                                      impl="kernel")
            launched = {n: common.launch_counts[n] - before[n]
                        for n in TWO_PASS + TWO_PASS_TC}
            dk_ref, dv_ref = flash_attention_backward_dkv_plain(
                *args, causal=causal)
            dq_ref = flash_attention_backward_dq_plain(*args, causal=causal)
            torch.cuda.synchronize()
            errs, need = {}, {}
            ok = launched == {n: 2 * (n in names) for n in launched}
            for n, a, b in zip(("dq", "dk", "dv"), got,
                               (dq_ref, dk_ref, dv_ref)):
                errs[n], _, need[n], agree = compare(a, b, tols[n])
                ok &= agree and a.dtype == b.dtype == dtype
            same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
            ok &= same_bits
            if causal and Lq > Lk:      # rows that see no key: dq exactly 0
                ok &= int(torch.count_nonzero(got[0][:, :, :Lq - Lk])) == 0
            log({"phase": "two_pass_vs_plain", "case": name, "dtype": dname,
                 "shape": f"B{B} H{H} Hkv{Hkv} Lq{Lq} Lk{Lk} d{d}",
                 "causal": causal, "max_abs_err": errs, "arms_needed": need,
                 "tol": {n: "atol {} + {} * rms + rtol {}".format(*tols[n])
                         for n in errs},
                 "two_calls_same_bits": same_bits, "launches": launched,
                 "ok": ok})
            if not ok:
                failed.append(f"{name} {dname}")
            worst[dkv_name] = max(worst[dkv_name], errs["dk"], errs["dv"])
            worst[dq_name] = max(worst[dq_name], errs["dq"])
            if causal and Lq == Lk == 2048:
                bad = dropped_two_pass_tile(*args, dq_ref, dk_ref, dv_ref)
                caught = {n: not compare(x, ref, tols[n])[3] for n, x, ref in
                          zip(("dq", "dk", "dv"), bad,
                              (dq_ref, dk_ref, dv_ref))}
                log({"phase": "two_pass_limit_power", "case": name,
                     "dtype": dname,
                     "fault": "pairs of rows 1920-2047 and keys 1024-1087 "
                              "left out", "caught": caught})
                if not all(caught.values()):
                    failed.append(f"{name} {dname}: a limit passes a "
                                  f"dropped tile")
            del args, got, again, dq_ref, dk_ref, dv_ref
    check(not failed, f"the two-pass kernels disagree with their plain "
                      f"halves: {failed}")
    return worst


def two_pass_long() -> dict:
    """At mode (f)'s attention shape, B1 H8 L16384 d64 causal bf16: the
    forward kernel against its plain version, the dK/dV and dQ kernels
    against their plain halves (each of those builds two [1, 8, 16384,
    16384] fp32 tensors, ~22 GB at most), all at ATTN_TOL's bf16 limits;
    the fused kernel as a second witness for the two passes; two calls of
    each backward form giving the same bits; each call checked to launch
    its tensor-core form.  The inputs come from a seed of
    their own, not from the phases before.  Returns the largest error of
    each output against its plain version (``vs_plain``) and against the
    fused kernel (``vs_fused``)."""
    dtype, tols = torch.bfloat16, ATTN_TOL[torch.bfloat16]
    before = dict(common.launch_counts)
    q, k, v, out, lse, do = args = attention_inputs(
        torch.Generator(DEV).manual_seed(0), LONG_B, 8, 8, LONG_L, LONG_L,
        64, dtype, True)
    plain = dict(zip(("out", "lse"), flash_attention_forward(
        q, k, v, causal=True, impl="plain")[:2]))
    torch.cuda.empty_cache()
    two = flash_attention_backward_two_pass(*args, causal=True,
                                            impl="kernel")
    again = flash_attention_backward_two_pass(*args, causal=True,
                                              impl="kernel")
    fused = flash_attention_backward_fused(*args, causal=True, impl="kernel")
    fused_again = flash_attention_backward_fused(*args, causal=True,
                                                 impl="kernel")
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    plain["dk"], plain["dv"] = flash_attention_backward_dkv_plain(
        *args, causal=True)
    torch.cuda.empty_cache()
    plain["dq"] = flash_attention_backward_dq_plain(*args, causal=True)
    torch.cuda.synchronize()
    got = {"out": out, "lse": lse, **dict(zip(("dq", "dk", "dv"), two))}
    errs = {"vs_plain": {}, "vs_fused": {}}
    need, ok = {"vs_plain": {}, "vs_fused": {}}, True
    for n, a in got.items():
        errs["vs_plain"][n], _, need["vs_plain"][n], agree = compare(
            a, plain[n], tols[n])
        ok &= agree
    for n, a, b in zip(("dq", "dk", "dv"), two, fused):
        errs["vs_fused"][n], _, need["vs_fused"][n], agree = compare(
            a, b, tols[n])
        ok &= agree
    same_bits = all(torch.equal(a, b) for a, b in zip(two, again))
    fused_same = all(torch.equal(a, b) for a, b in zip(fused, fused_again))
    row = {"phase": "long_attention_vs_plain", "dtype": "bfloat16",
           "shape": f"B{LONG_B} H8 L{LONG_L} d64 causal",
           "max_abs_err": errs, "arms_needed": need,
           "tol": {n: "atol {} + {} * rms + rtol {}".format(*tols[n])
                   for n in got},
           "two_calls_same_bits": same_bits,
           "fused_two_calls_same_bits": fused_same, "launches": launched,
           "ok": bool(ok and same_bits and fused_same and launched == {
               ATTENTION_TC[0]: 1, ATTENTION_TC[1]: 2,
               **dict.fromkeys(TWO_PASS_TC, 2)})}
    log(row)
    check(row["ok"], "at L = 16384 the forward or two-pass kernels disagree "
                     "with their plain versions or the fused kernel, two "
                     "calls of either backward differ, or a call did not "
                     "launch its tensor-core form")
    del args, q, k, v, out, lse, do, two, again, fused, fused_again, plain
    del got
    torch.cuda.empty_cache()
    return errs


def two_pass_times(gen) -> dict:
    """At ``TWO_PASS_TIMED`` (causal, d 64): the dK/dV and dQ kernels each
    in their dtype's form, the pair against the fused kernel, the plain
    halves where the card's free memory holds them (each kernel also held
    against its half there, under ``ATTN_TOL``), and the backward of
    ``scaled_dot_product_attention`` (one time for the pair), with each
    pass's bound.  CUDA events, the median of 5 batches."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for dtype, B, H, L in TWO_PASS_TIMED:
        d = 64
        args = attention_inputs(gen, B, H, H, L, L, d, dtype, True)
        q, k, v, out, lse, do = args
        scale = 1.0 / math.sqrt(d)
        kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True, scale, 0)
        pin = (q, k, v, do, lse, kin[5], True, scale, 0)
        iters = max(1, round(64 * 2048 ** 2 / (B * L * L)))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        lib_out = sdpa(*leaves, is_causal=True)

        def timed(fn, n=iters):
            return device_ms(fn, warmup=1, iters=n, reps=5)

        dkv_name, dq_name = (fa._form_name(n, dtype)
                             for n in TWO_PASS_KERNELS)
        ms = {dkv_name: timed(lambda: fa._launch_dkv(*kin)),
              dq_name: timed(lambda: fa._launch_dq(*kin))}
        pair_ms = timed(lambda: flash_attention_backward_two_pass(
            *args, causal=True, impl="kernel"))
        fused_ms = timed(lambda: flash_attention_backward_fused(
            *args, causal=True, impl="kernel"))
        library_ms = timed(lambda: torch.autograd.grad(
            lib_out, leaves, do, retain_graph=True))
        del lib_out, leaves
        torch.cuda.empty_cache()
        # the plain halves hold two fp32 [B, H, L, L] tensors and a half
        plain_bytes = 2.5 * B * H * L * L * 4 + 2 ** 30
        fits = torch.cuda.mem_get_info()[0] > 1.2 * plain_bytes
        plain = {dkv_name: fa._dkv_plain, dq_name: fa._dq_plain}
        plain_ms = {n: (device_ms(lambda: f(*pin), warmup=1, iters=1, reps=5)
                        if fits else None) for n, f in plain.items()}
        # each kernel against its plain half on these inputs, where they fit
        err = dict.fromkeys(plain)
        if fits:
            got = {dkv_name: fa._launch_dkv(*kin),
                   dq_name: (fa._launch_dq(*kin),)}
            want = {dkv_name: fa._dkv_plain(*pin),
                    dq_name: (fa._dq_plain(*pin),)}
            for n, outs in zip(plain, (("dk", "dv"), ("dq",))):
                res = [compare(a, b, ATTN_TOL[dtype][o])
                       for a, b, o in zip(got[n], want[n], outs)]
                err[n] = max(r[0] for r in res)
                check(all(r[3] for r in res),
                      f"{n} disagrees with its plain half at B{B} H{H} "
                      f"L{L}: {[r[0] for r in res]}")
            del got, want
        torch.cuda.empty_cache()
        item = q.element_size()
        act = B * H * L * d * item
        product = 2 * B * H * causal_visible(L, L) * d   # one causal product
        peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
        work = {   # (flops, bytes: inputs read once, outputs written once)
            dkv_name: (4 * product, 6 * act + 2 * B * H * L * 4),
            dq_name: (3 * product, 5 * act + 2 * B * H * L * 4)}
        dname = str(dtype).split(".")[1]
        shape = f"B{B} H{H} L{L} d{d} causal"
        for n, (flops, nbytes) in work.items():
            bound = {"operations": flops / peak * 1e3,
                     "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
            bound_by = max(bound, key=bound.get)
            row = {"ms": ms[n], "plain_ms": plain_ms[n], "max_abs_err": err[n],
                   "library_ms": library_ms, "bound_ms": bound[bound_by],
                   "bound_by": bound_by, "of_bound": bound[bound_by] / ms[n],
                   "flops": flops, "bytes": nbytes,
                   "tflops": flops / (ms[n] * 1e-3) / 1e12}
            log({"phase": "kernel_time", "kernel": n, "dtype": dname,
                 "shape": shape,
                 "library": "scaled_dot_product_attention(is_causal=True) "
                            "backward, the pair's yardstick", **row})
            rows[(n, dtype, L)] = row
        pair_bound = (7 * product) / peak * 1e3
        log({"phase": "backward_forms", "dtype": dname, "shape": shape,
             "two_pass_ms": pair_ms, "fused_ms": fused_ms,
             "two_pass_over_fused": pair_ms / fused_ms,
             "jax_rule_picks": "two-pass" if two_pass(
                 L, L, d, item, True) else "fused",
             "faster_on_this_card": "two-pass" if pair_ms < fused_ms
             else "fused",
             "library_ms": library_ms, "two_pass_bound_ms": pair_bound,
             "fused_bound_ms": 5 * product / peak * 1e3,
             "card": torch.cuda.get_device_name(0)})
        del args, kin, pin, q, k, v, out, lse, do
        torch.cuda.empty_cache()
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
            again = layernorm_backward(dy, x, g, mean, var,
                                       impl=impl or "kernel")
            ref_grads = layernorm_backward(dy, x, g, mean, var,
                                           impl="plain")
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(grads, again))
            judge("layernorm_fwd", name,
                  list(zip(("y", "mean", "var"), got, ref)))
            judge("layernorm_bwd", name,
                  list(zip(("dx", "dgamma", "dbeta"), grads, ref_grads)),
                  same)
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
            if causal and Lq > Lk:      # rows that see no key: uniform over
                width = Lk + pad_cols(Lk)   # the TPU's padded width
                uniform = torch.tensor(1 / width).to(dtype)
                empty_ok = bool((p[:, :, :Lq - Lk] == uniform).all())
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
    """Fused kernels' times at the reference MT shapes (LayerNorm forward R
    = 8192, H = 256; softmax [32, 8, 256, 256] causal), fp32 and bf16:
    kernel, plain and library, with the bound (the LayerNorm backward's in
    ``ln_times``).  Inputs rotate through enough copies that each
    call reads past the 50 MB L2."""
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
        ns = copies["attn_softmax_fwd"]
        ss = [torch.randn(*shape, generator=gen, device=DEV).to(dtype)
              for _ in range(ns)]
        ps = [attn_softmax_forward(s, mask_future=True) for s in ss]
        dps = [torch.randn(*shape, generator=gen, device=DEV).to(dtype)
               for _ in range(ns)]
        cmask = causal_mask(REF_L, REF_L, dtype, DEV)
        tick = [0]

        def nxt(n):
            tick[0] = (tick[0] + 1) % n
            return tick[0]

        def ln_fwd(impl):
            return layernorm_forward(xs[nxt(nl)], g, b, impl=impl)

        def ln_fwd_lib():
            return F.layer_norm(xs[nxt(nl)], (H,), g, b, eps=1e-8)

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
                 "attn_softmax_fwd": (sm_fwd, sm_fwd_lib),
                 "attn_softmax_bwd": (sm_bwd, sm_bwd_lib)}
        library = {
            "layernorm_fwd": "F.layer_norm(eps=1e-8)",
            "attn_softmax_fwd": "torch.softmax(x + causal mask, -1)",
            "attn_softmax_bwd": "torch._softmax_backward_data"}
        for name, (fn, lib) in calls.items():
            ms = device_ms(lambda: fn("kernel"), iters=20)
            plain_ms = device_ms(lambda: fn("plain"), iters=5)
            library_ms = device_ms(lib, iters=20)
            nbytes, flops = work[name]
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": flops / CUDA_CORE_FLOPS * 1e3}
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
        del xs, ss, ps, dps
    return rows


def ln_times(gen, H, kernel="layernorm_bwd") -> dict:
    """The LayerNorm backward's times (the whole call: dx, dgamma, dbeta),
    or with ``kernel="layernorm_fwd"`` the forward's (y, mean, var), at R =
    8192 rows of H, the rows of both training configs (H 256 the reference
    MT width, 512 the production one, mode (e)'s), fp32 and bf16: kernel,
    plain and library, with the bound.  Inputs rotate past the L2."""
    F = torch.nn.functional
    R = REF_B * REF_L
    fwd = kernel == "layernorm_fwd"
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        it = torch.tensor([], dtype=dtype).element_size()
        # bytes each function must move and its fp32 operations: the
        # forward reads x, gamma, beta and writes y, mean, var; the backward
        # reads dy, x, gamma, mean, var and writes dx, dgamma, dbeta
        nbytes, flops = ((2 * R * H * it + 2 * H * it + 2 * R * 4, 7 * R * H)
                         if fwd else
                         (3 * R * H * it + 3 * H * it + 2 * R * 4, 17 * R * H))
        n = max(2, math.ceil(2 * L2_BYTES / nbytes))
        g = (1 + 0.1 * torch.randn(H, generator=gen, device=DEV)).to(dtype)
        b = (0.1 * torch.randn(H, generator=gen, device=DEV)).to(dtype)
        xs, dys = ([torch.randn(R, H, generator=gen, device=DEV).to(dtype)
                    for _ in range(n)] for _ in range(2))
        stats = [layernorm_forward(x, g, b)[1:] for x in xs]
        leaves = [[t.detach().requires_grad_() for t in (x, g, b)]
                  for x in xs]
        lib_ys = [F.layer_norm(x, (H,), gl, bl, eps=1e-8)
                  for x, gl, bl in leaves]
        tick = [0]

        def nxt():
            tick[0] = (tick[0] + 1) % n
            return tick[0]

        def ln_call(impl):
            i = nxt()
            if fwd:
                return layernorm_forward(xs[i], g, b, impl=impl)
            return layernorm_backward(dys[i], xs[i], g, *stats[i], impl=impl)

        def ln_lib():
            i = nxt()
            if fwd:
                return F.layer_norm(xs[i], (H,), g, b, eps=1e-8)
            return torch.autograd.grad(lib_ys[i], leaves[i], dys[i],
                                       retain_graph=True)

        ms = device_ms(lambda: ln_call("kernel"), iters=20)
        plain_ms = device_ms(lambda: ln_call("plain"), iters=5)
        library_ms = device_ms(ln_lib, iters=20)
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "operations": flops / CUDA_CORE_FLOPS * 1e3}
        bound_by = max(bound, key=bound.get)
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound[bound_by], "bound_by": bound_by,
               "of_bound": bound[bound_by] / ms, "bytes": nbytes,
               "flops": flops, "hbm_GBps": nbytes / (ms * 1e-3) / 1e9,
               "copies": n}
        log({"phase": "kernel_time", "kernel": kernel,
             "dtype": str(dtype).split(".")[1], "shape": f"R{R} H{H}",
             "library": ("F.layer_norm(eps=1e-8)" if fwd else
                         "autograd of F.layer_norm (dx, dgamma, dbeta)"),
             **row})
        rows[dtype] = row
        del xs, dys, stats, leaves, lib_ys
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


def quantized(w, bits, group=None):
    """``w`` [K, N] quantized: the kernel's weight arguments."""
    if bits == 8:
        return quant.quantize_weight(w)
    packed, scales, _ = quant.quantize_weight_int4(
        w, group_size=group, allow_small_groups=True)
    return packed, scales


def quant_matmul(kind, x, q, impl):
    if kind == "int8_matmul":
        return quant.int8_matmul(x, *q, impl=impl)
    return quant.int4_matmul(x, *q, k_dim=x.shape[1], impl=impl)


def quant_form(kind, M, K, N, dtype) -> str:
    """The launch-count name a call of ``kind`` at M rows of ``dtype`` x, K
    and N columns adds to (the plan's form; every group here is a multiple
    of 16): the tensor-core forms, but at M <= 8 only where 16 divides N
    and the code rows (K, or int4's ceil(K / 2)) are within
    ``QUANT_DEC_ROWS``; the rest the CUDA-core decode form."""
    if M > 8:
        return kind + (common.TC if dtype == torch.bfloat16 else common.X3)
    rows = K if kind == "int8_matmul" else (K + 1) // 2
    if N % 16 or rows > QUANT_DEC_ROWS[dtype]:
        return kind
    return kind + (common.DEC if dtype == torch.bfloat16 else common.DEC_X3)


def trace(fn, calls: int) -> tuple[list, dict]:
    """One torch.profiler trace of ``calls`` calls of ``fn``: its device
    events as ``key_averages`` groups them, and the host's kernel-launch
    calls in it (runtime API events), by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = {e.key: e.count for e in averages
                if e.device_type == torch.autograd.DeviceType.CPU
                and "LaunchKernel" in e.key}
    return events, launches


def device_events(fn, calls: int, tries: int = TRACE_TRIES,
                  pause: float = TRACE_PAUSE_S, least: int = 1) -> list:
    """The device events of ``calls`` calls of ``fn`` under torch.profiler
    (after a call outside it), as ``key_averages`` groups them.  A trace
    that holds no device event at all saw nothing, which is not zero
    kernels: it is logged and, after ``pause`` seconds, taken again, up to
    ``tries`` traces in all; then it raises.  A trace that holds some but
    fewer than ``least`` (a caller whose every call runs a kernel passes
    ``least=calls``) is a short one: it is logged with its kernels and the
    host's launch calls and taken again, ``SHORT_TRACES_ALLOWED`` times in
    a run; the next short trace raises."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        if attempt > 1:
            time.sleep(pause)
        events, launches = trace(fn, calls)
        seen = sum(e.count for e in events)
        if seen >= least:
            return events
        if not seen:
            log({"phase": "profiler_empty_trace", "calls": calls,
                 "trace": attempt, "of": tries, "host_launches": launches})
            continue
        short_traces.append({"calls": calls, "least": least,
                             "kernels": {e.key: e.count for e in events},
                             "host_launches": launches})
        log({"phase": "profiler_short_trace", **short_traces[-1],
             "in_run": len(short_traces), "allowed": SHORT_TRACES_ALLOWED})
        if len(short_traces) > SHORT_TRACES_ALLOWED:
            raise RuntimeError(f"{len(short_traces)} profiler traces in this "
                               f"run held fewer device events than their "
                               f"calls' kernels: {short_traces}")
    raise RuntimeError(f"{tries} profiler traces of {calls} calls held no "
                       f"device event")


def kernels_run(fn, calls: int = 3) -> list[str]:
    """The CUDA kernels ``calls`` calls of ``fn`` run, by name, under the
    profiler (``device_events``); each call runs one at least, so a trace
    that holds fewer is a short one."""
    return [e.key for e in device_events(fn, calls, least=calls)
            for _ in range(e.count)]


def quant_cases(gen) -> dict:
    """The three quantized matmul kernels against their plain versions on
    the same inputs, fp32 and bf16 x, at every M of ``QUANT_M``, each call
    checked to launch the form its plan names; returns the largest error of
    each form by launch name; the tensor-core decode forms and the fp32
    tensor-core form are also called a second time and must give the same
    bits.  Every shape is logged before
    a disagreement fails the phase; the first case of each form and dtype
    also checks that its limit fails a perturbed row."""
    worst = dict.fromkeys((*QUANT, *QUANT_TC, *QUANT_DEC, *QUANT_X3,
                           *QUANT_DEC_X3), 0.0)
    failed, largest, power_checked = [], {}, set()
    for kind, cases in QUANT_CASES.items():
        bits = QUANT[kind][0]
        for K, N, group in cases:
            q = quantized(torch.randn(K, N, generator=gen, device=DEV), bits,
                          group)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                tol = QUANT_TOL[dtype]
                errs, need, forms, ok = {}, {}, {}, True
                for M in QUANT_M:
                    x = torch.randn(M, K, generator=gen, device=DEV).to(dtype)
                    form = quant_form(kind, M, K, N, dtype)
                    before = common.launch_counts[form]
                    got = quant_matmul(kind, x, q, "kernel")
                    launched = common.launch_counts[form] - before
                    same = (form not in QUANT_DEC + QUANT_X3 + QUANT_DEC_X3
                            or torch.equal(got,
                                           quant_matmul(kind, x, q, "kernel")))
                    ref = quant_matmul(kind, x, q, "plain")
                    torch.cuda.synchronize()
                    errs[M], _, need[M], agree = compare(got, ref, tol)
                    forms[M] = form
                    ok &= (agree and got.dtype == ref.dtype == dtype
                           and launched == 1 and same)
                    worst[form] = max(worst[form], errs[M])
                    if (form, dname) not in power_checked:
                        power_checked.add((form, dname))
                        caught = not compare(perturbed(ref), ref.float(),
                                             tol)[3]
                        log({"phase": "quant_limit_power", "kernel": form,
                             "dtype": dname, "shape": f"M{M} K{K} N{N}",
                             "fault": "1 % of the last row's |sum| added "
                                      "to its first value",
                             "caught": caught})
                        if not caught:
                            failed.append(f"{form} {dname}: the limit "
                                          f"passes a perturbed row")
                key = f"{kind} {dname}"
                largest[key] = max(largest.get(key, 0.0), *need.values())
                log({"phase": "quant_vs_plain", "kernel": kind,
                     "shape": f"K{K} N{N}" + (f" g{group}" if group else ""),
                     "dtype": dname, "max_abs_err_by_M": errs,
                     "arms_needed_by_M": need, "form_by_M": forms,
                     "tol": "{1} * rms + rtol {2}".format(*tol), "ok": ok})
                if not ok:
                    failed.append(f"{kind} K{K} N{N} {dname}")
            del q
    log({"phase": "quant_tolerance", "arms_needed_beside_rtol": largest})
    check(not failed, f"quantized matmul kernels disagree with their plain "
                      f"versions: {failed}")
    return worst


def quant_times(gen) -> dict:
    """The quantized matmul kernels' times at ``QUANT_TIMED``: kernel,
    plain and library (``x @ W`` against the weight dequantized once to x's
    dtype, the alternative the JAX package names at quant.py:13-15; the
    port never calls it), with the bound and the plan's form, tile, splits
    (the tensor-core decode form: its cluster), blocks and ring.  Weights
    rotate through enough copies that each call reads past the 50 MB L2, as
    each layer's own weights would.  Tensor-core decode calls, bf16 and
    fp32 x, must run one kernel each under the profiler (no reduction
    kernel, no workspace fill)."""
    rows = {}
    for kind in QUANT:
        for M, K, N, dtype in QUANT_TIMED:
            q = quantized(torch.randn(K, N, generator=gen, device=DEV),
                          *QUANT[kind][:2])
            wbytes = sum(t.numel() * t.element_size() for t in q)
            qs = past_l2(*q)
            deqs = past_l2(quant.dequantize(*q, K).to(dtype))
            item = deqs[0][0].element_size()
            x = torch.randn(M, K, generator=gen, device=DEV, dtype=dtype)
            ms = rotating_ms(lambda *w: quant_matmul(kind, x, w, "kernel"),
                             qs, iters=20)
            plain_ms = rotating_ms(lambda *w: quant_matmul(kind, x, w,
                                                           "plain"),
                                   qs, iters=5)
            library_ms = rotating_ms(lambda d: x @ d, deqs, iters=20)
            nbytes = wbytes + item * (M * K + M * N)   # codes, scales, x, out
            flops = 2 * M * K * N
            form = quant_form(kind, M, K, N, dtype)
            peak = (BF16_FLOPS if dtype == torch.bfloat16 else FP32_X3_FLOPS
                    if form in QUANT_X3 + QUANT_DEC_X3 else FP32_FLOPS)
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": flops / peak * 1e3}
            bound_by = max(bound, key=bound.get)
            group = K // q[1].shape[0] if q[1].dim() == 2 else None
            plan = quant._plan(M, N, q[0].shape[0],
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count, dtype, group)
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound[bound_by], "bound_by": bound_by,
                   "of_bound": bound[bound_by] / ms, "bytes": nbytes,
                   "flops": flops, "tflops": flops / (ms * 1e-3) / 1e12,
                   "hbm_GBps": nbytes / (ms * 1e-3) / 1e9,
                   "form": plan.form, "tile": f"{plan.bm}x{plan.bn}",
                   "blocks": plan.blocks, "splits": plan.splits,
                   "copies": len(qs)}
            dname = str(dtype).split(".")[1]
            if plan.form in ("decode_tc", "decode_tc_x3"):
                run = kernels_run(lambda: quant_matmul(kind, x, qs[0],
                                                       "kernel"))
                row["cluster"], row["kernels_in_3_calls"] = plan.splits, run
                row["ring"] = f"{plan.stages}x{plan.stage_rows} rows"
                name = ("_dec_kernel" if plan.form == "decode_tc"
                        else "_dec_x3_kernel")
                check(len(run) == 3 and all(name in k for k in run),
                      f"{kind} M{M} K{K} N{N}: 3 decode calls ran {run}")
            log({"phase": "kernel_time", "kernel": form,
                 "shape": f"M{M} K{K} N{N} {dname} x",
                 "library": f"x @ W dequantized to {dname}", **row})
            rows[(kind, (M, K, N, dtype))] = row
            del q, qs, deqs
    return rows


def quant_x3_vs_fp64(gen) -> dict:
    """The fp32 tensor-core forms of each kernel against the float64
    product of the same x and weights at each of ``QUANT_FP64_SHAPES``
    (the prefill form, ``_x3``, at 1024 rows; the decode form, ``_dec_x3``,
    at 8), beside the plain fp32 version (cuBLAS's
    fp32 GEMM with TF32 off, then the scales): the largest and the rms error
    of each; the form's largest must be at most ``X3_FP64_RATIO`` times the
    plain one's.  Returns the form's largest error by launch name."""
    worst, failed = {}, []
    for M, K, N in QUANT_FP64_SHAPES:
        x = torch.randn(M, K, generator=gen, device=DEV)
        w = torch.randn(K, N, generator=gen, device=DEV)
        for kind in QUANT:
            form = quant_form(kind, M, K, N, torch.float32)
            check(form in QUANT_X3 + QUANT_DEC_X3,
                  f"{kind} M{M} K{K} N{N}: {form} is no fp32 tensor-core "
                  f"form")
            bits, group, _ = QUANT[kind]
            q = quantized(w, bits, group)
            codes = q[0] if bits == 8 else quant.unpack_int4(q[0], K)
            exact = x.double() @ quant.dequantize(codes, q[1], K).double()
            errs = {}
            for impl in ("kernel", "plain"):
                before = common.launch_counts[form]
                d = quant_matmul(kind, x, q, impl).double() - exact
                check((common.launch_counts[form] - before
                       == (impl == "kernel")),
                      f"{kind} M{M}: the kernel call did not launch {form}")
                errs[impl] = {"max_abs": float(d.abs().max()),
                              "rms": float(d.square().mean().sqrt())}
            ratio = errs["kernel"]["max_abs"] / errs["plain"]["max_abs"]
            log({"phase": "quant_x3_vs_float64", "kernel": form,
                 "shape": f"M{M} K{K} N{N} fp32 x"
                 + (f", groups of {group}" if group else ""),
                 "kernel_err": errs["kernel"], "plain_fp32_err": errs["plain"],
                 "max_abs_over_plain": ratio, "limit": X3_FP64_RATIO})
            if not ratio <= X3_FP64_RATIO:
                failed.append(f"{form}: {ratio}")
            worst[form] = errs["kernel"]["max_abs"]
            del q, codes, exact
    check(not failed, f"fp32 tensor-core forms against float64: {failed} "
                      f"times the plain fp32 version's error")
    return worst


def gemm_kind(name: str) -> str | None:
    """The operand type of a cuBLAS / CUTLASS GEMM kernel from its name, or
    None for any other kernel.  ``"fp32"``: SIMT ``sgemm`` or ``f32f32``
    xmma; ``"bf16"``: a bf16 GEMM or cuBLAS's ``nvjet`` tensor-core kernels,
    which with TF32 off run only the bf16 products here."""
    if "nvjet" in name or ("gemm" in name and "bf16" in name):
        return "bf16"
    if "gemm" not in name:
        return None
    return "fp32" if "sgemm" in name or "f32f32" in name else "other"


def port_kernel(key: str, name: str) -> bool:
    """Whether the profiler's kernel ``key`` is the port's kernel counted as
    ``name``: a flash kernel's form ``<D, kMask, kDrop, kQuant>`` under the
    form's name, + ``fa.MASK`` where kMask is true, + ``fa.DROP`` where
    kDrop is, + ``fa.KVQ[g]`` where kQuant is g's (1 token, 2 channel; the
    quantized fused fp32 forms are ``flash_attention_bwd_kvq_x6_kernel``)."""
    quant = 0
    for i, suffix in enumerate(fa.KVQ.values(), 1):
        if name.endswith(suffix):
            name, quant = name[:-len(suffix)], i
    dropped = name.endswith(fa.DROP)
    base = name[:-len(fa.DROP)] if dropped else name
    masked = base.endswith(fa.MASK)
    base = base[:-len(fa.MASK)] if masked else base
    kernel = ("flash_attention_bwd_kvq_x6" if quant and base == ATTENTION_X6[1]
              else base)
    if f"{kernel}_kernel" not in key:
        return False
    if base not in ATTENTION_TC + ATTENTION_X6 + TWO_PASS + TWO_PASS_TC:
        return True
    flags = re.search(r"_kernel<\d+, (true|false), (true|false), (\d+)>",
                      key)
    return bool(flags) and flags.groups() == (
        str(masked).lower(), str(dropped).lower(), str(quant))


def kernel_profile(fn, steps: int = 4) -> dict:
    """Kernels of ``fn()`` under torch.profiler, per call: launches, their
    summed device time, each of the port's kernels' time, the GEMMs' time
    by operand type, and the eight largest."""
    kernels = device_events(fn, steps)
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ours = {n: sum(e.self_device_time_total for e in kernels
                   if port_kernel(e.key, n)) / steps / 1e3
            for n in KERNELS + ("quant_matmul_reduce",)}
    gemms = collections.defaultdict(float)
    for e in kernels:
        kind = gemm_kind(e.key)
        if kind:
            gemms[kind] += e.self_device_time_total / steps / 1e3
    return {"kernels_per_step": sum(e.count for e in kernels) / steps,
            "kernel_ms_per_step": total_us / steps / 1e3,
            "port_kernel_ms_per_step": ours,
            "gemm_ms_per_step": dict(gemms),
            "other_kernel_ms_per_step": (total_us / steps / 1e3
                                         - sum(ours.values())
                                         - sum(gemms.values())),
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
             per_step: dict, chunked_vocab: int = 0,
             batch: dict | None = None) -> dict:
    """``train_epoch`` at the full width and depth of ``config`` on one
    repeated batch of ``shape`` (``batch``, or random ids from a seed): 3
    warm-up steps, then 11 (the first of them opens the loop's first timing
    window, which it leaves out).  ``per_step`` gives each training
    kernel's launches a step (0 where absent); returns every training
    kernel's launches in the timed run."""
    cfg = DecoderConfig(**config, p_dropout=p_dropout, dtype=dtype)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    state = opt.init(dict(model.named_parameters()))
    if batch is None:
        batch = train_batch(0, shape, cfg.n_vocab)
    gen = torch.Generator(DEV).manual_seed(1)
    step = make_train_step(model, opt, chunked_vocab=chunked_vocab)

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
    seg = batch.get("segment_ids")
    log({"phase": "training", "mode": mode,
         "config": {**config, "p_dropout": p_dropout,
                    "dtype": str(dtype).split(".")[1],
                    "batch": shape[0], "seq_len": shape[1],
                    "chunked_vocab": chunked_vocab},
         **({} if seg is None else {"segments_a_row": [
             int(np.asarray(r).max()) + 1 for r in seg]}),
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


def training_end_to_end(name: str, config: dict, shape, chunked_vocab=0,
                        launches=None, profile=False,
                        batch: dict | None = None) -> dict:
    """One Adam step of the fp32 model of ``config`` (TF32 off) through the
    kernels and one through their plain versions, from the same
    parameters and batch (``batch``, or random ids from a seed): loss,
    every gradient, every updated parameter, and the kernels launched by
    the first step only (exactly ``launches`` where given).  With
    ``profile``, then the device time of a kernel step and its kernels
    under the profiler (``kernel_profile``)."""
    cfg = DecoderConfig(**config, p_dropout=0.0, dtype=torch.float32)
    batch = place_batch(batch or train_batch(1, shape, cfg.n_vocab), DEV)
    lr = 1e-3
    runs, launched = {}, {}
    for impl in ("kernel", "plain"):
        model = DecoderLM(cfg, device=DEV)
        init_params(model, torch.Generator(DEV).manual_seed(2))
        opt = adam(lr=lr)
        state = opt.init(dict(model.named_parameters()))
        torch.cuda.synchronize()
        common.launch_counts.clear()
        _, loss = make_train_step(model, opt, chunked_vocab=chunked_vocab,
                                  impl=impl)(state, batch)
        launched[impl] = {n: c for n, c in common.launch_counts.items() if c}
        runs[impl] = (float(loss), {n: (p.detach(), p.grad)
                                    for n, p in model.named_parameters()})
    (loss_k, got), (loss_p, want) = runs["kernel"], runs["plain"]
    # Gradients: fp32 sums in another order (at the production config 4
    # layers of attention over 2048 positions, dQ over 32 key tiles; at the
    # reference config the fused kernels' row sums, rsqrtf and expf): 1e-3
    # of the tensor's largest
    # gradient, plus 1e-5 of the model's largest for tensors whose exact
    # gradient is 0 (the K projection's bias: softmax ignores a shift of a
    # row's scores) and so hold rounding noise only.  Updated parameters:
    # Adam's first step moves each weight by ~lr * sign(g), so where |g|
    # lies within the gradient tolerance of 0 a sign may flip (up to 2 lr
    # apart); elsewhere the steps agree to 1e-6.
    # With quantized K/V a code near a rounding boundary may round the
    # other way in one of the two runs (from layer 2 on, K and V carry the
    # fp32 noise of the layers below), so the gradients differ more, still
    # within their limit; Adam's first step, lr g / (|g| + eps'), eps' =
    # eps / sqrt(1 - beta2) = 3.2e-7, has the slope lr eps' / (|g| +
    # eps')^2, which magnifies that difference where |g| is a few eps' (a
    # reading of 2.3e-5 at the production config with int8 K/V).  There the
    # updated parameters are held to 1e-6 plus that slope, at the smaller
    # |g|, times each element's measured gradient difference.
    kv_quant = cfg.kv_quant != "none"
    eps_eff = 1e-8 / math.sqrt(1 - 0.999)
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
        p_tol = 1e-6
        if kv_quant:
            p_tol = 1e-6 + lr * eps_eff * (g_k - g_p).abs() / (
                torch.minimum(g_k.abs(), g_p.abs()) + eps_eff) ** 2
            p_tol = p_tol[~near0]
        if bool((~near0).any()):
            param_err = max(param_err, float(diff[~near0].max()))
        ok &= (err <= tol and bool((diff[~near0] <= p_tol).all())
               and bool((diff[near0] <= 2 * lr + 1e-6).all()))
        flips += int((diff[near0] > 1e-6).sum())
    worst = sorted(grad_errs, reverse=True)[:3]
    ok &= bool(launched["kernel"]) and not launched["plain"]
    if launches is not None:
        ok &= launched["kernel"] == launches
    row = {"phase": "training_end_to_end", "config": name,
           "chunked_vocab": chunked_vocab,
           "launches": launched, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_tol": "rtol 1e-5",
           "grad_worst": [{"param": n, "max_abs_err": e, "tol": t}
                          for _, n, e, t in worst],
           "grad_tol": "1e-3 * max|g| of the tensor + 1e-5 * max|g| of all",
           "param_max_err": param_err,
           "param_tol": ("1e-6 + Adam's slope x the gradient difference"
                         if kv_quant else 1e-6),
           "near_zero_grad_params_moved_apart": flips,
           "near_zero_tol": f"2 lr = {2 * lr}", "ok": bool(ok)}
    if profile:
        del runs, got, want
        torch.cuda.empty_cache()
        model = DecoderLM(cfg, device=DEV)
        init_params(model, torch.Generator(DEV).manual_seed(2))
        opt = adam(lr=lr)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt, chunked_vocab=chunked_vocab,
                               impl="kernel")

        def one_step():
            step(state, batch)

        row["device_ms_per_step"] = device_ms(one_step, warmup=1, iters=1,
                                              reps=3,
                                              hold_cycles=400_000_000)
        row.update(kernel_profile(one_step, steps=2))
        row["card"] = torch.cuda.get_device_name(0)
        del model, state, step
        torch.cuda.empty_cache()
    log(row)
    check(ok, f"{name}: the training step through the kernels disagrees "
              f"with the plain versions")
    return row


def dropout_step(name: str, config: dict, shape, per_step: dict,
                 chunked_vocab: int = 0, batch: dict | None = None,
                 dtype=torch.bfloat16, phase: str = "dropout_step") -> dict:
    """One bf16 mixed-precision Adam step of ``config`` (its
    ``attn_dropout`` on, feed-forward dropout 0.1, one seeded CUDA
    generator) after a warm-up step: the loss finite and each training
    kernel launched exactly ``per_step`` times in the counted step (the
    counts set to 0 just before it); its host time and peak memory beside.
    fp32 ``dtype`` takes plain Adam.  Returns the counted step's
    launches."""
    cfg = DecoderConfig(**config, p_dropout=0.1, dtype=dtype)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    opt = (mixed_precision(adam(lr=1e-3)) if dtype == torch.bfloat16
           else adam(lr=1e-3))
    state = opt.init(dict(model.named_parameters()))
    batch = place_batch(batch or train_batch(0, shape, cfg.n_vocab), DEV)
    gen = torch.Generator(DEV).manual_seed(1)
    step = make_train_step(model, opt, chunked_vocab=chunked_vocab)
    state, warm = step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.launch_counts.clear()
    t = time.perf_counter()
    state, loss = step(state, batch, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    launches = {n: c for n, c in common.launch_counts.items()
                if c and n in TRAINING_KERNELS}
    losses = [float(warm), float(loss)]
    ok = all(math.isfinite(x) for x in losses) and launches == per_step
    log({"phase": phase, "config": name,
         "attn_dropout": cfg.attn_dropout, "p_dropout": cfg.p_dropout,
         "kv_quant": cfg.kv_quant, "window": cfg.window,
         "dtype": str(dtype).split(".")[1], "batch": shape[0],
         "seq_len": shape[1],
         "n_layer": cfg.n_layer, "chunked_vocab": chunked_vocab,
         "losses": losses, "step_ms": step_ms,
         "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
         "launches": launches, "launches_expected": per_step, "ok": ok,
         "card": torch.cuda.get_device_name(0)})
    check(ok, f"{name}: a non-finite loss, or the step launched {launches}, "
              f"not {per_step}")
    del model, state, step, batch
    torch.cuda.empty_cache()
    return launches


def kvq_label(dtype, masked: bool, dropped: bool, long: bool) -> str:
    """The ``KVQ_TIMED`` label of the main-path run that launches a
    quantized form: the production shapes for the forward and the fused
    backward, the long ones (two passes) for the dK/dV and dQ passes."""
    bf16 = dtype == torch.bfloat16
    if long:
        base = (("mode (g): window 2048" if bf16 else "window 2048")
                if masked else "mode (f)" if bf16 else "L8192")
    else:
        base = (("window 256, segments of mode (h)" if dropped
                 else "segments of mode (h)") if masked
                else "mode (j)" if bf16 else "mode (a)")
    return base + (", attention dropout" if dropped else "")


def kvq_steps(packed) -> list[dict]:
    """One training step of each quantized-K/V configuration that the
    main path runs beside mode (j), each launching its quantized forms
    (``dropout_step``: a warm-up step, then the counted one): in bf16 the
    production config with fp8, int8_channel and fp8_channel K/V, with
    attention dropout, over mode (h)'s packed rows, and over them under a
    window of 256 with attention dropout, and the long config at 2 layers
    (mode (f)'s L = 16384 with int8, the two passes) alone, with attention
    dropout, under mode (g)'s window and under both; in fp32 the same that
    ``kvq_e2e`` does not hold against plain (the long ones at L = 8192).
    Returns each step's launches."""
    prod, long_b = (TRAIN_B, TRAIN_L), torch.bfloat16
    drop = {"attn_dropout": DROP_RATE}
    runs = [("prod-flash-kv-fp8", {**TRAIN, "kv_quant": "fp8"}, prod,
             long_b, "token", False, False, None)]
    for g, mode in KVQ_MODE.items():
        q = {"kv_quant": mode}
        if g == "channel":
            for m in ("int8_channel", "fp8_channel"):
                runs.append((f"prod-flash-kv-{m}", {**TRAIN, "kv_quant": m},
                             prod, long_b, g, False, False, None))
        for dt in (torch.bfloat16, torch.float32):
            name = f"{'bf16' if dt == torch.bfloat16 else 'fp32'}-{mode}"
            runs += [(f"prod-flash-attn-dropout-{name}", {**TRAIN, **q,
                                                          **drop}, prod, dt,
                      g, False, True, None)]
            if dt == torch.bfloat16 or g == "channel":
                runs += [(f"prod-packed-{name}", {**TRAIN, **q},
                          (PACK_ROWS, PACK_L), dt, g, True, False, packed),
                         (f"prod-packed-window-256-attn-dropout-{name}",
                          {**TRAIN, "window": 256, **q, **drop},
                          (PACK_ROWS, PACK_L), dt, g, True, True, packed)]
            elif dt == torch.float32:
                runs += [(f"prod-packed-{name}", {**TRAIN, **q},
                          (PACK_ROWS, PACK_L), dt, g, True, False, packed)]
            long_cfg = {**TRAIN_LONG, "n_layer": 2, **q}
            long_shape = (LONG_B, LONG_L if dt == torch.bfloat16
                          else LONG_E2E_L)
            for masked, dropped in ((False, False), (False, True),
                                    (True, False), (True, True)):
                if (dt == torch.float32 and g == "token" and not masked
                        and not dropped):
                    continue        # kvq_e2e's long step
                cfg = {**long_cfg, **(drop if dropped else {}),
                       **({"window": LONG_WINDOW} if masked else {})}
                runs.append((f"long-two-pass{'-window-2048' * masked}"
                             f"{'-attn-dropout' * dropped}-2-layers-{name}",
                             cfg, long_shape, dt, g, masked, dropped, None))
    out = []
    for name, cfg, shape, dt, g, masked, dropped, batch in runs:
        forms = QUANTIZED[(g, dt, masked, dropped)]
        n = cfg["n_layer"]
        if cfg.get("remat"):     # the forward twice a layer, two passes
            per_step = {forms[0]: 2 * n, **dict.fromkeys(forms[2:], n)}
        else:
            per_step = dict.fromkeys(forms[:2], n)
        out.append(dropout_step(name, cfg, shape, per_step,
                                chunked_vocab=LONG_CHUNKS
                                if cfg.get("remat") else 0,
                                batch=batch, dtype=dt, phase="kvq_step"))
    return out


def kvq_e2e(packed) -> list[dict]:
    """The fp32 quantized-K/V steps held against their plain versions
    (``training_end_to_end``): mode (a)'s config with int8 K/V (JAX's
    bench/exp_fp32_configs.py "int8-KV") and with int8_channel, the long
    config at 2 layers and L = 8192 with int8 (the six-product two
    passes), and mode (h)'s packed rows under a window of 256 with
    attention dropout and int8 (JAX's
    test_segment_composes_with_window_dropout_quant)."""
    prod = (TRAIN_B, TRAIN_L)
    f32 = torch.float32
    token = QUANTIZED[("token", f32, False, False)]
    return [
        training_end_to_end("prod-flash-kv-int8", {**TRAIN,
                                                   "kv_quant": "int8"}, prod,
                            launches=dict.fromkeys(token[:2], 4)),
        training_end_to_end(
            "prod-flash-kv-int8_channel",
            {**TRAIN, "kv_quant": "int8_channel"}, prod,
            launches=dict.fromkeys(QUANTIZED[("channel", f32, False,
                                              False)][:2], 4)),
        training_end_to_end(
            "long-two-pass-kv-int8", {**TRAIN_LONG, "n_layer": 2,
                                      "kv_quant": "int8"},
            (LONG_B, LONG_E2E_L), chunked_vocab=LONG_CHUNKS,
            launches={token[0]: 4, **dict.fromkeys(token[2:], 2)}),
        training_end_to_end(
            "prod-flash-window-256-packed-attn-dropout-kv-int8",
            {**TRAIN, "window": 256, "attn_dropout": DROP_RATE,
             "kv_quant": "int8"}, (PACK_ROWS, PACK_L), batch=packed,
            launches=dict.fromkeys(QUANTIZED[("token", f32, True,
                                              True)][:2], 4))]


def long_peak_memory() -> list[dict]:
    """``torch.cuda.max_memory_allocated`` over one training step (after a
    warm-up step) at the long config, bf16 mixed-precision Adam, dropout
    0.1, for each of remat on and off and chunked_vocab 8 and 0; with the
    memory held before the step (parameters, optimizer state, batch).

    The same runs check remat on the card: from one seed and one CUDA
    generator, remat on and off give the same bits in both losses, every
    gradient and parameter after the second step, and the generator's
    final state (every kernel of the step is deterministic: the backward
    takes the two passes, which use no atomics)."""
    batch = place_batch(train_batch(0, (LONG_B, LONG_L), TRAIN["n_vocab"]),
                        DEV)
    rows, after = [], {}
    for remat in (True, False):
        for chunks in (LONG_CHUNKS, 0):
            cfg = DecoderConfig(**{**TRAIN_LONG, "remat": remat},
                                p_dropout=0.1, dtype=torch.bfloat16)
            model = DecoderLM(cfg, device=DEV)
            init_params(model, torch.Generator(DEV).manual_seed(0))
            opt = mixed_precision(adam(lr=1e-3))
            state = opt.init(dict(model.named_parameters()))
            step = make_train_step(model, opt, chunked_vocab=chunks)
            gen = torch.Generator(DEV).manual_seed(1)
            state, first = step(state, batch, gen)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            state, loss = step(state, batch, gen)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            row = {"remat": remat, "chunked_vocab": chunks,
                   "peak_GiB": peak / 2**30, "held_before_GiB": before / 2**30,
                   "step_peak_over_held_GiB": (peak - before) / 2**30,
                   "loss": float(loss)}
            log({"phase": "long_peak_memory",
                 "shape": f"B{LONG_B} L{LONG_L}", **row,
                 "card": torch.cuda.get_device_name(0)})
            check(math.isfinite(row["loss"]), "long config: non-finite loss")
            rows.append(row)
            # kept on the host, out of the next runs' peak memory
            after[remat, chunks] = (
                torch.stack([first, loss]).cpu(),
                {n: (p.detach().cpu(), p.grad.cpu())
                 for n, p in model.named_parameters()},
                gen.get_state())
            del model, state, step
            torch.cuda.empty_cache()
    for chunks in (LONG_CHUNKS, 0):
        (loss_r, tensors_r, gen_r), (loss_n, tensors_n, gen_n) = (
            after[True, chunks], after[False, chunks])
        differ = [f"{n}.{part}" for n, pair in tensors_n.items()
                  for part, a, b in zip(("data", "grad"), pair, tensors_r[n])
                  if not torch.equal(a, b)]
        same = {"losses": bool(torch.equal(loss_r, loss_n)),
                "params_and_grads": not differ,
                "generator_state": bool(torch.equal(gen_r, gen_n))}
        log({"phase": "long_remat_equals_no_remat", "chunked_vocab": chunks,
             "shape": f"B{LONG_B} L{LONG_L}", "p_dropout": 0.1,
             "steps": 2, "same_bits": same, "differ": differ[:8]})
        check(all(same.values()), f"chunked_vocab {chunks}: remat on and "
                                  f"off differ: {same} {differ[:8]}")
    del after
    return rows


SERVING_MODES = (("int8", None, "run_many(8)"), ("none", None, "run()"),
                 ("int8", 256, "run_many(8)"))


def serving_prompts(n_vocab: int) -> list[list[int]]:
    """16 prompts of 16 to 1024 tokens from a seed."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1025, 16)
    return [rng.integers(1, n_vocab, n).tolist() for n in lens]


@torch.no_grad()
def serving(model, n_layer: int, modes=SERVING_MODES,
            matmul: str | None = None) -> dict[str, int]:
    """16 requests through the engine in each of ``modes`` (KV cache,
    prefill chunk, drive); returns the kernel launches counted while the
    engines ran.  ``matmul`` names a quantized model's matmul kernel: every
    forward must launch it once for each Linear, 6 a layer and lm_head, in
    the tensor-core decode form at a decode step (8 rows of bf16) and in
    the tensor-core prefill form at a prefill or prefill chunk (16 to 1024
    rows), and never in the CUDA-core forms."""
    prompts = serving_prompts(model.cfg.n_vocab)
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

    names = ("flash_decode",) + ((matmul, matmul + common.TC,
                                  matmul + common.DEC) if matmul else ())
    total = dict.fromkeys(names, 0)
    hook = model.lm_head.register_forward_hook(watch)
    try:
        for kv_quant, chunk, drive in modes:
            eng = DecodeEngine(model, n_slots=8, max_len=8192,
                               sampling=sampling, kv_quant=kv_quant,
                               prefill_chunk=chunk, device=DEV)
            for uid, p in enumerate(prompts):
                eng.submit(Request(uid, p))
            common.launch_counts.clear()
            t0 = time.perf_counter()
            done = eng.run_many(8) if drive == "run_many(8)" else eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: common.launch_counts[n] for n in names}
            steps = eng.stats["decode_steps"]
            n_tok = sum(len(c.tokens) for c in done)
            step_ms = eng.stats["decode_s"] / steps * 1e3
            # device time of one decode step (8 slots), the stream held
            # until the host has queued the whole step
            live = torch.ones(8, dtype=torch.bool, device=DEV)
            step_device_ms = device_ms(
                lambda: eng._decode_step(eng.last_tokens, live), warmup=1,
                iters=1, reps=5, hold_cycles=100_000_000)
            common.launch_counts.clear()      # one decode step on its own
            eng._decode_step(eng.last_tokens, live)
            torch.cuda.synchronize()
            step_launches = {n: common.launch_counts[n] for n in names}
            log({"phase": "serving", "weights": matmul or "bf16",
                 "kv_quant": kv_quant,
                 "prefill_chunk": chunk, "drive": drive,
                 "requests": len(done), "tokens": n_tok, "wall_s": wall,
                 "tok_s": n_tok / wall, "decode_steps": steps,
                 "decode_ms_per_step": step_ms,
                 "decode_device_ms_per_step": step_device_ms,
                 "decode_device_idle_share": 1 - step_device_ms / step_ms,
                 "admit_s": eng.stats["admit_s"],
                 "launches": launches,
                 "launches_per_decode_step": step_launches,
                 "card": torch.cuda.get_device_name(0)})
            what = f"{matmul or 'bf16'} {drive}/{kv_quant}"
            check(sorted(c.uid for c in done) == list(range(len(prompts))),
                  f"{what}: not every request completed")
            check(all(len(c.tokens) == 64 and c.finished_reason == "length"
                      for c in done), f"{what}: short completion")
            check(steps > 0 and launches["flash_decode"] == n_layer * steps
                  and step_launches["flash_decode"] == n_layer,
                  f"{what}: {launches} kernel launches for {steps} decode "
                  f"steps of {n_layer} layers")
            if matmul:
                # every forward: the decode steps (those between prefill
                # chunks included) in the tensor-core decode form, and one a
                # prefill or prefill chunk in the tensor-core prefill form
                per_forward = 6 * n_layer + 1
                prefills = (len(prompts) if chunk is None else sum(
                    common.cdiv(len(p), chunk) for p in prompts))
                tc, dec = matmul + common.TC, matmul + common.DEC
                check(step_launches[dec] == per_forward
                      and step_launches[tc] == step_launches[matmul] == 0
                      and launches[dec] == per_forward * steps
                      and launches[tc] == per_forward * prefills
                      and launches[matmul] == 0,
                      f"{what}: {dec} launched {step_launches[dec]} times "
                      f"in a decode step (not {per_forward}), "
                      f"{launches[dec]} in {steps} decode steps, {tc} "
                      f"{launches[tc]} times in {prefills} prefill forwards "
                      f"and {matmul} {launches[matmul]} times")
            check(bool(finite), f"{what}: non-finite logits")
            for n, c in launches.items():
                total[n] += c
            log({"phase": "decode_profile", "weights": matmul or "bf16",
                 "kv_quant": kv_quant, "drive": drive, **kernel_profile(
                     lambda: eng._decode_step(eng.last_tokens, live))})
            del eng, done
    finally:
        hook.remove()
    return total


@torch.no_grad()
def quantized_serving(model) -> dict[str, int]:
    """The serving model converted by ``quantize_model_linears`` in each
    mode of ``QUANT_SERVING``: the logits' relative error against the float
    model on the first prompt, held to the JAX tests' limit, then
    ``serving`` with its launch checks; returns the launches."""
    prompt = torch.tensor([serving_prompts(model.cfg.n_vocab)[0]],
                          device=DEV)
    ref = model(prompt).float()
    total = {}
    for kind, kv_quant, chunk, drive, limit in QUANT_SERVING:
        bits, group, _ = QUANT[kind]
        qmodel = quantize_model_linears(copy.deepcopy(model), bits=bits,
                                        group_size=group)
        rel = float((qmodel(prompt).float() - ref).norm() / ref.norm())
        log({"phase": "quant_logits", "weights": kind, "group_size": group,
             "prompt_tokens": prompt.shape[1], "rel_err_vs_bf16": rel,
             "jax_test_limit": limit})
        check(rel < limit, f"{kind}: logits {rel} from the float model's")
        for n, c in serving(qmodel, model.cfg.n_layer, ((kv_quant, chunk,
                                                         drive),),
                            matmul=kind).items():
            total[n] = total.get(n, 0) + c
        del qmodel
        torch.cuda.empty_cache()
    return total


def end_to_end(kind: str | None = None) -> dict[str, int]:
    """Serving end to end at full width, 2 layers, fp32 with TF32 off,
    with float weights or, with ``kind``, quantized for that matmul kernel
    (fp32 x: decode steps in the fp32 tensor-core decode form, prefills in
    the fp32 tensor-core form):
    engine tokens against generate's and the
    uncached forward's, and one decode step's logits with the kernels
    against the plain path.  Returns the launches of the ``generate`` and
    engine runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DecoderConfig(**{**SERVING, "n_layer": 2, "dtype": torch.float32,
                           "attention_kind": "naive"})
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(1))
    if kind is not None:
        quantize_model_linears(model, bits=QUANT[kind][0],
                               group_size=QUANT[kind][1])
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 200, 8)
    n_new, max_len = 16, 1024
    ids = np.zeros((8, int(lens.max())), np.int64)
    prompts = []
    for i, n in enumerate(lens):
        prompts.append(rng.integers(1, cfg.n_vocab, n).tolist())
        ids[i, :n] = prompts[-1]
    sampling = SamplingConfig(max_new_tokens=n_new)
    # the quantized calls by kernel and by whether x has more than 8 rows
    calls = collections.Counter()
    launch = quant._launch

    def counted(name, symbol, count_as, x, *args, **kwargs):
        calls[count_as, x.shape[0] > 8] += 1
        return launch(name, symbol, count_as, x, *args, **kwargs)

    common.launch_counts.clear()
    quant._launch = counted
    try:
        ref, _ = generate(model, ids, lens, sampling, max_len=max_len,
                          device=DEV)
        ref = ref.cpu().numpy()
        eng = DecodeEngine(model, n_slots=8, max_len=max_len,
                           sampling=sampling, device=DEV)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p))
        got = {c.uid: c.tokens for c in eng.run()}
    finally:
        quant._launch = launch
    served = dict(common.launch_counts)
    # fp32 x at a decode step: the fp32 tensor-core decode form
    decode_form = quant_form(kind, 8, SERVING["n_embd"], SERVING["n_embd"],
                             torch.float32) if kind else None
    if kind is not None:
        # every call of more than 8 rows (the prefills) in the fp32
        # tensor-core form, every other call in the decode form
        want = {kind + common.X3: calls[kind, True],
                decode_form: calls[kind, False]}
        got_n = {n: served.get(n, 0) for n in want}
        check(got_n == want and calls[kind, True] > 0,
              f"{kind}: launches {got_n}, calls by M > 8 {dict(calls)}, "
              f"want {want}")
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
        out, launched = {}, {}
        for impl in ("kernel", "plain"):
            copies = [dataclasses.replace(
                c, k=c.k.clone(), v=c.v.clone(), lengths=c.lengths.clone())
                for c in caches]
            torch.cuda.synchronize()
            common.launch_counts.clear()
            out[impl], _ = model(tok, kv_caches=copies, positions=pos,
                                 impl=impl)
            launched[impl] = {n: c for n, c in common.launch_counts.items()
                              if c}
        err = float((out["kernel"] - out["plain"]).abs().max())
    # fp32 logits of |x| ~ 1: summation order, __expf and, quantized, the
    # matmuls' order of sums
    tol = 1e-4
    want = {"flash_decode": cfg.n_layer,
            **({decode_form: 6 * cfg.n_layer + 1} if kind else {})}
    log({"phase": "end_to_end", "weights": kind or "fp32",
         "tokens_compared": compared, "near_ties": ties,
         "logits_max_abs_err": err, "logits_tol": tol,
         "launches": launched})
    check(err <= tol, f"{kind}: kernel vs plain decode logits differ by "
                      f"{err}")
    check(launched["kernel"] == want and not launched["plain"],
          f"{kind}: decode step launches {launched}, not {want}")
    return served


def main() -> int:
    t0 = time.perf_counter()
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
    built = common.build(SOURCES, rebuild=True)   # with ptxas's report
    log({"phase": "build", **{
        n: {"seconds": r.seconds, "ptxas": ptxas_report(r.log),
            "warnings": [ln for ln in r.log.splitlines()
                         if "warning" in ln][:20]}
        for n, r in built.items()}})
    # the flash-attention kernels' tensor-core and six-product forms (each
    # of the four kernels at each head dim, unmasked and masked, without
    # and with dropout, without and with quantized K/V) and the
    # quantized matmuls'
    # tensor-core decode form must not spill (a spilled form of the two-pass
    # dQ kernel passed its tests 38 times slower)
    reports = {k: r for n in FLASH_SOURCES + KVQ_SOURCES
               for k, r in ptxas_report(built[n].log).items()}
    tc = {k: r for k, r in reports.items() if "_tc_kernel" in k}
    x6 = {k: r for k, r in reports.items() if "_x6_kernel" in k}
    quant_reports = {k: r for n in QUANT_SOURCES
                     for k, r in ptxas_report(built[n].log).items()}
    dec = {k: r for k, r in quant_reports.items() if "_dec_kernel" in k}
    dec_x3 = {k: r for k, r in quant_reports.items()
              if "_dec_x3_kernel" in k}
    x3 = {k: r for k, r in quant_reports.items()
          if "_x3_kernel" in k and k not in dec_x3}
    spills = {k: r for k, r in {**tc, **x6, **dec, **x3, **dec_x3}.items()
              if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    # the softmax forward's 32 template forms, the LayerNorm backward's 38
    # and the LayerNorm forward's 26 share a name each in the report (it
    # reads integer template arguments only), so their spills are read
    # from ptxas's warnings
    sm_spills, ln_spills, ln_fwd_spills = (
        [ln for ln in built[n].log.splitlines()
         if "warning" in ln and "spill" in ln]
        for n in ("attn_softmax_fwd", "layernorm_bwd", "layernorm_fwd"))
    # flash decode: a kernel for each head dim, cache dtype and rows a block
    fd = ptxas_report(built["flash_decode"].log)
    fd_spills = {k: r for k, r in fd.items()
                 if r.get("spill_stores", 0) or r.get("spill_loads", 0)}
    log({"phase": "tensor_core_spills",
         "kernels": len(tc) + len(x6) + len(dec) + len(x3) + len(dec_x3),
         "six_product_form": x6, "decode_form": dec,
         "fp32_prefill_form": x3, "fp32_decode_form": dec_x3,
         "spilling": spills,
         "softmax_forward_spills": sm_spills,
         "layernorm_backward": ptxas_report(built["layernorm_bwd"].log),
         "layernorm_backward_spills": ln_spills,
         "layernorm_forward": ptxas_report(built["layernorm_fwd"].log),
         "layernorm_forward_spills": ln_fwd_spills,
         "flash_decode": fd, "flash_decode_spills": fd_spills})
    check(not sm_spills, f"the softmax forward spills: {sm_spills}")
    check(not ln_spills, f"the LayerNorm backward spills: {ln_spills}")
    check(not ln_fwd_spills,
          f"the LayerNorm forward spills: {ln_fwd_spills}")
    check(len(fd) == 4 * (4 + 3 + 2 + 2) and not fd_spills,
          f"flash decode: {len(fd)} kernels reported, spilling {fd_spills}")
    # the flash kernels: each form at each head dim, unmasked and masked,
    # without and with dropout, without quantized K/V and with it per token
    # and per channel;
    # the decode forms: a kernel a mode at tiles of 32, 64 and 128 columns
    check(len(tc) == 12 * len(FLASH_KERNELS) * len(fa.HEAD_DIMS)
          and len(x6) == 12 * len(FLASH_KERNELS) * len(fa.HEAD_DIMS)
          and len(dec) == 3 * len(QUANT) and len(x3) == len(QUANT_X3)
          and len(dec_x3) == 3 * len(QUANT_DEC_X3) and not spills,
          f"the tensor-core kernels spill or are missing: {len(tc)} flash, "
          f"{len(x6)} six-product, {len(dec)} quantized decode, {len(x3)} "
          f"quantized fp32 prefill, {len(dec_x3)} quantized fp32 decode "
          f"reported, {spills}")

    gen = torch.Generator(DEV).manual_seed(0)
    worst = kernel_cases(gen)
    rows = kernel_times(gen)

    attn_worst = attention_cases(gen)
    fp64_errs = attention_vs_fp64(gen)
    attn_rows = attention_times(gen)
    fused_backward_bits(gen)
    fused_backward_bits(gen, window=256)
    fused_backward_bits(gen, rate=DROP_RATE)
    fused_backward_bits(gen, window=256, rate=DROP_RATE)
    probed_bits = mask_probe()
    masked_worst = masked_cases(gen)
    two_worst = two_pass_cases(gen)
    long_errs = two_pass_long()
    two_rows = two_pass_times(gen)
    masked_rows = masked_times(gen)
    drop_rows = masked_times(gen, DROP_TIMED, DROP_RATE)
    kvq_worst = kvq_cases(gen)
    fused_backward_bits(gen, mode="int8")
    fused_backward_bits(gen, window=256, rate=DROP_RATE, mode="fp8_channel")
    kvq_fp64 = kvq_vs_fp64(gen)
    kvq_rows = kvq_times(gen)
    fused_worst = fused_cases(gen)
    fused_rows = fused_times(gen)
    ln_rows = {H: ln_times(gen, H)
               for H in (REF["n_embd"], TRAIN["n_embd"])}
    fused_rows.update({("layernorm_bwd", dt): r
                       for dt, r in ln_rows[REF["n_embd"]].items()})
    # the forward at mode (e)'s width (H 256's rows are fused_times')
    ln_fwd_wide = ln_times(gen, TRAIN["n_embd"], "layernorm_fwd")
    fused_dispatch_times(gen)
    quant_worst = quant_cases(gen)
    x3_fp64 = quant_x3_vs_fp64(gen)
    quant_rows = quant_times(gen)

    cfg = DecoderConfig(**SERVING)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    log({"phase": "model", "params": num_parameters(model),
         "config": {k: str(v) for k, v in SERVING.items()}})
    launches = serving(model, cfg.n_layer)
    for n, c in quantized_serving(model).items():
        launches[n] = launches.get(n, 0) + c
    del model
    torch.cuda.empty_cache()
    end_to_end()
    for kind in QUANT:
        # fp32 weights' serving: decode steps in the fp32 tensor-core decode
        # form, prefills in the fp32 tensor-core form
        served = end_to_end(kind)
        for n in (kind, kind + common.X3, kind + common.DEC_X3):
            launches[n] = launches.get(n, 0) + served.get(n, 0)

    # launches a step, both configs having 4 layers: each attention kernel
    # once a layer, in its dtype's form; each LayerNorm kernel twice a layer
    # and once before lm_head
    flash, flash_tc = (dict.fromkeys(ATTENTION_X6, 4),
                       dict.fromkeys(ATTENTION_TC, 4))
    fused_sm = dict.fromkeys(("attn_softmax_fwd", "attn_softmax_bwd"), 4)
    fused_ln = dict.fromkeys(("layernorm_fwd", "layernorm_bwd"), 9)
    prod, ref = (TRAIN_B, TRAIN_L), (REF_B, REF_L)
    packed = packed_batch()
    long_window_two_pass = two_pass(LONG_L, LONG_L, 64, 2, True, 0,
                                    LONG_WINDOW)
    train_launches = [
        training("(a) prod-flash-fp32-adam", TRAIN, prod, torch.float32,
                 0.0, adam(lr=1e-3), flash),
        training("(b) prod-flash-bf16-mixed-precision-adam-dropout", TRAIN,
                 prod, torch.bfloat16, 0.1, mixed_precision(adam(lr=1e-3)),
                 flash_tc),
        training("(c) ref-fused-fused-ln-fp32-adam", REF, ref, torch.float32,
                 0.0, adam(lr=1e-3), {**fused_sm, **fused_ln}),
        training("(d) ref-fused-fused-ln-bf16-mixed-precision-adam-dropout",
                 REF, ref, torch.bfloat16, 0.1,
                 mixed_precision(adam(lr=1e-3)), {**fused_sm, **fused_ln}),
        training("(e) prod-flash-fused-ln-bf16-mixed-precision-adam-dropout",
                 {**TRAIN, "use_fused_kernel": True}, prod, torch.bfloat16,
                 0.1, mixed_precision(adam(lr=1e-3)),
                 {**flash_tc, **fused_ln}),
        # remat runs each layer's forward twice; bf16 at L = 16384 takes
        # the two-pass backward
        training("(f) long-flash-two-pass-bf16-remat-chunked", TRAIN_LONG,
                 (LONG_B, LONG_L), torch.bfloat16, 0.1,
                 mixed_precision(adam(lr=1e-3)),
                 {ATTENTION_TC[0]: 8, **dict.fromkeys(TWO_PASS_TC, 4)},
                 chunked_vocab=LONG_CHUNKS),
        # the window's band: the masked forward twice a layer (remat) and
        # the backward form the JAX rule takes under the window (two passes
        # at L = 16384 in bf16)
        training("(g) long-window-2048-flash-bf16-remat-chunked",
                 {**TRAIN_LONG, "window": LONG_WINDOW}, (LONG_B, LONG_L),
                 torch.bfloat16, 0.1, mixed_precision(adam(lr=1e-3)),
                 {MASKED_TC[0]: 8, **(dict.fromkeys(MASKED_TC[2:], 4)
                                      if long_window_two_pass
                                      else {MASKED_TC[1]: 4})},
                 chunked_vocab=LONG_CHUNKS),
        # packed rows: the masked forward and fused backward once a layer
        training("(h) prod-packed-flash-bf16-mixed-precision-adam-dropout",
                 TRAIN, (PACK_ROWS, PACK_L), torch.bfloat16, 0.1,
                 mixed_precision(adam(lr=1e-3)),
                 dict.fromkeys(MASKED_TC[:2], 4), batch=packed),
        # (b) with attention dropout: the forward's and the fused
        # backward's dropout forms once a layer
        training("(i) prod-flash-bf16-mixed-precision-adam-dropout-"
                 "attn-dropout", {**TRAIN, "attn_dropout": DROP_RATE}, prod,
                 torch.bfloat16, 0.1, mixed_precision(adam(lr=1e-3)),
                 dict.fromkeys(DROPPED_TC[:2], 4)),
        # (b) with int8 K/V (JAX's --kv-quant-train int8): the forward's
        # and the fused backward's token-scaled forms once a layer
        training("(j) prod-flash-bf16-mixed-precision-adam-dropout-"
                 "kv-quant-int8", {**TRAIN, "kv_quant": "int8"}, prod,
                 torch.bfloat16, 0.1, mixed_precision(adam(lr=1e-3)),
                 dict.fromkeys(QUANTIZED[("token", torch.bfloat16, False,
                                          False)][:2], 4)),
    ]
    # the shorter attention-dropout steps: (f) at 2 layers (the forward
    # twice a layer under remat, the two passes once), (g) at 2 layers (the
    # masked forms), (h) (the masked forward and fused backward) and the
    # reference config (d) on the fused route (P times the keep multiplier
    # outside the kernels)
    drop = {"attn_dropout": DROP_RATE}
    train_launches += [
        dropout_step("(f) long-flash-two-pass-bf16-remat-chunked, 2 layers",
                     {**TRAIN_LONG, "n_layer": 2, **drop}, (LONG_B, LONG_L),
                     {DROPPED_TC[0]: 4, **dict.fromkeys(DROPPED_TC[2:], 2)},
                     chunked_vocab=LONG_CHUNKS),
        dropout_step("(g) long-window-2048-flash-bf16-remat-chunked, "
                     "2 layers",
                     {**TRAIN_LONG, "n_layer": 2, "window": LONG_WINDOW,
                      **drop}, (LONG_B, LONG_L),
                     {MASK_DROPPED_TC[0]: 4,
                      **(dict.fromkeys(MASK_DROPPED_TC[2:], 2)
                         if long_window_two_pass
                         else {MASK_DROPPED_TC[1]: 2})},
                     chunked_vocab=LONG_CHUNKS),
        dropout_step("(h) prod-packed-flash-bf16", {**TRAIN, **drop},
                     (PACK_ROWS, PACK_L), dict.fromkeys(MASK_DROPPED_TC[:2], 4),
                     batch=packed),
        dropout_step("(d) ref-fused-fused-ln-bf16", {**REF, **drop}, ref,
                     {**fused_sm, **fused_ln}),
    ]
    train_launches += kvq_steps(packed)
    for n in TRAINING_KERNELS:
        launches[n] = sum(t.get(n, 0) for t in train_launches)
    # the masked fp32 forms: one fp32 step at the production widths over
    # mode (h)'s packed rows under a window of 256, and one at 2 layers and
    # L = 8192 under mode (g)'s window, where fp32 takes the two passes
    packed_e2e = training_end_to_end(
        "prod-flash-window-256-packed", {**TRAIN, "window": 256},
        (PACK_ROWS, PACK_L), batch=packed,
        launches=dict.fromkeys(MASKED_X6[:2], 4))
    window_e2e = training_end_to_end(
        "long-two-pass-window-2048",
        {**TRAIN_LONG, "n_layer": 2, "window": LONG_WINDOW},
        (LONG_B, LONG_E2E_L), chunked_vocab=LONG_CHUNKS,
        launches={MASKED_X6[0]: 4, **dict.fromkeys(MASKED_X6[2:], 2)})
    # the fp32 dropout forms: the same two steps and the production and
    # long configs' with attn_dropout, each against its plain version (the
    # same seeds, so the same masks)
    drop_e2e = [
        training_end_to_end(
            "prod-flash-window-256-packed-attn-dropout",
            {**TRAIN, "window": 256, **drop}, (PACK_ROWS, PACK_L),
            batch=packed, launches=dict.fromkeys(MASK_DROPPED_X6[:2], 4)),
        training_end_to_end(
            "prod-flash-attn-dropout", {**TRAIN, **drop}, prod,
            launches=dict.fromkeys(DROPPED_X6[:2], 4)),
        training_end_to_end(
            "long-two-pass-attn-dropout",
            {**TRAIN_LONG, "n_layer": 2, **drop}, (LONG_B, LONG_E2E_L),
            chunked_vocab=LONG_CHUNKS,
            launches={DROPPED_X6[0]: 4, **dict.fromkeys(DROPPED_X6[2:], 2)}),
        training_end_to_end(
            "long-two-pass-window-2048-attn-dropout",
            {**TRAIN_LONG, "n_layer": 2, "window": LONG_WINDOW, **drop},
            (LONG_B, LONG_E2E_L), chunked_vocab=LONG_CHUNKS,
            launches={MASK_DROPPED_X6[0]: 4,
                      **dict.fromkeys(MASK_DROPPED_X6[2:], 2)})]
    for row in (packed_e2e, window_e2e, *drop_e2e, *kvq_e2e(packed)):
        for n, c in row["launches"]["kernel"].items():
            launches[n] += c
    long_peak_memory()
    training_end_to_end("prod-flash", TRAIN, prod)
    training_end_to_end("ref-fused-fused-ln", REF, ref)
    # fp32 at L = 8192 takes the two passes in their six-product form: the
    # only run of the main path that launches them
    long_e2e = training_end_to_end(
        "long-two-pass", {**TRAIN_LONG, "n_layer": 2}, (LONG_B, LONG_E2E_L),
        chunked_vocab=LONG_CHUNKS,
        launches={ATTENTION_X6[0]: 4, **dict.fromkeys(TWO_PASS, 2)},
        profile=True)
    for n in TWO_PASS:
        launches[n] += long_e2e["launches"]["kernel"][n]

    main_row = next(r for r in rows if r["cache"] == "int8"
                    and r["length"] == 1024)
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [{
        "name": "flash_decode", "route": "cuda",
        "source": "tpu_flash_torch/kernels/csrc/flash_decode.cu",
        "replaces": "tpu_flash/kernels/decode.py:93",
        "launches": launches["flash_decode"], "max_abs_err": worst,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "B8 Hq16 Hkv16 Lq1 d64 S8192 int8 cache, lengths 1024",
        "other_shapes": {f"{r['cache']} cache, lengths {r['length']}":
                         {k: r[k] for k in timed}
                         for r in rows if r is not main_row}}]
    replaces = {"flash_attention_fwd": "flash_attention.py:498",
                "flash_attention_bwd": "flash_attention.py:1228"}
    long_plain, long_fused = long_errs["vs_plain"], long_errs["vs_fused"]
    for n in ATTENTION:
        # the tensor-core form (bf16) and the six-product form (fp32), each
        # at the training shape
        for dtype in (torch.bfloat16, torch.float32):
            form = fa._form_name(n, dtype)
            r = attn_rows[(form, dtype)]
            entries.append({
                "name": form, "route": "cuda",
                "source": f"tpu_flash_torch/kernels/csrc/{n}.cu",
                "replaces": f"tpu_flash/kernels/{replaces[n]}",
                "launches": launches[form],
                "max_abs_err": attn_worst[form], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "shape": "B4 H8 L2048 d64 causal "
                         + str(dtype).split(".")[1]})
            if dtype == torch.float32:
                outs = (("out", "lse") if n == fa.KERNEL_FWD
                        else ("dq", "dk", "dv"))
                entries[-1]["max_abs_err_vs_float64"] = {
                    o: fp64_errs[TRAIN_L][o] for o in outs}
    # mode (f) runs the tensor-core forward at L = 16384 too
    next(e for e in entries if e["name"] == ATTENTION_TC[0])[
        "max_abs_err_at_mode_f_shape"] = max(long_plain["out"],
                                             long_plain["lse"])
    for n, line in zip(TWO_PASS_KERNELS, ("flash_attention.py:1134",
                                          "flash_attention.py:1159")):
        outs = ("dk", "dv") if n.endswith("dkv") else ("dq",)
        # the tensor-core form (bf16) at mode (f)'s shape, its max_abs_err
        # against the plain halves there
        tc = fa._form_name(n, torch.bfloat16)
        r = two_rows[(tc, torch.bfloat16, LONG_L)]
        entries.append({
            "name": tc, "route": "cuda",
            "source": f"tpu_flash_torch/kernels/csrc/{TWO_PASS_SOURCE}.cu",
            "replaces": f"tpu_flash/kernels/{line}",
            "launches": launches[tc],
            "max_abs_err": max(long_plain[x] for x in outs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"B{LONG_B} H8 L{LONG_L} d64 causal bf16",
            "max_abs_err_over_two_pass_cases": two_worst[tc],
            "max_abs_err_vs_fused_at_this_shape": max(
                long_fused[x] for x in outs)})
        # the six-product form (fp32) at the fp32 two-pass shape, its
        # max_abs_err against the plain halves there
        x6 = fa._form_name(n, torch.float32)
        r = two_rows[(x6, torch.float32, LONG_E2E_L)]
        check(r["max_abs_err"] is not None,
              f"{x6} was not held against its plain half at L{LONG_E2E_L}")
        entries.append({
            "name": x6, "route": "cuda",
            "source": f"tpu_flash_torch/kernels/csrc/{TWO_PASS_SOURCE}.cu",
            "replaces": f"tpu_flash/kernels/{line}",
            "launches": launches[x6], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": f"B1 H8 L{LONG_E2E_L} d64 causal fp32",
            "max_abs_err_over_two_pass_cases": two_worst[x6],
            "max_abs_err_vs_float64": {
                o: fp64_errs[LONG_E2E_L][o] for o in outs}})
    # the masked forms: each at the shape its main-path run takes (modes (g)
    # and (h) in bf16, the two fp32 steps), the other timed shapes beside
    main_label = {
        MASKED_TC[0]: "mode (g): window 2048",
        MASKED_TC[1]: "segments of mode (h)",
        MASKED_TC[2]: "mode (g): window 2048",
        MASKED_TC[3]: "mode (g): window 2048",
        MASKED_X6[0]: "window 256", MASKED_X6[1]: "window 256",
        MASKED_X6[2]: "window 2048", MASKED_X6[3]: "window 2048"}
    lines = dict(zip(FLASH_KERNELS, ("flash_attention.py:498",
                                     "flash_attention.py:1228",
                                     "flash_attention.py:1134",
                                     "flash_attention.py:1159")))
    for n in MASKED:
        kernel = next(k for k in FLASH_KERNELS
                      if n.startswith(k + common.TC)
                      or n.startswith(k + common.X6))
        src = kernel if kernel in ATTENTION else TWO_PASS_SOURCE
        r = masked_rows[(n, main_label[n])]
        entries.append({
            "name": n, "route": "cuda",
            "source": f"tpu_flash_torch/kernels/csrc/{src}.cu",
            "replaces": f"tpu_flash/kernels/{lines[kernel]}",
            "launches": launches[n], "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in timed},
            "shape": f"{r['shape']}, {main_label[n]}",
            "max_abs_err_over_mask_cases": masked_worst[n],
            "other_shapes": {lb: {k: masked_rows[(m, lb)][k]
                                  for k in timed + ("max_abs_err",)}
                             for m, lb in masked_rows
                             if m == n and lb != main_label[n]}})
    # the dropout forms: each at the shape of the dropout run that launches
    # it on the main path, the other dropout shapes beside
    drop_label = {
        **dict.fromkeys(DROPPED_TC[:2] + DROPPED_X6[:2], "mode (i)"),
        **dict.fromkeys(DROPPED_TC[2:], "mode (f)"),
        **dict.fromkeys(DROPPED_X6[2:], "L8192"),
        MASK_DROPPED_TC[0]: "mode (g): window 2048",
        MASK_DROPPED_TC[1]: "segments of mode (h)",
        **dict.fromkeys(MASK_DROPPED_TC[2:], "mode (g): window 2048"),
        **dict.fromkeys(MASK_DROPPED_X6[:2],
                        "window 256, segments of mode (h)"),
        **dict.fromkeys(MASK_DROPPED_X6[2:], "window 2048")}
    for n in DROPPED:
        kernel = next(k for k in FLASH_KERNELS
                      if n.startswith(k + common.TC)
                      or n.startswith(k + common.X6))
        src = kernel if kernel in ATTENTION else TWO_PASS_SOURCE
        r = drop_rows[(n, drop_label[n])]
        entries.append({
            "name": n, "route": "cuda",
            "source": f"tpu_flash_torch/kernels/csrc/{src}.cu",
            "replaces": f"tpu_flash/kernels/{lines[kernel]}",
            "launches": launches[n], "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in timed},
            "shape": f"{r['shape']}, {drop_label[n]}",
            "mask_probe_bits_compared": probed_bits,
            "other_shapes": {lb: {k: drop_rows[(m, lb)][k]
                                  for k in timed + ("max_abs_err",)}
                             for m, lb in drop_rows
                             if m == n and lb != drop_label[n]}})
    # the quantized forms: each at the shape of the main-path run that
    # launches it, the other timed shapes beside
    for (g, dt, masked_, dropped_), names in QUANTIZED.items():
        for i, n in enumerate(names):
            label = kvq_label(dt, masked_, dropped_, long=i >= 2)
            r = kvq_rows[(n, label)]
            src = FLASH_SOURCES[min(i, 2)] + fa.KVQ[g]
            entries.append({
                "name": n, "route": "cuda",
                "source": f"tpu_flash_torch/kernels/csrc/{src}.cu",
                "replaces": f"tpu_flash/kernels/{lines[FLASH_KERNELS[i]]}",
                "launches": launches[n], "max_abs_err": r["max_abs_err"],
                **{k: r[k] for k in timed},
                "dequant_ms": r["dequant_ms"],
                "shape": f"{r['shape']}, {label}",
                "max_abs_err_over_kvq_cases": kvq_worst[n],
                "other_shapes": {lb: {k: kvq_rows[(m, lb)][k]
                                      for k in timed + ("max_abs_err",)}
                                 for m, lb in kvq_rows
                                 if m == n and lb != label}})
            if dt == torch.float32 and not masked_ and not dropped_:
                L = TRAIN_L if i < 2 else LONG_E2E_L
                if i < 2 or two_pass(L, L, 64, 4, True):
                    outs = (("out", "lse"), ("dq", "dk", "dv"), ("dk", "dv"),
                            ("dq",))[i]
                    entries[-1]["max_abs_err_vs_float64"] = {
                        o: kvq_fp64[(g, L)][o] for o in outs}
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
        # both dtypes, with the launches a step of the training modes that
        # run each (bf16: (d), and (e) for the LayerNorm)
        b = fused_rows[(n, torch.bfloat16)]
        per_step = {**fused_sm, **fused_ln}[n]
        entries[-1]["launches_a_step"] = {
            "(c) fp32": per_step, "(d) bf16": per_step,
            **({"(e) bf16": per_step} if n.startswith("layernorm") else {})}
        entries[-1]["bfloat16"] = {k: b[k] for k in timed}
        if n.startswith("layernorm"):   # and the production width, (e)'s
            wide = (ln_fwd_wide if n == "layernorm_fwd"
                    else ln_rows[TRAIN["n_embd"]])
            entries[-1]["R8192 H512"] = {
                str(dt).split(".")[1]: {k: r[k] for k in timed}
                for dt, r in wide.items()}
    # every form on the main path; the CUDA-core decode form is on none of
    # its shapes (their N are multiples of 16, their code rows within the
    # cap) and is held against plain in quant_cases only
    forms = ((common.DEC, QUANT_MAIN_SHAPE, "the tensor-core decode form"),
             (common.TC, QUANT_TC_SHAPE, "the tensor-core prefill form"),
             (common.DEC_X3, QUANT_FP32_DECODE_SHAPE,
              "the fp32 tensor-core decode form"),
             (common.X3, QUANT_X3_SHAPE, "the fp32 tensor-core prefill form"))
    for n, (_, _, line) in QUANT.items():
        for suffix, shape, what in forms:
            form = n + suffix
            r = quant_rows[(n, shape)]
            entries.append({
                "name": form, "route": "cuda",
                "source": "tpu_flash_torch/kernels/csrc/{}.cu".format(
                    "int8_matmul" if n == "int8_matmul" else "int4_matmul"),
                "replaces": f"tpu_flash/kernels/{line}",
                "launches": launches[form], "max_abs_err": quant_worst[form],
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "shape": "M{} K{} N{} {} x".format(
                    *shape[:3], str(shape[3]).split(".")[1])
                + (", groups of 128" if n == "int4_matmul_group" else "")
                + f", {what}"})
            if form in x3_fp64:
                entries[-1]["max_abs_err_vs_float64"] = x3_fp64[form]
            if suffix == common.DEC_X3:   # the other serving linears
                entries[-1]["other_shapes"] = {
                    "M{} K{} N{}".format(*t[:3]): {
                        k: quant_rows[(n, t)][k] for k in timed}
                    for t in QUANT_TIMED
                    if t[0] == 8 and t[3] == torch.float32 and t != shape}
    idle = [e["name"] for e in entries if not e["launches"] > 0]
    check(not idle, f"kernels of the kernels line the main path never "
                    f"launched: {idle}")
    log({"phase": "total", "seconds": time.perf_counter() - t0,
         "short_profiler_traces": len(short_traces)})
    log({"kernels": entries})
    print(smi.splitlines()[0], flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": name,
                                "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
