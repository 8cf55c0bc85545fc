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
  8192, for a decode step's one query row and a verification forward's 2,
  4 and 8 (each held against the plain version, in each batch row within
  a share of the row's rms, SDPA timed with the same band); 16 requests through ``DecodeEngine`` at the full width of the 176M
  serving configuration in three modes, with the kernels of one decode step
  under ``torch.profiler``; speculative decoding on that model
  (``speculative_serving``: the bench's 2-layer draft and the target as its
  own draft through ``run_speculative``, and the acceptance guard; every
  token of each drive's completions, ``run()``'s too, within a near tie
  of the plain route's argmax when the plain route decodes the same tokens
  (teacher forcing), and each drive's flash-decode launches against its
  forwards) and a shared 512-token prefix (``prefix_serving``:
  ``set_prefix`` against the same chunked engine without it, both held
  token by token the same way); the engine against ``generate`` and the
  kernel against the plain path end to end;
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

* rotary positions and the routed MoE feed-forward (``moe_rope_serving``):
  the serving widths with ``positional="rope"`` and 8 experts, top-2,
  capacity factor 1.25 (~0.64B parameters), the 16 serving prompts, 64
  greedy tokens each, 8 slots, through ``run()`` over a bf16 and an int8
  cache and ``run_speculative(None)`` with the bench's learned draft; each
  drive timed (tok/s, decode ms a step, 8 flash-decode launches a step,
  peak memory), then run again with every forward the engine issues held
  against the plain route on a copy of the same caches and slot batch
  (``HeldLockstep``: each layer's expert choices, read by forward hooks,
  may differ only at a near tie, ``MOE_TIE_GAP``; every other row's
  attention output at each layer and its logits within ``MOE_HOLD_TOL`` of
  its rms; the completions equal to the timed drive's), and two planted
  faults (the kernel route's rotary positions shifted by one, noise on
  its router inputs) shown to fail those limits; ``train_epoch`` in mode
  (m), mode (b) with rotary positions and that feed-forward on the
  objective ``ce + aux_weight * aux`` (``moe_train_step``), and one fp32
  step of it through the kernels against the plain versions (loss, router
  term, gradients, updated parameters);

* the machine-translation app: ``apps.machine_translation.main``, the CLI,
  at the JAX CLI's defaults (the reference MT configuration: vocab 10000,
  E 256, 8 heads, 4 layers, L 40, batch 129, dropout 0.1) on the
  repository's German-English corpus, BPE trained in the run, BLEU after
  every epoch over the card's flash decode: run (k) in bf16 with fp32
  masters, the C++ batch ring and an int8 cache for BLEU, two epochs with a
  checkpoint each, then resumed from it for a third; run (l) in fp32 over
  packed rows with the fused LayerNorm, one epoch; each run checked to
  launch its flash forms, flash decode and ((l)) the LayerNorm kernels,
  its losses finite and falling from epoch to epoch, the resume to start
  at epoch 2, and ``metrics.jsonl`` to hold its epoch and BLEU lines;
  greedy and beam-4 decoding of (k)'s model through the kernels against the
  plain route (a greedy row may leave the plain one at a near tie; each
  choice of the beam pass is held against the plain route's logits on the
  same beams and caches, within the same near tie), with the beam pass's
  BLEU; and
  ``skip_nonfinite(mixed_precision(adam))`` steps of that model, one with
  a NaN in one gradient leaving every parameter and optimizer tensor
  bit-equal, neither making the host wait; then

* the rest of the single-card surface: the points classifier trained on
  the card to the JAX tests' accuracy thresholds (``points``); conv/pool's
  six functions at B8 C16 H64 W64, forwards and gradients against float64
  on the CPU, over a tie-laden maxpool input too (``conv_pool``);
  ``grad_check`` in fp32 through the flash forward, the fused and the
  two-pass backward (where the JAX rule takes them), the fused LayerNorm
  and the masked softmax, each form's launches counted, the fused fp32
  backward against the FA2 backward oracle, and a flipped backward that
  ``grad_check`` must reject (``grad_check_kernels``); run (k) of the MT
  app under ``--profile``, its trace read back for the flash forms and
  split a step at a time: kernels, kernel ms, the device's idle share, the
  GEMMs and the ten largest kernels (``mt_profile``); and
  ``utils.timing.compare`` of the bf16 flash forward against its plain
  version beside ``device_ms``, with ``utils.roofline``'s fraction
  (``timing_harness``); then

* the parallel layer (``parallel_modes``): the JAX package's parallel
  modes through ``tpu_flash_torch.parallel.dryrun``, (p1)-(p8) in one
  world of 4 ranks sharing this card over gloo (NCCL refuses two ranks on
  one device; CUDA tensors staged through host memory), each held against
  the single-process port on the same parameters and inputs: (p1) dp2 x
  tp2 with 8 experts top-1, sequence parallelism and the vocab-parallel
  loss at the production widths (vocab 10000, E 512, 8 heads, 4 layers, FF
  2048, B4 L2048, the JAX dryrun's packed batch), an fp32 and a bf16 mixed
  step, and an fp32 step at the reference MT widths on the fused kernels;
  (p2) (p1) with attention dropout; (p3) ZeRO-1 with mixed precision, two
  steps against plain DP x TP; (p4) GPipe, 4 stages, 4 microbatches; (p5)
  all-gather and ring attention at B1 H8 L16384 bf16 (and under window
  2048, where the ring truncates to 1 hop) and L32768 fp32 (the two-pass
  backward) against the single-process kernels; (p6) the DCN-hybrid mesh;
  (p7) sharded decode of the 176M serving model in four engine drives over
  bf16 and int8 caches, every token within a near tie of the plain route;
  (p8) the MT app's CLI at the JAX CLI's defaults on the mesh (``--dp 2
  --tp 2 --zero1 --sequence-parallel``), every step's loss against the
  single-process run (the first four at the fp32 limit, the later ones,
  where this run's steps amplify rounding, at ``PAR_MT_DRIFT``); (p9) a
  world of one over NCCL.  The ranks' launches
  join the kernels line's.  Their seconds and memory are of 4 ranks
  sharing one card: no multi-card speed.

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
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from tpu_flash_torch import grad_check
from tpu_flash_torch.apps.machine_translation import main as mt_app_main
from tpu_flash_torch.apps.machine_translation import (evaluate_bleu,
                                                     generate_translations,
                                                     make_loss_fn,
                                                     make_train_step,
                                                     place_batch, train_epoch,
                                                     translation_tokens)
from tpu_flash_torch.apps.points_classifier import run as points_run
from tpu_flash_torch.data.mt import (WordTokenizer, collate_packed,
                                     get_dataset,
                                     synthetic_translation_dataset)
from tpu_flash_torch.inference import DecodeEngine, KVCache, SamplingConfig
from tpu_flash_torch.inference.beam import NEG_INF, _gather_cache
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
from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, MoEConfig,
                                MoEFeedForward, MultiHeadAttention, adam,
                                init_params, mixed_precision, num_parameters,
                                quantize_model_linears, skip_nonfinite)
from tpu_flash_torch.nn import functional as pf
from tpu_flash_torch.nn.optim import accumulate_gradients
from tpu_flash_torch.parallel import dryrun as pdry
from tpu_flash_torch.parallel.sequence import \
    window_steps as sequence_window_steps
from tpu_flash_torch.ops import flash_attention as flash_ops_attention
from tpu_flash_torch.ops import fused
from tpu_flash_torch.ops.attention import (dequantize_kv, kv_quant_parts,
                                           quantize_kv)
from tpu_flash_torch.ops.reference import (causal_mask,
                                           flash_attention2_bw_reference,
                                           flash_attention2_fw_reference)
from tpu_flash_torch.utils.checkpoint import _flatten_with_paths
from tpu_flash_torch.utils.metrics import read_metrics
from tpu_flash_torch.utils.roofline import attention_bytes, roofline
from tpu_flash_torch.utils.timing import (L2_BYTES, attention_flops,
                                          device_ms, past_l2, rotating_ms)
from tpu_flash_torch.utils.timing import compare as timing_compare

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
# Mode (m): the production config with rotary positions and a routed
# feed-forward of 8 experts, top-2, capacity factor 1.25 (at B4 L2048 a
# layer's dispatch and combine tensors are [8192, 8, 2560], 671 MB each in
# fp32)
TRAIN_MOE = {**TRAIN, "positional": "rope",
             "moe": MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25)}
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
    # the MT app's step (mt_app, run (k) in bf16): B129 L40 d32, one
    # ragged tile under 64 keys
    ("mt-B129-L40-d32", 129, 8, 8, 40, 40, 32, True),
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


def smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


# A BLEU pass's cache lengths: from a short prompt's first step to the
# cache's end
MT_DECODE_LENGTHS = [2, 5, 9, 12, 17, 20, 26, 31, 39, 40, 41, 48, 57, 64,
                     79, 80]


# the query rows of a speculative verification forward (n_draft tokens
# over the cache), beside a decode step's 1
VERIFY_LQ = (1, 2, 4, 8)
# A verification forward's band (query row i sees the positions up to
# L - Lq + i) moves an output by about (Lq - 1) / L of its size, which at
# long lengths lies under TOL's atol: its cases are held in each batch row
# against that row's rms, |out - ref| <= arms * rms(ref) + rtol * |ref|,
# the rtol one bf16 ulp (2^-7 of a value) for a rounding the other way
VERIFY_TOL = (2e-2, 2 ** -7)


def closest(gaps, limits) -> dict:
    """The gap that comes closest to its limit (the largest share of it;
    a gap above a limit of 0 counts as infinitely close), that limit, and
    the largest gap anywhere."""
    share = torch.where(limits > 0, gaps / limits,
                        torch.where(gaps > 0, math.inf, 0.0))
    at = int(share.argmax())
    return {"largest_gap": float(gaps.flatten()[at]),
            "limit_there": float(limits.flatten()[at]),
            "largest_gap_anywhere": float(gaps.max())}


def within_rms(out, ref, tol=VERIFY_TOL) -> tuple[bool, float]:
    """``out`` against ``ref`` [B, ...] under ``VERIFY_TOL`` in each batch
    row; returns whether it holds and the largest error over its row's
    rms."""
    arms, rtol = tol
    out, ref = out.float().flatten(1), ref.float().flatten(1)
    diff = (out - ref).abs()
    r = ref.square().mean(1, keepdim=True).sqrt()
    ok = bool(torch.isfinite(out).all()) and bool(
        (diff <= arms * r + rtol * ref.abs()).all())
    return ok, float((diff / r).max())


def kernel_cases(gen) -> float:
    """The decode kernel against its plain version, each case called twice
    for the same bits; returns the largest error.  The verification
    forwards' cases (the serving shape at Lq 2, 4 and 8, lengths from Lq
    up, where the band moves an output most) are held under
    ``VERIFY_TOL``, the others under ``TOL``."""
    serving_lengths = [0, 1, 7, 1023, 1024, 1025, 8191, 8192]
    # the serving shape's cluster: lengths below it leave blocks of the
    # cluster no position, and so do windows of 1 and 5
    sms = common.sm_count(torch.device(DEV))
    C = decode._plan(8, 16, 1, 64, torch.int8, sms).cluster
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
        # the MT app's BLEU passes (mt_app): 16 prompts a batch, 8 heads of
        # 32, caches of the longest prompt plus 40 (<= 80); a decode step
        # over run (k)'s int8 cache with a bf16 q and over run (l)'s fp32
        # cache, and a prefill of 8-token prompts (DECODE_MAX_LQ)
        ("mt-int8-bf16", 16, 8, 8, 1, 80, 32, torch.bfloat16, "int8",
         MT_DECODE_LENGTHS, None),
        ("mt-fp32", 16, 8, 8, 1, 80, 32, torch.float32, "none",
         MT_DECODE_LENGTHS, None),
        ("mt-int8-bf16-prefill-lq8", 16, 8, 8, 8, 80, 32, torch.bfloat16,
         "int8", [8] * 16, None),
        ("mt-fp32-prefill-lq8", 16, 8, 8, 8, 80, 32, torch.float32, "none",
         [8] * 16, None),
    ]
    verify = []
    for Lq in VERIFY_LQ[1:]:
        for quant, kv in (("none", torch.bfloat16), ("int8", torch.int8)):
            Cq = decode._plan(8, 16, Lq, 64, kv, sms).cluster
            short = dict.fromkeys(max(Lq, n) for n in (
                Lq, Lq + 1, 7, Cq - 1, Cq, Cq + 1, Lq + 2, 2 * Lq + 1, 31,
                100))
            verify.append((
                f"verify-lq{Lq}-{'bf16' if quant == 'none' else quant}", 8,
                16, 16, Lq, 8192, 64, torch.bfloat16, quant,
                list(short)[:6] + [1000, 8192], None))
    worst = 0.0
    for (name, B, Hq, Hkv, Lq, S, d, dtype, quant, lengths,
         window) in cases + verify:
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
        row = {}
        if name.startswith("verify-"):
            ok, row["max_err_over_rms"] = within_rms(out, ref)
            row["lengths"] = lengths
            row["tol"] = (f"arms {VERIFY_TOL[0]} of each row's rms + rtol "
                          f"{VERIFY_TOL[1]}")
        else:
            tol = TOL[dtype]
            ok = bool(torch.isfinite(out).all()) and bool(
                ((out - ref).abs() <= tol + tol * ref.abs()).all())
            row["tol"] = f"atol {tol} + rtol {tol}"
        ok = ok and same
        log({"phase": "kernel_vs_plain", "case": name, "max_abs_err": err,
             **row, "two_calls_same_bits": same, "ok": ok})
        check(ok, f"flash_decode disagrees with its plain version: {name}")
        worst = max(worst, err)
        del cache
    return worst


def kernel_times(gen) -> list[dict]:
    """Decode kernel, plain and library times at the serving shape, for a
    decode step's one query row and a verification forward's 2, 4 and 8
    (``VERIFY_LQ``; each of those held against the plain version first,
    under ``VERIFY_TOL``).
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
        for L in (8192, 1024):
            lens = torch.full((R * B,), L, dtype=torch.int32, device=DEV)

            def part(x, i):
                return None if x is None else x[i * B:(i + 1) * B]

            def dense(x, s, i):   # [B, H, L, d] dequantized view
                x = part(x, i)[:, :L].view(B, L, H, d).float()
                if s is not None:
                    x = x * part(s, i)[:, :, :L].transpose(1, 2)[..., None]
                return x.to(dtype).transpose(1, 2).contiguous()

            views = [dense(k, ks, i) for i in range(R)]
            vviews = [dense(v, vs, i) for i in range(R)]
            one_ms = None
            for Lq in VERIFY_LQ:
                q = torch.randn(B, H, Lq, d, generator=gen, device=DEV,
                                dtype=dtype)
                # query row i sees the positions up to L - Lq + i, as the
                # kernel's; SDPA takes the same band
                mask = None if Lq == 1 else (
                    torch.arange(L, device=DEV)[None, :]
                    <= L - Lq + torch.arange(Lq, device=DEV)[:, None])
                tick = [0]

                def call(impl):
                    i = tick[0] = (tick[0] + 1) % R
                    return flash_decode_attention(
                        q, part(k, i), part(v, i), part(lens, i),
                        part(ks, i), part(vs, i), impl=impl)

                def library():
                    i = tick[0] = (tick[0] + 1) % R
                    return torch.nn.functional.scaled_dot_product_attention(
                        q, views[i], vviews[i], attn_mask=mask)

                err = None
                if Lq > 1:
                    tick[0] = R - 1    # both on copy 0
                    out = call("kernel")
                    tick[0] = R - 1
                    ref = call("plain")
                    torch.cuda.synchronize()
                    err = float((out.float() - ref.float()).abs().max())
                    ok, over = within_rms(out, ref)
                    log({"phase": "kernel_vs_plain",
                         "case": f"verify-lq{Lq}-{quant}-len{L}",
                         "max_abs_err": err, "max_err_over_rms": over,
                         "tol": f"arms {VERIFY_TOL[0]} of each row's rms + "
                                f"rtol {VERIFY_TOL[1]}", "ok": ok})
                    check(ok, f"flash_decode disagrees with its plain "
                              f"version at Lq {Lq}, {quant} cache, L {L}")
                ms = device_ms(lambda: call("kernel"))
                plain_ms = device_ms(lambda: call("plain"), iters=5)
                library_ms = device_ms(library)
                itemsize = k.element_size()
                nbytes = (2 * B * H * L * d * itemsize        # K and V codes
                          + (2 * B * H * L * 4 if ks is not None else 0)
                          + 2 * B * H * Lq * d * q.element_size()  # q, out
                          + B * 4)                            # lengths
                flops = 4 * B * H * Lq * L * d
                bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                         "operations": flops / CUDA_CORE_FLOPS * 1e3}
                bound_by = max(bound, key=bound.get)
                one_ms = ms if Lq == 1 else one_ms
                row = {"cache": "bf16" if quant == "none" else quant,
                       "length": L, "lq": Lq, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bytes": nbytes,
                       "bound_ms": bound[bound_by], "bound_by": bound_by,
                       "hbm_GBps": nbytes / (ms * 1e-3) / 1e9,
                       "over_lq1": ms / one_ms, "max_abs_err": err}
                log({"phase": "kernel_time", "kernel": "flash_decode",
                     "shape": f"B{B} Hq{H} Hkv{H} Lq{Lq} d{d} S{S}", **row})
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


def moe_train_step(model, opt, chunked_vocab: int = 0, impl=None):
    """``make_train_step``'s step on the MoE objective, the user's in the
    JAX package (``tests/test_moe.py:100-102``): the MT app's loss
    (``make_loss_fn``, every batch key and ``chunked_vocab`` as there) plus
    ``moe.aux_weight`` times the router's term summed over the layers.
    Neither MT app has an MoE switch, so the objective is put together
    from the app's pieces: its loss over a call of the model that keeps
    the router's term aside, ``accumulate_gradients`` over one microbatch,
    then ``opt``'s update copied into the parameters (no host sync).
    Dropout draws from the step's ``generator``.  The step keeps its last
    router term in ``step.aux``."""
    params = dict(model.named_parameters())
    weight = model.cfg.moe.aux_weight

    def call(ids, **kw):                  # the model, its aux kept aside
        out, step.aux = model(ids, return_aux=True, **kw)
        return out

    call.lm_head = model.lm_head
    loss_fn = make_loss_fn(call, chunked_vocab=chunked_vocab)

    def objective(batch, generator):
        loss = loss_fn(batch, generator=generator, training=True, impl=impl)
        return loss + weight * step.aux

    compute = accumulate_gradients(objective, params, 1)

    def step(opt_state, batch, generator=None):
        loss, grads = compute({k: v[None] for k, v in batch.items()},
                              generator)
        with torch.no_grad():
            new, opt_state = opt.update(
                grads, opt_state, {n: p.detach() for n, p in params.items()})
            for n, p in params.items():
                p.copy_(new[n])
        step.aux = step.aux.detach()
        return opt_state, loss

    return step


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
             batch: dict | None = None, make_step=make_train_step) -> dict:
    """``train_epoch`` at the full width and depth of ``config`` on one
    repeated batch of ``shape`` (``batch``, or random ids from a seed): 3
    warm-up steps, then 11 (the first of them opens the loop's first timing
    window, which it leaves out), each step made by ``make_step`` (the MT
    app's, or ``moe_train_step``).  ``per_step`` gives each training
    kernel's launches a step (0 where absent); returns every training
    kernel's launches in the timed run."""
    cfg = DecoderConfig(**config, p_dropout=p_dropout, dtype=dtype)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    state = opt.init(dict(model.named_parameters()))
    if batch is None:
        batch = train_batch(0, shape, cfg.n_vocab)
    gen = torch.Generator(DEV).manual_seed(1)
    step = make_step(model, opt, chunked_vocab=chunked_vocab)

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
         "config": {**{k: dataclasses.asdict(v) if dataclasses.is_dataclass(v)
                       else v for k, v in config.items()},
                    "p_dropout": p_dropout,
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
         **prof, "card": torch.cuda.get_device_name(0),
         "nvidia_smi": smi_line()})
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
                        batch: dict | None = None,
                        make_step=make_train_step) -> dict:
    """One Adam step of the fp32 model of ``config`` (TF32 off) through the
    kernels and one through their plain versions, from the same
    parameters and batch (``batch``, or random ids from a seed): loss,
    every gradient, every updated parameter, and the kernels launched by
    the first step only (exactly ``launches`` where given); each step made
    by ``make_step`` (the MT app's, or ``moe_train_step``, whose router
    term is held too, at the loss's limit).  With
    ``profile``, then the device time of a kernel step and its kernels
    under the profiler (``kernel_profile``)."""
    cfg = DecoderConfig(**config, p_dropout=0.0, dtype=torch.float32)
    batch = place_batch(batch or train_batch(1, shape, cfg.n_vocab), DEV)
    lr = 1e-3
    runs, launched, aux = {}, {}, {}
    for impl in ("kernel", "plain"):
        model = DecoderLM(cfg, device=DEV)
        init_params(model, torch.Generator(DEV).manual_seed(2))
        opt = adam(lr=lr)
        state = opt.init(dict(model.named_parameters()))
        torch.cuda.synchronize()
        common.launch_counts.clear()
        step = make_step(model, opt, chunked_vocab=chunked_vocab, impl=impl)
        _, loss = step(state, batch)
        launched[impl] = {n: c for n, c in common.launch_counts.items() if c}
        if hasattr(step, "aux"):
            aux[impl] = float(step.aux)
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
    if aux:
        ok &= abs(aux["kernel"] - aux["plain"]) <= 1e-5 * abs(aux["plain"])
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
           **({"aux_kernel": aux["kernel"], "aux_plain": aux["plain"],
               "aux_tol": "rtol 1e-5"} if aux else {}),
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
        step = make_step(model, opt, chunked_vocab=chunked_vocab,
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


# The speculative draft: JAX's serving bench's (bench/bench_serving.py:
# 194-198), the serving model's family at half its width and 2 layers
SPEC_DRAFT = dict(n_vocab=32768, n_embd=512, n_head=8, n_positions=8192,
                  n_layer=2, p_dropout=0.0, attention_kind="flash",
                  dtype=torch.bfloat16)
SPEC_N_DRAFT = 4
# The least acceptance of the target as its own draft (PERF.md §6:
# predicted 0.62-0.75; 3 of a round's 4 proposals are drafts, so at most
# 0.75; a near tie between the Lq 1 and Lq 4 forwards rejects the rest of
# the round)
SPEC_SELF_ACCEPTANCE = 0.5
PREFIX_LEN, PREFIX_CHUNK = 512, 256


@torch.no_grad()
def departure(model, prompt, ref, got, kv_quant) -> dict | None:
    """None where ``got`` equals ``ref`` (token lists of one length);
    else where it first leaves it: the step, both tokens and, inside the
    position table, the gap of ``got``'s token below the top logit when
    the plain route decodes ``prompt + ref[:t]`` alone (``generate``'s
    prefill and steps), its limit (``MT_TIE_GAP``) and whether it is a
    near tie.  Past the table both routes decode NaN logits."""
    t = next((j for j, (x, y) in enumerate(zip(got, ref)) if x != y), None)
    if t is None:
        return None
    at = {"step": t, "got": got[t], "ref": ref[t]}
    if len(prompt) + t > model.cfg.n_positions:
        return {**at, "past_the_table": True, "near_tie": False}
    last, caches = prefill_prompt(
        model, torch.tensor([prompt], device=DEV),
        torch.tensor([len(prompt)], device=DEV), max_len=len(prompt) + t,
        kv_quant=kv_quant, impl="plain")
    for x in ref[:t]:
        out, caches = model(torch.tensor([[x]], device=DEV),
                            kv_caches=caches, impl="plain",
                            positions=caches[0].lengths[:, None].long())
        last = out[:, 0]
    logits = last[0].float()
    top = float(logits.max())
    atol, rtol = MT_TIE_GAP[model.cfg.dtype]
    at.update(gap=top - float(logits[got[t]]), limit=atol + rtol * abs(top))
    at["near_tie"] = at["gap"] <= at["limit"]
    return at


@torch.no_grad()
def forced_gaps(model, prompts, rows, kv_quant):
    """Teacher forcing through the plain route: ``prompts`` (token lists)
    prefilled together (``prefill_prompt``), then ``rows`` [B, n] fed a
    token a step; returns each token's gap below the top logit of its
    position and the gap's limit there (``MT_TIE_GAP``), both [B, n]."""
    B, n = rows.shape
    lengths = torch.tensor([len(p) for p in prompts], device=DEV)
    ids = torch.zeros(B, int(lengths.max()), dtype=torch.long, device=DEV)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = torch.tensor(p, device=DEV)
    last, caches = prefill_prompt(model, ids, lengths,
                                  max_len=ids.shape[1] + n,
                                  kv_quant=kv_quant, impl="plain")
    atol, rtol = MT_TIE_GAP[model.cfg.dtype]
    gaps, limits = [], []
    for j in range(n):
        logits = last.float()
        top = logits.max(-1).values
        gaps.append(top - logits.gather(1, rows[:, j:j + 1])[:, 0])
        limits.append(atol + rtol * top.abs())
        if j + 1 < n:
            out, caches = model(rows[:, j:j + 1], kv_caches=caches,
                                impl="plain",
                                positions=caches[0].lengths[:, None].long())
            last = out[:, 0]
    return torch.stack(gaps, 1), torch.stack(limits, 1)


def compare_completions(model, prompts, got, kv_quant, what: str,
                        ref=None) -> dict:
    """``got``'s completions (uid -> tokens, one for each prompt, of one
    length) held token by token: each token within ``MT_TIE_GAP`` of the
    top logit when the plain route decodes the prompt and the tokens
    before it (``forced_gaps``).  Returns the tokens held, those off the
    plain route's argmax, the gaps ``closest`` reports and, given ``ref``,
    the number of completions equal to ``ref``'s."""
    check(sorted(got) == list(range(len(prompts))),
          f"{what}: completions {sorted(got)}, not every request")
    n = len(got[0])
    check(all(len(t) == n for t in got.values()),
          f"{what}: completions of more than one length")
    rows = torch.tensor([got[u] for u in range(len(prompts))], device=DEV)
    gaps, limits = forced_gaps(model, prompts, rows, kv_quant)
    far = (gaps > limits).nonzero().tolist()
    res = {"tokens_held": gaps.numel(),
           "off_argmax": int((gaps > 0).sum()), **closest(gaps, limits)}
    if ref is not None:
        res["same_as_reference"] = sum(got[u] == ref[u] for u in ref)
    check(not far, f"{what}: tokens away from a near tie of the plain "
                   f"route's argmax (request, step): {far[:8]}")
    return res


@torch.no_grad()
def speculative_serving(model) -> int:
    """The 176M serving model with the bench's draft (``SPEC_DRAFT``):
    16 requests, 64 greedy tokens each, int8 cache, ``n_draft`` 4, driven
    by ``run()`` (the reference) and by ``run_speculative``: without the
    guard with the random draft and with the target as its own draft
    (its cache int8 too), and under the guard (8 timed rounds of each
    mode) with the random draft.  Each drive's flash-decode launches
    against the count of its forwards (the target's layers for each
    verification forward and plain step, the draft's for each of its
    steps, 4 a round, and for each plain step of the guard's probation,
    which feeds the draft too; the prefills' buckets of 16 or more rows
    take the composed attention), every drive's completions held token by token
    through the plain route (``compare_completions``) and counted equal
    to ``run()``'s, and the self-draft's acceptance at least
    ``SPEC_SELF_ACCEPTANCE``.  Returns the drives' flash-decode
    launches."""
    t_phase = time.perf_counter()
    prompts = serving_prompts(model.cfg.n_vocab)
    sampling = SamplingConfig(max_new_tokens=64)
    draft = DecoderLM(DecoderConfig(**SPEC_DRAFT), device=DEV)
    init_params(draft, torch.Generator(DEV).manual_seed(1))
    n_t = model.cfg.n_layer

    def engine(draft_model=None, draft_kv_quant="none", n_new=64):
        eng = DecodeEngine(model, n_slots=8, max_len=8192,
                           sampling=SamplingConfig(max_new_tokens=n_new),
                           kv_quant="int8", draft_model=draft_model,
                           n_draft=SPEC_N_DRAFT,
                           draft_kv_quant=draft_kv_quant, device=DEV)
        return eng

    warm = engine(draft, n_new=8)      # the draft's kernels and GEMMs
    warm.submit(Request(0, prompts[0]))
    warm.run_speculative(None)
    del warm

    def drive(eng, run):
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p))
        torch.cuda.synchronize()
        common.launch_counts.clear()
        t0 = time.perf_counter()
        done = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = common.launch_counts["flash_decode"]
        check(all(len(c.tokens) == 64 and c.finished_reason == "length"
                  for c in done), "speculative_serving: a short completion")
        return {c.uid: c.tokens for c in done}, wall, launched

    plain = engine()
    ref, plain_wall, plain_launched = drive(plain, plain.run)
    steps = plain.stats["decode_steps"]
    plain_tok = sum(map(len, ref.values()))
    t0 = time.perf_counter()
    held = compare_completions(model, prompts, ref, "int8",
                               "speculative_serving (run())")
    log({"phase": "speculative_serving", "drive": "run()",
         "requests": len(ref), "tokens": plain_tok, "wall_s": plain_wall,
         "tok_s": plain_tok / plain_wall, "decode_steps": steps,
         "flash_decode_launches": plain_launched,
         "expected_launches": n_t * steps, **held,
         "forcing_s": time.perf_counter() - t0,
         "card": torch.cuda.get_device_name(0)})
    check(plain_launched == n_t * steps,
          f"speculative_serving run(): {plain_launched} flash_decode "
          f"launches for {steps} steps")
    total = plain_launched
    rows = {}
    for label, draft_model, kvq, probe in (
            ("random draft", draft, "none", None),
            ("self-draft", model, "int8", None),
            ("random draft, guard", draft, "none", 8)):
        eng = engine(draft_model, kvq)
        got, wall, launched = drive(
            eng, lambda e=eng, p=probe: e.run_speculative(p))
        st = eng._spec_stats
        rounds, plain_steps = st["rounds"], eng.stats["decode_steps"]
        d_layers = draft_model.cfg.n_layer
        # the probation's plain steps feed the draft too (draft_fed)
        expected = n_t * (rounds + plain_steps) + d_layers * (
            SPEC_N_DRAFT * rounds + st["draft_fed"])
        t0 = time.perf_counter()
        held = compare_completions(model, prompts, got, "int8",
                                   f"speculative_serving ({label})", ref)
        forcing_s = time.perf_counter() - t0
        n_tok = sum(map(len, got.values()))
        rows[label] = row = {
            "phase": "speculative_serving", "drive": label,
            "probe_rounds": probe, "draft_kv_quant": kvq,
            "requests": len(got), "tokens": n_tok, "wall_s": wall,
            "tok_s": n_tok / wall, "tok_s_over_run": plain_wall / wall,
            "rounds": rounds, "plain_steps": plain_steps,
            "draft_fed": st["draft_fed"],
            "round_widths": sorted(eng._spec_compiled),
            "proposed": st["proposed"], "emitted": st["emitted"],
            "accepted": st["accepted"],
            "acceptance": st["accepted"] / max(st["proposed"], 1),
            "spec_decision": eng.spec_decision,
            "flash_decode_launches": launched,
            "expected_launches": expected,
            **held, "forcing_s": forcing_s,
            "card": torch.cuda.get_device_name(0)}
        log(row)
        check(launched == expected and row["round_widths"] == [SPEC_N_DRAFT],
              f"speculative_serving ({label}): {launched} flash_decode "
              f"launches, {expected} expected (rounds {rounds}, plain "
              f"steps {plain_steps}, widths {row['round_widths']})")
        total += launched
        del eng
    check(rows["self-draft"]["acceptance"] >= SPEC_SELF_ACCEPTANCE,
          f"speculative_serving: the self-draft accepts "
          f"{rows['self-draft']['acceptance']} of its proposals")
    check(rows["random draft, guard"]["spec_decision"] is not None,
          "speculative_serving: the guard made no decision")
    del draft
    torch.cuda.empty_cache()
    log({"phase": "speculative_serving_total",
         "seconds": time.perf_counter() - t_phase})
    return total


@torch.no_grad()
def prefix_serving(model) -> int:
    """Shared-prefix caching: a 512-token system prompt from a seed before
    each of the 16 serving prompts, a chunked engine (chunk 256, int8
    cache, ``run_many(8)``) with ``set_prefix`` against the same engine
    without it: each engine's completions held token by token through the
    plain route (``compare_completions``) and counted equal, each engine's
    flash-decode launches one a layer a decode step, and both engines'
    admission time.  Returns the launches."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(2)
    prefix = rng.integers(1, model.cfg.n_vocab, PREFIX_LEN).tolist()
    prompts = [prefix + p for p in serving_prompts(model.cfg.n_vocab)]
    out, total = {}, 0
    for label in ("uncached", "set_prefix"):
        eng = DecodeEngine(model, n_slots=8, max_len=8192,
                           sampling=SamplingConfig(max_new_tokens=64),
                           kv_quant="int8", prefill_chunk=PREFIX_CHUNK,
                           device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "set_prefix":
            eng.set_prefix(prefix)
        torch.cuda.synchronize()
        prefix_s = time.perf_counter() - t0
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid, p))
        common.launch_counts.clear()
        t0 = time.perf_counter()
        done = eng.run_many(8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = common.launch_counts["flash_decode"]
        steps = eng.stats["decode_steps"]
        out[label] = {c.uid: c.tokens for c in done}
        n_tok = sum(map(len, out[label].values()))
        row = {"phase": "prefix_serving", "engine": label,
               "prefix_tokens": PREFIX_LEN, "prefill_chunk": PREFIX_CHUNK,
               "set_prefix_s": prefix_s if label == "set_prefix" else None,
               "requests": len(done), "tokens": n_tok, "wall_s": wall,
               "tok_s": n_tok / wall, "admit_s": eng.stats["admit_s"],
               "admissions": eng.stats["admissions"],
               "decode_steps": steps, "flash_decode_launches": launched,
               "card": torch.cuda.get_device_name(0)}
        check(all(len(c.tokens) == 64 for c in done),
              f"prefix_serving ({label}): a short completion")
        t0 = time.perf_counter()
        row.update(compare_completions(
            model, prompts, out[label], "int8", f"prefix_serving ({label})",
            out.get("uncached") if label == "set_prefix" else None))
        row["forcing_s"] = time.perf_counter() - t0
        log(row)
        check(launched == model.cfg.n_layer * steps,
              f"prefix_serving ({label}): {launched} flash_decode launches "
              f"for {steps} decode steps")
        total += launched
        del eng
    log({"phase": "prefix_serving_total",
         "seconds": time.perf_counter() - t_phase})
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


# The MT app (apps/machine_translation.main) at the JAX CLI's defaults, the
# reference MT configuration (L 40, vocab 10000, E 256, 8 heads, 4 layers,
# dropout 0.1, batch (128*40+40)//40 = 129), on the repository's corpus
MT_BASE = ["--dataset", "local", "--max-iters-per-epoch", "40"]
MT_RUNS = {
    # bf16 with fp32 masters, the C++ batch ring, an int8 cache for BLEU;
    # two epochs with a checkpoint each, then a resumed third
    "k": MT_BASE + ["--dtype", "bfloat16", "--mixed-precision",
                    "--native-loader", "--kv-quant", "int8",
                    "--checkpoint-every", "1"],
    # fp32 packed rows under segment masks, the fused LayerNorm
    "l": MT_BASE + ["--pack", "--use-fused-kernel", "--n-epochs", "1"],
}
MT_KV_QUANT = {"k": "int8", "l": "none"}
MT_WORKDIR = "workdir_chip_smoke_mt"     # git-ignored (workdir*/)
MT_L = 40
# Greedy decoding of the test split through the kernels and through their
# plain versions on the same trained model.  The routes' logits differ by
# rounding, so a hypothesis may leave the plain route's only where the
# kernel route's token scores within this gap of the top logit when the
# plain route decodes that sequence again alone: fp32 1e-3 (end_to_end's
# near tie); bf16 2^-4 of the top logit's magnitude (the logits' own
# rounding moves a gap by up to an ulp, 2^-7 of it, and the products of
# one sequence may round otherwise than those of a batch of 16).
MT_TIE_GAP = {torch.float32: (1e-3, 0.0), torch.bfloat16: (0.0, 2 ** -4)}


def mt_main(argv: list[str]) -> tuple[dict, dict]:
    """``main(argv)`` with the launch counts set to 0 just before and read
    just after; returns its records and the counts."""
    torch.cuda.synchronize()
    common.launch_counts.clear()
    rec = mt_app_main(argv)
    torch.cuda.synchronize()
    return rec, dict(common.launch_counts)


def mt_generation_routes(rec: dict, kv_quant: str, label: str) -> dict:
    """The trained model's greedy tokens on the test split (as
    ``generate_translations`` takes them) through the kernels and through
    their plain versions: every hypothesis that leaves the plain route's
    must do so at a near tie (``MT_TIE_GAP``, ``departure``) inside the
    position table; past it both routes decode NaN logits
    (``nan_past_table``)."""
    model, tok = rec["model"], rec["tokenizer"]
    test = get_dataset("local", MT_L)[0]["test"]
    rows = {impl: translation_tokens(model, test, "de", "en", tok, MT_L,
                                     kv_quant=kv_quant, impl=impl)
            for impl in ("kernel", "plain")}
    atol, rtol = MT_TIE_GAP[model.cfg.dtype]
    ties, faults = [], []
    for i, (a, b) in enumerate(zip(rows["kernel"], rows["plain"])):
        at = departure(model, tok(f"{test[i]['de']}<eos_de>")["input_ids"],
                       b, a, kv_quant)
        if at is None:
            continue
        at = {"example": i, **at}
        at["kernel"], at["plain"] = at.pop("got"), at.pop("ref")
        (ties if at.pop("near_tie") else faults).append(at)
    row = {"phase": "mt_generation_routes", "run": label,
           "kv_quant": kv_quant, "examples": len(test),
           "same_tokens": sum(a == b for a, b in zip(*rows.values())),
           "near_ties": ties, "faults": faults,
           "tie_gap": f"{atol} + {rtol} * |top logit|"}
    log(row)
    check(not faults, f"mt_app ({label}): greedy decoding through the "
                      f"kernels leaves the plain route's away from a near "
                      f"tie: {faults}")
    return row


# Beam search over the trained (k) model's test split
MT_BEAM = 4


class Lockstep:
    """``model`` as ``beam_generate`` calls it (prefill, then a step a
    token), through the kernels, each call also run through the plain
    route on a copy of the same caches; ``plain`` keeps those logits."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.plain = []

    def __call__(self, ids, *, kv_caches, impl=None, **kw):
        copies = [_gather_cache(c, torch.arange(c.k.shape[0], device=DEV))
                  for c in kv_caches]
        self.plain.append(self.model(ids, kv_caches=copies, impl="plain",
                                     **kw)[0])
        return self.model(ids, kv_caches=kv_caches, impl="kernel", **kw)


# The rotary + MoE serving model: the 176M serving widths with rotary
# positions and a routed feed-forward of 8 experts, top-2, capacity factor
# 1.25 (~0.64B parameters, 1.3 GB of bf16; a 2.1 GB bf16 cache for 8
# slots at 8192)
MOE_SERVING = {**SERVING, "positional": "rope",
               "moe": MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25)}
# The routes' router inputs differ by rounding (the flash-decode kernel's
# attention against the plain version's, about one bf16 ulp of a layer's
# attention output), which moves a router probability by ~1e-4: a token's
# experts may differ between the routes only where the plain route's k-th
# and (k+1)-th probabilities of the round that differs lie within this gap
MOE_TIE_GAP = 5e-3
# Each layer's attention output and the logits, in each batch row whose
# routing agrees, against the plain route's: |out - ref| <= arms * rms(ref)
# + rtol * |ref| (the flash-decode cases' VERIFY_TOL reach 0.032 of a row's
# rms; eight layers of bf16 carry the first layers' differences on)
MOE_HOLD_TOL = (5e-2, 2 ** -7)
# The planted faults' drive: the first prompts, a few tokens each
FAULT_PROMPTS, FAULT_NEW = 8, 8


def routing(ff, x):
    """An MoE layer's choices on its input ``x`` (its router and capacity,
    and ``_route``'s dispatch): each token's experts in round order [T, k],
    the router's probabilities in descending order [T, X], and the experts
    whose buffer kept it [T, X].  Without router noise round r takes the
    r-th largest probability, the lower index first at a tie (``_route``'s
    first-index argmax over the experts not yet taken): the stable sort's
    order."""
    tokens = x.reshape(-1, x.shape[-1])
    logits = ff.router_logits(tokens)
    dispatch, _, _ = ff._route(logits, capacity=ff.capacity(tokens.shape[0]))
    probs, order = torch.softmax(logits, -1).sort(dim=-1, descending=True,
                                                  stable=True)
    return order[:, :ff.moe.top_k], probs, dispatch.sum(-1) > 0


class HeldLockstep(Lockstep):
    """``Lockstep`` for the engine, each forward held at once.  Forward
    hooks (on the model's modules, none in the package) read every layer's
    attention output and MoE routing in both routes.  Layer by layer, a
    token's experts may differ between the routes only at a near tie of
    the plain route (``MOE_TIE_GAP``); its batch row, and any row whose
    buffer places changed with it (the capacity counts the whole call),
    are then left out of the later layers' holds.  Every other row's
    attention output at each layer, and its logits, lie within
    ``within_rms(tol)`` of the plain route's.  Faults are counted in
    ``stats``, not raised.  Planted faults: ``shift`` moves the kernel
    route's rotary positions, ``noise`` adds that share of its rms to the
    kernel route's MoE inputs."""

    def __init__(self, model, tol=MOE_HOLD_TOL, shift: int = 0,
                 noise: float = 0.0):
        super().__init__(model)
        self.tol, self.shift, self.noise = tol, shift, noise
        self.gen = torch.Generator(DEV).manual_seed(9)
        self.stats = dict(forwards=0, rows_held=0, rows_left_out=0,
                          near_ties=0, largest_tie_gap=0.0, tie_faults=0,
                          holds=0, hold_faults=0, largest_err_over_rms=0.0)
        self._seen, self._kernel = None, False
        self._hooks = []
        for m in model.modules():
            if isinstance(m, MultiHeadAttention):
                self._hooks.append(m.register_forward_hook(self._attention))
            elif isinstance(m, MoEFeedForward):
                self._hooks.append(m.register_forward_pre_hook(self._moe))

    def close(self) -> None:
        for h in self._hooks:
            h.remove()

    def _attention(self, _mod, _args, out):
        if self._seen is not None:
            self._seen.append(("attention", out[0]))

    def _moe(self, mod, args):
        if self._seen is None:
            return None
        x = args[0]
        planted = self.noise and self._kernel
        if planted:
            rms = x.float().square().mean().sqrt()
            x = x + (self.noise * rms * torch.randn(
                x.shape, generator=self.gen, device=DEV)).to(x.dtype)
        self._seen.append(("moe", routing(mod, x)))
        return (x,) if planted else None

    def __call__(self, ids, *, kv_caches, impl=None, **kw):
        copies = [_gather_cache(c, torch.arange(c.k.shape[0], device=DEV))
                  for c in kv_caches]
        self._seen, self._kernel = (plain_seen := []), False
        plain = self.model(ids, kv_caches=copies, impl="plain", **kw)[0]
        kernel_kw = dict(kw)
        if self.shift:
            pos = kw.get("positions")
            if pos is None:
                pos = torch.arange(ids.shape[1], device=DEV)[None, :]
            kernel_kw["positions"] = pos + self.shift
        self._seen, self._kernel = (kernel_seen := []), True
        out = self.model(ids, kv_caches=kv_caches, impl="kernel", **kernel_kw)
        self._seen = None
        self.hold(out[0], plain, kernel_seen, plain_seen)
        return out

    def _hold_rows(self, got, want, rows):
        if not bool(rows.any()):
            return
        arms, rtol = self.tol
        g, w = got[rows].float().flatten(1), want[rows].float().flatten(1)
        diff = (g - w).abs()
        r = w.square().mean(1, keepdim=True).sqrt()
        bad = ~(diff <= arms * r + rtol * w.abs()).all(1)
        st = self.stats
        st["holds"] += int(rows.sum())
        st["hold_faults"] += int(bad.sum())
        st["largest_err_over_rms"] = max(st["largest_err_over_rms"],
                                         float((diff / r).max()))

    def hold(self, got, want, kernel_seen, plain_seen):
        st = self.stats
        B, L = got.shape[:2]
        row_of = torch.arange(B * L, device=DEV) // L
        out = torch.zeros(B, dtype=torch.bool, device=DEV)  # rows let go
        st["forwards"] += 1
        for (kind, k), (_, p) in zip(kernel_seen, plain_seen, strict=True):
            if kind == "attention":
                self._hold_rows(k, p, ~out)
                continue
            (ck, _, kept_k), (cp, sp, kept_p) = k, p
            differ = ck != cp                                   # [T, k]
            token = differ.any(1)
            if bool(token.any()):
                first = differ.long().argmax(1)[:, None]     # round that moved
                gap = (sp.gather(1, first) - sp.gather(1, first + 1))[:, 0]
                new = token & ~out[row_of]
                st["near_ties"] += int(new.sum())
                if bool(new.any()):
                    st["largest_tie_gap"] = max(st["largest_tie_gap"],
                                                float(gap[new].max()))
                st["tie_faults"] += int((new & (gap > MOE_TIE_GAP)).sum())
                moved = token | (kept_k != kept_p).any(1)
                out[row_of[moved]] = True
            else:
                # a buffer place changes only with some token's choice
                st["tie_faults"] += int((kept_k != kept_p).any(1).sum())
        self._hold_rows(got, want, ~out)
        st["rows_held"] += int((~out).sum())
        st["rows_left_out"] += int(out.sum())


@torch.no_grad()
def moe_rope_serving() -> int:
    """The rotary + MoE serving model (``MOE_SERVING``, random weights from
    a seed) behind the engine: the 16 serving prompts, 64 greedy tokens
    each, 8 slots, through ``run()`` over a bf16 and an int8 cache and
    through ``run_speculative(None)`` with the bench's learned draft
    (``SPEC_DRAFT``, int8 cache).  Each drive runs once for its times
    (tok/s, host ms a decode step and its kernels' ms under the profiler,
    flash-decode launches against the forwards, peak memory), then again with the target (and the draft)
    behind ``HeldLockstep``: every forward the engine issues runs through
    the kernels and, on a copy of the same caches and the same slot batch,
    through the plain route, held there; the completions must equal the
    timed drive's.  Then the planted faults (a rotary shift of one, and
    router-input noise of 10 % of its rms, in the kernel route) must fail
    the holds and the tie limit.  Returns the flash-decode launches of the
    timed drives."""
    t_phase = time.perf_counter()
    cfg = DecoderConfig(**MOE_SERVING)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(3))
    draft = DecoderLM(DecoderConfig(**SPEC_DRAFT), device=DEV)
    init_params(draft, torch.Generator(DEV).manual_seed(1))
    prompts = serving_prompts(cfg.n_vocab)
    log({"phase": "moe_rope_serving_model", "params": num_parameters(model),
         "config": {k: str(v) for k, v in MOE_SERVING.items()}})

    def engine(target, kv_quant, draft_model=None, n_new=64):
        return DecodeEngine(target, n_slots=8, max_len=8192,
                            sampling=SamplingConfig(max_new_tokens=n_new),
                            kv_quant=kv_quant, draft_model=draft_model,
                            n_draft=SPEC_N_DRAFT, draft_kv_quant="int8",
                            device=DEV)

    def drive(eng, spec, reqs=prompts):
        for uid, p in enumerate(reqs):
            eng.submit(Request(uid, p))
        torch.cuda.synchronize()
        common.launch_counts.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = eng.run_speculative(None) if spec else eng.run()
        torch.cuda.synchronize()
        return ({c.uid: c.tokens for c in done}, time.perf_counter() - t0,
                common.launch_counts["flash_decode"],
                torch.cuda.max_memory_allocated() / 2**30)

    warm = engine(model, "int8", draft, n_new=8)
    drive(warm, True, prompts[:1])
    del warm
    n_t, n_d, total = cfg.n_layer, draft.cfg.n_layer, 0
    for label, kvq, spec in (("run(), bf16 cache", "none", False),
                             ("run(), int8 cache", "int8", False),
                             ("run_speculative(None), int8 cache", "int8",
                              True)):
        eng = engine(model, kvq, draft if spec else None)
        got, wall, launched, peak = drive(eng, spec)
        steps, rounds = eng.stats["decode_steps"], eng._spec_stats["rounds"]
        expected = n_t * (steps + rounds) + n_d * SPEC_N_DRAFT * rounds
        n_tok = sum(map(len, got.values()))
        row = {"phase": "moe_rope_serving", "drive": label,
               "requests": len(got), "tokens": n_tok, "wall_s": wall,
               "tok_s": n_tok / wall, "decode_steps": steps,
               "rounds": rounds, "admit_s": eng.stats["admit_s"],
               "flash_decode_launches": launched,
               "expected_launches": expected, "peak_memory_GiB": peak}
        if spec:
            st = eng._spec_stats
            row["acceptance"] = st["accepted"] / max(st["proposed"], 1)
        else:
            row["decode_ms_per_step"] = eng.stats["decode_s"] / steps * 1e3
            live = torch.ones(8, dtype=torch.bool, device=DEV)
            common.launch_counts.clear()      # one decode step on its own
            eng._decode_step(eng.last_tokens, live)
            torch.cuda.synchronize()
            row["flash_decode_launches_per_step"] = (
                common.launch_counts["flash_decode"])
            prof = kernel_profile(
                lambda: eng._decode_step(eng.last_tokens, live))
            row["decode_profile"] = {k: prof[k] for k in (
                "kernels_per_step", "kernel_ms_per_step", "gemm_ms_per_step",
                "other_kernel_ms_per_step", "top")}
        del eng
        check(all(len(t) == 64 for t in got.values()) and len(got) == 16,
              f"moe_rope_serving ({label}): a short or missing completion")
        check(launched == expected and row.get(
            "flash_decode_launches_per_step", n_t) == n_t,
              f"moe_rope_serving ({label}): {launched} flash_decode "
              f"launches, {expected} expected, "
              f"{row.get('flash_decode_launches_per_step')} in one step")
        total += launched
        # the same drive, every forward held against the plain route
        t0 = time.perf_counter()
        lock = HeldLockstep(model)
        dlock = HeldLockstep(draft) if spec else None
        try:
            held, *_ = drive(engine(lock, kvq, dlock), spec)
        finally:
            for lk in (lock, dlock):
                if lk is not None:
                    lk.close()
        row.update(held_s=time.perf_counter() - t0, target=lock.stats,
                   same_completions=held == got,
                   tie_gap=MOE_TIE_GAP, hold_tol=list(MOE_HOLD_TOL),
                   card=torch.cuda.get_device_name(0),
                   nvidia_smi=smi_line())
        if dlock is not None:
            row["draft"] = dlock.stats
        log(row)
        for what, st in (("target", lock.stats),
                         ("draft", dlock.stats if dlock else None)):
            if st is None:
                continue
            check(not st["tie_faults"] and not st["hold_faults"],
                  f"moe_rope_serving ({label}): the {what}'s kernel route "
                  f"leaves the plain route's: {st}")
        check(held == got, f"moe_rope_serving ({label}): the held drive's "
                           f"completions differ from the timed drive's")
    # planted faults: each must fail its limit
    faults = {}
    for label, kw in (("rotary positions shifted by one", {"shift": 1}),
                      ("router input noise, 0.1 of its rms",
                       {"noise": 0.1})):
        lock = HeldLockstep(model, **kw)
        try:
            drive(engine(lock, "none", n_new=FAULT_NEW), False,
                  prompts[:FAULT_PROMPTS])
        finally:
            lock.close()
        faults[label] = lock.stats
    log({"phase": "moe_rope_serving_planted_faults", "prompts": FAULT_PROMPTS,
         "new_tokens": FAULT_NEW, **faults, "tie_gap": MOE_TIE_GAP,
         "hold_tol": list(MOE_HOLD_TOL)})
    check(faults["rotary positions shifted by one"]["hold_faults"] > 0
          and faults["router input noise, 0.1 of its rms"]["tie_faults"] > 0,
          f"moe_rope_serving: a planted fault passed the holds: {faults}")
    del model, draft
    torch.cuda.empty_cache()
    log({"phase": "moe_rope_serving_total",
         "seconds": time.perf_counter() - t_phase})
    return total


def beam_choices(trace, plain, prompt_lengths, W, pad_id, tie) -> dict:
    """Each choice of a beam pass through the kernels (``trace``, from
    ``beam_generate``) against the plain route's logits on the same beams
    and caches (``plain``, from ``Lockstep``; a prefill's row at each
    prompt's last token, then a step's): every kept candidate's score, its
    beam's score plus its plain log-prob, may lie below the W-th best
    plain candidate by at most ``tie = (atol, rtol)``: atol and rtol of
    the largest |top logit| of the sequence's live beams.  A sequence's step with a NaN logit (past the
    position table, where both routes' logits are NaN) is not held."""
    gaps, limits, skipped = [], [], 0
    first = 0
    for S, done, kept in trace:
        logits = plain.pop(0).float()
        if logits.shape[1] > 1:       # a prefill: each prompt's last token
            n = logits.shape[0]
            lens = prompt_lengths[first:first + n]
            first += n
            logits = logits[torch.arange(n), lens - 1].repeat_interleave(W, 0)
        else:
            logits = logits[:, 0]
        B, V = S.shape[0], logits.shape[-1]
        logp = torch.log_softmax(logits, -1).view(B, W, V)
        finished = torch.full((V,), NEG_INF, device=DEV)
        finished[pad_id] = 0.0
        logp = torch.where(done[:, :, None], finished, logp)
        cand = (S[:, :, None] + logp).view(B, W * V)
        wth = torch.sort(cand, -1, descending=True).values[:, W - 1]
        top = torch.where(done, 0.0, logits.view(B, W, V).amax(-1))
        top = top.abs().amax(-1)
        held = torch.isfinite(cand).all(-1) & torch.isfinite(top)
        skipped += int((~held).sum())
        gaps.append((wth[:, None] - cand.gather(1, kept))[held].amax(-1))
        limits.append(tie[0] + tie[1] * top[held])
    check(not plain, "mt_beam_routes: the plain logits outnumber the steps")
    gaps, limits = torch.cat(gaps), torch.cat(limits)
    return {"choices_held": gaps.numel(), "sequence_steps_past_table":
            skipped, "off_plain_top": int((gaps > 0).sum()),
            **closest(gaps, limits), "faults": int((gaps > limits).sum())}


@torch.no_grad()
def mt_beam_routes(rec: dict, kv_quant: str, label: str) -> tuple[dict, int]:
    """The MT app's beam pass on the trained model: ``generate_translations
    (beam_size=4)`` (its flash-decode launches counted) and its BLEU beside
    the greedy BLEU of the run's last epoch; then the pass again through
    ``Lockstep``, each of its choices held against the plain route's
    logits on the same beams (``beam_choices``, ``MT_TIE_GAP``), and its
    rows counted equal to a pass through the plain route."""
    model, tok = rec["model"], rec["tokenizer"]
    test = get_dataset("local", MT_L)[0]["test"]
    t_phase = t0 = time.perf_counter()
    torch.cuda.synchronize()
    common.launch_counts.clear()
    hyps = generate_translations(model, test, "de", "en", tok, MT_L,
                                 kv_quant=kv_quant, beam_size=MT_BEAM)
    torch.cuda.synchronize()
    launched = common.launch_counts["flash_decode"]
    seconds = time.perf_counter() - t0
    lock, trace = Lockstep(model), []
    kernel = translation_tokens(lock, test, "de", "en", tok, MT_L,
                                kv_quant=kv_quant, beam_size=MT_BEAM,
                                trace=trace)
    plain = translation_tokens(model, test, "de", "en", tok, MT_L,
                               kv_quant=kv_quant, beam_size=MT_BEAM,
                               impl="plain")
    lengths = torch.tensor([len(tok(f"{ex['de']}<eos_de>")["input_ids"])
                            for ex in test], device=DEV)
    atol, rtol = MT_TIE_GAP[model.cfg.dtype]
    held = beam_choices(trace, lock.plain, lengths, MT_BEAM,
                        tok.vocab["<pad>"], (atol, rtol))
    row = {"phase": "mt_beam_routes", "run": label, "kv_quant": kv_quant,
           "beam_size": MT_BEAM, "examples": len(test),
           "same_rows": sum(a == b for a, b in zip(kernel, plain)),
           **held, "tie_gap": f"{atol} + {rtol} * |top logit|",
           "beam_bleu": evaluate_bleu(test, hyps, "en")["bleu"],
           "greedy_bleu": rec["bleu"][-1]["bleu"],
           "beam_pass_s": seconds, "flash_decode_launches": launched,
           "seconds": time.perf_counter() - t_phase,
           "card": torch.cuda.get_device_name(0)}
    log(row)
    check(not held["faults"],
          f"mt_app ({label}): beam choices through the kernels away from a "
          f"near tie of the plain route's: {held}")
    check(launched > 0 and launched % model.cfg.n_layer == 0,
          f"mt_app ({label}): the beam pass launched flash_decode "
          f"{launched} times")
    return row, launched


def mt_packed_attention(tokenizer, gen) -> dict:
    """Run (l)'s attention at its own shapes: the first 129 training pairs
    packed into rows of 40 by ``collate_packed`` with the run's tokenizer
    (its segment ids), random q, k, v and dO of 8 heads of 32 in fp32; the
    masked forward and fused backward, the forms (l) launches, against
    their plain versions at ATTN_TOL."""
    dtype, tols = torch.float32, ATTN_TOL[torch.float32]
    train = get_dataset("local", MT_L)[0]["train"]
    seg = torch.as_tensor(collate_packed(train[:129], "de", "en", tokenizer,
                                         MT_L)["segment_ids"], device=DEV)
    q, k, v, do = (torch.randn(seg.shape[0], 8, MT_L, 32, generator=gen,
                               device=DEV) for _ in range(4))
    kw = dict(causal=True, segment_ids=seg)
    before = dict(common.launch_counts)
    out, lse, _ = flash_attention_forward(q, k, v, impl="kernel", **kw)
    grads = flash_attention_backward(q, k, v, out, lse, do, impl="kernel",
                                     **kw)
    launched = {n: c - before.get(n, 0) for n, c in
                common.launch_counts.items() if c != before.get(n, 0)}
    ref_out, ref_lse, _ = flash_attention_forward(q, k, v, impl="plain", **kw)
    ref = flash_attention_backward(q, k, v, out, lse, do, impl="plain", **kw)
    torch.cuda.synchronize()
    ok = launched == dict.fromkeys(
        (fa._form_name(n, dtype, True) for n in ATTENTION), 1)
    errs = {}
    for n, a, b in [("out", out, ref_out), ("lse", lse, ref_lse)] + list(
            zip(("dq", "dk", "dv"), grads, ref)):
        errs[n], _, _, agree = compare(a, b, tols[n])
        ok &= agree
    row = {"phase": "mt_packed_attention", "dtype": "float32",
           "shape": f"B{seg.shape[0]} H8 L{MT_L} d32 causal",
           "segments": int((seg[:, 1:] != seg[:, :-1]).sum()) + seg.shape[0],
           "max_abs_err": errs, "launches": launched, "ok": ok}
    log(row)
    check(ok, f"mt_app (l): the masked flash forms disagree with their "
              f"plain versions on the run's packed rows: {row}")
    return row


def poisoned(tx, name: str):
    """``tx`` with a NaN written into gradient ``name`` on the card (no host
    read): the skip's input."""
    def update(grads, state, params):
        g = grads[name].clone()
        g.view(-1)[:1].fill_(float("nan"))
        return tx.update({**grads, name: g}, state, params)

    return type(tx)(tx.init, update)


def nan_gradient_step() -> dict:
    """``skip_nonfinite(mixed_precision(adam))`` steps of the reference MT
    model in bf16 on a batch of 129 x 40: after a finite step, one with a
    NaN in one gradient leaves the parameters, the fp32 masters, Adam's
    moments and step count bit-equal and ``skipped`` at 1; neither step
    makes the host wait (torch's sync debug mode)."""
    cfg = DecoderConfig(n_vocab=10_000, n_embd=256, n_head=8,
                        n_positions=MT_L, n_layer=4, p_dropout=0.1,
                        dtype=torch.bfloat16)
    model = DecoderLM(cfg, device=DEV)
    init_params(model, torch.Generator(DEV).manual_seed(0))
    tx = skip_nonfinite(mixed_precision(adam(lr=0.02)))
    batch = train_batch(0, (129, MT_L), cfg.n_vocab)
    gen = torch.Generator(DEV).manual_seed(1)
    state = tx.init(dict(model.named_parameters()))
    step = make_train_step(model, tx)
    state, _ = step(state, place_batch(batch, DEV), gen)
    # a finite step first: the skip's arithmetic waits for nothing either
    state, clean_syncs = syncs_in_a_step(step, state, batch, gen)
    name = "layers.0.attention.q_projection.weight"

    def tensors():
        return [t for _, t in _flatten_with_paths(
            (dict(model.named_parameters()), state)) if torch.is_tensor(t)]

    before = [t.clone() for t in tensors()]
    state, syncs = syncs_in_a_step(
        make_train_step(model, poisoned(tx, name)), state, batch, gen)
    after = tensors()
    changed = sum(not torch.equal(a, b) for a, b in zip(before, after))
    # the skip count is the one leaf that moves
    skipped = int(state.skipped)
    row = {"phase": "mt_nan_gradient_step", "poisoned_gradient": name,
           "tensors_compared": len(before), "tensors_changed": changed,
           "skipped": skipped, "adam_step": int(state.inner.inner.step),
           "host_syncs_in_a_step": syncs,
           "host_syncs_in_a_finite_step": clean_syncs}
    log(row)
    check(skipped == 1 and changed == 1,
          f"the NaN-gradient step changed {changed} tensors (only the skip "
          f"count may move), skipped {skipped}")
    check(not syncs and not clean_syncs,
          f"a skip_nonfinite step made the host wait: {syncs} (NaN), "
          f"{clean_syncs} (finite)")
    del model, state
    torch.cuda.empty_cache()
    return row


def mt_app() -> dict[str, int]:
    """The MT app's main path on the card (``mt_app_main``, the CLI): run
    (k) two epochs, then resumed from its checkpoint for a third; run (l)
    one epoch; BLEU after each epoch.  Checks each run's kernels by their
    launch counts, the losses, the resume, ``metrics.jsonl`` and the
    NaN-gradient step; then, on each configuration's trained model, greedy
    decoding through the kernels against their plain versions and (l)'s
    masked attention on its packed rows.  Returns the launches of the
    kernels line's forms."""
    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        MT_WORKDIR)
    shutil.rmtree(root, ignore_errors=True)
    fwd, bwd = ATTENTION
    expect = {
        "k": (fa._form_name(fwd, torch.bfloat16),
              fa._form_name(bwd, torch.bfloat16), "flash_decode"),
        "l": (fa._form_name(fwd, torch.float32, True),
              fa._form_name(bwd, torch.float32, True), "flash_decode",
              "layernorm_fwd", "layernorm_bwd")}
    launches: collections.Counter = collections.Counter()
    rows, routes, beams = {}, {}, {}
    try:
        for name, args in MT_RUNS.items():
            wd = ["--workdir", os.path.join(root, name)]
            runs = ([args + wd + ["--n-epochs", "2"],
                     args + wd + ["--n-epochs", "3", "--resume"]]
                    if name == "k" else [args + wd])
            for i, argv in enumerate(runs):
                t = time.perf_counter()
                rec, counts = mt_main(argv)
                label = name + ("" if i == 0 else " resumed")
                losses = [x for r in rec["epochs"]
                          for x in (r["train_loss"], r["validation_loss"])]
                rows[label] = {
                    "argv": argv, "seconds": time.perf_counter() - t,
                    "bpe_vocab": rec["tokenizer_vocab"],
                    "epochs": rec["epochs"], "bleu": rec["bleu"],
                    "samples": rec["samples"],
                    "launches": {n: counts.get(n, 0) for n in expect[name]},
                    "card": torch.cuda.get_device_name(0)}
                log({"phase": "mt_app", "run": label, **rows[label]})
                check(all(math.isfinite(x) for x in losses),
                      f"mt_app ({label}): a non-finite loss {losses}")
                check(len(rec["bleu"]) == len(rec["epochs"]) and all(
                    0.0 <= b["bleu"] <= 100.0 for b in rec["bleu"]),
                      f"mt_app ({label}): BLEU {rec['bleu']}")
                idle = [n for n in expect[name] if not counts.get(n)]
                check(not idle, f"mt_app ({label}) never launched {idle}")
                for n in expect[name]:
                    launches[n] += counts.get(n, 0)
                if name == "k" and i == 0:
                    tl = [r["train_loss"] for r in rec["epochs"]]
                    check(len(tl) == 2 and tl[1] < tl[0],
                          f"mt_app (k): epoch 2's train loss is not below "
                          f"epoch 1's: {tl}")
                if name == "k" and i == 1:
                    check([r["epoch"] for r in rec["epochs"]] == [2],
                          f"mt_app (k): the resumed run did not start from "
                          f"epoch 2: {rec['epochs']}")
            recs = read_metrics(os.path.join(root, name, "metrics.jsonl"))
            epochs = [r["step"] for r in recs if r.get("event") == "epoch"]
            bleus = [r["step"] for r in recs if r.get("event") == "bleu"]
            want = [0, 1, 2] if name == "k" else [0]
            check(epochs == want and bleus == want,
                  f"mt_app ({name}): metrics.jsonl holds epochs {epochs}, "
                  f"BLEU {bleus}, not {want}")
            # the last run's trained model: kernels against plain versions
            routes[label] = mt_generation_routes(rec, MT_KV_QUANT[name],
                                                 label)
            if name == "k":
                beams[label], n = mt_beam_routes(rec, MT_KV_QUANT[name],
                                                 label)
                launches["flash_decode"] += n
            if name == "l":
                mt_packed_attention(rec["tokenizer"],
                                    torch.Generator(DEV).manual_seed(20))
            del rec
            torch.cuda.empty_cache()
        nan_gradient_step()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log({"phase": "mt_app_total", "seconds": time.perf_counter() - t0,
         "bleu": {k: [b["bleu"] for b in r["bleu"]] for k, r in rows.items()},
         "tokens_per_sec": {k: [e["tokens_per_sec"] for e in r["epochs"]]
                            for k, r in rows.items()},
         "bpe_vocab": {k: r["bpe_vocab"] for k, r in rows.items()},
         "greedy_tokens_same": {k: r["same_tokens"]
                                for k, r in routes.items()},
         "beam_rows_same": {k: r["same_rows"] for k, r in beams.items()},
         "beam_bleu": {k: r["beam_bleu"] for k, r in beams.items()}})
    return dict(launches)


# --- the single-card utilities (points, conv/pool, grad_check, the MT app's
# --profile, the timing harness) ---------------------------------------------

# JAX's tests/test_points.py:48-53: (dataset, steps, least accuracy)
POINTS = (("Simple", 200, 0.97), ("Diag", 200, 0.97), ("Xor", 500, 0.95),
          ("Circle", 500, 0.93))


def points() -> list[dict]:
    """``apps.points_classifier.run`` on the card for each of ``POINTS``
    (256 points, hidden 32, Adam lr 0.05, seed 0): the final loss, the
    accuracy against JAX's test threshold, and the seconds of the run (the
    host reads the losses once, after the last step)."""
    rows = []
    for name, steps, least in POINTS:
        t = time.perf_counter()
        loss, acc = points_run(name, steps=steps, device=DEV)
        rows.append({"phase": "points", "dataset": name, "steps": steps,
                     "loss": loss, "accuracy": acc, "least_accuracy": least,
                     "seconds": time.perf_counter() - t,
                     "card": torch.cuda.get_device_name(0)})
        log(rows[-1])
    low = [(r["dataset"], r["accuracy"]) for r in rows
           if not r["accuracy"] >= r["least_accuracy"]]
    check(not low, f"points: below JAX's accuracy thresholds: {low}")
    return rows


# The conv/pool phase's shape and its limit: fp32 on the card (TF32 off)
# against the same code in float64 on the CPU.  A sum of n fp32 products
# errs by ~n^0.5 * 2^-24 of its terms' size: conv2d's 144 products a value
# and dW's 32768 stay under 1e-5 of the result's largest magnitude; 1e-4
# leaves room for cuDNN's algorithm and fails a misplaced pad (O(1)).
CONV_B, CONV_C, CONV_HW = 8, 16, 64
CONV_TOL = 1e-4


def conv_pool(gen) -> dict:
    """``nn.functional``'s ``tile``, ``avgpool2d``, ``maxpool2d``,
    ``argmax``, ``conv1d`` and ``conv2d`` on the card at B8 C16 H64 W64
    (conv2d 3x3, conv1d taps 5 over the rows flattened to 4096, pools
    2x2 and 4x4, maxpool also over values from {0, 1, 2}, where most
    windows tie; argmax at every axis): each forward and the gradient of
    ``sum(out * w)`` for every input against the same function in float64
    on the CPU, within ``CONV_TOL`` of the result's largest magnitude
    (argmax exactly, and without a gradient)."""
    x = torch.randn(CONV_B, CONV_C, CONV_HW, CONV_HW, generator=gen,
                    device=DEV)
    ties = torch.randint(0, 3, x.shape, generator=gen, device=DEV).float()
    w2 = torch.randn(CONV_C, CONV_C, 3, 3, generator=gen, device=DEV)
    w1 = torch.randn(CONV_C, CONV_C, 5, generator=gen, device=DEV)
    x1 = x.flatten(2)
    cases = [("tile 2x2", lambda a: pf.tile(a, (2, 2))[0], (x,)),
             ("tile 4x4", lambda a: pf.tile(a, (4, 4))[0], (x,)),
             ("avgpool2d 2x2", lambda a: pf.avgpool2d(a, (2, 2)), (x,)),
             ("avgpool2d 4x4", lambda a: pf.avgpool2d(a, (4, 4)), (x,)),
             ("maxpool2d 2x2", lambda a: pf.maxpool2d(a, (2, 2)), (x,)),
             ("maxpool2d 4x4", lambda a: pf.maxpool2d(a, (4, 4)), (x,)),
             ("maxpool2d 2x2 ties", lambda a: pf.maxpool2d(a, (2, 2)),
              (ties,)),
             ("maxpool2d 4x4 ties", lambda a: pf.maxpool2d(a, (4, 4)),
              (ties,)),
             ("conv1d K5", pf.conv1d, (x1, w1)),
             ("conv2d 3x3", pf.conv2d, (x, w2))]
    rows, failed = {}, []
    for label, fn, args in cases:
        errs = []
        for dev, dtype in ((DEV, torch.float32), ("cpu", torch.float64)):
            leaves = [a.to(dev, dtype).requires_grad_(True) for a in args]
            out = fn(*leaves)
            w = torch.randn(out.shape, generator=torch.Generator(
                "cpu").manual_seed(1), dtype=torch.float64).to(dev, dtype)
            grads = torch.autograd.grad((out * w).sum(), leaves)
            errs.append([out.detach(), *grads])
        row = {}
        for name, got, ref in zip(("out", *(f"d{i}" for i in range(
                len(args)))), errs[0], errs[1]):
            err = float((got.double().cpu() - ref).abs().max())
            scale = float(ref.abs().max())
            row[name] = {"max_abs_err": err, "largest": scale}
            if not err <= CONV_TOL * max(1.0, scale):
                failed.append(f"{label} {name}: {err} of {scale}")
        if "ties" in label:     # the card's gradient split among ties
            leaf = args[0].clone().requires_grad_(True)
            (split,) = torch.autograd.grad(fn(leaf).sum(), leaf)
            row["split_inputs"] = int(((split > 0) & (split < 1)).sum())
            if not row["split_inputs"]:
                failed.append(f"{label}: no window split its gradient")
        rows[label] = row
    for axis in range(-4, 4):
        got = pf.argmax(x, axis)
        ref = pf.argmax(x.double().cpu(), axis)
        same = torch.equal(got.cpu(), ref) and not got.requires_grad
        rows[f"argmax axis {axis}"] = {"same": same,
                                       "shape": list(got.shape)}
        if not same:
            failed.append(f"argmax axis {axis}")
    log({"phase": "conv_pool", "shape": f"B{CONV_B} C{CONV_C} "
         f"H{CONV_HW} W{CONV_HW} fp32, TF32 off", "tol": f"{CONV_TOL} of "
         "the largest |float64 value|", "cases": rows,
         "card": torch.cuda.get_device_name(0)})
    check(not failed, f"conv_pool against float64: {failed}")
    return rows


class _FlippedFlash(torch.autograd.Function):
    """The flash kernels' forward with their backward's sign flipped: the
    wrong VJP ``grad_check`` must catch."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse, _ = flash_attention_forward(q, k, v, causal=causal,
                                              impl="kernel")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = flash_attention_backward(q, k, v, out, lse, do,
                                         causal=ctx.causal, impl="kernel")
        return (*(-g for g in grads), None)


# grad_check's shapes: the fused backward at B1 H2 L256 d64, the two passes
# where the JAX rule takes them in fp32 (L 8192 at d64, H1)
GC_FUSED = (1, 2, 256, 64)
GC_TWO_PASS = (1, 1, 8192, 64)
BW_ORACLE_TOL = 1e-2        # the kernel backward's tolerance


def grad_check_kernels(gen) -> dict:
    """``grad_check`` in fp32 on the card through the kernel route of
    ``ops.flash_attention`` (causal and not; the fused backward at
    ``GC_FUSED``, the two passes at ``GC_TWO_PASS``, where
    ``backward_form.two_pass`` takes them), ``ops.layer_norm`` and
    ``ops.attn_softmax`` (``impl="kernel"``), each output weighted by a
    fixed random tensor and summed in float64; the launches of each form
    counted; the fused ``_x6`` backward's dq, dk, dv against
    ``flash_attention2_bw_reference`` within ``BW_ORACLE_TOL``; and a
    backward with its sign flipped, which ``grad_check`` must reject."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEV)

    flash_forms = ATTENTION_X6 + TWO_PASS
    rows, launched = [], collections.Counter()

    def checked_run(label, fn, args, forms, **kw):
        before = {n: common.launch_counts[n] for n in forms}
        t = time.perf_counter()
        ok = grad_check(fn, *args, **kw)
        torch.cuda.synchronize()
        n = {f: common.launch_counts[f] - before[f] for f in forms}
        launched.update(n)
        rows.append({"case": label, "passed": ok, "launches": n,
                     "seconds": time.perf_counter() - t})

    forms = {GC_FUSED: ATTENTION_X6, GC_TWO_PASS: (ATTENTION_X6[0],)
             + TWO_PASS}
    for shape, form in forms.items():
        B, H, L, d = shape
        q, k, v, w = (rand(B, H, L, d) for _ in range(4))
        for causal in (False, True):
            check(two_pass(L, L, d, 4, causal) == (shape == GC_TWO_PASS),
                  f"grad_check: the rule's form at L{L} is not the one "
                  f"meant")
            checked_run(
                f"flash_attention B{B} H{H} L{L} d{d} causal={causal}",
                lambda *a, c=causal: (flash_ops_attention(*a, causal=c)
                                      * w).double(),
                (q, k, v), form)
    x, gamma, beta, wl = rand(4, 40, 256), rand(256), rand(256), rand(256)
    checked_run("layer_norm R160 H256",
                lambda *a: (fused.layer_norm(*a, impl="kernel")
                            * wl).double(),
                (x, gamma, beta), ("layernorm_fwd", "layernorm_bwd"))
    s, w = rand(2, 8, 40, 40), rand(2, 8, 40, 40)
    pad = torch.zeros(2, 40, device=DEV)
    pad[1, 30:] = common.MASK_VALUE
    for causal in (False, True):
        checked_run(f"attn_softmax B2 H8 L40 causal={causal}",
                    lambda a, c=causal: (fused.attn_softmax(
                        a, pad, mask_future=c, impl="kernel") * w).double(),
                    (s,), ("attn_softmax_fwd", "attn_softmax_bwd"),
                    n_samples=8)
    idle = [f for f in flash_forms + FUSED if not launched[f]]
    # the fused _x6 backward against the FA2 backward oracle
    B, H, L, d = GC_FUSED
    q, k, v, do = (rand(B, H, L, d) for _ in range(4))
    oracle = {}
    for causal in (False, True):
        out, lse, _ = flash_attention_forward(q, k, v, causal=causal,
                                              impl="kernel")
        got = flash_attention_backward_fused(q, k, v, out, lse, do,
                                             causal=causal, impl="kernel")
        res = flash_attention2_fw_reference(q, k, v, causal=causal)
        want = flash_attention2_bw_reference(q, k, v, res.out, res.lse, do,
                                             causal=causal)
        oracle[f"causal={causal}"] = {
            n: float((a - b).abs().max())
            for n, a, b in zip(("dq", "dk", "dv"), got, want)}
    # the planted wrong VJP
    q, k, v, w = (rand(*GC_FUSED) for _ in range(4))
    try:
        grad_check(lambda *a: (_FlippedFlash.apply(*a, True) * w).double(),
                   q, k, v)
        caught = None
    except AssertionError as e:
        caught = str(e)
    log({"phase": "grad_check_kernels", "dtype": "float32",
         "defaults": "4 positions an argument, eps 1e-3, rtol 1e-2, "
                     "atol 1e-2", "cases": rows,
         "launches": dict(launched), "fused_bwd_x6_vs_fa2_bw_oracle": oracle,
         "oracle_tol": BW_ORACLE_TOL, "flipped_backward_caught": caught,
         "card": torch.cuda.get_device_name(0)})
    check(not idle, f"grad_check_kernels never launched {idle}")
    far = {c: e for c, e in oracle.items()
           if not max(e.values()) <= BW_ORACLE_TOL}
    check(not far, f"the fused _x6 backward against the FA2 backward "
                   f"oracle: {far}")
    check(caught is not None, "grad_check passed a flipped backward")
    return dict(launched)


MT_PROFILE_ITERS = 30


def trace_split(path: str, steps: int) -> dict:
    """The device side of a ``utils.profiling.trace`` file, a step at a
    time: kernels and their summed time, the port's flash kernels, the
    GEMMs by operand type and the rest, the device's idle share over the
    span from its first event's start to its last event's end, and the
    ten largest kernels by time."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in device if e["cat"] == "kernel"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    busy, end = 0.0, -math.inf
    for s, e in spans:          # the union of the device's intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    total_us = sum(us for _, us in by_name.values())
    ours = {n: sum(us for k, (_, us) in by_name.items() if port_kernel(k, n))
            / steps / 1e3 for n in ATTENTION_TC}
    gemms = collections.defaultdict(float)
    for k, (_, us) in by_name.items():
        if gemm_kind(k):
            gemms[gemm_kind(k)] += us / steps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"events": len(events), "steps": steps,
            "kernels_per_step": len(kernels) / steps,
            "kernel_ms_per_step": total_us / steps / 1e3,
            "device_span_ms_per_step": span / steps / 1e3,
            "idle_share": 1.0 - busy / span if span else None,
            "port_flash_ms_per_step": ours,
            "gemm_ms_per_step": dict(gemms),
            "other_kernel_ms_per_step": (total_us / steps / 1e3
                                         - sum(ours.values())
                                         - sum(gemms.values())),
            "top10": [{"name": k[:100], "count_per_step": c / steps,
                       "ms_per_step": us / steps / 1e3,
                       "share": us / total_us if total_us else None}
                      for k, (c, us) in top]}


def mt_profile() -> dict[str, int]:
    """The MT app's CLI with ``--profile``: run (k)'s argv for one epoch of
    at most ``MT_PROFILE_ITERS`` steps (the corpus holds 22 batches of 129;
    no checkpoint, no BLEU pass), the launch
    counts set to 0 just before and read just after.  Checks the profile
    line, that the trace under ``<workdir>/profile`` holds the flash
    forward's and fused backward's ``_tc`` forms (by name, no exact count:
    a trace may drop kernels, PERF.md §7) and that the run launched them;
    logs the first split of the app's step (``trace_split``).  Returns
    the launches of the kernels line's forms."""
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        MT_WORKDIR)
    root = os.path.join(base, "k_profile")
    shutil.rmtree(base, ignore_errors=True)
    argv = MT_RUNS["k"] + ["--profile", "--n-epochs", "1",
                           "--max-iters-per-epoch", str(MT_PROFILE_ITERS),
                           "--checkpoint-every", "0", "--skip-bleu",
                           "--workdir", root]
    try:
        t = time.perf_counter()
        rec, counts = mt_main(argv)
        seconds = time.perf_counter() - t
        traces = glob.glob(os.path.join(root, "profile", "*.pt.trace.json"))
        check(len(traces) == 1, f"mt_profile: traces written {traces}")
        steps = 1 + max(r["step"] for r in read_metrics(
            os.path.join(root, "metrics.jsonl"))
                        if "loss" in r and r.get("event") is None)
        t = time.perf_counter()
        split = trace_split(traces[0], steps)
        parse_s = time.perf_counter() - t
        trace_mb = os.path.getsize(traces[0]) / 2 ** 20
    finally:
        shutil.rmtree(base, ignore_errors=True)
    forms = {n: split["port_flash_ms_per_step"][n] > 0 for n in ATTENTION_TC}
    launches = {n: counts.get(n, 0) for n in ATTENTION_TC}
    log({"phase": "mt_profile", "argv": argv, "seconds": seconds,
         "trace_mb": trace_mb, "trace_parse_s": parse_s,
         "epoch": rec["epochs"][0], "launches": launches,
         "flash_tc_in_trace": forms, **split,
         "card": torch.cuda.get_device_name(0)})
    check(all(forms.values()), f"mt_profile: the trace lacks {forms}")
    check(all(launches.values()), f"mt_profile launched {launches}")
    # the corpus's whole batches of the app's 129 rows, at most the cap
    batches = len(get_dataset("local", MT_L)[0]["train"]) // (
        (128 * MT_L + MT_L) // MT_L)
    check(steps == min(MT_PROFILE_ITERS, batches),
          f"mt_profile ran {steps} steps, not min({MT_PROFILE_ITERS}, "
          f"{batches})")
    return launches


TIMING_SHAPE = (4, 8, 2048, 64)     # PERF.md §6's row 1 shape, causal
TIMING_AGREE = 0.15


def timing_harness(gen) -> dict:
    """``utils.timing.compare`` of the bf16 flash forward kernel against
    its plain version at ``TIMING_SHAPE``, causal; ``benchmark``'s
    ``mean_ms`` for the kernel must be within ``TIMING_AGREE`` of a
    ``device_ms`` of the same call, and ``utils.roofline``'s fraction for
    it is logged beside PERF.md's 13.9 %."""
    B, H, L, d = TIMING_SHAPE
    q, k, v = (torch.randn(B, H, L, d, generator=gen, device=DEV).to(
        torch.bfloat16) for _ in range(3))
    flops = attention_flops(B, H, L, d, causal=True)

    def kernel(q, k, v):
        return flash_attention_forward(q, k, v, causal=True, impl="kernel")

    def plain(q, k, v):
        return flash_attention_forward(q, k, v, causal=True, impl="plain")

    before = common.launch_counts[ATTENTION_TC[0]]
    rk, rp, speedup = timing_compare(kernel, plain, q, k, v, flops=flops,
                                     names=("kernel", "plain"))
    check(common.launch_counts[ATTENTION_TC[0]] > before,
          "timing_harness: the kernel was not launched")
    direct = device_ms(lambda: kernel(q, k, v), iters=50)
    point = roofline(rk.mean_ms, flops, attention_bytes(B, H, L, d))
    row = {"phase": "timing_harness", "kernel": ATTENTION_TC[0],
           "shape": f"B{B} H{H} L{L} d{d} causal bf16",
           "benchmark_ms": rk.mean_ms, "device_ms": direct,
           "benchmark_over_device_ms": rk.mean_ms / direct,
           "plain_ms": rp.mean_ms, "speedup": speedup,
           "tflops": rk.tflops, "roofline": point.summary(),
           "perf_md_fraction": 0.139,
           "card": torch.cuda.get_device_name(0)}
    log(row)
    check(abs(rk.mean_ms / direct - 1.0) <= TIMING_AGREE,
          f"timing_harness: benchmark {rk.mean_ms} ms against device_ms "
          f"{direct} ms")
    return row


# ----------------------------------------------------------------------------
# The parallel layer (A8): the JAX package's parallel modes at 4 ranks.
# One card: the 4 ranks share cuda:0 and the world takes gloo (NCCL refuses
# two ranks on one device), CUDA tensors staged through host memory
# (parallel/comm.py); every kernel runs on the card.  Times here are of 4
# ranks sharing one card and say nothing of multi-card speed.
PAR_WORLD = 4
PAR_DEVICE = "cuda"            # each rank binds cuda:{rank % 1}, cuda:0
# (p1): the production widths with a routed feed-forward (the JAX dryrun's
# model, __graft_entry__.py:25-34, at full width: vocab 10000, E 512, 8
# heads, 4 layers, FF 2048, 8 experts top-1), Megatron sequence
# parallelism, the vocab-parallel loss, the dryrun's packed batch at B4
# L2048
PAR_TRAIN = dict(n_vocab=10_000, n_embd=512, n_head=8, n_positions=2048,
                 n_layer=4, ff_middle_dim=2048, attention_kind="flash",
                 p_dropout=0.0)
PAR_MOE = {**PAR_TRAIN, "moe": MoEConfig(n_experts=8, top_k=1),
           "sequence_parallel": True}
PAR_B, PAR_L = 4, 2048
# (p5): mode (f)'s shape in bf16 (4096-long chunks), under window 2048 too,
# and L32768 in fp32, whose 8192-long chunks take the two-pass backward
PAR_SEQ = ((torch.bfloat16, 16384, None), (torch.bfloat16, 16384, 2048),
           (torch.float32, 32768, None))
# (p7): the serving model's drives (the JAX dryrun's four, at serving
# sizes: chunks of 64, a 32-token shared prefix)
PAR_PREFIX = 32
PAR_DECODE_MODES = {
    "plain": dict(kw={}, method="run", prefix=None),
    "chunked": dict(kw=dict(prefill_chunk=64), method="run", prefix=None),
    "prefix": dict(kw=dict(prefill_chunk=64), method="run",
                   prefix="shared"),
    "run_many": dict(kw={}, method="run_many", prefix=None),
}
PAR_DECODE = dict(n_slots=4, max_len=512, max_new=8)
# (p8): the MT app's CLI at the JAX CLI's defaults on the repository's
# corpus, one epoch and a BLEU pass, on the mesh; dropout off, since the
# port's p_dropout masks come from each rank's local shapes.  The mesh
# rounds the batch of 129 up to 130 (dp 2, as JAX's app does); the
# single-process run is given 130, so that both step the same rows, and so
# is its twin with --accum-steps 2 (the same steps in exact arithmetic).
# Every step's loss is held against the single-process run's.  At lr 0.02
# the run's loss leaps at step 2 (2.02 -> 3.87) and from step 4 on the
# steps amplify rounding: runs that are equal in exact arithmetic part by
# up to 4.5e-2 relative, so the steps before PAR_MT_EXACT_STEPS are held at
# the fp32 limit and the later ones at PAR_MT_DRIFT (my chip run, PR 24
# call 14, _archive/p8_drift.py: steps 0-3 within 1.8e-6 and steps 4-21
# within 1.6e-2 for the twin and the plain route, 3.8e-2 for dp2 x tp2
# and 4.5e-2 for this mesh; a run and its repeat the same bits).
PAR_MT = ["--dataset", "local", "--p-dropout", "0"]
PAR_MT_MESH = ["--dp", "2", "--tp", "2", "--zero1", "--sequence-parallel"]
PAR_MT_SINGLE = ["--batch-size", "130"]
PAR_MT_TWIN = PAR_MT_SINGLE + ["--accum-steps", "2", "--skip-bleu"]
PAR_MT_EXACT_STEPS = 4
PAR_MT_DRIFT = 0.1
# bf16 steps against the single-process port: the loss within ATTN_TOL's
# bf16 rtol of the single-process bf16 step's; the gradients against the
# fp32 step on the same bf16 values, each gradient's rms difference over
# the larger of its rms and 1e-3 of the largest gradient rms (a floor for
# gradients that are 0 in exact arithmetic, the K bias's), at most twice
# the single-process bf16 step's (bf16 rounds the sharded step's partial
# sums at other places: its gradients are as far from fp32's, not equal
# to the single-process step's; CPU rehearsal at E 64-256: 0.07-0.11
# sharded, 0.08-0.24 single)
PAR_BF16 = {"loss_rtol": ATTN_TOL[torch.bfloat16]["out"][2],
            "grad_vs_fp32": "at most 2x the single-process bf16 step's"}


def par_prompts(n_vocab: int) -> dict[int, list[int]]:
    """6 prompts of 40 to 200 tokens from a seed, each after the shared
    32-token prefix (4 slots: two waves of admissions)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, n_vocab, PAR_PREFIX).tolist()
    return {u: prefix + rng.integers(1, n_vocab, int(n)).tolist()
            for u, n in enumerate(rng.integers(8, 169, 6))}, prefix


def par_step_ok(r: dict, dtype, what: str) -> dict:
    """A sharded step's loss and first gradients against the single-process
    port's: fp32 at ``training_end_to_end``'s limits (loss rtol 1e-5,
    each gradient within 1e-3 of its largest plus 1e-5 of the model's),
    bf16 at ``PAR_BF16``."""
    loss, ref = r["loss"][0], r["ref_loss"]
    e = r["grad_errors"]
    if dtype == torch.float32:
        ok = (abs(loss - ref) <= 1e-5 * abs(ref)
              and e["worst_over_fp32_tol"] <= 1.0)
        lim = {"loss_rtol": 1e-5, "grad": "1e-3 max|g| + 1e-5 max|g| all"}
    else:
        got = r["grad_errors_vs_fp32"]["worst_rms_rel_floored"]
        single = r["single_grad_errors_vs_fp32"]["worst_rms_rel_floored"]
        ok = (abs(loss - ref) <= PAR_BF16["loss_rtol"] * abs(ref)
              and got <= 2 * single)
        lim = PAR_BF16
    check(ok, f"{what}: sharded step {loss} / {e} against single-process "
              f"{ref} beyond {lim}")
    return lim


def parallel_calls(prompts, prefix):
    """The (p1)-(p8) rank calls, in order, for one world."""
    batch = pdry.dryrun_batch(PAR_B, PAR_L, PAR_TRAIN["n_vocab"])
    ref_batch = pdry.dryrun_batch(REF_B, REF_L, REF["n_vocab"],
                                  segments=False)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, PAR_TRAIN["n_vocab"], (PAR_B, PAR_L))
    tgt = rng.integers(0, PAR_TRAIN["n_vocab"], (PAR_B, PAR_L))
    modes = {k: {**v, "prefix": prefix if v["prefix"] else None}
             for k, v in PAR_DECODE_MODES.items()}
    mesh = dict(data=2, model=2)
    calls = [
        ("p1 fp32", "rank_train", dict(config_kw=PAR_MOE, batch=batch,
                                       **mesh)),
        ("p1 bf16 mixed", "rank_train", dict(
            config_kw={**PAR_MOE, "dtype": torch.bfloat16}, batch=batch,
            mixed=True, **mesh)),
        ("p1 reference MT widths", "rank_train", dict(
            config_kw={**REF, "p_dropout": 0.0}, batch=ref_batch,
            **mesh)),
        ("p2 attn_dropout", "rank_train", dict(
            config_kw={**PAR_MOE, "attn_dropout": 0.1}, batch=batch,
            logits=False, **mesh)),
        ("p3 zero1 mixed", "rank_train", dict(
            config_kw=PAR_MOE, batch=batch, mixed=True, zero1=True,
            steps=2, **mesh)),
        ("p4 gpipe", "rank_pipeline", dict(config_kw=PAR_TRAIN, ids=ids,
                                          tgt=tgt, n_micro=4)),
    ]
    for dtype, L, window in PAR_SEQ:
        for strategy in ("allgather", "ring"):
            calls.append((
                f"p5 {strategy} {str(dtype).split('.')[1]} L{L}"
                + (f" window {window}" if window else ""),
                "rank_sequence", dict(
                    q=None, k=None, v=None, w=None, strategy=strategy,
                    window=window, reference="kernel", seed=L,
                    shape=(1, 8, L, 64), dtype=dtype,
                    tol=ATTN_TOL[dtype])))
    calls += [
        ("p6 dcn", "rank_train", dict(config_kw=PAR_MOE, batch=batch,
                                      data=1, model=2, dcn=2,
                                      reference=False, logits=False)),
        ("p7 sharded decode", "rank_decode", dict(
            config_kw=SERVING, prompts=prompts, kv_quants=("none", "int8"),
            modes=modes, reference=False, **PAR_DECODE, **mesh)),
        ("p8 mt app", "rank_mt_main", dict(
            argv=PAR_MT + PAR_MT_MESH + ["--workdir", os.path.join(
                MT_WORKDIR, "parallel")])),
    ]
    return calls, modes


def parallel_modes() -> dict[str, int]:
    """The parallel layer's phase: (p1)-(p8) in one world of 4 ranks on
    this card over gloo (``parallel.dryrun.rank_many``), each held against
    the single-process port; (p9) a world of one over NCCL.  Returns the
    ranks' launches of the kernels line's forms (the single-process pins'
    excluded)."""
    t0 = time.perf_counter()
    smi = smi_line()
    prompts, prefix = par_prompts(SERVING["n_vocab"])
    calls, modes = parallel_calls(prompts, prefix)
    # (p8)'s single-process run and its twin first, on this process
    mt_root = os.path.join(MT_WORKDIR, "parallel")
    for d in ("parallel_single", "parallel_twin", "parallel"):
        shutil.rmtree(os.path.join(MT_WORKDIR, d), ignore_errors=True)
    t = time.perf_counter()
    single = mt_app_main(PAR_MT + PAR_MT_SINGLE + [
        "--workdir", MT_WORKDIR + "/parallel_single"])
    single_s = time.perf_counter() - t
    twin = mt_app_main(PAR_MT + PAR_MT_TWIN + [
        "--workdir", MT_WORKDIR + "/parallel_twin"])
    for rec in (single, twin):
        del rec["model"], rec["tokenizer"]
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = pdry.run_world("tpu_flash_torch.parallel.dryrun.rank_many",
                           PAR_WORLD, device=PAR_DEVICE, timeout=1000,
                           calls=[(fn, kw) for _, fn, kw in calls])
    world_s = time.perf_counter() - t
    launches: collections.Counter = collections.Counter()
    for r in ranks:
        for res in r:
            launches.update(res.get("launches", {}))
    by = {name: [r[i] for r in ranks] for i, (name, _, _) in
          enumerate(calls)}

    def row(name, **extra):
        rs = by[name]
        rec = {"phase": "parallel_modes", "mode": name,
               "transport": rs[0]["transport"],
               "seconds_per_rank": [r["seconds"] for r in rs],
               "peak_mb_per_rank": [r["peak_mb"] for r in rs],
               "launches_rank0": rs[0]["launches"],
               "card": smi, **extra}
        log(rec)
        check(rec["transport"] == "gloo-host",
              f"{name}: transport {rec['transport']}")
        check(all(r["launches"] for r in rs),
              f"{name}: a rank launched no kernel")
        return rs[0]

    for name, dtype in (("p1 fp32", torch.float32),
                        ("p1 bf16 mixed", torch.bfloat16),
                        ("p1 reference MT widths", torch.float32),
                        ("p2 attn_dropout", torch.float32)):
        r0 = by[name][0]
        lim = par_step_ok(r0, dtype, name)
        row(name, loss=r0["loss"][0], single_process_loss=r0["ref_loss"],
            grad_errors=r0["grad_errors"], limits=lim,
            **{k: r0[k] for k in ("fp32_loss", "grad_errors_vs_fp32",
                                  "single_grad_errors_vs_fp32")
               if k in r0},
            logits_max_abs_err=r0.get("logits_max_abs_err"),
            logits_rms_rel=r0.get("logits_rms_rel"), mesh=r0["mesh"])
    fused_ranks = [r["launches"] for r in by["p1 reference MT widths"]]
    check(all(all(r.get(n, 0) > 0 for n in FUSED) for r in fused_ranks),
          f"p1 reference MT widths: rows 5-8 not on every rank: "
          f"{fused_ranks}")
    p1 = by["p1 fp32"][0]
    z = by["p3 zero1 mixed"][0]
    check(z["params_vs_plain"] <= 1e-6 and z["moments_vs_plain"] <= 1e-6
          and abs(z["loss"][0] - p1["loss"][0]) <= 1e-5 * abs(p1["loss"][0])
          and all(r["state_bytes"] < 0.55 * r["plain_state_bytes"]
                  for r in by["p3 zero1 mixed"]),
          f"p3: ZeRO-1 against plain DP x TP: {z}")
    row("p3 zero1 mixed", loss=z["loss"], plain_loss=z["plain_loss"],
        params_vs_plain=z["params_vs_plain"],
        moments_vs_plain=z["moments_vs_plain"],
        state_bytes_per_rank=[r["state_bytes"]
                              for r in by["p3 zero1 mixed"]],
        plain_state_bytes_per_rank=[r["plain_state_bytes"]
                                    for r in by["p3 zero1 mixed"]])
    pp = by["p4 gpipe"][0]
    check(abs(pp["loss"] - pp["ref_loss"]) <= 1e-5 * abs(pp["ref_loss"])
          and pp["grad_errors"]["worst_over_fp32_tol"] <= 1.0,
          f"p4: GPipe against single-process: {pp}")
    row("p4 gpipe", loss=pp["loss"], single_process_loss=pp["ref_loss"],
        grad_errors=pp["grad_errors"], grad_max_dev=pp["grad_max_dev"],
        split_s={k: pp[k] for k in ("setup_s", "forward_s", "backward_s")})
    for name, _, kw in calls:
        if not name.startswith("p5"):
            continue
        r0 = by[name][0]
        steps = sequence_window_steps(PAR_WORLD, kw["shape"][2]
                                      // PAR_WORLD, kw["window"])
        want_hops = steps - 1 if "ring" in name else None
        check(all(e["ok"] for e in r0["errors"].values()),
              f"{name}: against the single-process kernels: "
              f"{r0['errors']}")
        if want_hops is not None:
            check(r0["hops"] == want_hops,
                  f"{name}: {r0['hops']} ring hops, not {want_hops}")
        row(name, errors=r0["errors"], tol=str(kw["tol"]),
            hops=r0.get("hops"), partials_rank0=r0.get("partials"),
            window_steps=steps, loss=r0["loss"],
            single_process_loss=r0["ref_loss"])
    d = by["p6 dcn"][0]
    check(d["mesh"] == ((0, 1), (2, 3))
          and abs(d["loss"][0] - p1["ref_loss"]) <= 1e-5 * abs(
              p1["ref_loss"]),
          f"p6: DCN mesh {d['mesh']} loss {d['loss']} against "
          f"{p1['ref_loss']}")
    row("p6 dcn", mesh=d["mesh"], loss=d["loss"][0],
        single_process_loss=p1["ref_loss"])
    dec = by["p7 sharded decode"][0]
    for r in by["p7 sharded decode"][1:]:
        check(r["completions"] == dec["completions"],
              "p7: the ranks' completions differ")
    held = {}
    model = pdry.build_model(DecoderConfig(**SERVING), DEV)
    for key, comp in dec["completions"].items():
        mode, q = key.split("/")
        ref = pdry.run_engine(model, mode, prompts=prompts, kv_quant=q,
                              modes=modes, **PAR_DECODE)
        plist = [prompts[u] for u in sorted(prompts)]
        held[key] = compare_completions(
            model, plist, {u: list(t) for u, (t, _) in comp.items()}, q,
            f"p7 {key}", ref={u: list(t) for u, (t, _) in ref.items()})
    del model
    torch.cuda.empty_cache()
    row("p7 sharded decode", held=held,
        kv_heads_local=dec["kv_heads_local"])
    mt = by["p8 mt app"][0]
    got, want = mt["epochs"][0], single["epochs"][0]
    ref = single["losses"][0]

    def drift(losses):
        return [abs(a - b) / abs(b) for a, b in zip(losses, ref)]

    mesh_drift, twin_drift = drift(mt["losses"][0]), drift(twin["losses"][0])
    limits = [1e-5 if i < PAR_MT_EXACT_STEPS else PAR_MT_DRIFT
              for i in range(len(ref))]
    check(len(mt["losses"][0]) == len(ref) > PAR_MT_EXACT_STEPS
          and all(d <= lim for d, lim in zip(mesh_drift, limits)),
          f"p8: the mesh's step losses {mt['losses'][0]} against the "
          f"single-process run's {ref}: relative {mesh_drift} beyond "
          f"{limits}")
    check(all(r["losses"] == mt["losses"] for r in by["p8 mt app"]),
          "p8: the ranks logged other losses")
    check(mt["bleu"] and math.isfinite(mt["bleu"][0]["bleu"]),
          f"p8: BLEU {mt['bleu']}")
    row("p8 mt app", argv=PAR_MT + PAR_MT_MESH,
        single_process_argv=PAR_MT + PAR_MT_SINGLE, epoch=got,
        single_process_epoch=want, step_losses=mt["losses"][0],
        single_process_step_losses=ref, step_drift=mesh_drift,
        twin_argv=PAR_MT + PAR_MT_TWIN, twin_step_drift=twin_drift,
        step_limits={"exact_steps": PAR_MT_EXACT_STEPS,
                     "exact": 1e-5, "after": PAR_MT_DRIFT},
        bleu=mt["bleu"], single_process_bleu=single["bleu"],
        single_process_seconds=single_s)
    launches.update(nccl_world(smi))
    log({"phase": "parallel_modes_total",
         "seconds": time.perf_counter() - t0, "world_seconds": world_s,
         "launches": dict(launches), "card": smi,
         "note": "4 ranks share one card over gloo-host: no multi-card "
                 "speed"})
    return dict(launches)


def nccl_world(smi: str) -> dict[str, int]:
    """(p9): a world of one over NCCL, a DP x TP (1 x 1) step at the
    reference MT widths against the single-process port, and comm's
    primitives and differentiable forms on CUDA tensors over the world
    group.  Returns its launches."""
    t = time.perf_counter()
    nccl = pdry.run_world("tpu_flash_torch.parallel.dryrun.rank_nccl_step",
                          1, device="cuda", backend="nccl", timeout=300,
                          config_kw={**REF, "p_dropout": 0.0},
                          batch=pdry.dryrun_batch(8, REF_L, REF["n_vocab"],
                                                  segments=False))[0]
    nccl_s = time.perf_counter() - t
    c = nccl["collectives"]
    check(nccl["backend"] == "nccl" and nccl["transport_world"] == "nccl"
          and c["all_reduce"] == list(range(8))
          and c["reduce_scatter"] == list(range(8))
          and c["grad"] == [2.0] * 8 and nccl["launches"]
          and abs(nccl["loss"][0] - nccl["ref_loss"])
          <= 1e-5 * abs(nccl["ref_loss"]),
          f"p9: the NCCL world of one: {nccl}")
    log({"phase": "parallel_modes", "mode": "p9 nccl world of one",
         "backend": nccl["backend"], "collectives": c,
         "loss": nccl["loss"][0], "single_process_loss": nccl["ref_loss"],
         "seconds": nccl_s, "card": smi})
    return nccl["launches"]


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
    t_times = time.perf_counter()
    rows = kernel_times(gen)
    log({"phase": "kernel_times_total",
         "seconds": time.perf_counter() - t_times})

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
    # speculative decoding and the shared-prefix cache on the same model
    launches["flash_decode"] += speculative_serving(model)
    launches["flash_decode"] += prefix_serving(model)
    del model
    torch.cuda.empty_cache()
    # the rotary + MoE model behind the engine, every forward held
    launches["flash_decode"] += moe_rope_serving()
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
        # (b) with rotary positions and the routed feed-forward (8 experts,
        # top-2) on the objective ce + aux_weight * aux
        training("(m) prod-rope-moe-top2-flash-bf16-mixed-precision-adam-"
                 "dropout", TRAIN_MOE, prod, torch.bfloat16, 0.1,
                 mixed_precision(adam(lr=1e-3)), flash_tc,
                 make_step=moe_train_step),
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
    # mode (m)'s config in fp32: loss, router term, gradients and updated
    # parameters through the six-product forms against the plain versions
    moe_e2e = training_end_to_end(
        "prod-rope-moe-top2", TRAIN_MOE, prod, make_step=moe_train_step,
        launches=dict.fromkeys(ATTENTION_X6, 4))
    for row in (packed_e2e, window_e2e, *drop_e2e, *kvq_e2e(packed),
                moe_e2e):
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
    # the MT app's CLI, this slice's main path: its flash, decode and
    # LayerNorm launches join the kernels line's
    for n, c in mt_app().items():
        launches[n] += c
    # this slice's paths: the points classifier, conv/pool, grad_check over
    # the training kernels, the MT app under --profile, the timing harness
    t_utils = time.perf_counter()
    points()
    conv_pool(gen)
    grad_check_kernels(gen)
    for n, c in mt_profile().items():
        launches[n] += c
    timing_harness(gen)
    log({"phase": "single_card_utilities_total",
         "seconds": time.perf_counter() - t_utils})
    # this slice's path: the parallel modes at 4 ranks on this card; the
    # ranks' launches join the kernels line's
    for n, c in parallel_modes().items():
        launches[n] = launches.get(n, 0) + c

    main_row = next(r for r in rows if r["cache"] == "int8"
                    and r["length"] == 1024 and r["lq"] == 1)
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
        "other_shapes": {f"Lq{r['lq']}, {r['cache']} cache, lengths "
                         f"{r['length']}": {k: r[k] for k in timed
                                            + ("over_lq1", "max_abs_err")}
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
