"""Time two trees of the port on one card, in turns (A, B, B, A), each turn
in a process of its own: the flash-attention forward and fused backward
(``_launch_forward`` / ``_launch_backward`` of ``kernels/flash_attention.py``)
and the two-pass backward's dK/dV and dQ kernels (``_launch_dkv`` /
``_launch_dq``), each alone, in the form the tree picks for the dtype, at
the shapes below (causal, d 64; CUDA events, the median of 5 batches), with
a check that two calls of each backward give the same bits; and the
quantized matmuls (``int8_matmul`` / ``int4_matmul`` of
``kernels/quant.py``, int8, int4 and int4 in groups of 128) at bf16 decode
(M 8) on each linear of the 176M serving model and at one 1024-token
prefill, and int8, int4 and int4 in groups of 128 at fp32 decode (M 8) on
each serving linear and at fp32 prefills of 16, 64, 128, 256 and 1024
tokens at K1024 N4096, weights rotating past the 50 MB L2, with the same
check, beside cuBLAS's fp32 ``x @ W`` against the weight dequantized once
at each fp32 shape (the same for every tree: a yardstick, never called by
the port); the fused LayerNorm forward at R8192 H256 and H512 (fp32 and
bf16; H512 is mode (e)'s) and backward at R8192 H256 (fp32 and bf16) and H512
(the production width, fp32 and bf16), the masked softmax forward and
backward (fp32 and bf16, the dtypes modes (c) and (d) give them) at B32 H8
L256 causal (the reference MT shapes), and flash decode at
B8 H16 d64 over int8 and bf16 caches of 8192 positions at lengths 1024 and
8192, inputs rotating past the L2, with the same check (each call of the
LayerNorm backward timed whole: dx, dgamma and dbeta); the kernels' summed
device time of one decode step of the 176M serving model (8 layers, bf16
weights, 8 sequences of ~1024 tokens, int8 and bf16 caches of 8192
positions), all of them and flash decode's (the profiler's sum, ``clock``
``kernels``: a decode step's host is slower than the card), and the same
of one fp32 decode step of that model at 2 layers with int8, per-column
int4 and grouped int4 weights (``chip_smoke.py``'s ``end_to_end``: 13
quantized
Linears a step), all kernels and the quantized matmuls' (their reduction
kernel included); and the host's time to issue one quantized Linear call
(``int8_linear`` / ``int4_linear`` under ``torch.no_grad``, as serving
calls them) at bf16 and fp32 decode on each serving linear, the stream
held so that the host never waits for the card (``host_us``; these rows'
``clock`` is ``host``); and
the device time of one training step of ``chip_smoke.py``'s long-two-pass
config (the production widths, 2 layers, L 8192, remat, the chunked loss
over 8 pieces, fp32), where the backward takes the two passes, the stream
held while the host queues it; and the kernels' summed device time a step
(the profiler's sum, ``clock`` ``kernels``), all of them and the softmax
forward's, of its training modes (c) and (d) (the reference MT config,
fused attention and fused LayerNorm, B32 L256, fp32 Adam, and bf16 mixed
precision with dropout 0.1), whose host issues a step slower than the card
runs it, so that a held stream fills before the step is queued.

    PYTHONPATH=. python3 tools/torch_ab.py A_ROOT B_ROOT

A_ROOT and B_ROOT are checkouts of the repository (for example the parent
commit unpacked with ``git archive`` into a directory ``.gitignore`` lists,
and ``.``).  Each turn imports ``tpu_flash_torch`` from its root and builds
that tree's kernels there; every turn times with this tree's
``tpu_flash_torch/utils/timing.py``.  It prints one JSON line a turn and a
summary with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

# (dtype, B, H, L): causal, d 64.  B4 H8 L2048 is the production training
# shape (the JAX rule takes the fused backward there: modes (a), (b), (e));
# B1 H8 L16384 bf16 mode (f)'s, where the rule takes the two passes; L8192
# fp32 the fp32 two-pass shape.
FWD_BWD_SHAPES = (("bfloat16", 4, 8, 2048), ("bfloat16", 1, 8, 16384),
                  ("float32", 4, 8, 2048))
TWO_PASS_SHAPES = (("bfloat16", 1, 8, 16384), ("bfloat16", 4, 8, 2048),
                   ("float32", 1, 8, 8192))
# (kind, group), and (M, K, N) of bf16 x: decode on the serving linears (q,
# k, v and out; FF in; FF out; lm_head), then one prefill.
QUANT_KINDS = (("int8", None), ("int4", None), ("int4_g128", 128))
QUANT_SHAPES = tuple((8, K, N) for K, N in ((1024, 1024), (1024, 4096),
                                            (4096, 1024), (1024, 32768))
                     ) + ((1024, 1024, 4096),)
# fp32 x: prefills at the FF-in linear, for the kinds with an fp32 tensor-core
# prefill form; M 16 to 128 are the short prompts of fp32 serving, where
# most of the form's 128-row tile is empty.
QUANT_FP32_KINDS = (("int8", None), ("int4", None), ("int4_g128", 128))
QUANT_FP32_SHAPES = QUANT_SHAPES[:4] + tuple(
    (M, 1024, 4096) for M in (16, 64, 128, 256, 1024))
# Training steps (label, config, B, L, dtype, dropout, chunked_vocab,
# clock): chip_smoke.py's long-two-pass step (TRAIN_LONG at 2 layers), and
# its modes (c) and (d) (REF).
TRAIN_LONG = dict(n_vocab=10_000, n_embd=512, n_head=8, n_positions=8192,
                  n_layer=2, ff_middle_dim=256, attention_kind="flash",
                  remat=True)
TRAIN_REF = dict(n_vocab=10_000, n_embd=256, n_head=8, n_positions=256,
                 n_layer=4, ff_middle_dim=256, attention_kind="fused",
                 use_fused_kernel=True)
TRAIN_STEPS = (("long-two-pass", TRAIN_LONG, 1, 8192, "float32", 0.0, 8,
                "device"),
               ("(c) ref fused", TRAIN_REF, 32, 256, "float32", 0.0, 0,
                "kernels"),
               ("(d) ref fused mixed", TRAIN_REF, 32, 256, "bfloat16", 0.1,
                0, "kernels"))
TIMING = (Path(__file__).resolve().parents[1] / "tpu_flash_torch" / "utils"
          / "timing.py")


def inputs_at(torch, fa, shape, gen):
    """q, k, v, the backward kernels' inputs and the shape's label."""
    dname, B, H, L = shape
    dtype = getattr(torch, dname)
    q, k, v, do = (torch.randn(B, H, L, 64, generator=gen, device="cuda"
                               ).to(dtype) for _ in range(4))
    out, lse, _ = fa.flash_attention_forward(q, k, v, causal=True)
    kin = (*fa._bwd_inputs(q, k, v, out, lse, do, None), True,
           1 / math.sqrt(64), 0)
    return q, k, v, kin, f"B{B} H{H} L{L} d64 causal"


def timing():
    """This tree's timing module, loaded from its file, so that both turns'
    trees are timed by the same code."""
    spec = importlib.util.spec_from_file_location("ab_timing", TIMING)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def timed_rows(torch, fa, device_ms) -> list[dict]:
    gen = torch.Generator("cuda").manual_seed(0)
    rows = []

    def add(what, dname, shape, fn, same, B, L):
        iters = max(1, round(4 * 2048 ** 2 * 10 / (B * L * L)))
        rows.append({"what": what, "dtype": dname, "shape": shape,
                     "ms": device_ms(fn, warmup=1, iters=iters, reps=5),
                     "two_calls_same_bits": same})

    for dname, B, H, L in FWD_BWD_SHAPES:
        q, k, v, kin, shape = inputs_at(torch, fa, (dname, B, H, L), gen)
        first, second = fa._launch_backward(*kin), fa._launch_backward(*kin)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        add("fwd", dname, shape, lambda: fa._launch_forward(
            q, k, v, True, None, None, False), None, B, L)
        add("bwd_fused", dname, shape, lambda: fa._launch_backward(*kin),
            same, B, L)
        del q, k, v, kin, first, second
        torch.cuda.empty_cache()
    for dname, B, H, L in TWO_PASS_SHAPES:
        q, k, v, kin, shape = inputs_at(torch, fa, (dname, B, H, L), gen)

        def pair():
            return (*fa._launch_dkv(*kin), fa._launch_dq(*kin))

        first, second = pair(), pair()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        add("dkv", dname, shape, lambda: fa._launch_dkv(*kin), same, B, L)
        add("dq", dname, shape, lambda: fa._launch_dq(*kin), same, B, L)
        del q, k, v, kin, first, second
        torch.cuda.empty_cache()
    return rows


def quant_rows(torch, quant, timer) -> list[dict]:
    gen = torch.Generator("cuda").manual_seed(0)
    rows, hosts = [], []
    cases = [(kind, group, shape, torch.bfloat16)
             for kind, group in QUANT_KINDS for shape in QUANT_SHAPES] + [
                 (kind, group, shape, torch.float32)
                 for kind, group in QUANT_FP32_KINDS
                 for shape in QUANT_FP32_SHAPES]
    for kind, group, (M, K, N), dtype in cases:
        w = torch.randn(K, N, generator=gen, device="cuda")
        if kind == "int8":
            q = quant.quantize_weight(w)

            def call(x, *q):
                return quant.int8_matmul(x, *q)

            qw = quant.QuantizedLinearWeights(*q)
            linear = quant.int8_linear
        else:
            q = quant.quantize_weight_int4(w, group_size=group)[:2]

            def call(x, *q):
                return quant.int4_matmul(x, *q, k_dim=K)

            qw = quant.QuantizedLinearWeights4(*q, K)
            linear = quant.int4_linear
        x = torch.randn(M, K, generator=gen, device="cuda", dtype=dtype)
        same = torch.equal(call(x, *q), call(x, *q))
        rows.append({"what": f"quant {kind}",
                     "dtype": str(dtype).split(".")[1],
                     "shape": f"M{M} K{K} N{N}", "clock": "device",
                     "ms": timer.rotating_ms(
                         lambda *w: call(x, *w), timer.past_l2(*q),
                         iters=20, reps=5),
                     "two_calls_same_bits": same})
        if M <= 8:
            with torch.no_grad():
                us = timer.host_us(lambda: linear(x, qw))
            hosts.append({"what": f"host {kind} linear",
                          "dtype": str(dtype).split(".")[1],
                          "shape": f"M{M} K{K} N{N}", "clock": "host",
                          "ms": us * 1e-3, "two_calls_same_bits": same})
        del w, q, qw
    for M, K, N in QUANT_FP32_SHAPES:
        # the yardstick: cuBLAS's fp32 GEMM (TF32 off) on the weight
        # dequantized once, as chip_smoke.py's library_ms
        w = torch.randn(K, N, generator=gen, device="cuda")
        x = torch.randn(M, K, generator=gen, device="cuda")
        rows.append({"what": "cublas x @ W dequantized", "dtype": "float32",
                     "shape": f"M{M} K{K} N{N}", "clock": "device",
                     "ms": timer.rotating_ms(lambda d: x @ d,
                                             timer.past_l2(w), iters=20,
                                             reps=5),
                     "two_calls_same_bits": None})
        del w, x
    return rows + hosts


def other_rows(torch, timer) -> list[dict]:
    """The LayerNorm, softmax and decode kernels at PERF.md §6's shapes."""
    from tpu_flash_torch.kernels.decode import flash_decode_attention
    from tpu_flash_torch.kernels.layernorm import (layernorm_backward,
                                                   layernorm_forward)
    from tpu_flash_torch.kernels.softmax import (attn_softmax_backward,
                                                 attn_softmax_forward)

    gen = torch.Generator("cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    R, H = 8192, 256
    x, dy, g, b = randn(R, H), randn(R, H), 1 + 0.1 * randn(H), randn(H)
    _, mean, var = layernorm_forward(x, g, b)
    s = randn(32, 8, 256, 256)
    s16 = s.to(torch.bfloat16)
    p, dp = attn_softmax_forward(s, mask_future=True), randn(*s.shape)
    B, Hq, d, S = 8, 16, 64, 8192
    k, v = (torch.randint(-127, 128, (B, S, Hq * d), generator=gen,
                          device="cuda", dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(B, Hq, S, generator=gen, device="cuda") / 64
              for _ in range(2))
    k16, v16 = (randn(B, S, Hq * d).to(torch.bfloat16) for _ in range(2))
    q = randn(B, Hq, 1, d).to(torch.bfloat16)

    def ln_fwd(dname, H):
        """(name, dtype, shape, operands, call) of the forward at R x H."""
        dt = getattr(torch, dname)
        g, b = (1 + 0.1 * randn(H)).to(dt), (0.1 * randn(H)).to(dt)
        return ("layernorm fwd", dname, f"R{R} H{H}", (randn(R, H).to(dt),),
                lambda x: layernorm_forward(x, g, b))

    def ln_bwd(dname, H):
        """(name, dtype, shape, operands, call) of the backward at R x H."""
        dt = getattr(torch, dname)
        x, dy = randn(R, H).to(dt), randn(R, H).to(dt)
        g = (1 + 0.1 * randn(H)).to(dt)
        _, mean, var = layernorm_forward(x, g, torch.zeros_like(g))
        return ("layernorm bwd", dname, f"R{R} H{H}", (dy, x, mean, var),
                lambda dy, x, mean, var: layernorm_backward(dy, x, g, mean,
                                                            var))

    def decode(cache, L):
        lengths = torch.full((B,), L, dtype=torch.int32, device="cuda")
        if cache == "int8":
            return ("flash decode", "bfloat16",
                    f"B{B} H{Hq} d{d} S{S} int8 cache, length {L}",
                    (k, v, ks, vs),
                    lambda k, v, ks, vs: flash_decode_attention(
                        q, k, v, lengths, ks, vs))
        return ("flash decode", "bfloat16",
                f"B{B} H{Hq} d{d} S{S} bf16 cache, length {L}", (k16, v16),
                lambda k, v: flash_decode_attention(q, k, v, lengths))

    cases = (
        ("layernorm fwd", "float32", f"R{R} H{H}", (x,),
         lambda x: layernorm_forward(x, g, b)),
        ("layernorm bwd", "float32", f"R{R} H{H}", (dy, x, mean, var),
         lambda dy, x, mean, var: layernorm_backward(dy, x, g, mean, var)),
        ("softmax fwd", "float32", "B32 H8 L256 causal", (s,),
         lambda s: attn_softmax_forward(s, mask_future=True)),
        ("softmax fwd", "bfloat16", "B32 H8 L256 causal", (s16,),
         lambda s: attn_softmax_forward(s, mask_future=True)),
        ("softmax bwd", "float32", "B32 H8 L256 causal", (p, dp),
         attn_softmax_backward),
        decode("int8", 1024),
        ln_bwd("bfloat16", 256), ln_bwd("float32", 512),
        ln_bwd("bfloat16", 512),
        decode("bf16", 1024), decode("int8", 8192), decode("bf16", 8192),
        ln_fwd("bfloat16", 256), ln_fwd("bfloat16", 512),
        ln_fwd("float32", 512),
        ("softmax bwd", "bfloat16", "B32 H8 L256 causal",
         (attn_softmax_forward(s16, mask_future=True),
          dp.to(torch.bfloat16)), attn_softmax_backward))
    rows = []
    for what, dname, shape, args, fn in cases:
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        if isinstance(first, torch.Tensor):
            first, second = (first,), (second,)
        rows.append({"what": what, "dtype": dname, "shape": shape,
                     "clock": "device",
                     "ms": timer.rotating_ms(fn, timer.past_l2(*args),
                                             iters=20, reps=5),
                     "two_calls_same_bits": all(
                         torch.equal(a, c) for a, c in zip(first, second))})
    return rows


def kernel_ms(torch, fn, keys=("",), calls=2, reps=7) -> list[float]:
    """Medians over ``reps`` profiler traces of ``calls`` calls of ``fn``
    of the summed device time a call of the kernels whose names hold each
    of ``keys`` (``""``: every kernel).  A trace now and then holds no
    device event (PERF.md §7); such a trace is taken again, up to ``reps``
    times in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    sums, empty = [], 0
    while len(sums) < reps:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if not events:
            empty += 1
            if empty == reps:
                raise RuntimeError(f"{reps} profiler traces held no kernel")
            continue
        sums.append([sum(e.self_device_time_total for e in events
                         if k in e.key) / calls / 1e3 for k in keys])
    return [statistics.median(col) for col in zip(*sums)]


def decode_step_rows(torch) -> list[dict]:
    """The kernels' summed device time of one decode step of the 176M
    serving model (``chip_smoke.py``'s SERVING: 8 layers, E 1024, 16
    heads, bf16 weights from a seed), 8 sequences of 1024 prompt tokens
    in caches of 8192 positions, int8 and bf16: all of them and flash
    decode's.  Each step appends a token, so the traces read lengths
    1024 to ~1040."""
    from tpu_flash_torch.inference.sampler import prefill_prompt
    from tpu_flash_torch.nn import DecoderConfig, DecoderLM, init_params

    cfg = DecoderConfig(n_vocab=32768, n_embd=1024, n_head=16,
                        n_positions=8192, n_layer=8, ff_middle_dim=4096,
                        p_dropout=0.0, attention_kind="flash",
                        dtype=torch.bfloat16)
    model = DecoderLM(cfg, device="cuda")
    init_params(model, torch.Generator("cuda").manual_seed(0))
    B, L = 8, 1024
    gen = torch.Generator("cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.n_vocab, (B, L), generator=gen,
                           device="cuda")
    rows = []
    for quant in ("int8", "none"):
        with torch.no_grad():
            logits, caches = prefill_prompt(
                model, prompt, torch.full((B,), L, device="cuda"),
                max_len=cfg.n_positions, kv_quant=quant)
            tok = logits.argmax(-1)[:, None]

            def step():
                return model(tok, kv_caches=caches,
                             positions=caches[0].lengths[:, None].long())

            ms = kernel_ms(torch, step, ("", "flash_decode"))
        cache = "bf16" if quant == "none" else quant
        rows += [{"what": what, "dtype": "bfloat16",
                  "shape": f"176M, 8 layers, B{B}, {cache} cache near "
                           f"length {L}",
                  "clock": "kernels", "ms": t, "two_calls_same_bits": None}
                 for what, t in zip(("decode step, kernels",
                                     "decode step, flash decode kernels"),
                                    ms)]
        del caches
    del model
    torch.cuda.empty_cache()
    return rows


def fp32_decode_step_rows(torch) -> list[dict]:
    """The kernels' summed device time of one decode step of the 176M
    serving model at 2 layers in fp32 (``chip_smoke.py``'s ``end_to_end``:
    weights from a seed, TF32 off) with its Linears quantized to int8, to
    int4 per column and to int4 in groups of 128, 8 sequences of 1024
    prompt tokens in fp32 caches of 2048 positions: all kernels and the
    quantized matmuls' (the names holding ``_matmul``: each form's kernel
    and the CUDA-core form's reduction kernel)."""
    from tpu_flash_torch.inference.sampler import prefill_prompt
    from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, init_params,
                                    quantize_model_linears)

    cfg = DecoderConfig(n_vocab=32768, n_embd=1024, n_head=16,
                        n_positions=8192, n_layer=2, ff_middle_dim=4096,
                        p_dropout=0.0, attention_kind="naive",
                        dtype=torch.float32)
    B, L = 8, 1024
    gen = torch.Generator("cuda").manual_seed(4)
    prompt = torch.randint(0, cfg.n_vocab, (B, L), generator=gen,
                           device="cuda")
    rows = []
    for kind, bits, group in (("int8", 8, None), ("int4", 4, None),
                              ("int4_g128", 4, 128)):
        model = DecoderLM(cfg, device="cuda")
        init_params(model, torch.Generator("cuda").manual_seed(1))
        quantize_model_linears(model, bits=bits, group_size=group)
        with torch.no_grad():
            logits, caches = prefill_prompt(
                model, prompt, torch.full((B,), L, device="cuda"),
                max_len=2 * L)
            tok = logits.argmax(-1)[:, None]

            def step():
                return model(tok, kv_caches=caches,
                             positions=caches[0].lengths[:, None].long())

            ms = kernel_ms(torch, step, ("", "_matmul"))
        rows += [{"what": what, "dtype": "float32",
                  "shape": f"176M, 2 layers, {kind} weights, B{B}, fp32 "
                           f"cache near length {L}",
                  "clock": "kernels", "ms": t, "two_calls_same_bits": None}
                 for what, t in zip(("fp32 decode step, kernels",
                                     "fp32 decode step, quantized matmul "
                                     "kernels"), ms)]
        del model, caches
        torch.cuda.empty_cache()
    return rows


def train_rows(torch, device_ms) -> list[dict]:
    """Each of ``TRAIN_STEPS`` (Adam, in mixed precision for bf16; random
    weights and tokens from seeds): the device time of one step, the stream
    held while the host queues it, or its kernels' summed time a step and
    the softmax forward's."""
    import numpy as np

    from tpu_flash_torch.apps.machine_translation import (make_train_step,
                                                         place_batch)
    from tpu_flash_torch.nn import (DecoderConfig, DecoderLM, adam,
                                    init_params, mixed_precision)

    rows = []
    for label, config, B, L, dname, dropout, chunks, clock in TRAIN_STEPS:
        dtype = getattr(torch, dname)
        cfg = DecoderConfig(**config, p_dropout=dropout, dtype=dtype)
        model = DecoderLM(cfg, device="cuda")
        init_params(model, torch.Generator("cuda").manual_seed(2))
        opt = adam(lr=1e-3)
        if dtype == torch.bfloat16:
            opt = mixed_precision(opt)
        state = opt.init(dict(model.named_parameters()))
        rng = np.random.default_rng(1)
        batch = place_batch(
            {"input_ids": rng.integers(0, cfg.n_vocab, (B, L)),
             "labels": rng.integers(0, cfg.n_vocab, (B, L)),
             "label_token_weights": (rng.random((B, L)) > 0.5
                                     ).astype(np.float32)}, "cuda")
        step = make_train_step(model, opt, chunked_vocab=chunks)
        shape = f"E{cfg.n_embd} {cfg.n_layer} layers B{B} L{L}"
        if clock == "device":
            ms = [device_ms(lambda: step(state, batch), warmup=1, iters=1,
                            reps=5, hold_cycles=400_000_000)]
            whats = [f"train step {label}"]
        else:
            ms = kernel_ms(torch, lambda: step(state, batch),
                           ("", "attn_softmax_fwd"))
            whats = [f"train step {label}, kernels",
                     f"train step {label}, softmax fwd kernels"]
        rows += [{"what": what, "dtype": dname, "shape": shape,
                  "clock": clock, "ms": t, "two_calls_same_bits": None}
                 for what, t in zip(whats, ms)]
        del model, state, opt, step
        torch.cuda.empty_cache()
    return rows


def one(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from tpu_flash_torch.kernels import common, flash_attention as fa, quant

    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 GEMMs in fp32
    where = Path(fa.__file__).resolve()
    assert Path(root).resolve() in where.parents, where
    common.build([fa.KERNEL_FWD, fa.KERNEL_BWD, fa.SOURCE_TWO_PASS,
                  quant.KERNEL_INT8, quant.KERNEL_INT4, "layernorm_fwd",
                  "layernorm_bwd", "attn_softmax_fwd", "attn_softmax_bwd",
                  "flash_decode"])
    timer = timing()
    return {"root": root, "rows": timed_rows(torch, fa, timer.device_ms)
            + quant_rows(torch, quant, timer) + other_rows(torch, timer)
            + decode_step_rows(torch) + fp32_decode_step_rows(torch)
            + train_rows(torch, timer.device_ms)}


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
        vals = {r: [x["rows"][i]["ms"] for x in runs if x["root"] == r]
                for r in (a, b)}
        summary.append({
            "what": row["what"], "dtype": row["dtype"], "shape": row["shape"],
            "clock": row.get("clock", "device"), "a_ms": vals[a],
            "b_ms": vals[b],
            "b_over_a": statistics.mean(vals[b]) / statistics.mean(vals[a]),
            "same_bits": [x["rows"][i]["two_calls_same_bits"]
                          for x in runs]})
    print(json.dumps({"summary": summary, "turns": [r["root"] for r in runs],
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
