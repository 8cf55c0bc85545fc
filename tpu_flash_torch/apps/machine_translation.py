"""The machine-translation app, counterpart of
``tpu_flash/apps/machine_translation.py``: corpus -> byte-level BPE ->
batches (fixed-length, or sequence-packed with ``--pack``; from the C++
batch ring with ``--native-loader``) -> decoder-only LM trained with masked
MLE (the model's kernels: flash attention, or the fused masked softmax,
and the fused LayerNorm with ``--use-fused-kernel``) -> greedy or beam
generation over the KV cache (the flash-decode kernel) -> corpus BLEU, with
checkpoints, resume and a JSONL metrics log.

The JAX step is one jitted program over an external parameter tree; here
the parameters live in the module, the step runs eagerly, and the
optimizer's new values are copied into the parameters in place.

Run on the card: ``python -m tpu_flash_torch.apps.machine_translation
--dataset local``; on the CPU: ``main([...], device="cpu")``.

Deviations from the JAX app:
  * ``--dataset`` takes the corpora in the repository only (``local``,
    ``deen``, ``local-deen``, ``local-comp``) and defaults to ``local``;
    any other name raises (``data.mt.get_dataset``);
  * ``--native-loader`` raises where the C++ loader cannot be built (the
    JAX app goes on with the Python collate);
  * not ported yet, each raising ``NotImplementedError`` with its
    ROADMAP.md item: ``--dp``/``--tp``/``--dcn-data`` above 1, ``--zero1``
    and ``--sequence-parallel`` (A8, as ``ctx=`` on ``train_epoch``,
    ``evaluate_loss`` and ``generate_translations``), ``--profile`` (A9b).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from tpu_flash_torch.data import mt
from tpu_flash_torch.inference.beam import beam_generate
from tpu_flash_torch.inference.sampler import SamplingConfig, generate
from tpu_flash_torch.kernels.common import resolve_device
from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.nn.module import init_params, num_parameters
from tpu_flash_torch.nn.optim import (accumulate_gradients, adam,
                                      mixed_precision)
from tpu_flash_torch.nn.transformer import (DecoderConfig, DecoderLM,
                                            _not_ported)
from tpu_flash_torch.utils.bleu import corpus_bleu
from tpu_flash_torch.utils.checkpoint import (AsyncCheckpointer,
                                              restore_checkpoint,
                                              restore_like)
from tpu_flash_torch.utils.metrics import MetricsLogger


def _no_ctx(ctx, what: str) -> None:
    if ctx is not None:
        raise _not_ported(f"{what} under a parallel context (ctx)", "A8")


def make_loss_fn(model, chunked_vocab: int = 0):
    """``loss_fn(batch, *, generator=None, training=False, impl=None)``:
    masked MLE, ``sum(losses * label_token_weights)`` over every position,
    divided by the number of positions (or by ``batch["loss_norm"]`` for
    packed batches).  ``chunked_vocab`` > 0 takes the post-LN hidden state
    (``return_hidden``) through ``F.chunked_softmax_loss`` with lm_head's
    weight and bias in that many vocab slices: the [B, L, V] logits are
    never materialized.  ``impl`` reaches the kernels' wrappers."""

    def loss_fn(batch, *, generator=None, training: bool = False,
                impl=None):
        out = model(batch["input_ids"],
                    segment_ids=batch.get("segment_ids"),
                    positions=batch.get("positions"),
                    training=training, generator=generator, impl=impl,
                    return_hidden=chunked_vocab > 0)
        if chunked_vocab > 0:
            lm = model.lm_head
            losses = F.chunked_softmax_loss(out, lm.weight, lm.bias,
                                            batch["labels"],
                                            n_chunks=chunked_vocab)
        else:
            losses = F.softmax_loss(out, batch["labels"])
        weighted = losses * batch["label_token_weights"]
        if "loss_norm" in batch:
            return weighted.sum() / batch["loss_norm"]
        return weighted.sum() / weighted.numel()

    return loss_fn


def make_train_step(model, opt, chunked_vocab: int = 0,
                    accum_steps: int = 1, impl=None):
    """``train_step(opt_state, batch, generator=None) -> (opt_state,
    loss)``: forward and backward with training dropout (``chunked_vocab``
    as in ``make_loss_fn``), then ``opt``'s
    update copied into the parameters.  The loss stays a device tensor (no
    host sync).  Dropout draws from ``generator``, or, where the caller
    gives none, from the step's own generator on the model's device, seeded
    with 0 (the JAX step always takes a key, so it always drops).
    With ``accum_steps > 1`` the batch is split into that many microbatches
    along its first axis (scalars such as ``loss_norm`` are divided by it)
    whose fp32 gradients are averaged; otherwise the step's gradients stay
    in each parameter's ``.grad`` until the next step."""
    loss_fn = make_loss_fn(model, chunked_vocab=chunked_vocab)
    params = dict(model.named_parameters())
    own_generator = torch.Generator(model.device).manual_seed(0)

    def micro_loss(micro, generator):
        return loss_fn(micro, generator=generator, training=True, impl=impl)

    compute = accumulate_gradients(micro_loss, params, accum_steps)

    def split(v):
        if v.dim() == 0:
            return (v.float() / accum_steps).expand(accum_steps)
        return v.reshape(accum_steps, v.shape[0] // accum_steps,
                         *v.shape[1:])

    def train_step(opt_state, batch, generator=None):
        if generator is None:
            generator = own_generator
        if accum_steps > 1:
            loss, grads = compute({k: split(v) for k, v in batch.items()},
                                  generator)
        else:
            for p in params.values():
                p.grad = None
            loss = micro_loss(batch, generator)
            loss.backward()
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in params.items()}
        with torch.no_grad():
            new, opt_state = opt.update(
                grads, opt_state, {n: p.detach() for n, p in params.items()})
            for n, p in params.items():
                p.copy_(new[n])
        return opt_state, loss.detach()

    return train_step


def place_batch(batch, device):
    """Host arrays (numpy or tensors) to tensors on ``device``, without
    making the host wait for the card: a host array bound for the card is
    staged in pinned memory and copied with ``non_blocking=True``, so the
    copy queues behind the steps already on the stream (a copy from pageable
    memory would synchronize the stream, as JAX's ``device_put`` does not).
    Tensors already on ``device`` are kept as they are."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def train_epoch(model, opt, opt_state, examples, collate_fn, batch_size, *,
                seed: int = 0, generator=None, n_samples=None, max_iters=None,
                log_every: int = 10, native_loader=None, metrics=None,
                train_step=None, chunked_vocab: int = 0, ctx=None,
                log=print):
    """One training epoch.  Returns ``(opt_state, losses, step_times,
    step_tokens)``: the parameters are the module's own and change in place,
    so where the JAX loop also returns them this one returns the optimizer
    state alone beside the JAX loop's three results.

    The order of ``examples`` is shuffled with numpy's generator from
    ``seed``; with a ``native_loader`` (``data.native_loader.
    NativeBatchLoader``) the batches come from its C++ ring instead, packed
    on its own threads.  Dropout draws from ``generator``, or where none is
    given from a generator on the model's device seeded from ``seed`` (the
    JAX loop always splits its key for the step).  Batches reach the card
    through ``place_batch``, which does not wait for it.  As in the JAX loop
    the host syncs (reads the loss) only every ``log_every`` steps and at
    the last, so steps queue back to back in between; a step's time is its
    window's host time over the window's steps, and the first window
    (kernel builds, warm-up) is left out of ``step_times``.  At each such
    read ``metrics`` (a ``utils.metrics.MetricsLogger``) logs the step,
    loss, ms a step and tokens/s.  Without a ``train_step`` the loop builds
    ``make_train_step(model, opt, chunked_vocab=chunked_vocab)``, as the
    JAX loop does.  ``ctx`` (a parallel mesh) is A8's."""
    _no_ctx(ctx, "train_epoch")
    if train_step is None:
        train_step = make_train_step(model, opt, chunked_vocab=chunked_vocab)
    if generator is None:
        generator = torch.Generator(model.device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(examples))
    if n_samples:
        order = order[:n_samples]
    n_batches = len(order) // batch_size
    if max_iters is not None:
        n_batches = min(n_batches, max_iters)
    losses_dev, step_times, step_tokens = [], [], 0
    mark_t, mark_it = time.perf_counter(), 0
    for it in range(n_batches):
        if native_loader is not None:
            batch = native_loader.next()
        else:
            idx = order[it * batch_size:(it + 1) * batch_size]
            batch = collate_fn([examples[i] for i in idx])
        if "segment_ids" in batch and "loss_norm" not in batch:
            batch["loss_norm"] = np.float32(
                batch_size * np.shape(batch["input_ids"])[1])
        batch = place_batch(batch, model.device)
        opt_state, loss = train_step(opt_state, batch, generator)
        losses_dev.append(loss)
        step_tokens = batch["input_ids"].numel()
        if it % log_every == 0 or it == n_batches - 1:
            loss_h = float(loss)                 # host sync closes window
            now = time.perf_counter()
            n_win = it - mark_it + 1
            dt = (now - mark_t) / n_win
            if mark_it > 0:
                step_times.extend([dt] * n_win)
            mark_t, mark_it = now, it + 1
            if log is not None:
                log(f"  it {it}/{n_batches}  loss {loss_h:.4f}  "
                    f"tokens/sec {step_tokens / dt:,.0f}")
            if metrics is not None:
                metrics.log(step=it, loss=loss_h,
                            step_ms=round(dt * 1e3, 2),
                            tokens_per_sec=round(step_tokens / dt))
    losses = [float(l) for l in losses_dev]
    return opt_state, losses, step_times, step_tokens


@torch.no_grad()
def evaluate_loss(model, examples, collate_fn, batch_size,
                  chunked_vocab: int = 0, ctx=None) -> float:
    """Mean loss over whole batches of ``examples`` (no dropout)."""
    _no_ctx(ctx, "evaluate_loss")
    loss_fn = make_loss_fn(model, chunked_vocab=chunked_vocab)
    losses = []
    for i in range(0, len(examples) - batch_size + 1, batch_size):
        batch = place_batch(collate_fn(examples[i:i + batch_size]),
                            model.device)
        losses.append(float(loss_fn(batch)))
    return float(np.mean(losses)) if losses else float("nan")


@torch.no_grad()
def generate_translations(model, examples, src_key, tgt_key, tokenizer,
                          model_max_length, *, batch_size=16,
                          max_new_tokens=None, kv_quant="none",
                          beam_size=1, ctx=None, impl=None) -> list[str]:
    """Greedy (``beam_size`` 1) or beam KV-cache decoding of the test set
    (JAX ``apps/machine_translation.py:241-295``): ``translation_tokens``
    with pads and eos dropped, the rest decoded.  Returns the hypotheses in
    ``examples``' order.  ``ctx`` is A8's."""
    _no_ctx(ctx, "generate_translations")
    drop = {tokenizer.vocab["<pad>"], tokenizer.vocab[f"<eos_{tgt_key}>"]}
    return [tokenizer.decode([t for t in row if t not in drop])
            for row in translation_tokens(
                model, examples, src_key, tgt_key, tokenizer,
                model_max_length, batch_size=batch_size,
                max_new_tokens=max_new_tokens, kv_quant=kv_quant,
                beam_size=beam_size, impl=impl)]


@torch.no_grad()
def translation_tokens(model, examples, src_key, tgt_key, tokenizer,
                       model_max_length, *, batch_size=16,
                       max_new_tokens=None, kv_quant="none", beam_size=1,
                       impl=None, trace=None) -> list[list[int]]:
    """Each example's tokens, one a step (pads after its eos): prompts of
    ``src<eos_src>``, right-padded, ``batch_size`` at a time through
    ``inference.generate`` (greedy) or, with ``beam_size`` above 1,
    ``inference.beam_generate`` (``eos_id`` the target's eos, ``max_len``
    the longest prompt plus ``max_new_tokens``, by default
    ``model_max_length``; ``kv_quant`` the cache's codes; ``impl`` to the
    kernels' wrappers; ``trace`` to ``beam_generate``, batch after
    batch)."""
    pad_id = tokenizer.vocab["<pad>"]
    eos = tokenizer.vocab[f"<eos_{tgt_key}>"]
    max_new = max_new_tokens or model_max_length
    sampling = SamplingConfig(max_new_tokens=max_new, temperature=0.0,
                              eos_id=eos)
    out = []
    for i in range(0, len(examples), batch_size):
        chunk = examples[i:i + batch_size]
        prompts = [tokenizer(f"{ex[src_key]}<eos_{src_key}>")["input_ids"]
                   for ex in chunk]
        lengths = np.asarray([len(p) for p in prompts], np.int32)
        Lp = int(lengths.max())
        padded = np.full((len(chunk), Lp), pad_id, np.int64)
        for j, p in enumerate(prompts):
            padded[j, :len(p)] = p
        if beam_size > 1:
            toks, _ = beam_generate(
                model, padded, lengths, beam_size=beam_size,
                max_new_tokens=max_new, max_len=Lp + max_new, eos_id=eos,
                pad_id=pad_id, kv_quant=kv_quant, device=model.device,
                impl=impl, trace=trace)
        else:
            toks, _ = generate(model, padded, lengths, sampling,
                               max_len=Lp + max_new, kv_quant=kv_quant,
                               pad_id=pad_id, device=model.device,
                               impl=impl)
        out += toks.cpu().tolist()
    return out


def evaluate_bleu(examples, gen_sents, tgt_key) -> dict[str, float]:
    """Corpus BLEU of the hypotheses against ``examples``' targets, as
    ``sacrebleu``'s default ``BLEU()`` gives it (``utils/bleu.py``)."""
    return {"bleu": corpus_bleu(gen_sents,
                                [[ex[tgt_key] for ex in examples]])}


def _parser() -> argparse.ArgumentParser:
    """The JAX app's flags with its defaults, ``--dataset``'s excepted."""
    p = argparse.ArgumentParser(
        prog="python -m tpu_flash_torch.apps.machine_translation")
    p.add_argument("--dataset", default="local",
                   help="a corpus in the repository: " + ", ".join(
                       mt.LOCAL_CORPORA))
    p.add_argument("--synthetic", action="store_true",
                   help="the offline synthetic translation task")
    p.add_argument("--model-max-length", type=int, default=40)
    p.add_argument("--n-vocab", type=int, default=10_000)
    p.add_argument("--n-embd", type=int, default=256)
    p.add_argument("--n-head", type=int, default=8)
    p.add_argument("--n-layer", type=int, default=4)
    p.add_argument("--p-dropout", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = the reference's rule (128*40+L)//L")
    p.add_argument("--n-epochs", type=int, default=1)
    p.add_argument("--max-iters-per-epoch", type=int, default=None)
    p.add_argument("--samples-per-epoch", type=int, default=20_000)
    p.add_argument("--attention-kind", default="flash",
                   choices=["flash", "fused", "naive", "auto"])
    p.add_argument("--use-fused-kernel", action="store_true")
    p.add_argument("--mask-padding", action="store_true",
                   help="zero the loss weights of pad positions")
    p.add_argument("--pack", action="store_true",
                   help="sequence-packed rows under segment-id masking")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--mixed-precision", action="store_true",
                   help="fp32 master weights in the optimizer state")
    p.add_argument("--workdir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-bleu", action="store_true")
    p.add_argument("--beam-size", type=int, default=1,
                   help="beam width for BLEU generation")
    p.add_argument("--kv-quant", default="none",
                   choices=("none", "int8", "fp8"),
                   help="the KV cache's codes for BLEU generation")
    p.add_argument("--kv-quant-train", default="none",
                   choices=("none", "int8", "fp8",
                            "int8_channel", "fp8_channel"),
                   help="quantized-K/V training attention "
                        "(DecoderConfig.kv_quant)")
    p.add_argument("--native-loader", action="store_true",
                   help="the C++ batch ring (raises if it cannot build)")
    p.add_argument("--chunked-loss", type=int, default=0, metavar="N",
                   help="lm_head + cross-entropy over N vocab chunks")
    p.add_argument("--accum-steps", type=int, default=1, metavar="A",
                   help="gradient accumulation over A microbatches")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save a checkpoint every N epochs (0 disables)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in the workdir")
    p.add_argument("--profile", action="store_true",
                   help="a profiler trace of epoch 0 (A9b)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh size (above 1: A8)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size (above 1: A8)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 optimizer-state sharding (A8)")
    p.add_argument("--sequence-parallel", action="store_true",
                   help="Megatron sequence parallelism (A8)")
    p.add_argument("--dcn-data", type=int, default=1, metavar="H",
                   help="multi-host data parallelism (above 1: A8)")
    return p


def _refuse_unported(args) -> None:
    for bad, what, item in (
            (args.dp > 1, f"--dp {args.dp}", "A8"),
            (args.tp > 1, f"--tp {args.tp}", "A8"),
            (args.dcn_data > 1, f"--dcn-data {args.dcn_data}", "A8"),
            (args.zero1, "--zero1", "A8"),
            (args.sequence_parallel, "--sequence-parallel", "A8"),
            (args.profile, "--profile", "A9b")):
        if bad:
            raise _not_ported(what, item)


def main(argv=None, *, device=None) -> dict:
    """The CLI (JAX ``apps/machine_translation.py:309-457``).  ``device``
    ``None`` is the card (raising without one); the tests pass ``"cpu"``.
    Returns the records it printed (``epochs``, ``bleu``, the last BLEU
    pass's three ``samples``, ``tokenizer_vocab``) with the trained
    ``model`` and its ``tokenizer``."""
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve_device(device)
    L = args.model_max_length
    batch_size = args.batch_size or (128 * 40 + L) // L  # reference rule
    if args.accum_steps > 1:
        if args.pack:
            raise SystemExit("--accum-steps with --pack is unsupported: "
                             "packed rows-per-step vary, so microbatch "
                             "splits would be ragged")
        if batch_size % args.accum_steps:
            batch_size = -(-batch_size // args.accum_steps) * args.accum_steps
            print(json.dumps({"batch_size_rounded_to_accum": batch_size}))
    workdir = args.workdir or f"workdir_vocab{args.n_vocab}_len{L}"
    os.makedirs(workdir, exist_ok=True)

    dataset, src_key, tgt_key = mt.get_dataset(
        args.dataset, L, synthetic=args.synthetic or None)
    print(json.dumps({"data_size": {s: len(d) for s, d in dataset.items()}}))
    tokenizer = mt.get_tokenizer(
        dataset["train"], args.n_vocab, src_key, tgt_key, workdir)
    print(json.dumps({"tokenizer_vocab": len(tokenizer)}))
    if len(tokenizer) > args.n_vocab:
        raise SystemExit(
            f"--n-vocab {args.n_vocab} is smaller than the trained "
            f"tokenizer's vocab ({len(tokenizer)}); byte-level BPE needs "
            f"at least 259")

    def collate_fn(examples):
        return mt.collate_batch(examples, src_key, tgt_key, tokenizer, L,
                                mask_padding=args.mask_padding)

    train_collate_fn = collate_fn
    pack_rows = 0
    if args.pack:
        # one packed row count for every step: the most of five shuffled
        # probes, plus a row of margin; overflow is dropped and counted
        prng = np.random.default_rng(args.seed)
        need = 1
        for _ in range(5):
            idx = prng.choice(len(dataset["train"]),
                              min(batch_size, len(dataset["train"])),
                              replace=False)
            probe = mt.collate_packed(
                [dataset["train"][i] for i in idx], src_key, tgt_key,
                tokenizer, L)
            need = max(need, probe["input_ids"].shape[0])
        pack_rows = need + 1
        print(json.dumps({"pack_rows": pack_rows,
                          "examples_per_step": batch_size}))
        drop_counter: list = []

        def train_collate_fn(examples):
            return mt.collate_packed(examples, src_key, tgt_key, tokenizer,
                                     L, fixed_rows=pack_rows,
                                     drop_counter=drop_counter)

        train_collate_fn.drop_counter = drop_counter

    cfg = DecoderConfig(
        n_vocab=args.n_vocab, n_embd=args.n_embd, n_head=args.n_head,
        n_positions=L, n_layer=args.n_layer, p_dropout=args.p_dropout,
        attention_kind=args.attention_kind,
        use_fused_kernel=args.use_fused_kernel,
        kv_quant=args.kv_quant_train,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32)
    model = DecoderLM(cfg, device=device)
    init_params(model, torch.Generator(device).manual_seed(args.seed))
    print(f"model parameters: {num_parameters(model):,}")

    opt = adam(lr=args.lr)
    if args.mixed_precision:
        opt = mixed_precision(opt)
    opt_state = opt.init({n: p.detach() for n, p in
                          model.named_parameters()})

    ckpt_dir = os.path.join(workdir, "checkpoints")
    start_epoch = 0
    if args.resume:
        try:
            tree, step, _ = restore_checkpoint(ckpt_dir)
        except FileNotFoundError:
            print(json.dumps({"resume": "no checkpoint found, cold start"}))
        else:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(tree["params"][n])
            opt_state = restore_like(opt_state, tree["opt_state"])
            start_epoch = step + 1
            print(json.dumps({"resumed_from_epoch": step}))

    native_loader = None
    if args.native_loader:
        from tpu_flash_torch.data import native_loader as nl

        flats = nl.tokenize_corpus(dataset["train"], src_key, tgt_key,
                                   tokenizer)
        native_loader = nl.NativeBatchLoader(
            *flats, max_len=L, pad_id=tokenizer.vocab["<pad>"],
            batch_size=batch_size, mask_padding=args.mask_padding,
            seed=args.seed, n_threads=2, packed=args.pack,
            fixed_rows=pack_rows)
        print(json.dumps({"native_loader": "enabled", "packed": args.pack}))

    metrics = MetricsLogger(os.path.join(workdir, "metrics.jsonl"),
                            run={"event_args": vars(args)})
    ckpt = AsyncCheckpointer()
    try:
        out = _train_loop(args, model, opt, opt_state, dataset,
                          train_collate_fn, collate_fn, batch_size,
                          start_epoch, native_loader, metrics, ckpt_dir,
                          tokenizer, src_key, tgt_key, L, ckpt)
    finally:
        # the write in flight lands (its error raised) before the exit
        ckpt.close()
        metrics.close()
        if native_loader is not None:
            native_loader.close()
    return {**out, "tokenizer_vocab": len(tokenizer), "model": model,
            "tokenizer": tokenizer}


def _train_loop(args, model, opt, opt_state, dataset, train_collate_fn,
                collate_fn, batch_size, start_epoch, native_loader, metrics,
                ckpt_dir, tokenizer, src_key, tgt_key, L, ckpt) -> dict:
    """Epochs from ``start_epoch``: train, validation loss, the epoch record
    (JAX ``apps/machine_translation.py:641-663``), an async checkpoint every
    ``--checkpoint-every`` epochs, then BLEU on the test split with three
    sample lines."""
    train_step = None
    if args.accum_steps > 1:
        train_step = make_train_step(model, opt,
                                     chunked_vocab=args.chunked_loss,
                                     accum_steps=args.accum_steps)
    out = {"epochs": [], "bleu": [], "samples": []}
    for epoch in range(start_epoch, args.n_epochs):
        t0 = time.perf_counter()
        opt_state, losses, step_times, step_tokens = train_epoch(
            model, opt, opt_state, dataset["train"], train_collate_fn,
            batch_size, seed=args.seed * 100_003 + epoch + 1,
            n_samples=args.samples_per_epoch,
            max_iters=args.max_iters_per_epoch,
            native_loader=native_loader, metrics=metrics,
            chunked_vocab=args.chunked_loss, train_step=train_step)
        epoch_time = time.perf_counter() - t0
        val_loss = evaluate_loss(model, dataset["validation"], collate_fn,
                                 batch_size, chunked_vocab=args.chunked_loss)
        mean_step = float(np.mean(step_times)) if step_times else float("nan")
        epoch_rec = {
            "epoch": epoch,
            "train_loss": float(np.mean(losses)),
            "validation_loss": val_loss,
            "epoch_time_s": round(epoch_time, 2),
            "mean_step_ms": round(mean_step * 1e3, 2),
            # rows * L stepped (under --pack the packed rows)
            "tokens_per_sec": round(step_tokens / mean_step)
            if step_times else None,
            "examples_per_sec": round(batch_size / mean_step)
            if step_times else None,
        }
        drops = getattr(train_collate_fn, "drop_counter", None)
        if drops is not None:
            epoch_rec["packed_dropped_examples"] = int(sum(drops))
            drops.clear()
        if native_loader is not None and native_loader.packed:
            epoch_rec["packed_dropped_examples"] = native_loader.dropped()
        print(json.dumps(epoch_rec))
        metrics.log(step=epoch, event="epoch", **epoch_rec)
        out["epochs"].append(epoch_rec)

        if args.checkpoint_every and (epoch + 1) % args.checkpoint_every == 0:
            # the host copy now, the write on the checkpointer's thread
            ckpt.save(ckpt_dir, epoch,
                      {"params": dict(model.named_parameters()),
                       "opt_state": opt_state},
                      metadata={"lr": args.lr, "config": vars(args)})
            print(json.dumps({"checkpoint": f"{ckpt_dir}/step_{epoch}",
                              "async": True}))

        if not args.skip_bleu:
            hyps = generate_translations(
                model, dataset["test"], src_key, tgt_key, tokenizer, L,
                kv_quant=args.kv_quant, beam_size=args.beam_size)
            scores = evaluate_bleu(dataset["test"], hyps, tgt_key)
            print(json.dumps({"epoch": epoch, **scores}))
            metrics.log(step=epoch, event="bleu", **scores)
            out["bleu"].append({"epoch": epoch, **scores})
            out["samples"] = [{"src": ex[src_key], "ref": ex[tgt_key],
                               "hyp": hyp}
                              for ex, hyp in zip(dataset["test"], hyps[:3])]
            for line in out["samples"]:
                print(json.dumps(line))
    return out


if __name__ == "__main__":
    main()
