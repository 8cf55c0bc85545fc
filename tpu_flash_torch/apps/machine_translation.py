"""Machine-translation training core, counterpart of the part of
``tpu_flash/apps/machine_translation.py`` below its CLI: the masked-MLE
loss, the training step (forward, backward through the model's kernels:
flash attention, or the fused masked softmax, and the fused LayerNorm with
``use_fused_kernel``; optimizer update) and the epoch loop, plus
``evaluate_loss``.

The JAX step is one jitted program over an external parameter tree; here
the parameters live in the module, the step runs eagerly, and the
optimizer's new values are copied into the parameters in place.  The CLI
(``main``), the BPE data pipeline, ``generate_translations`` and BLEU need
the ``tokenizers`` and ``sacrebleu`` packages and are not ported yet
(ROADMAP.md, queue A item A4), nor is ``chunked_vocab``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.nn.optim import accumulate_gradients


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue A item A4)")


def make_loss_fn(model, chunked_vocab: int = 0):
    """``loss_fn(batch, *, generator=None, training=False, impl=None)``:
    masked MLE, ``sum(losses * label_token_weights)`` over every position,
    divided by the number of positions (or by ``batch["loss_norm"]`` for
    packed batches).  ``impl`` reaches the kernels' wrappers."""
    if chunked_vocab > 0:
        raise _not_ported("chunked_vocab (the fused lm_head + loss)")

    def loss_fn(batch, *, generator=None, training: bool = False,
                impl=None):
        logits = model(batch["input_ids"],
                       segment_ids=batch.get("segment_ids"),
                       positions=batch.get("positions"),
                       training=training, generator=generator, impl=impl)
        losses = F.softmax_loss(logits, batch["labels"])
        weighted = losses * batch["label_token_weights"]
        if "loss_norm" in batch:
            return weighted.sum() / batch["loss_norm"]
        return weighted.sum() / weighted.numel()

    return loss_fn


def make_train_step(model, opt, chunked_vocab: int = 0,
                    accum_steps: int = 1, impl=None):
    """``train_step(opt_state, batch, generator=None) -> (opt_state,
    loss)``: forward and backward with training dropout, then ``opt``'s
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
                log_every: int = 10, train_step=None, log=print):
    """One training epoch.  Returns ``(opt_state, losses, step_times,
    step_tokens)``: the parameters are the module's own and change in place,
    so where the JAX loop also returns them this one returns the optimizer
    state alone beside the JAX loop's three results.

    The order of ``examples`` is shuffled with numpy's generator from
    ``seed``; dropout draws from ``generator``, or where none is given from
    a generator on the model's device seeded from ``seed`` (the JAX loop
    always splits its key for the step).  Batches reach the card through
    ``place_batch``, which does not wait for it.  As in the JAX loop the host
    syncs (reads the loss) only every ``log_every`` steps and at the last,
    so steps queue back to back in between; a step's time is its window's
    host time over the window's steps, and the first window (kernel builds,
    warm-up) is left out of ``step_times``."""
    if train_step is None:
        train_step = make_train_step(model, opt)
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
    losses = [float(l) for l in losses_dev]
    return opt_state, losses, step_times, step_tokens


@torch.no_grad()
def evaluate_loss(model, examples, collate_fn, batch_size,
                  chunked_vocab: int = 0) -> float:
    """Mean loss over whole batches of ``examples`` (no dropout)."""
    loss_fn = make_loss_fn(model, chunked_vocab=chunked_vocab)
    losses = []
    for i in range(0, len(examples) - batch_size + 1, batch_size):
        batch = place_batch(collate_fn(examples[i:i + batch_size]),
                            model.device)
        losses.append(float(loss_fn(batch)))
    return float(np.mean(losses)) if losses else float("nan")
