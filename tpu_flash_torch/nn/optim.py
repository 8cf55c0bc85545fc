"""Optimizers, counterpart of ``tpu_flash/nn/optim.py``.

The same ``(init, update)`` pairs as the JAX package, over flat dicts of
tensors keyed by parameter name (``dict(model.named_parameters())``) in
place of pytrees: ``update(grads, state, params) -> (new_params,
new_state)`` returns new tensors and leaves its inputs alone, so a step can
be held against the JAX package's on identical gradients.
``apps.machine_translation.make_train_step`` copies the new values into the
module's parameters.  The arithmetic is the JAX package's, operation for
operation: Adam's ``step_size = lr * sqrt(1 - b2^t) / (1 - b1^t)`` in fp32,
``denom = sqrt(v) + eps``, and ``minitorch_compat``'s ``(1 - beta1)``
coefficient on ``grad**2``.  As in JAX, Adam's step count is a 0-d int32
tensor on the parameters' device and the bias corrections are formed from
it there, so that a step (``skip_nonfinite``'s choice included) never makes
the host wait for the card; an ``lr`` schedule takes that tensor and
returns a tensor.  States are NamedTuples over the dicts; ``tree_map``
walks them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

Tree = dict  # parameter name -> tensor


def _map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def tree_map(fn, *trees):
    """``fn`` over the tensors of like-shaped trees: dicts, NamedTuples,
    tuples and lists of tensors (None and other leaves kept from the
    first tree)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *parts)
                             for parts in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    if torch.is_tensor(first):
        return fn(*trees)
    return first


class Transform(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Tree], tuple[Tree, Any]]
    # update(grads, state, params) -> (new_params, new_state)


def sgd(lr: float = 0.01) -> Transform:
    """Plain SGD."""

    def init(params):
        return ()

    def update(grads, state, params):
        return _map(lambda p, g: (p - lr * g).to(p.dtype), params,
                    grads), state

    return Transform(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor          # 0-d int32 on the parameters' device
    exp_avg: Tree
    exp_avg_sq: Tree


def _bias_corrected_lr(lr, beta1, beta2, step: torch.Tensor) -> torch.Tensor:
    """``lr * sqrt(1 - b2^t) / (1 - b1^t)`` as a 0-d fp32 tensor on the
    step's device, each operation in fp32 as the JAX package computes it
    (JAX ``nn/optim.py:78-80``); ``lr`` is a number or a 0-d tensor."""
    t = step.float()
    bc1 = 1.0 - torch.pow(beta1, t)
    bc2 = 1.0 - torch.pow(beta2, t)
    return lr * torch.sqrt(bc2) / bc1


def _adam_moments(grads, state, beta1, beta2, sq_coeff):
    # moments keep their own dtype (fp32 grads must not promote bf16 state)
    exp_avg = _map(lambda m, g: (beta1 * m + (1.0 - beta1) * g).to(m.dtype),
                   state.exp_avg, grads)
    exp_avg_sq = _map(
        lambda v, g: (beta2 * v + sq_coeff * torch.square(g)).to(v.dtype),
        state.exp_avg_sq, grads)
    return exp_avg, exp_avg_sq


def _device_of(params: Tree) -> torch.device:
    return next(iter(params.values())).device


def _adam_init(params):
    step = torch.zeros((), dtype=torch.int32, device=_device_of(params))
    return AdamState(step, _map(torch.zeros_like, params),
                     _map(torch.zeros_like, params))


def adam(lr: float = 1e-3, beta1: float = 0.9, beta2: float = 0.999,
         eps: float = 1e-8, minitorch_compat: bool = False) -> Transform:
    """Adam.  ``denom = sqrt(v) + eps``; ``step_size = lr * sqrt(1 - b2^t)
    / (1 - b1^t)``.  ``minitorch_compat`` uses ``(1 - beta1)`` as the
    coefficient on ``grad**2``, the reference's bug."""
    sq_coeff = (1.0 - beta1) if minitorch_compat else (1.0 - beta2)

    def update(grads, state, params):
        step = state.step + 1
        exp_avg, exp_avg_sq = _adam_moments(grads, state, beta1, beta2,
                                            sq_coeff)
        step_size = _bias_corrected_lr(lr, beta1, beta2, step)
        # fp32 arithmetic, cast back: the JAX package's fp32 step_size
        # promotes bf16 operands the same way
        new_params = _map(
            lambda p, m, v: (p.float() - step_size * m.float()
                             / (torch.sqrt(v.float()) + eps)).to(p.dtype),
            params, exp_avg, exp_avg_sq)
        return new_params, AdamState(step, exp_avg, exp_avg_sq)

    return Transform(_adam_init, update)


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
          beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Transform:
    """AdamW: decoupled weight decay.  ``lr`` may be a schedule
    ``step -> learning rate`` over the 0-d step tensor."""

    def update(grads, state, params):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        exp_avg, exp_avg_sq = _adam_moments(grads, state, beta1, beta2,
                                            1.0 - beta2)
        step_size = _bias_corrected_lr(lr_t, beta1, beta2, step)
        new_params = _map(
            lambda p, m, v: (p.float() - step_size * m.float()
                             / (torch.sqrt(v.float()) + eps)
                             - lr_t * weight_decay * p.float()).to(p.dtype),
            params, exp_avg, exp_avg_sq)
        return new_params, AdamState(step, exp_avg, exp_avg_sq)

    return Transform(_adam_init, update)


def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / (norm + 1e-6))``;
    returns ``(clipped, norm)``."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_lr: float = 0.0
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr``: a
    0-d step tensor in, a 0-d fp32 tensor out, on the step's device and
    without a host read (JAX ``nn/optim.py:133-146``)."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(1, warmup_steps)
        progress = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps),
            0.0, 1.0)
        cos = min_lr + 0.5 * (peak_lr - min_lr) * (
            1.0 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def accumulate_gradients(loss_fn, params: Tree, accum_steps: int):
    """Gradient accumulation: returns ``compute(batch, *args, **kwargs) ->
    (loss, grads)`` where ``batch`` leaves carry a leading microbatch axis
    of ``accum_steps``; ``loss_fn(micro, *args, **kwargs)`` returns a
    scalar loss over ``params``.  Losses and gradients are averaged over
    the microbatches, the gradients summed in fp32 (and left in fp32), so
    only one microbatch's activations are alive at a time."""

    def compute(batch, *args, **kwargs):
        loss_sum = 0.0
        grad_sum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for n, p in params.items()}
        for i in range(accum_steps):
            for p in params.values():
                p.grad = None
            loss = loss_fn({k: v[i] for k, v in batch.items()}, *args,
                           **kwargs)
            loss.backward()
            for n, p in params.items():
                if p.grad is not None:
                    grad_sum[n] += p.grad.float()
            loss_sum = loss_sum + loss.detach().float()
        inv = 1.0 / accum_steps
        return loss_sum * inv, _map(lambda g: g * inv, grad_sum)

    return compute


class MixedPrecisionState(NamedTuple):
    inner: Any
    master: Tree            # fp32 master copy of every parameter


def mixed_precision(tx: Transform) -> Transform:
    """fp32 master weights in the optimizer state while the model keeps
    its compute dtype (bf16): ``update`` casts the grads up, steps ``tx`` on
    the masters, and casts the result down to each parameter's dtype."""

    def init(params):
        master = _map(lambda p: p.detach().float().clone(), params)
        return MixedPrecisionState(tx.init(master), master)

    def update(grads, state, params):
        grads32 = _map(lambda g: g.float(), grads)
        new_master, new_inner = tx.update(grads32, state.inner, state.master)
        new_params = _map(lambda m, p: m.to(p.dtype), new_master, params)
        return new_params, MixedPrecisionState(new_inner, new_master)

    return Transform(init, update)


class SkipState(NamedTuple):
    inner: Any
    skipped: torch.Tensor   # 0-d int32: updates skipped for non-finite grads


def skip_nonfinite(tx: Transform) -> Transform:
    """Where any gradient holds a NaN or an Inf, keep the parameters and
    ``tx``'s state as they were and count the skip (JAX ``nn/optim.py:
    233-264``).  The inner update always runs and each new tensor is chosen
    against the old one with ``torch.where`` on a device flag, so the step
    makes the host wait for nothing.  Composes as
    ``skip_nonfinite(mixed_precision(adam(...)))``.  Under a parallel
    context each rank sees only its shards' gradients, so the flag is
    reduced over every rank (a MIN all-reduce): all of them skip
    together."""

    def init(params):
        return SkipState(tx.init(params), torch.zeros(
            (), dtype=torch.int32, device=_device_of(params)))

    def update(grads, state, params):
        finite = torch.stack([torch.isfinite(g).all()
                              for g in grads.values()]).all()
        from tpu_flash_torch.parallel.context import current_context

        if current_context() is not None:
            from tpu_flash_torch.parallel import comm

            finite = comm.all_ranks_true(finite)

        def keep(new, old):
            return tree_map(lambda n, o: torch.where(finite, n, o), new, old)

        new_params, new_inner = tx.update(grads, state.inner, params)
        skipped = state.skipped + (~finite).to(torch.int32)
        return keep(new_params, params), SkipState(
            keep(new_inner, state.inner), skipped)

    return Transform(init, update)
