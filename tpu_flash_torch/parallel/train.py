"""The sharded training step, counterpart of ``tpu_flash/parallel/train.py``.

The JAX step is one jitted SPMD program over the (data, model) mesh.  Here
every rank runs the step on its rows and its shards: the forward and
backward pass through the model's tensor-parallel hooks (the collectives of
``parallel/comm.py``), then each gradient is averaged over the data group in
one flat all-reduce a dtype, and the optimizer updates this rank's shards.

The loss function is written as for one device over the rank's rows (the
mean over them): the mean over the data ranks of those means is the mean
over the global batch, as the JAX loss's own normalization gives it
(equal shards).  A packed batch's ``loss_norm`` is the global batch's
divisor; ``local_loss_norm`` turns it into the shard's.  The step returns
that mean loss, the same on every rank.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.parallel import comm
from tpu_flash_torch.parallel.context import ParallelContext, parallel_context
from tpu_flash_torch.parallel.sharding import shard_params


def backward_and_reduce(ctx: ParallelContext, params: dict, loss_fn, batch,
                        generator):
    """``loss_fn(batch, generator=, training=True)`` on this rank, its
    backward, then (loss, grads) averaged over the data group."""
    for p in params.values():
        p.grad = None
    loss = loss_fn(batch, generator=generator, training=True)
    loss.backward()
    names = list(params)
    grads = [torch.zeros_like(params[n]) if params[n].grad is None
             else params[n].grad for n in names]
    inv = 1.0 / ctx.data_size
    *grads, loss = comm.flat_all_reduce(
        grads + [loss.detach().float().reshape(1)], ctx.data_group, inv)
    return loss.reshape(()), dict(zip(names, grads))


def make_sharded_train_step(ctx: ParallelContext, model, opt, loss_fn):
    """``train_step(opt_state, batch, generator=None) -> (opt_state,
    loss)`` over this rank's shards (the port's MT step contract; the JAX
    step also takes and returns the parameters, which here live in the
    module).  ``loss_fn(batch, *, generator=None, training=False)`` ->
    scalar over the rank's rows (``batch`` from ``put_batch``).  Dropout
    draws from ``generator``, else from the step's own, seeded with 0 on
    the rank's device."""
    params = dict(model.named_parameters())
    own = torch.Generator(ctx.device).manual_seed(0)

    def train_step(opt_state, batch, generator=None):
        with parallel_context(ctx):
            loss, grads = backward_and_reduce(ctx, params, loss_fn, batch,
                                              generator or own)
            train_step.grads = grads      # this rank's, averaged over data
            with torch.no_grad():
                new, opt_state = opt.update(
                    grads, opt_state,
                    {n: p.detach() for n, p in params.items()})
                for n, p in params.items():
                    p.copy_(new[n])
        return opt_state, loss

    return train_step


def init_sharded(ctx: ParallelContext, model, opt):
    """Cut ``model`` (initialized or loaded the same on every rank) to this
    rank's shards and start ``opt`` over them.  Returns ``(opt_state,
    specs)`` (the JAX function also returns the parameters, which here are
    the module's)."""
    specs = shard_params(ctx, model)
    opt_state = opt.init({n: p.detach() for n, p in
                          model.named_parameters()})
    return opt_state, specs


def local_loss_norm(ctx: ParallelContext, batch):
    """``batch`` with a global ``loss_norm`` (a packed batch's divisor, the
    examples of the whole step times L) divided by the data size: the
    shard's divisor, so that the ranks' mean loss is the global one."""
    if "loss_norm" not in batch or ctx.data_size == 1:
        return batch
    return {**batch, "loss_norm": batch["loss_norm"] / ctx.data_size}
