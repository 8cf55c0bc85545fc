"""ZeRO-1: the optimizer state sharded over the data group, counterpart of
``tpu_flash/parallel/zero.py``.

Plain data parallelism keeps Adam's moments (and mixed precision's fp32
masters) whole on every data rank.  ZeRO-1 gives each data rank one slice
of every parameter's state along ``zero1_specs``' dim: the step
reduce-scatters each gradient over the data group (instead of the
all-reduce), updates this rank's slice of the parameter with its slice of
the state, and all-gathers the new slices back to the tensor-parallel
layout; the sliced parameters go through one flat reduce-scatter and one
flat all-gather a dtype (``comm.flat_reduce_scatter``).  A reduce-scatter and an all-gather move the bytes of the
all-reduce they replace.  Leaves with no dim the data size divides (small
LayerNorm vectors) keep their state whole and take the all-reduce.

The optimizer runs on dicts keyed by parameter name (``nn/optim.py``), so
its state -- wrapped ones like ``skip_nonfinite(mixed_precision(adam))``
included -- is built over the sliced parameters and holds only slices: the
JAX package's path-suffix lookup (``state_shardings``) needs no counterpart,
and ``state_shardings`` here reports the spec of each state leaf by the same
rule for checkpoints and checks.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.parallel import comm
from tpu_flash_torch.parallel.context import ParallelContext, parallel_context
from tpu_flash_torch.parallel.sharding import (Spec, decoder_param_specs,
                                               gather_named, gather_params,
                                               shard_params)


def zero1_specs(ctx: ParallelContext, params: dict, specs: dict
                ) -> dict[str, Spec]:
    """Each parameter's spec with the data axis on its first dim that is
    unsharded and divisible by the data size (its own spec where none
    is)."""
    out = {}
    for n, p in params.items():
        entries = tuple(specs[n]) + (None,) * (p.dim() - len(specs[n]))
        out[n] = entries
        for i, (dim, s) in enumerate(zip(p.shape, entries)):
            if s is None and dim >= ctx.data_size \
                    and dim % ctx.data_size == 0:
                out[n] = entries[:i] + (ctx.data_axis,) + entries[i + 1:]
                break
    return out


def _zero_dim(spec: Spec, axis: str) -> int | None:
    return spec.index(axis) if axis in spec else None


def _slice(ctx, t, d):
    return t if d is None else comm.local_slice(t, ctx.data_group, d)


def state_shardings(ctx: ParallelContext, opt_state, zspecs: dict):
    """The spec of every leaf of ``opt_state`` (a tree over dicts keyed by
    parameter name): a dict entry takes its parameter's zero1 spec, other
    leaves (step counts, skip counts) replicate."""

    def walk(node):
        if isinstance(node, dict):
            return {k: zspecs.get(k, ()) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return ()

    return walk(opt_state)


def init_zero1(ctx: ParallelContext, model, opt):
    """Cut ``model`` to this rank's tensor-parallel shards, and start
    ``opt`` over this data rank's zero1 slices of them.  Returns
    ``(opt_state, specs, zspecs)``."""
    specs = shard_params(ctx, model)
    params = {n: p.detach() for n, p in model.named_parameters()}
    zspecs = zero1_specs(ctx, params, specs)
    sliced = {n: _slice(ctx, p, _zero_dim(zspecs[n], ctx.data_axis))
              for n, p in params.items()}
    return opt.init(sliced), specs, zspecs


def gather_state(ctx: ParallelContext, opt_state, zspecs: dict):
    """The whole (tensor-parallel-local) optimizer state: every sliced
    leaf all-gathered over the data group."""

    def leaf(k, v):
        d = _zero_dim(zspecs.get(k, ()), ctx.data_axis)
        return v if d is None else comm.all_gather(v, ctx.data_group, d)

    return _walk(opt_state, leaf)


def make_zero1_train_step(ctx: ParallelContext, model, opt, loss_fn):
    """``train_step(opt_state, batch, generator=None) -> (opt_state,
    loss)``, ``make_sharded_train_step``'s contract with the state over
    ``init_zero1``'s slices.  The update is elementwise, so its numbers are
    the plain step's; only where the reduction lands changes."""
    params = dict(model.named_parameters())
    zspecs = zero1_specs(ctx, params, decoder_param_specs(model))
    zdim = {n: _zero_dim(zspecs[n], ctx.data_axis) for n in params}
    by_dtype: dict = {}
    for n, p in params.items():
        if zdim[n] is not None:
            by_dtype.setdefault(p.dtype, []).append(n)
    by_dtype = list(by_dtype.values())
    own = torch.Generator(ctx.device).manual_seed(0)
    inv = 1.0 / ctx.data_size

    def train_step(opt_state, batch, generator=None):
        with parallel_context(ctx):
            for p in params.values():
                p.grad = None
            loss = loss_fn(batch, generator=generator or own, training=True)
            loss.backward()
            with torch.no_grad():
                grads = {n: torch.zeros_like(p) if p.grad is None
                         else p.grad for n, p in params.items()}
                whole = [n for n in params if zdim[n] is None]
                red = comm.flat_all_reduce(
                    [grads[n] for n in whole]
                    + [loss.detach().float().reshape(1)],
                    ctx.data_group, inv)
                loss_avg = red[-1].reshape(())
                g_sl = dict(zip(whole, red[:-1]))
                # one reduce-scatter and one all-gather a dtype for every
                # sliced parameter (flat buckets)
                for names in by_dtype:
                    g_sl.update(zip(names, comm.flat_reduce_scatter(
                        [grads[n] for n in names], [zdim[n] for n in names],
                        ctx.data_group, inv)))
                p_sl = {n: _slice(ctx, p.detach(), zdim[n])
                        for n, p in params.items()}
                new, opt_state = opt.update(g_sl, opt_state, p_sl)
                for n in whole:
                    params[n].copy_(new[n])
                for names in by_dtype:
                    full = comm.flat_all_gather(
                        [new[n] for n in names], [zdim[n] for n in names],
                        ctx.data_group)
                    for n, v in zip(names, full):
                        params[n].copy_(v)
        return opt_state, loss_avg

    return train_step



def _walk(node, leaf):
    """``leaf(name, tensor)`` over every dict entry of an optimizer-state
    tree (dicts keyed by parameter name inside NamedTuples, tuples and
    lists); other leaves kept."""
    if isinstance(node, dict):
        return {k: leaf(k, v) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_walk(x, leaf) for x in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(x, leaf) for x in node)
    return node


def shard_tree(ctx: ParallelContext, state, specs: dict,
               zspecs: dict | None = None):
    """A full-layout optimizer state (a fresh or restored one) cut to this
    rank's tensor-parallel slices, and with ``zspecs`` to its ZeRO-1
    slices over data."""
    from tpu_flash_torch.parallel.sharding import spec_dim

    def leaf(name, t):
        d = spec_dim(specs.get(name, ()), "model")
        if d is not None and ctx.model_size > 1:
            t = comm.local_slice(t, ctx.model_group, d)
        if zspecs is not None:
            t = _slice(ctx, t, _zero_dim(zspecs.get(name, ()),
                                         ctx.data_axis))
        return t

    return _walk(state, leaf)


def gather_tree(ctx: ParallelContext, model, state,
                zspecs: dict | None = None):
    """``(params, state)`` in the full layout: the state's ZeRO-1 slices
    all-gathered over data, then every tensor-parallel shard over the
    model group (each rank takes part and gets the result)."""
    if zspecs is not None:
        state = gather_state(ctx, state, zspecs)
    return (gather_params(ctx, model),
            _walk(state, lambda n, t: gather_named(ctx, model, {n: t})[n]))
