"""Parameter and batch sharding for the ``DecoderLM``, counterpart of
``tpu_flash/parallel/sharding.py``, in the port's ``[out, in]`` Linear
layout.

Megatron tensor parallelism over the ``model`` axis:

  * q/k/v projections and FF ``linear_in``: weight and bias sharded on dim 0
    (output features: heads, hidden) -- column-parallel;
  * ``out_projection`` and FF ``linear_out``: weight sharded on dim 1 (input
    features), the bias replicated (added after the partial sums meet) --
    row-parallel;
  * both embeddings: dim 1 (the embedding dim);
  * ``lm_head``: dim 0 (the vocab), bias too;
  * LayerNorm parameters replicated;
  * MoE: ``w_in``, ``b_in``, ``w_out``, ``b_out`` on the expert dim, the
    router replicated (the JAX package's ``expert_param_specs``).

A spec is a tuple of axis names, one per dim (``None`` unsharded), as a
JAX ``PartitionSpec``.  ``shard_params`` cuts a full model (as
``nn.load_jax_params`` or ``nn.init_params`` leave it, the same on every
rank) down to this rank's slices in place; ``gather_params`` is its inverse
and gives the full tensors back (checkpoints, parity checks).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tpu_flash_torch.parallel import comm
from tpu_flash_torch.parallel.context import MODEL_AXIS, ParallelContext

Spec = tuple


def _rule(name: str, ndim: int, moe: bool) -> Spec:
    """The model-axis spec of one parameter by its dotted name."""
    ax = MODEL_AXIS
    leaf = name.rsplit(".", 1)[-1]
    parts = name.split(".")
    if parts[0] in ("token_embeddings", "position_embeddings"):
        return (None, ax)
    if parts[0] == "lm_head":
        return (ax,) + (None,) * (ndim - 1)
    if "attention" in parts:
        proj = parts[-2]
        if proj in ("q_projection", "k_projection", "v_projection"):
            return (ax,) + (None,) * (ndim - 1)
        if proj == "out_projection":
            return (None, ax) if leaf == "weight" else (None,)
    if "ff" in parts:
        if moe and leaf in ("w_in", "b_in", "w_out", "b_out"):
            return (ax,) + (None,) * (ndim - 1)
        if parts[-2] == "linear_in":
            return (ax,) + (None,) * (ndim - 1)
        if parts[-2] == "linear_out":
            return (None, ax) if leaf == "weight" else (None,)
    return (None,) * ndim


def decoder_param_specs(model, params=None) -> dict[str, Spec]:
    """The spec of every parameter of ``model`` (a ``DecoderLM``) by name;
    ``params`` (a name -> tensor dict) defaults to the model's own."""
    if params is None:
        params = dict(model.named_parameters())
    moe = model.cfg.moe is not None
    return {n: _rule(n, p.dim(), moe) for n, p in params.items()}


def spec_dim(spec: Spec, axis: str) -> int | None:
    """The dim ``spec`` shards over ``axis``, or None."""
    return spec.index(axis) if axis in spec else None


def map_with_specs(params: Any, specs: Any, fn):
    """``fn(leaf, spec)`` over a (nested) dict of leaves and the congruent
    dict of specs: specs are tuples, so they are leaves here, never walked
    into."""
    if isinstance(params, dict):
        return {k: map_with_specs(params[k], specs[k], fn) for k in params}
    return fn(params, specs)


def _check_divides(ctx: ParallelContext, model) -> None:
    c = model.cfg
    tp = ctx.model_size
    for what, val in (("n_head", c.n_head), ("n_kv_head", c.kv_heads),
                      ("n_embd", c.n_embd), ("n_vocab", c.n_vocab),
                      ("ff_middle_dim", c.ff_middle_dim)):
        if val % tp:
            raise ValueError(f"model size {tp} must divide {what} ({val})")
    if c.moe is not None and c.moe.n_experts % tp:
        raise ValueError(f"model size {tp} must divide n_experts "
                         f"({c.moe.n_experts})")


@torch.no_grad()
def shard_params(ctx: ParallelContext, model):
    """Cut every parameter of ``model`` to this rank's slice over the model
    axis, in place (each ``Parameter`` keeps its identity; its data becomes
    the slice).  Returns the specs.  Without tensor parallelism nothing
    changes."""
    specs = decoder_param_specs(model)
    if ctx.model_size > 1:
        _check_divides(ctx, model)
        for name, p in model.named_parameters():
            d = spec_dim(specs[name], MODEL_AXIS)
            if d is not None:
                p.data = comm.local_slice(p.data, ctx.model_group, d)
    return specs


@torch.no_grad()
def gather_named(ctx: ParallelContext, model, named: dict
                 ) -> dict[str, torch.Tensor]:
    """Tensors named and shaped like ``model``'s parameter shards (the
    shards, their gradients, optimizer state over them) in the full
    layout: each sharded one all-gathered over the model group, on every
    rank."""
    specs = decoder_param_specs(model)
    out = {}
    for name, t in named.items():
        d = spec_dim(specs[name], MODEL_AXIS)
        out[name] = (t.detach() if d is None or ctx.model_size == 1
                     else comm.all_gather(t.detach().contiguous(),
                                          ctx.model_group, d))
    return out


def gather_params(ctx: ParallelContext, model) -> dict[str, torch.Tensor]:
    """The inverse of ``shard_params``: the full parameters (name ->
    tensor on this rank's device), on every rank."""
    return gather_named(ctx, model, dict(model.named_parameters()))


_BATCH_2D_FIELDS = ("input_ids", "labels", "label_token_weights",
                    "segment_ids", "positions")


def batch_specs(ctx: ParallelContext, batch=None) -> dict[str, Spec]:
    """[B, L] fields shard their rows over data; scalars (the packed
    ``loss_norm``) replicate.  With ``batch`` the specs cover its keys."""
    keys = _BATCH_2D_FIELDS if batch is None else batch.keys()
    return {k: ((ctx.data_axis, None) if k in _BATCH_2D_FIELDS else ())
            for k in keys}


def _to_tensor(v, device) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return t.to(device)


def put_batch(ctx: ParallelContext, batch) -> dict[str, torch.Tensor]:
    """The global batch (host arrays or tensors, the same on every rank) to
    this rank's rows on its device: dim 0 of each row field split over the
    data axis (it must divide), the rest replicated."""
    specs = batch_specs(ctx, batch)
    out = {}
    for k, v in batch.items():
        t = _to_tensor(v, "cpu" if not torch.is_tensor(v) else v.device)
        if specs[k]:
            if t.shape[0] % ctx.data_size:
                raise ValueError(f"batch field {k!r} has {t.shape[0]} rows, "
                                 f"not a multiple of data size "
                                 f"{ctx.data_size}")
            n = t.shape[0] // ctx.data_size
            t = t[ctx.data_rank * n:(ctx.data_rank + 1) * n]
        out[k] = t.to(ctx.device)
    return out


def put_local_batch(ctx: ParallelContext, local_batch
                    ) -> dict[str, torch.Tensor]:
    """A batch that already holds this rank's rows (its loader's shard) to
    its device, as it is."""
    return {k: _to_tensor(v, ctx.device) for k, v in local_batch.items()}
