"""Vocab-parallel fused lm_head + cross-entropy over the model group,
counterpart of ``tpu_flash/parallel/vocab_loss.py``.

The Megatron-LM design: every model rank turns its own vocab slice of
``lm_head`` into (max, sumexp, picked-logit) partials over ``n_chunks``
slices of it, and one MAX and two SUM all-reduces over the model group merge
them; no rank ever holds a full-vocab logits row, and the collectives move
O(N) scalars.  The backward sums dx over the model group.  dW and db stay
the sums over this rank's tokens: JAX's sums them over the data axis inside
its loss, where the port's sharded step (``make_sharded_train_step``) owns
that reduction and averages every gradient over the data group itself.

The JAX package pads the global vocab to ``tp * n_chunks`` columns of -inf
bias (``vocab_loss.py:62-75``); here each rank holds ``V / tp`` columns (the
sharding needs tp to divide V) and the last of its chunks is padded with
-inf columns instead, which add exactly 0 either way.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.parallel.context import ParallelContext, current_context


def vocab_parallel_softmax_loss(hidden: torch.Tensor, weight: torch.Tensor,
                                bias: torch.Tensor | None,
                                labels: torch.Tensor, *, n_chunks: int = 4,
                                ctx: ParallelContext | None = None
                                ) -> torch.Tensor:
    """Per-token cross-entropy of ``hidden @ weight^T + bias`` against
    ``labels``, fp32, shaped like ``labels``.

    ``hidden`` [B, L, E] or [N, E] (this rank's rows, replicated over the
    model group); ``weight`` [V / tp, E] and ``bias`` [V / tp]: this rank's
    ``lm_head`` shard (``parallel.shard_params``); ``labels`` global ids.
    Differentiable in ``hidden``, ``weight`` and ``bias``; dW and db over
    this rank's tokens only (the data reduction is the caller's).

    Without a context (or with a model size of 1) this is the
    single-device chunked loss, so callers may use it unconditionally."""
    ctx = ctx or current_context()
    if ctx is None or ctx.model_size == 1:
        return F.chunked_softmax_loss(hidden, weight, bias, labels,
                                      n_chunks=n_chunks)
    return F.chunked_softmax_loss(hidden, weight, bias, labels,
                                  n_chunks=n_chunks,
                                  axis_name=ctx.model_group)
