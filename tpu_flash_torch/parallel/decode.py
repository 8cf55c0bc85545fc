"""Sharded decode: the rows of a cached forward split over the data group,
counterpart of the tensor-parallel decode in the JAX package's
``nn/transformer.py:262-305``.

Under a parallel context the model's heads are split over the model group
by its shards (``parallel.shard_params``; the caches then hold this rank's
KV heads, and the flash-decode kernel runs on them).  ``RowSplit`` adds the
data axis: a batch of ``n`` rows (the engine's slots, ``generate``'s
prompts) keeps ``n / data_size`` of them on each data rank -- its caches
hold only those -- and the logits of every row are all-gathered, so that the
host logic (sampling, admission, retirement) runs the same on every rank.
A batch the data size does not divide (one prompt's prefill) runs whole on
every rank.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.parallel import comm
from tpu_flash_torch.parallel.context import current_context


class RowSplit:
    """Rows ``[r0, r0 + n_local)`` of ``n_rows`` on this data rank."""

    def __init__(self, n_rows: int):
        ctx = current_context()
        self.group = None
        self.n_local, self.r0 = n_rows, 0
        if (ctx is not None and ctx.data_size > 1
                and n_rows % ctx.data_size == 0):
            self.group = ctx.data_group
            self.n_local = n_rows // ctx.data_size
            self.r0 = ctx.data_rank * self.n_local

    @property
    def split(self) -> bool:
        return self.group is not None

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor over all of them."""
        return t if self.group is None else t[self.r0:self.r0 + self.n_local]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in order."""
        return comm.all_gather(t.contiguous(), self.group, 0)

    def owned(self, row: int) -> int | None:
        """The local index of global ``row``, None where another data rank
        holds it."""
        i = row - self.r0
        return i if 0 <= i < self.n_local else None
