"""The parallel context: the mesh of ranks and the process groups the port
shards over, counterpart of ``tpu_flash/parallel/context.py``.

The JAX package lays devices out on a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives.  The port is explicit SPMD: one process per rank,
each holding its own shard of the parameters, the batch and the optimizer
state, and every collective an explicit call on a ``torch.distributed``
process group (``parallel/comm.py``).  A ``ParallelContext`` names two axes:

  * ``data``  -- data parallelism: batch rows split over the data group,
                 gradients averaged over it;
  * ``model`` -- tensor parallelism: attention heads, the feed-forward
                 hidden, the experts and the vocab split over the model
                 group (Megatron layouts, ``parallel/sharding.py``).

``make_mesh(data, model, dcn_data=h)`` lays the world out as ``[h, data,
model]`` with the model axis innermost: the ranks of one model group are
contiguous, so tensor-parallel collectives stay inside a host, and the data
axis is ordered [host slower, rank faster], as the JAX package's hybrid mesh
(``context.py:130-151``).  On one machine ``dcn_data`` > 1 emulates hosts as
contiguous rank blocks, the same order.

Launch: ``python -m torch.distributed.run --nproc-per-node N ...`` (the
``env://`` rendezvous), or ``initialize_distributed(init_method="file://...",
world_size=N, rank=r)`` from spawned processes (the tests and
``parallel/dryrun.py``).  Each rank binds ``cuda:{local_rank %
device_count}`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class ParallelContext:
    """This rank's place on a ``[dcn * data, model]`` mesh of ranks and the
    process groups of its two axes (``None`` for an axis of size 1)."""

    data_size: int            # dcn_data * data: the whole data axis
    model_size: int
    dcn_data: int
    rank: int
    data_rank: int
    model_rank: int
    data_group: object
    model_group: object
    mesh: tuple               # mesh[d][m] = the global rank there
    device: torch.device
    data_axis: str = DATA_AXIS
    model_axis: str = MODEL_AXIS

    def group(self, axis: str):
        """The process group of ``axis`` (``"data"`` or ``"model"``)."""
        if axis == self.data_axis:
            return self.data_group
        if axis == self.model_axis:
            return self.model_group
        raise ValueError(f"no mesh axis {axis!r} (have {self.data_axis!r}, "
                         f"{self.model_axis!r})")


_current: ParallelContext | None = None


def set_parallel_context(ctx: ParallelContext | None) -> None:
    global _current
    _current = ctx


def current_context() -> ParallelContext | None:
    return _current


@contextlib.contextmanager
def parallel_context(ctx: ParallelContext):
    prev = _current
    set_parallel_context(ctx)
    try:
        yield ctx
    finally:
        set_parallel_context(prev)


def local_rank() -> int:
    """``LOCAL_RANK`` under ``torch.distributed.run``, else the rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """``device`` as given, or ``cuda:{local_rank % device_count}`` for
    ``None`` or an unindexed ``"cuda"`` (``rank`` stands for the local rank
    before the process group exists); raises without a card (CPU runs ask
    for ``"cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "ranks on the CPU")
    local = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
             else rank if rank is not None else local_rank())
    return torch.device("cuda", local % torch.cuda.device_count())


def default_backend(world_size: int, device=None) -> str:
    """NCCL where every rank of this host has a card of its own; gloo on
    the CPU or where ranks share a card (NCCL refuses two ranks on one
    device), gloo then staging CUDA tensors through host memory
    (``comm.py``)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if torch.cuda.device_count() >= per_host else "gloo"


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, *,
                           backend: str | None = None, device=None,
                           timeout_s: float = 600.0) -> None:
    """Join the job: wraps ``dist.init_process_group``.  Idempotent: a
    second call in an initialized process is a no-op (the JAX package's
    contract, ``context.py:100-127``).

    Under ``torch.distributed.run`` every argument comes from the
    environment (``env://``); spawned processes pass a ``file://`` store,
    the world size and their rank.  ``backend`` None takes
    ``default_backend``.  A CUDA rank binds its card first."""
    if dist.is_initialized():
        return
    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    backend = backend or default_backend(world_size, device)
    dev = None
    if device is not None or torch.cuda.is_available():
        dev = rank_device(device, rank)
    if dev is not None and dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def _groups(blocks):
    """One process group for each block of ranks, made on every rank in
    the same order (``new_group`` is collective); returns the group of the
    block that holds this rank, None where that block has one rank."""
    me = dist.get_rank()
    mine = None
    for ranks in blocks:
        g = dist.new_group(list(ranks))
        if me in ranks:
            mine = g if len(ranks) > 1 else None
    return mine


def make_mesh(data: int = 1, model: int = 1, *, dcn_data: int = 1,
              device=None) -> ParallelContext:
    """The ``[dcn_data * data, model]`` mesh over the world's ranks, model
    innermost; ``device`` as ``rank_device`` takes it.  Every rank must call
    it with the same arguments, in the same order as its other groups."""
    if not dist.is_initialized():
        raise RuntimeError("initialize_distributed() first")
    world = dist.get_world_size()
    n = dcn_data * data * model
    if n != world:
        raise ValueError(
            f"mesh dcn={dcn_data} x {data}x{model} != {world} ranks")
    rows = dcn_data * data
    mesh = tuple(tuple(d * model + m for m in range(model))
                 for d in range(rows))
    me = dist.get_rank()
    data_rank, model_rank = divmod(me, model)
    model_group = _groups(mesh)
    data_group = _groups([tuple(mesh[d][m] for d in range(rows))
                          for m in range(model)])
    return ParallelContext(
        data_size=rows, model_size=model, dcn_data=dcn_data, rank=me,
        data_rank=data_rank, model_rank=model_rank, data_group=data_group,
        model_group=model_group, mesh=mesh, device=rank_device(device))
