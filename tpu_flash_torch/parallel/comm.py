"""Collectives of the parallel layer: what GSPMD inserts in the JAX package,
written as explicit calls on process groups, each differentiable one an
``autograd.Function`` whose backward is its transpose.

Every other module of ``parallel/`` and the model's tensor-parallel hooks
reach collectives through this one.  A group of ``None`` is an axis of one
rank: every function returns its input.

Conventions (the autograd of JAX's ``shard_map`` collectives):
  * over the model group the loss is replicated -- every model rank computes
    the same value -- so ``copy_to_group`` (identity, backward all-reduce)
    enters a tensor-parallel region and ``reduce_from_group`` (all-reduce,
    backward identity) leaves it; ``gather_from_group`` (all-gather,
    backward: this rank's slice) joins a sharded dim under a replicated
    cotangent;
  * Megatron sequence parallelism swaps them for ``gather_sequence``
    (all-gather, backward reduce-scatter) and ``scatter_sequence``
    (reduce-scatter, backward all-gather), and enters with
    ``split_to_group`` (this rank's slice, backward all-gather);
  * ``all_reduce_sum`` is ``psum``: its transpose is itself;
  * ``shift`` moves a tensor ``offset`` places along the group's ring; its
    transpose is the reverse shift.

Transport: a group's backend decides, by one fixed rule in ``_on_host``,
whether a CUDA tensor is staged through host memory.  gloo moves CUDA
tensors through the host (four ranks sharing one card cannot use NCCL,
which refuses two ranks on one device); NCCL takes them as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def backend(group) -> str:
    return dist.get_backend(group)


def transport(group) -> str:
    """``"gloo-host"``, ``"nccl"`` or ``"local"`` (one rank)."""
    if group is None:
        return "local"
    return "gloo-host" if backend(group) == "gloo" else backend(group)


def _on_host(group, t: torch.Tensor) -> bool:
    """The transport rule: a CUDA tensor on a gloo group goes through host
    memory."""
    return t.is_cuda and backend(group) == "gloo"


def _staged(group, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if _on_host(group, t) else t


# ---------------------------------------------------------------- primitives
def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group``."""
    if group is None:
        return t.clone()
    buf = _staged(group, t).contiguous().clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    src = _staged(group, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``t`` summed over ``group`` (the
    dim must divide).  gloo: an all-reduce, then the slice; NCCL:
    ``reduce_scatter_tensor``."""
    if group is None:
        return t
    n = group_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {n} ranks")
    if _on_host(group, t) or not t.is_cuda:
        return all_reduce(t, group).chunk(n, dim)[group_rank(group)] \
            .contiguous()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def local_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``t`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"over {n} ranks")
    return t.chunk(n, dim)[group_rank(group)].contiguous()


def broadcast(t: torch.Tensor, group, src_rank: int) -> torch.Tensor:
    """``t`` of group rank ``src_rank`` on every rank (a new tensor)."""
    if group is None:
        return t
    buf = _staged(group, t).contiguous().clone()
    dist.broadcast(buf, dist.get_global_rank(group, src_rank), group=group)
    return buf.to(t.device)


def send(t: torch.Tensor, group, dst_rank: int) -> None:
    """Point-to-point send to group rank ``dst_rank`` (the pipeline's stage
    hand-off)."""
    dist.send(_staged(group, t).contiguous(),
              dist.get_global_rank(group, dst_rank), group=group)


def recv(like: torch.Tensor, group, src_rank: int) -> torch.Tensor:
    """A tensor shaped like ``like`` from group rank ``src_rank``."""
    buf = torch.empty_like(like, device="cpu" if _on_host(group, like)
                           else like.device)
    dist.recv(buf, dist.get_global_rank(group, src_rank), group=group)
    return buf.to(like.device)


def _shift(t: torch.Tensor, group, offset: int) -> torch.Tensor:
    """Rank r's ``t`` lands on rank ``(r + offset) mod n``: each rank sends
    and receives once, both posted before either waits."""
    n = group_size(group)
    if n == 1 or offset % n == 0:
        return t
    me = group_rank(group)
    src = _staged(group, t).contiguous()
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (me + offset) % n), group),
           dist.P2POp(dist.irecv, buf,
                      dist.get_global_rank(group, (me - offset) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf.to(t.device)


# ---------------------------------------------------- differentiable forms
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather; backward this rank's slice (replicated cotangent)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return local_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    """All-gather; backward reduce-scatter (partial cotangents)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return _shift(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return _shift(g.contiguous(), ctx.group, -ctx.offset), None, None


def copy_to_group(x, group):
    """Identity; backward all-reduce: the entry of a tensor-parallel
    region (column-parallel input)."""
    return x if group is None else _Copy.apply(x, group)


def reduce_from_group(x, group):
    """All-reduce; backward identity: a row-parallel output's partial
    sums."""
    return x if group is None else _Reduce.apply(x, group)


def all_reduce_sum(x, group):
    """``psum``: all-reduce forward and backward."""
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_from_group(x, group, dim: int = -1):
    """All-gather along ``dim``; backward this rank's slice."""
    return x if group is None else _Gather.apply(x, group, dim % x.dim())


def split_to_group(x, group, dim: int):
    """This rank's slice along ``dim``; backward all-gather."""
    return x if group is None else _Split.apply(x, group, dim % x.dim())


def gather_sequence(x, group, dim: int = 1):
    """All-gather along ``dim``; backward reduce-scatter: Megatron-SP's
    entry to a tensor-parallel block, or the all-gather of K/V."""
    return x if group is None else _GatherSum.apply(x, group, dim % x.dim())


def scatter_sequence(x, group, dim: int = 1):
    """Reduce-scatter along ``dim``; backward all-gather: Megatron-SP's
    exit from a row-parallel product."""
    return x if group is None else _ScatterSum.apply(x, group, dim % x.dim())


def shift(x, group, offset: int = 1):
    """The ring hop: rank r's ``x`` to rank ``r + offset``; backward the
    reverse hop."""
    return x if group is None else _Shift.apply(x, group, offset)


def all_ranks_true(flag: torch.Tensor, group=None) -> torch.Tensor:
    """A 0-d bool that is true where ``flag`` is true on every rank of
    ``group`` (None: the world), by a MIN all-reduce, on ``flag``'s
    device."""
    if not dist.is_initialized():
        return flag
    group = dist.group.WORLD if group is None else group
    if dist.get_world_size(group) == 1:
        return flag
    return all_reduce(flag.to(torch.int32), group,
                      dist.ReduceOp.MIN).to(torch.bool)


def flat_all_reduce(tensors: list[torch.Tensor], group,
                    scale: float = 1.0) -> list[torch.Tensor]:
    """``tensors`` summed over ``group`` and multiplied by ``scale``, in one
    collective per dtype (a flat bucket), each returned in its own shape."""
    if group is None:
        return [t * scale if scale != 1.0 else t for t in tensors]
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        flat = all_reduce(flat, group)
        if scale != 1.0:
            flat = flat * scale
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def resolve_group(axis):
    """A process group from ``axis``: None stays None (no reduction), a
    mesh axis name (``"data"``, ``"model"``) is the current context's group
    of that axis, ``"world"`` every rank, and a group is itself."""
    if axis is None:
        return None
    if isinstance(axis, str):
        if axis == "world":
            return dist.group.WORLD
        from tpu_flash_torch.parallel.context import current_context

        ctx = current_context()
        if ctx is None:
            raise ValueError(f"axis {axis!r} needs an active parallel "
                             f"context")
        return ctx.group(axis)
    return axis


def _rows(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``t`` as ``[n, -1]``: row r holds its r-th equal slice along
    ``dim``."""
    return t.movedim(dim, 0).reshape(n, -1)


def flat_reduce_scatter(tensors: list, dims: list, group,
                        scale: float = 1.0) -> list:
    """Each tensor summed over ``group`` (times ``scale``), this rank
    keeping its equal slice along its dim: one collective for the whole
    list (a dtype), each rank's slices laid out contiguously."""
    n = group_size(group)
    if n == 1:
        return [t * scale if scale != 1.0 else t for t in tensors]
    flat = torch.cat([_rows(t, d, n) for t, d in zip(tensors, dims)], 1)
    mine = reduce_scatter(flat.contiguous(), group, 0)[0]
    if scale != 1.0:
        mine = mine * scale
    out, off = [], 0
    for t, d in zip(tensors, dims):
        moved = t.movedim(d, 0)
        shape = (moved.shape[0] // n, *moved.shape[1:])
        k = t.numel() // n
        out.append(mine[off:off + k].reshape(shape).movedim(0, d))
        off += k
    return out


def flat_all_gather(tensors: list, dims: list, group) -> list:
    """Every rank's slices joined along each tensor's dim: the inverse of
    ``flat_reduce_scatter``'s split, one collective for the list."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    flat = torch.cat([t.movedim(d, 0).reshape(-1)
                      for t, d in zip(tensors, dims)])
    rows = all_gather(flat[None].contiguous(), group, 0)       # [n, total]
    out, off = [], 0
    for t, d in zip(tensors, dims):
        moved = t.movedim(d, 0)
        k = t.numel()
        part = rows[:, off:off + k].reshape(n * moved.shape[0],
                                            *moved.shape[1:])
        out.append(part.movedim(0, d).contiguous())
        off += k
    return out
