"""Sequence (context) parallelism: causal attention over a sequence split
across the ranks of a group, counterpart of ``tpu_flash/parallel/sequence.py``.

Rank r holds query, key and value chunk r of a global causal attention over
``L_glob = L_loc * n``.  The chunk level of the flash decomposition runs
across ranks, the tile level inside each chunk stays in the kernels:

* ``allgather_attention`` -- K/V all-gathered over the group (one
  collective; its transpose a reduce-scatter), then each rank merges the
  partials of its chunk distances;
* ``ring_attention`` -- K/V travel one hop a step around the ring
  (``comm.shift``; its transpose the reverse hop), memory O(L_loc).

Each partial ``(out, lse)`` comes from the port's flash kernels through
``_AttentionWithLse``, whose backward takes the lse cotangent
(``flash_attention_backward(dlse=)``); the diagonal chunk is the local
causal call, a chunk ``dist`` behind is causal with ``q_offset = dist *
L_loc`` (the causal test vacuous, a window band landing on the right global
columns), and a chunk ahead gives an empty partial.  The merge is plain
torch, in fp32: the running output stays fp32 until the end, and in bf16
q enters as an fp32 copy cast down for each partial, so that its partials'
gradients add up in fp32 and out and dq are rounded to bf16 once.  K/V
travel in their own dtype, as JAX's do: the all-gather and each ring hop
move bf16, and so do their transposes (the reduce-scatter, the reverse
hop), which add a chunk's gradients in that dtype.  With a ``window``
only distances ``< ceil(window / L_loc) + 1``
have keys in any row's window: the ring truncates there, and neither their
compute nor their communication happens.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.kernels.flash_attention import (
    flash_attention_backward, flash_attention_forward)
from tpu_flash_torch.parallel import comm


class _AttentionWithLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, q_offset, impl):
        out, lse, _ = flash_attention_forward(
            q, k, v, causal=True, window=window, q_offset=q_offset,
            impl=impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (window, q_offset, impl)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        window, q_offset, impl = ctx.args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, do.contiguous(), dlse, causal=True,
            window=window, q_offset=q_offset, impl=impl)
        return dq, dk, dv, None, None, None


def merge_partials(o1, lse1, o2, lse2):
    """The online-softmax merge of two partials over disjoint key sets
    (``out [B, H, L, d]``, ``lse [B, H, L]``); ``lse = -inf`` marks an
    empty one and is absorbed exactly.  The merged output is fp32."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w1 = torch.where(torch.isneginf(lse1), 0.0, torch.exp(lse1 - m_safe))
    w2 = torch.where(torch.isneginf(lse2), 0.0, torch.exp(lse2 - m_safe))
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) \
        / denom_safe[..., None]
    return o, m + torch.log(denom_safe)


def window_steps(n: int, chunk_len: int, window: int | None) -> int:
    """Chunk distances with any key in some row's window: all ``n``
    without a window, else ``min(n, ceil(window / chunk_len) + 1)``."""
    if window is None:
        return n
    return min(n, -(-window // chunk_len) + 1)


def _partial(q32, kv, dist, impl, window, chunk_len):
    return _AttentionWithLse.apply(q32.to(kv.dtype), kv[0], kv[1], window,
                                   dist * chunk_len if dist else None, impl)


def _empty(q):
    B, H, L, _ = q.shape
    return (torch.zeros(q.shape, device=q.device),
            torch.full((B, H, L), float("-inf"), device=q.device))


def allgather_attention(q, k, v, *, axis_name=None, impl=None,
                        window: int | None = None, stats=None):
    """Causal flash attention with the sequence split over ``axis_name``
    (a process group, a context axis name, or None for the world); q, k, v
    are this rank's ``[B, H, L_loc, d]`` chunks.  ``stats`` (a dict) gets
    the partials computed (``"partials"``) and the bytes of the gathered
    K/V (``"kv_bytes"``)."""
    group = comm.resolve_group("world" if axis_name is None else axis_name)
    n, my = comm.group_size(group), comm.group_rank(group)
    Lc, dt = q.shape[-2], q.dtype
    kv = comm.gather_sequence(torch.stack([k, v])[None], group, 0)
    q32 = q.float()
    out, lse = _empty(q)
    done = 0
    for dist in range(window_steps(n, Lc, window)):
        if my - dist < 0:
            continue                      # a chunk ahead: empty
        o_c, lse_c = _partial(q32, kv[my - dist], dist, impl, window, Lc)
        out, lse = merge_partials(out, lse, o_c, lse_c)
        done += 1
    if stats is not None:
        stats["partials"] = stats.get("partials", 0) + done
        stats["kv_bytes"] = (stats.get("kv_bytes", 0)
                             + kv.numel() * kv.element_size())
    return out.to(dt)


def ring_attention(q, k, v, *, axis_name=None, impl=None,
                   window: int | None = None, stats=None):
    """Ring flash attention: at step s rank r holds the K/V chunk of rank
    ``r - s`` (a static distance s behind, or a wrapped chunk ahead, which
    it skips) and merges its partial; the chunk then moves one hop right.
    Under a ``window`` the ring stops after ``window_steps`` hops.
    ``stats`` gets ``"hops"``, ``"partials"`` and the bytes of K/V the
    hops received (``"kv_bytes"``)."""
    group = comm.resolve_group("world" if axis_name is None else axis_name)
    n, my = comm.group_size(group), comm.group_rank(group)
    Lc, dt = q.shape[-2], q.dtype
    steps = window_steps(n, Lc, window)
    kv = torch.stack([k, v])
    q32 = q.float()
    out, lse = _empty(q)
    held, done = [], 0
    for s in range(steps):
        if my >= s:
            o_c, lse_c = _partial(q32, kv, s, impl, window, Lc)
            out, lse = merge_partials(out, lse, o_c, lse_c)
            done += 1
        if s + 1 < steps:
            kv = comm.shift(kv, group, 1)
            held.append(kv)
    if stats is not None:
        stats["hops"] = stats.get("hops", 0) + len(held)
        stats["partials"] = stats.get("partials", 0) + done
        stats["kv_bytes"] = stats.get("kv_bytes", 0) + sum(
            t.numel() * t.element_size() for t in held)
    # every hop's output stays in the graph on every rank, so each rank
    # runs every reverse hop of the backward, used or not
    for t in held:
        out = out + 0.0 * t.reshape(-1)[0]
    return out.to(dt)


def sequence_parallel_attention(q, k, v, *, axis_name=None,
                                strategy: str = "allgather", impl=None,
                                window: int | None = None, stats=None):
    """``strategy`` in {"allgather", "ring"}."""
    if strategy == "allgather":
        return allgather_attention(q, k, v, axis_name=axis_name, impl=impl,
                                   window=window, stats=stats)
    if strategy == "ring":
        return ring_attention(q, k, v, axis_name=axis_name, impl=impl,
                              window=window, stats=stats)
    raise ValueError(f"unknown sequence-parallel strategy: {strategy}")
