"""Fused row LayerNorm forward and backward, counterpart of
``tpu_flash/kernels/layernorm.py``.

``layernorm_forward(x, gamma, beta) -> (y, mean, var)`` and
``layernorm_backward(dy, x, gamma, mean, var) -> (dx, dgamma, dbeta)`` keep
the JAX package's signatures: the rows are every leading index of ``x``
(``R`` = their product), ``H`` its last axis; ``y`` and ``dx`` take
``x``'s dtype, ``mean`` and ``var`` are fp32 over the leading shape, and
``dgamma``, ``dbeta`` take ``gamma``'s dtype.  ``var = E[x^2] - mean^2``
and ``LN_EPS`` (1e-8) sits inside the rsqrt, as in the TPU kernel; all
arithmetic is fp32 whatever the dtypes, and only the stores round.

On CUDA tensors the forward launches ``csrc/layernorm_fwd.cu`` and the
backward ``csrc/layernorm_bwd.cu``; on CPU tensors they run
``layernorm_forward_plain`` / ``layernorm_backward_plain``, the same
arithmetic in plain PyTorch (``impl="kernel"|"plain"`` forces one).  The
forward takes its plan from ``_fwd_plan``: a row held in registers in
16-byte vectors (or the looped form), the rows a warp loads at once and a
grid sized to the card.  The backward is one launch: a persistent grid of clusters of 8 blocks
(``_bwd_clusters``) writes dx and finishes ``dgamma`` and ``dbeta`` itself,
in a fixed order, through a workspace of each cluster's fp32 partial sums
that is allocated once per device (``_workspace``); the JAX package sums its
per-tile slabs outside the Pallas call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu_flash_torch.kernels.common import (
    call_on_stream,
    cdiv,
    check_cuda,
    entry,
    kernel_input,
    launch_counts,
    resolve_impl,
    sm_count,
)

KERNEL_FWD = "layernorm_fwd"
KERNEL_BWD = "layernorm_bwd"
LN_EPS = 1e-8
# The backward kernel: blocks of 8 warps, a row a warp at a time, in
# clusters of 8 blocks; rows up to 1024 wide are held in registers, and the
# looped form (wider rows, H % 4 != 0) keeps a slab of shared memory a warp,
# which bounds H.
LN_BWD_WARPS = 8
LN_BWD_CLUSTER = 8
LN_BWD_HELD_MAX = 1024
LN_BWD_MAX_H = 3072
# The forward kernel: blocks of 8 warps, 2 an SM (tools/torch_ln_fwd_plans.py
# times 1 to 8: at 2 a warp walks two passes of rows at R8192, the second's
# loads in flight under the first's stores), each warp a row at a time (or
# two); rows up to 1024 wide are held in registers.
LN_FWD_WARPS = 8
LN_FWD_BLOCKS_PER_SM = 2
LN_FWD_HELD_MAX = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class FwdPlan(NamedTuple):
    """The forward kernel's launch: ``V`` values a vector and ``NV``
    vectors a lane of the held form (``V`` 0: the looped form), and the
    blocks of the grid."""
    V: int
    NV: int
    blocks: int
# the backward's workspace on each device: a counter for each eighth of the
# columns, then each cluster's [2H] partial sums
_workspaces: dict[torch.device, torch.Tensor] = {}


def _rows(x):
    H = x.shape[-1]
    return x.reshape(-1, H), x.numel() // H if H else 0, H


def layernorm_forward_plain(x, gamma, beta):
    """The forward kernel's function in plain PyTorch."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    xhat = (xf - mean) * torch.rsqrt(var + LN_EPS)
    y = (xhat * gamma + beta).to(x.dtype)
    return y, mean[..., 0], var[..., 0]


def layernorm_backward_plain(dy, x, gamma, mean, var):
    """The backward kernel's function in plain PyTorch."""
    dyf, xf, g = dy.float(), x.float(), gamma.float()
    H = x.shape[-1]
    rstd = torch.rsqrt(var[..., None] + LN_EPS)
    xhat = (xf - mean[..., None]) * rstd
    dxhat = dyf * g
    dx = (dxhat - (dxhat.sum(dim=-1, keepdim=True)
                   + xhat * (dxhat * xhat).sum(dim=-1, keepdim=True)) / H
          ) * rstd
    dgamma = (dyf * xhat).reshape(-1, H).sum(0)
    dbeta = dyf.reshape(-1, H).sum(0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def _check(x, gamma, what):
    for t in (x, gamma):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{what} takes float32 or bfloat16, got "
                            f"{t.dtype}")
    if gamma.shape != (x.shape[-1],):
        raise ValueError(f"gamma must be [{x.shape[-1]}], got "
                         f"{tuple(gamma.shape)}")


def _fwd_plan(R: int, H: int, dtype: torch.dtype, sms: int) -> FwdPlan:
    """The forward kernel's plan for R rows of H in ``dtype`` on a card of
    ``sms`` multiprocessors: a row held in 16-byte vectors (V = 8 in bf16,
    4 in fp32; 8-byte bf16 vectors where H % 8 != 0), NV the least power of
    two with 32 V NV >= H, up to H = 1024 and H % 4 == 0, else the looped
    form; blocks enough for every warp's rows (two a warp at once where a
    row is at most 32 bytes a lane, ``held_rows`` in the kernel), at most
    ``LN_FWD_BLOCKS_PER_SM`` an SM, at least one."""
    item = 2 if dtype == torch.bfloat16 else 4
    if H % 4 or H > LN_FWD_HELD_MAX:
        V = NV = 0
        rows = 1
    else:
        V = 8 if item == 2 and H % 8 == 0 else 4
        NV = 1
        while 32 * V * NV < H:
            NV *= 2
        rows = 2 if V * NV * item <= 32 else 1
    blocks = min(cdiv(max(R, 1), LN_FWD_WARPS * rows),
                 LN_FWD_BLOCKS_PER_SM * sms)
    return FwdPlan(V, NV, max(blocks, 1))


def _launch_forward(x, gamma, beta):
    _check(x, gamma, "layernorm_forward")
    if beta.dtype != gamma.dtype or beta.shape != gamma.shape:
        raise ValueError("beta must match gamma's shape and dtype")
    x2, R, H = _rows(x)
    x2, g, b = (kernel_input(t, x.device) for t in (x2, gamma, beta))
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    plan = _fwd_plan(R, H, x.dtype, sm_count(x.device))
    lib, fn = entry(KERNEL_FWD, "tf_layernorm_fwd",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
    err = call_on_stream(fn, x.device, x2.data_ptr(), g.data_ptr(),
                         b.data_ptr(), y.data_ptr(), mean.data_ptr(),
                         var.data_ptr(), R, H, _DTYPES[x.dtype],
                         _DTYPES[gamma.dtype], *plan)
    check_cuda(err, lib, "layernorm_fwd kernel")
    launch_counts[KERNEL_FWD] += 1
    lead = x.shape[:-1]
    return y.view(x.shape), mean.view(lead), var.view(lead)


def _bwd_clusters(R: int, H: int, sms: int) -> int:
    """Clusters of the backward kernel's persistent grid for R rows of H on
    a card of ``sms`` multiprocessors: blocks enough for a row a warp, at
    most as many as its registers let an SM hold at once (the held form
    takes ~63 registers a lane up to H = 256, ~118 up to 512 and ~216 up to
    1024; the looped form ~48); at least one cluster.  The C entry lowers
    it to the clusters of 8 the card holds at once, fewer than the blocks
    an SM allows suggest (a cluster's blocks share a GPC)."""
    held = H % 4 == 0 and H <= LN_BWD_HELD_MAX
    per_sm = 4 if H <= 256 or not held else 2 if H <= 512 else 1
    blocks = min(cdiv(max(R, 1), LN_BWD_WARPS), per_sm * sms)
    return cdiv(blocks, LN_BWD_CLUSTER)


def _workspace(device: torch.device, floats: int) -> torch.Tensor:
    """The backward's workspace on ``device``, at least ``floats`` long:
    allocated zeroed once and grown when a call needs more.  The kernel
    leaves its counter at 0, so calls on one device share it in stream
    order."""
    ws = _workspaces.get(device)
    if ws is None or ws.numel() < floats:
        ws = _workspaces[device] = torch.zeros(floats, dtype=torch.float32,
                                               device=device)
    return ws


def _launch_backward(dy, x, gamma, mean, var):
    _check(x, gamma, "layernorm_backward")
    if dy.dtype not in _DTYPES or dy.shape != x.shape:
        raise ValueError("dy must be float32 or bfloat16 of x's shape")
    if mean.shape != x.shape[:-1] or var.shape != x.shape[:-1]:
        raise ValueError("mean and var must have x's leading shape")
    dy2, R, H = _rows(dy)
    if H > LN_BWD_MAX_H:
        raise ValueError(f"the layernorm_bwd kernel takes H <= "
                         f"{LN_BWD_MAX_H}, got {H}")
    x2 = x.reshape(R, H)
    dy2, x2, g = (kernel_input(t, x.device) for t in (dy2, x2, gamma))
    m, v = (kernel_input(t.reshape(R).float(), x.device)
            for t in (mean, var))
    clusters = _bwd_clusters(R, H, sm_count(x.device))
    ws = _workspace(x.device, LN_BWD_CLUSTER + clusters * 2 * H)
    dx = torch.empty_like(x2)
    dgamma, dbeta = torch.empty(2, H, dtype=gamma.dtype, device=x.device)
    lib, fn = entry(KERNEL_BWD, "tf_layernorm_bwd",
                    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])
    err = call_on_stream(fn, x.device, dy2.data_ptr(), x2.data_ptr(),
                         g.data_ptr(), m.data_ptr(), v.data_ptr(),
                         dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                         ws.data_ptr(), R, H, clusters, _DTYPES[dy.dtype],
                         _DTYPES[x.dtype], _DTYPES[gamma.dtype])
    check_cuda(err, lib, "layernorm_bwd kernel")
    launch_counts[KERNEL_BWD] += 1
    return dx.view(x.shape), dgamma, dbeta


def layernorm_forward(x, gamma, beta, *, impl: str | None = None):
    """Row LayerNorm over the last axis; returns ``(y, mean, var)``.
    ``impl``: ``None`` launches the CUDA kernel for CUDA tensors and runs
    the plain version for CPU tensors; ``"plain"`` forces the plain one."""
    if resolve_impl(impl, x) == "plain":
        return layernorm_forward_plain(x, gamma, beta)
    return _launch_forward(x, gamma, beta)


def layernorm_backward(dy, x, gamma, mean, var, *, impl: str | None = None):
    """Backward of ``layernorm_forward``; returns ``(dx, dgamma, dbeta)``.
    ``impl`` as in the forward."""
    if resolve_impl(impl, x) == "plain":
        return layernorm_backward_plain(dy, x, gamma, mean, var)
    return _launch_backward(dy, x, gamma, mean, var)
