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
backward kernel writes fp32 partial sums of ``dy * xhat`` and ``dy`` for
each block of ``LN_BWD_ROWS`` rows into a ``[n_blocks, H]`` workspace, and
one torch sum over the blocks finishes ``dgamma`` and ``dbeta``, as the JAX
package sums its per-tile slabs outside the Pallas call.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_flash_torch.kernels.common import (
    call_on_stream,
    cdiv,
    check_cuda,
    entry,
    kernel_input,
    launch_counts,
    resolve_impl,
)

KERNEL_FWD = "layernorm_fwd"
KERNEL_BWD = "layernorm_bwd"
LN_EPS = 1e-8
LN_BWD_ROWS = 32       # rows per block of the backward kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _launch_forward(x, gamma, beta):
    _check(x, gamma, "layernorm_forward")
    if beta.dtype != gamma.dtype or beta.shape != gamma.shape:
        raise ValueError("beta must match gamma's shape and dtype")
    x2, R, H = _rows(x)
    x2, g, b = (kernel_input(t, x.device) for t in (x2, gamma, beta))
    y = torch.empty_like(x2)
    mean = torch.empty(R, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    lib, fn = entry(KERNEL_FWD, "tf_layernorm_fwd",
                    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                    + [ctypes.c_void_p])
    err = call_on_stream(fn, x.device, x2.data_ptr(), g.data_ptr(),
                         b.data_ptr(), y.data_ptr(), mean.data_ptr(),
                         var.data_ptr(), R, H, _DTYPES[x.dtype],
                         _DTYPES[gamma.dtype])
    check_cuda(err, lib, "layernorm_fwd kernel")
    launch_counts[KERNEL_FWD] += 1
    lead = x.shape[:-1]
    return y.view(x.shape), mean.view(lead), var.view(lead)


def _launch_backward(dy, x, gamma, mean, var):
    _check(x, gamma, "layernorm_backward")
    if dy.dtype not in _DTYPES or dy.shape != x.shape:
        raise ValueError("dy must be float32 or bfloat16 of x's shape")
    if mean.shape != x.shape[:-1] or var.shape != x.shape[:-1]:
        raise ValueError("mean and var must have x's leading shape")
    dy2, R, H = _rows(dy)
    x2 = x.reshape(R, H)
    dy2, x2, g = (kernel_input(t, x.device) for t in (dy2, x2, gamma))
    m, v = (kernel_input(t.reshape(R).float(), x.device)
            for t in (mean, var))
    n_blocks = cdiv(R, LN_BWD_ROWS)
    dx = torch.empty_like(x2)
    part = torch.empty(2, n_blocks, H, dtype=torch.float32, device=x.device)
    lib, fn = entry(KERNEL_BWD, "tf_layernorm_bwd",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                    + [ctypes.c_void_p])
    err = call_on_stream(fn, x.device, dy2.data_ptr(), x2.data_ptr(),
                         g.data_ptr(), m.data_ptr(), v.data_ptr(),
                         dx.data_ptr(), part[0].data_ptr(),
                         part[1].data_ptr(), R, H, LN_BWD_ROWS,
                         _DTYPES[dy.dtype], _DTYPES[x.dtype],
                         _DTYPES[gamma.dtype])
    check_cuda(err, lib, "layernorm_bwd kernel")
    launch_counts[KERNEL_BWD] += 1
    dgamma, dbeta = part.sum(dim=1).to(gamma.dtype)
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
