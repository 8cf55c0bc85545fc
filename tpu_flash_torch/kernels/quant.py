"""Weight-only quantized matmuls, counterpart of
``tpu_flash/kernels/quant.py``: int8 codes with per-column scales, and
packed int4 codes with per-column or group scales.

Weights keep the JAX package's layouts, so a quantized JAX tree loads as a
copy: int8 codes ``[K, N]`` with fp32 scales ``[N]``; packed uint8
``[ceil(K/2), N]`` holding two int4 codes a byte in split halves (byte row
``r``: code ``r`` in the low nibble, code ``ceil(K/2) + r`` in the high one,
each biased by +8), with fp32 scales ``[N]`` or ``[K/g, N]``.  The
quantizers give JAX's codes and scales bit for bit (both round half to
even).

``int8_matmul`` and ``int4_matmul`` launch ``csrc/int8_matmul.cu`` and
``csrc/int4_matmul.cu`` on CUDA tensors and run ``*_plain``, the same
arithmetic in plain PyTorch, on CPU tensors (``impl="kernel"|"plain"``
forces one).  Each source holds up to six forms of its kernels, and
``_plan``, a rule on the shape, the dtype and the group, picks one.  bf16
x where the tensor cores' k depth of 16 divides the group runs bf16
products with fp32 sums on the tensor cores: ``decode_tc`` at M <= 8
where 16 divides N too (one launch, the code rows split over a
thread-block cluster, counted under the kernel's name with ``_dec``),
``tensor_core`` above (counted with ``_tc``).  fp32 x runs the same two
shapes of launch with x split into three bf16 planes, each product three
exact bf16 products: ``decode_tc_x3`` at M <= 8 (N a multiple of 16;
counted with ``_dec_x3``) and ``tensor_core_x3`` above (counted with
``_x3``), per column or in groups that are a multiple of 16.  The rest
(groups that are not a multiple of 16, at M <= 8 N that is not, and more
code rows than a decode form's cluster takes) runs fp32 FMAs on the CUDA
cores: ``decode`` at M <= 8 and ``cuda_core`` above (such groups only),
counted under the kernel's name.  All round as the TPU kernels do: the
fp32 product of x and the integer codes is scaled after the dot (grouped:
each group's partial dot is scaled, then summed), and the weight is never
dequantized first.
``int8_linear`` and ``int4_linear`` are differentiable in x only, as the
JAX package's ``custom_vjp``s: dx of the per-column forms runs the int8
kernel on the transposed codes with the scales folded into dy; the grouped
form takes a dense matmul of the dequantized weight, as JAX's ``jnp.dot``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from tpu_flash_torch.kernels.common import (
    DEC,
    DEC_X3,
    TC,
    X3,
    call_on_stream,
    cdiv,
    check_cuda,
    entry,
    kernel_input,
    launch_counts,
    resolve_impl,
    round_up,
    sm_count,
)

KERNEL_INT8 = "int8_matmul"
KERNEL_INT4 = "int4_matmul"          # source, and launches of per-column int4
KERNEL_INT4_GROUP = "int4_matmul_group"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The forms (quant_matmul.cuh): rows and columns of out a block, code rows a
# slab (the chunks of a split are whole slabs), the blocks wanted for each
# streaming multiprocessor, and their id in the C entries (``form``).
_FORMS = {"decode": (8, 128, 128, 2), "cuda_core": (64, 128, 32, 2),
          "tensor_core": (128, 64, 64, 1), "decode_tc": (8, None, 64, 1),
          "tensor_core_x3": (128, 128, 64, 1),
          "decode_tc_x3": (8, None, 64, 1)}
_FORM_IDS = {"decode": 0, "cuda_core": 1, "tensor_core": 2, "decode_tc": 3,
             "tensor_core_x3": 4, "decode_tc_x3": 5}
# The tensor-core decode forms: blocks a cluster at most (the portable
# limit); code bytes a warp's ring stage and stages at most (two 4 KB stages
# a warp streamed lm_head fastest on an H100: tools/torch_decode_plans.py);
# code rows a block at most (its slice of x stays in shared memory: up to
# 8 x 2 x 2048 bf16, and fp32 x's three bf16 planes, 8 x 2 x 1024 each).
_DEC_CLUSTER, _DEC_STAGE_BYTES, _DEC_STAGES = 8, 4096, 2
_DEC_ROWS = {"decode_tc": 2048, "decode_tc_x3": 1024}


class Plan(NamedTuple):
    """A launch: the form, its tile (``bm`` x ``bn`` of out), the code
    rows split into ``splits`` ranges of ``chunk`` rows (the decode forms
    on the tensor cores: the blocks of a cluster), the blocks, and those
    forms' ring: each warp's ``stages`` of ``stage_rows`` code rows (0 in
    the other forms, whose kernels fix their own)."""
    form: str
    bm: int
    bn: int
    splits: int
    chunk: int
    blocks: int
    stages: int = 0
    stage_rows: int = 0


class QuantizedLinearWeights(NamedTuple):
    """int8 codes [K, N] + per-output-channel scales [N] (+ optional bias)."""
    codes: torch.Tensor
    scales: torch.Tensor
    bias: torch.Tensor | None = None


class QuantizedLinearWeights4(NamedTuple):
    """Packed int4 codes [ceil(K/2), N] (uint8) + fp32 scales ([N], or
    [K/g, N] by group) (+ optional bias); ``k_dim`` is the true K."""
    codes: torch.Tensor
    scales: torch.Tensor
    k_dim: int
    bias: torch.Tensor | None = None


def quantize_weight(w: torch.Tensor, *, axis: int = 0):
    """Symmetric per-channel int8 quantization of a [K, N] weight; ``axis``
    is the reduction (input) axis.  Returns (codes int8, scales fp32)."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis)
    scales = torch.where(amax == 0.0, 1.0, amax / 127.0)
    codes = torch.clamp(torch.round(wf / scales), -127, 127).to(torch.int8)
    return codes, scales


def quantize_weight_int4(w: torch.Tensor, *, group_size: int | None = None,
                         allow_small_groups: bool = False):
    """Symmetric int4 quantization of a [K, N] weight, codes in [-7, 7]
    stored +8 in a nibble, packed in split halves.  ``group_size``: scales
    per (K-group, column), which needs ``K % (2 * group_size) == 0``; groups
    under 128 need ``allow_small_groups`` (the JAX package's TPU rule, kept
    so both accept the same arguments).  Odd K (per column only) is padded
    with code 8 (value 0).  Returns (packed uint8 [ceil(K/2), N], scales
    fp32 [N] or [K/g, N], K)."""
    K, N = w.shape
    wf = w.float()
    if group_size is not None:
        g = int(group_size)
        if K % (2 * g):
            raise ValueError(
                f"group_size={g} requires K % (2*group_size) == 0 (K={K}): "
                f"the split-half packing needs whole groups per half")
        if g < 128 and not allow_small_groups:
            raise ValueError(
                f"group_size={g} < 128 underutilizes the MXU (one group = "
                f"one dot contraction); use group_size>=128, or pass "
                f"allow_small_groups=True for tests/interpret mode")
        wg = wf.reshape(K // g, g, N)
        amax = wg.abs().amax(dim=1)                           # [K/g, N]
        scales = torch.where(amax == 0.0, 1.0, amax / 7.0)
        v = torch.clamp(torch.round(wg / scales[:, None, :]), -7, 7) + 8.0
        v = v.reshape(K, N).to(torch.uint8)
        return v[: K // 2] | (v[K // 2:] << 4), scales, K
    amax = wf.abs().amax(dim=0)
    scales = torch.where(amax == 0.0, 1.0, amax / 7.0)
    v = (torch.clamp(torch.round(wf / scales), -7, 7) + 8.0).to(torch.uint8)
    Kp = K
    if K % 2:
        v = torch.cat([v, torch.full((1, N), 8, dtype=torch.uint8,
                                     device=v.device)])
        Kp += 1
    return v[: Kp // 2] | (v[Kp // 2:] << 4), scales, K


def unpack_int4(packed: torch.Tensor, k_dim: int) -> torch.Tensor:
    """Packed uint8 [K'/2, N] -> int8 codes [k_dim, N] (split-half order)."""
    w = packed.to(torch.int32)
    return torch.cat([(w & 0xF) - 8, (w >> 4) - 8])[:k_dim].to(torch.int8)


def dequantize(codes, scales, k_dim: int) -> torch.Tensor:
    """The fp32 weight [k_dim, N] that int8 codes, or packed int4 codes,
    with per-column or group scales stand for."""
    if codes.dtype == torch.uint8:
        codes = unpack_int4(codes, k_dim)
    s = scales.float()
    if s.dim() == 2:
        s = s.repeat_interleave(k_dim // s.shape[0], dim=0)
    return codes.float() * s


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def int8_matmul_plain(x, codes, scales):
    """The int8 kernel's function in plain PyTorch: fp32 dot of x and the
    codes, times the column scales, rounded to x's dtype."""
    _check_int8(x, codes)
    acc = x.float() @ codes.float()
    return (acc * scales.float()).to(x.dtype)


def int4_matmul_plain(x, packed, scales, *, k_dim=None):
    """The int4 kernels' function in plain PyTorch.  Per column: the fp32
    dot with the unpacked codes, times the scales.  Grouped: slab by slab,
    as the TPU kernel walks them, the low half's group and the high half's
    each dotted, scaled and added to the sum."""
    grouped = _check_int4(x, packed, scales, k_dim)
    K = x.shape[1]
    codes = unpack_int4(packed, K).float()
    xf = x.float()
    if not grouped:
        acc = (xf @ codes) * scales.float()
    else:
        G = scales.shape[0]
        g, h = K // G, K // 2
        s = scales.float()
        acc = torch.zeros(x.shape[0], packed.shape[1], dtype=torch.float32,
                          device=x.device)
        for i in range(G // 2):
            lo, hi = slice(i * g, (i + 1) * g), slice(h + i * g, h + (i + 1) * g)
            acc = acc + (xf[:, lo] @ codes[lo]) * s[i]
            acc = acc + (xf[:, hi] @ codes[hi]) * s[G // 2 + i]
    return acc.to(x.dtype)


# ---------------------------------------------------------------------------
# Checks (the JAX package's asserts and errors)
# ---------------------------------------------------------------------------

def _check_int8(x, codes):
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[0]:
        raise ValueError(f"x [M, K] and codes [K, N] do not match: "
                         f"{tuple(x.shape)}, {tuple(codes.shape)}")


def _check_int4(x, packed, scales, k_dim) -> bool:
    """The JAX checks (quant.py:312-323); returns whether scales are by
    group."""
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError("x must be [M, K] and packed [ceil(K/2), N]")
    K = x.shape[1]
    if k_dim is not None and K != k_dim:
        raise ValueError(f"x has K={K}, the weights k_dim={k_dim}")
    if packed.shape[0] != (K + 1) // 2:
        raise ValueError(f"packed rows {packed.shape[0]} != ceil(K/2) for "
                         f"x {tuple(x.shape)}")
    grouped = scales.dim() == 2
    if grouped:
        G = scales.shape[0]
        if G % 2 or K % G:
            raise ValueError(
                f"group-wise scales need an even group count dividing K "
                f"(K={K}, scales {tuple(scales.shape)}); use "
                f"quantize_weight_int4(group_size=...)")
    return grouped


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def _plan(M: int, N: int, rows: int, sms: int, dtype: torch.dtype,
          group: int | None) -> Plan:
    """The launch for x [M, K], ``rows`` code rows (K, or ceil(K/2)
    packed), N columns, on a card of ``sms`` streaming multiprocessors;
    ``group`` is the rows of W a scale covers (None: per column).
    Where the tensor cores' k depth of 16 divides the group, x takes a
    tensor-core form: at M <= 8 ``decode_tc`` for bf16 x (up to 8 x 2048
    code rows) and ``decode_tc_x3`` for fp32 x (up to 8 x 1024), both
    where N is a multiple of 16, the row stride their tensor map of the
    codes needs; above M = 8 ``tensor_core`` for bf16 x and
    ``tensor_core_x3`` for fp32 x.  The rest take the CUDA-core forms,
    ``decode`` at M <= 8 and ``cuda_core`` above (groups that 16 does not
    divide).  The code rows are split until the launch has the form's
    blocks for each multiprocessor (the tensor-core prefill forms' chunks
    rounded down, so that they get them whole)."""
    tc = group is None or group % 16 == 0
    if M <= 8:
        form = "decode_tc" if dtype == torch.bfloat16 else "decode_tc_x3"
        if tc and N % 16 == 0 and rows <= _DEC_CLUSTER * _DEC_ROWS[form]:
            return _decode_plan(N, rows, sms, form)
        form = "decode"
    elif tc:
        form = "tensor_core" if dtype == torch.bfloat16 else "tensor_core_x3"
    else:
        form = "cuda_core"
    bm, bn, bk, per_sm = _FORMS[form]
    tiles = cdiv(N, bn) * cdiv(M, bm)
    splits = max(1, min(cdiv(per_sm * sms, tiles), cdiv(rows, bk)))
    if form in ("tensor_core", "tensor_core_x3") and splits > 1:
        chunk = max(bk, rows // splits // bk * bk)
    else:
        chunk = round_up(cdiv(rows, splits), bk)
    splits = cdiv(rows, chunk)
    return Plan(form, bm, bn, splits, chunk, tiles * splits)


def _decode_plan(N: int, rows: int, sms: int, form: str) -> Plan:
    """``decode_tc`` and ``decode_tc_x3``: tiles of 128 code bytes a row
    where they alone give a block a multiprocessor, else of 64 where
    clusters of 8 can spread them that far, else of 32; the code rows split
    over a cluster of the smallest power of two (at most 8) that gives a
    block a multiprocessor, and into at least ``rows / _DEC_ROWS[form]``
    ranges, each a whole number of 16-row steps for each of the block's 4
    warps; each warp's quarter of the range through a ring of up to 2
    stages of up to 4 KB."""
    _, _, slab, per_sm = _FORMS[form]
    want = per_sm * sms
    if cdiv(N, 128) >= want:
        bn = 128
    else:
        bn = 64 if cdiv(N, 64) * _DEC_CLUSTER >= want else 32
    tiles = cdiv(N, bn)
    cluster = 1 << (cdiv(want, tiles) - 1).bit_length()
    cluster = max(min(_DEC_CLUSTER, cluster, cdiv(rows, slab)),
                  cdiv(rows, _DEC_ROWS[form]))
    chunk = round_up(cdiv(rows, cluster), slab)
    cluster = cdiv(rows, chunk)
    stage_rows = min(chunk // 4, _DEC_STAGE_BYTES // bn)
    return Plan(form, 8, bn, cluster, chunk, tiles * cluster,
                min(_DEC_STAGES, cdiv(chunk // 4, stage_rows)), stage_rows)


def _inputs(x, w, scales, what):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16 x, got {x.dtype}")
    dev = x.device
    return dev, [kernel_input(t, dev) for t in (x, w, scales.float())]


def _launch(name, symbol, count_as, x, w, scales, rows, extra, group=None):
    """Launch ``symbol`` of ``csrc/<name>.cu``; ``extra`` are the C
    arguments between K and the form (the int4 group count), ``group`` the
    rows a group scale covers.  out takes x's dtype; the launch counts under
    ``count_as``, with ``DEC``, ``DEC_X3``, ``TC`` or ``X3`` for the
    tensor-core forms.  The forms but the decode ones on the tensor cores
    take an fp32 workspace when they split the code rows."""
    dev, (x, w, s) = _inputs(x, w, scales, name)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = _plan(M, N, rows, sm_count(dev), x.dtype, group)
    count_as += {"decode_tc": DEC, "decode_tc_x3": DEC_X3, "tensor_core": TC,
                 "tensor_core_x3": X3}.get(plan.form, "")
    part = (torch.empty(plan.splits, M, N, dtype=torch.float32, device=dev)
            if plan.splits > 1
            and plan.form not in ("decode_tc", "decode_tc_x3") else None)
    lib, fn = entry(name, symbol, [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * (3 + len(extra) + 7)
                    + [ctypes.c_void_p])
    err = call_on_stream(fn, dev, x.data_ptr(), w.data_ptr(), s.data_ptr(),
                         out.data_ptr(),
                         None if part is None else part.data_ptr(),
                         M, N, K, *extra, _FORM_IDS[plan.form], plan.bn,
                         plan.chunk, plan.splits, plan.stage_rows,
                         plan.stages, _DTYPES[x.dtype])
    check_cuda(err, lib, f"{count_as} kernel")
    launch_counts[count_as] += 1
    return out


def int8_matmul(x, codes, scales, *, impl: str | None = None):
    """``out[M, N] = (x @ codes) * scales`` with x [M, K] fp32 or bf16,
    codes int8 [K, N], scales [N]; out in x's dtype.  ``impl``:
    ``None`` launches the CUDA kernel for CUDA tensors and runs the plain
    version for CPU tensors; ``"plain"`` forces the plain one."""
    if resolve_impl(impl, x) == "plain":
        return int8_matmul_plain(x, codes, scales)
    _check_int8(x, codes)
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    return _launch(KERNEL_INT8, "tf_int8_matmul", KERNEL_INT8, x, codes,
                   scales, x.shape[1], ())


def int4_matmul(x, packed, scales, *, k_dim=None, impl: str | None = None):
    """``out[M, N] = x @ dequant(packed)`` with packed uint8 [ceil(K/2), N]
    from ``quantize_weight_int4`` and scales [N] (per column) or [G, N] (by
    group); out in x's dtype.  ``impl`` as in ``int8_matmul``."""
    if resolve_impl(impl, x) == "plain":
        return int4_matmul_plain(x, packed, scales, k_dim=k_dim)
    grouped = _check_int4(x, packed, scales, k_dim)
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed codes must be uint8, got {packed.dtype}")
    return _launch(KERNEL_INT4, "tf_int4_matmul",
                   KERNEL_INT4_GROUP if grouped else KERNEL_INT4, x, packed,
                   scales, packed.shape[0],
                   (scales.shape[0] if grouped else 0,),
                   x.shape[1] // scales.shape[0] if grouped else None)


# ---------------------------------------------------------------------------
# Differentiable wrappers (x gets gradients; weights are frozen codes)
# ---------------------------------------------------------------------------

def _dx_per_column(dy, codes, scales, impl):
    """dx = dy @ W^T with W = codes * scales: the scales fold into dy, and
    the int8 kernel runs on the transposed codes with unit scales."""
    dy_scaled = (dy.float() * scales.float()).to(dy.dtype)
    ones = torch.ones(codes.shape[0], dtype=torch.float32, device=dy.device)
    return int8_matmul(dy_scaled, codes.t().contiguous(), ones, impl=impl)


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, codes, scales, impl):
        ctx.save_for_backward(codes, scales)
        ctx.impl = impl
        return int8_matmul(x, codes, scales, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        codes, scales = ctx.saved_tensors
        return _dx_per_column(dy, codes, scales, ctx.impl), None, None, None


class _Int4Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, scales, k_dim, impl):
        ctx.save_for_backward(packed, scales)
        ctx.k_dim, ctx.impl = k_dim, impl
        return int4_matmul(x, packed, scales, k_dim=k_dim, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        packed, scales = ctx.saved_tensors
        if scales.dim() == 2:
            # group scales vary along K: a dense matmul of the weight
            # dequantized once (a training-only path; decode never takes it)
            w = dequantize(packed, scales, ctx.k_dim)
            dx = (dy.float() @ w.T).to(dy.dtype)
        else:
            dx = _dx_per_column(dy, unpack_int4(packed, ctx.k_dim), scales,
                                ctx.impl)
        return dx, None, None, None, None


def _linear(fn, x, n_out, bias, *args):
    """``fn`` (the autograd Function's ``apply``) over x's rows, then the
    bias, in the promoted dtype."""
    lead = x.shape[:-1]
    out = fn(x.reshape(-1, x.shape[-1]), *args)
    if bias is not None:
        out = out + bias
    return out.reshape(*lead, n_out)


def int8_linear(x, qw: QuantizedLinearWeights, *, impl: str | None = None):
    """Linear layer with int8 weights on [..., K] activations; the output
    takes x's dtype, and the bias is added in the promoted dtype."""
    return _linear(_Int8Linear.apply, x, qw.codes.shape[1], qw.bias,
                   qw.codes, qw.scales, impl)


def int4_linear(x, qw: QuantizedLinearWeights4, *, impl: str | None = None):
    """Linear layer with packed int4 weights; as ``int8_linear``."""
    if x.shape[-1] != qw.k_dim:
        raise ValueError(f"x has K={x.shape[-1]}, the weights "
                         f"k_dim={qw.k_dim}")
    return _linear(_Int4Linear.apply, x, qw.codes.shape[1], qw.bias,
                   qw.codes, qw.scales, qw.k_dim, impl)
