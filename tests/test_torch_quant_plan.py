"""The quantized matmuls' launch plan (``kernels/quant.py`` ``_plan``), a
pure function of the shape, the dtype, the group and the card's count of
streaming multiprocessors, so it runs here without a card: which form each
shape takes (where the tensor cores' k depth of 16 divides the group, bf16
x takes ``decode_tc`` at M <= 8 and the tensor-core form above, fp32 x
``decode_tc_x3`` at M <= 8 and ``tensor_core_x3`` above, in every kernel;
otherwise the CUDA-core forms, ``decode`` at M <= 8), its tile, its splits
of the code rows, its ring, and that every decode and prefill shape of the
176M serving model fills an H100's 132 multiprocessors.  ``_launch`` runs
here too with its C entry replaced by a recorder, to show what a decode
call and an fp32 prefill call hand the kernel."""

import pathlib
import re

import pytest
import torch

from tpu_flash_torch.kernels import quant
from tpu_flash_torch.kernels.common import cdiv, round_up

SMS = 132          # an H100 SXM
BF16, FP32 = torch.bfloat16, torch.float32
# The 176M serving model's linears, K x N (chip_smoke.py SERVING_LINEARS).
SERVING_LINEARS = ((1024, 1024), (1024, 4096), (4096, 1024), (1024, 32768))


def weights(kind, K):
    """(code rows, group rows) of a [K, N] weight quantized as ``kind``."""
    return {"int8": (K, None), "int4": (cdiv(K, 2), None),
            "int4_g128": (cdiv(K, 2), 128)}[kind]


CSRC = pathlib.Path(quant.__file__).parent / "csrc"


@pytest.mark.parametrize("M,dtype,group,form", [
    (1, BF16, None, "decode_tc"),
    (8, BF16, 128, "decode_tc"),
    (8, FP32, None, "decode_tc_x3"),
    (9, BF16, None, "tensor_core"),
    (9, FP32, None, "tensor_core_x3"),
    (9, FP32, 8, "cuda_core"),
    (100, BF16, 16, "tensor_core"),
    (256, BF16, 64, "tensor_core"),
    (1024, BF16, 128, "tensor_core"),
    (1024, FP32, 128, "tensor_core_x3"),
    (1024, FP32, 24, "cuda_core"),
    (100, BF16, 8, "cuda_core"),
    (100, BF16, 24, "cuda_core"),
])
def test_the_form_follows_m_dtype_and_group(M, dtype, group, form):
    assert quant._plan(M, 1024, 512, SMS, dtype, group).form == form


def test_the_kernels_with_the_fp32_x_form():
    """Every kernel's source fills the fp32-x slot of its launch table,
    where ``_plan`` sends every fp32 prefill that 16 divides the group of;
    the per-column kernels have no CUDA-core prefill form (their slot is
    empty, and the C entry refuses form 1), the grouped one keeps it for
    the groups that 16 does not divide."""
    src = {n: (CSRC / f"{n}.cu").read_text()
           for n in (quant.KERNEL_INT8, quant.KERNEL_INT4)}
    for name, source in ((quant.KERNEL_INT8, quant.KERNEL_INT8),
                         (quant.KERNEL_INT4, quant.KERNEL_INT4),
                         (quant.KERNEL_INT4_GROUP, quant.KERNEL_INT4)):
        assert f"{name}_x3_kernel(const QParams p)" in src[source]
    for name in (quant.KERNEL_INT8, quant.KERNEL_INT4):
        assert f"{name}_kernel_m64" not in src[name]
        assert re.search(rf"{{\s*{name}_kernel_m8,\s*nullptr,", src[name])
    assert "int4_matmul_group_kernel_m64," in src[quant.KERNEL_INT4]


@pytest.mark.parametrize("name,source", [
    (quant.KERNEL_INT8, quant.KERNEL_INT8),
    (quant.KERNEL_INT4, quant.KERNEL_INT4),
    (quant.KERNEL_INT4_GROUP, quant.KERNEL_INT4)])
def test_every_kernel_has_the_fp32_decode_form(name, source):
    """Every kernel fills its fp32-x decode slots (form 5, which ``_plan``
    gives every fp32 call at M <= 8 that 16 divides the group and N of)
    with the ``_dec_x3`` body at each tile width, and the launcher keeps no
    refusal of an empty slot."""
    src = (CSRC / f"{source}.cu").read_text()
    body = {quant.KERNEL_INT8: "kInt8", quant.KERNEL_INT4: "kInt4",
            quant.KERNEL_INT4_GROUP: "kInt4Group"}[name]
    assert re.search(rf"{name}_dec_x3_kernel\(const __grid_constant__ "
                     rf"QDecParams d\) {{\s*quant_matmul_dec_body<{body}, "
                     rf"BN, true>\(d\);", src)
    assert re.search(r"\{\s*" + r",\s*".join(
        f"{name}_dec_x3_kernel<{bn}>" for bn in (32, 64, 128)) + r"\s*\}",
        src)
    assert "{nullptr, nullptr, nullptr}" not in src
    assert "if (!k)" not in (CSRC / "quant_matmul.cuh").read_text()


@pytest.mark.parametrize("M,kind,group,form", [
    (9, "int8", None, "tensor_core_x3"),
    (1024, "int8", None, "tensor_core_x3"),
    (9, "int4_g128", 128, "tensor_core_x3"),
    (1024, "int4_g128", 128, "tensor_core_x3"),
    (100, "int4_g128", 16, "tensor_core_x3"),
    (9, "int4", None, "tensor_core_x3"),
    (1024, "int4", None, "tensor_core_x3"),
    (100, "int4_g128", 8, "cuda_core"),
    (100, "int4_g128", 24, "cuda_core"),
    (8, "int8", None, "decode_tc_x3"),
    (1, "int4_g128", 128, "decode_tc_x3"),
    (8, "int4", None, "decode_tc_x3"),
    (1, "int4", None, "decode_tc_x3"),
    (1, "int4_g128", 8, "decode"),
])
def test_fp32_x_takes_the_x3_form_where_the_kernel_has_it(M, kind, group,
                                                          form):
    """fp32 x above M = 8 takes the fp32 tensor-core form for int8, int4
    per column and int4 in groups that are a multiple of 16; other groups
    keep the CUDA-core forms.  At M <= 8 the same kernels take the fp32
    tensor-core decode form, other groups the CUDA-core one.  bf16 x never
    takes either."""
    assert quant._plan(M, 1024, 512, SMS, FP32, group).form == form
    assert quant._plan(M, 1024, 512, SMS, BF16, group).form not in (
        "tensor_core_x3", "decode_tc_x3")


@pytest.mark.parametrize("M,dtype,kind,group,form", [
    (M, dtype, kind, group, form) for M in (1, 8)
    for dtype, kind, group, form in (
        (BF16, "int8", None, "decode_tc"), (BF16, "int4", None, "decode_tc"),
        (BF16, "int4_g", 128, "decode_tc"), (BF16, "int4_g", 64, "decode_tc"),
        (BF16, "int4_g", 8, "decode"), (BF16, "int4_g", 24, "decode"),
        (FP32, "int8", None, "decode_tc_x3"),
        (FP32, "int4", None, "decode_tc_x3"),
        (FP32, "int4_g", 128, "decode_tc_x3"),
        (FP32, "int4_g", 16, "decode_tc_x3"),
        (FP32, "int4_g", 8, "decode"), (FP32, "int4_g", 24, "decode"))])
def test_the_decode_form_follows_dtype_and_group(M, dtype, kind, group,
                                                 form):
    """bf16 x takes the tensor-core decode form where 16 divides the group
    and N, in every kernel; fp32 x the fp32 tensor-core decode form there,
    in every kernel too; other groups keep the CUDA-core decode kernels, as
    do N not a multiple of 16 (the codes' tensor map needs 16-byte rows)
    and more code rows than 8 blocks' slices of x hold (8 x 2048 bf16, 8 x
    1024 fp32: its three planes)."""
    cap = 2048 if dtype == BF16 else 1024
    for N, rows in ((1024, 512), (32768, 1024), (304, 128), (4096, 8 * cap)):
        assert quant._plan(M, N, rows, SMS, dtype, group).form == form
    for N in (300, 1000, 4097):
        assert quant._plan(M, N, 128, SMS, dtype, group).form == "decode"
    assert quant._plan(M, 4096, 8 * cap + 1, SMS, dtype,
                       group).form == "decode"


@pytest.mark.parametrize("M,N,rows,dtype,group,want", [
    # form, bm, bn, splits, chunk, blocks, stages, stage_rows (the ring:
    # decode_tc's alone)
    (1024, 4096, 1024, BF16, None,
     ("tensor_core", 128, 64, 1, 1024, 512, 0, 0)),
    (1024, 1024, 512, BF16, 128, ("tensor_core", 128, 64, 2, 256, 256, 0, 0)),
    (256, 1024, 512, BF16, None, ("tensor_core", 128, 64, 8, 64, 256, 0, 0)),
    (16, 1024, 512, BF16, None, ("tensor_core", 128, 64, 8, 64, 128, 0, 0)),
    (300, 300, 255, BF16, None, ("tensor_core", 128, 64, 4, 64, 60, 0, 0)),
    (8, 4096, 1024, BF16, None, ("decode_tc", 8, 64, 4, 256, 256, 1, 64)),
    (8, 32768, 1024, BF16, None, ("decode_tc", 8, 128, 1, 1024, 256, 2, 32)),
    (8, 32768, 512, BF16, 128, ("decode_tc", 8, 128, 1, 512, 256, 2, 32)),
    (1024, 4096, 1024, FP32, None,
     ("tensor_core_x3", 128, 128, 1, 1024, 256, 0, 0)),
    (8, 4096, 1024, FP32, None, ("decode_tc_x3", 8, 64, 4, 256, 256, 1, 64)),
    (8, 1024, 4096, FP32, None, ("decode_tc_x3", 8, 32, 8, 512, 256, 1, 128)),
    (8, 32768, 512, FP32, 128, ("decode_tc_x3", 8, 128, 1, 512, 256, 2, 32)),
    (8, 4096, 4096, FP32, None,
     ("decode_tc_x3", 8, 64, 4, 1024, 256, 2, 64)),
    # int4 per column, fp32 x at each serving linear (K / 2 packed rows)
    (8, 1024, 512, FP32, None, ("decode_tc_x3", 8, 32, 8, 64, 256, 1, 16)),
    (8, 4096, 512, FP32, None, ("decode_tc_x3", 8, 64, 4, 128, 256, 1, 32)),
    (8, 1024, 2048, FP32, None,
     ("decode_tc_x3", 8, 32, 8, 256, 256, 1, 64)),
    (8, 32768, 512, FP32, None,
     ("decode_tc_x3", 8, 128, 1, 512, 256, 2, 32)),
    # 8 x 1024 code rows, the fp32 cap, and past it (int4 per column at
    # K16384 and K16400; int8 at K8320), where the CUDA-core decode form
    # takes over with its workspace
    (8, 1024, 8192, FP32, None,
     ("decode_tc_x3", 8, 32, 8, 1024, 256, 2, 128)),
    (8, 1024, 8200, FP32, None, ("decode", 8, 128, 33, 256, 264, 0, 0)),
    (8, 1024, 8320, FP32, None, ("decode", 8, 128, 33, 256, 264, 0, 0)),
])
def test_tiles_and_splits(M, N, rows, dtype, group, want):
    assert tuple(quant._plan(M, N, rows, SMS, dtype, group)) == want


@pytest.mark.parametrize("M,N,rows,group,want", [
    # form, bm, bn, splits, chunk, blocks: [128, 128] tiles, a block an SM
    (1024, 4096, 1024, None, ("tensor_core_x3", 128, 128, 1, 1024, 256)),
    (1024, 4096, 512, 128, ("tensor_core_x3", 128, 128, 1, 512, 256)),
    (256, 4096, 1024, None, ("tensor_core_x3", 128, 128, 4, 320, 256)),
    (1024, 1024, 4096, None, ("tensor_core_x3", 128, 128, 4, 1344, 256)),
    (16, 1024, 512, 128, ("tensor_core_x3", 128, 128, 8, 64, 64)),
    (300, 300, 255, None, ("tensor_core_x3", 128, 128, 4, 64, 36)),
])
def test_x3_tiles_and_splits(M, N, rows, group, want):
    """The fp32-x form's tiles, and its splits of the code rows by the
    tensor-core prefill rule (whole 64-row chunks, rounded down)."""
    plan = quant._plan(M, N, rows, SMS, FP32, group)
    assert tuple(plan) == (*want, 0, 0)


def pr4_plan(M, N, rows, sms):
    """The decode and CUDA-core forms' plan as it stood before the
    tensor-core form: (bm, splits, chunk)."""
    bm, bk = (8, 128) if M <= 8 else (64, 32)
    tiles = cdiv(N, 128) * cdiv(M, bm)
    splits = max(1, min(cdiv(2 * sms, tiles), cdiv(rows, bk)))
    chunk = round_up(cdiv(rows, splits), bk)
    return bm, cdiv(rows, chunk), chunk


@pytest.mark.parametrize("M,dtype,group", [(1, BF16, 24), (8, BF16, 8),
                                           (8, FP32, None), (9, FP32, 8),
                                           (1024, FP32, 24)])
def test_the_cuda_core_forms_keep_their_plan(M, dtype, group):
    """As the plan stood before the tensor-core forms, for the shapes that
    keep the CUDA-core forms: fp32 x above M = 8 only in groups that are
    not a multiple of 16 (every kernel takes the fp32 tensor-core form for
    the rest), and per column at M <= 8 only at N not a multiple of 16 and
    above the fp32 decode form's 8 x 1024 code rows (K16400: 16400 rows of
    int8, 8200 of int4)."""
    shapes = SERVING_LINEARS + ((255, 300), (96, 130))
    if group is None:
        shapes = ((255, 300), (96, 130), (16400, 1024), (16400, 4096))
    for K, N in shapes:
        for kind in ("int8", "int4"):
            rows, _ = weights(kind, K)
            plan = quant._plan(M, N, rows, SMS, dtype, group)
            assert plan.form in ("decode", "cuda_core")
            assert (plan.bm, plan.splits, plan.chunk) == pr4_plan(M, N, rows,
                                                                  SMS)


@pytest.mark.parametrize("M,group", [(1, None), (8, None), (1, 128),
                                     (8, 64)])
def test_decode_keeps_the_cuda_core_plan_where_16_does_not_divide_n(M, group):
    """bf16 x at M <= 8 with N not a multiple of 16 takes the CUDA-core
    decode form with its plan as it stood before the tensor-core forms."""
    for N in (300, 130, 1000, 4100):
        for rows in (128, 255, 512, 2048):
            plan = quant._plan(M, N, rows, SMS, BF16, group)
            assert plan.form == "decode" and plan.stages == 0
            assert (plan.bm, plan.splits, plan.chunk) == pr4_plan(M, N, rows,
                                                                  SMS)


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g128"])
@pytest.mark.parametrize("M", [256, 1024])
def test_every_serving_prefill_shape_fills_the_card(M, kind):
    for K, N in SERVING_LINEARS:
        rows, group = weights(kind, K)
        plan = quant._plan(M, N, rows, SMS, BF16, group)
        assert plan.form == "tensor_core"
        assert plan.blocks >= SMS, (K, N, plan)


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g128"])
@pytest.mark.parametrize("K,N", SERVING_LINEARS)
def test_every_serving_decode_plan_fills_the_card(K, N, kind):
    """The tensor-core decode form at each serving linear: at least one
    block a multiprocessor (256 blocks at each), a cluster of 1 to 8 whose
    ranges are whole 16-row steps for each of a block's 4 warps, covering
    the code rows with none empty; each warp's ring of 1 or 2 stages of at
    most 4 KB, no deeper than its quarter of the range; the same plan at
    M 1 and 8."""
    rows, group = weights(kind, K)
    plan = quant._plan(8, N, rows, SMS, BF16, group)
    assert plan == quant._plan(1, N, rows, SMS, BF16, group)
    assert plan.form == "decode_tc" and plan.bn in (32, 64, 128)
    assert plan.blocks == cdiv(N, plan.bn) * plan.splits >= SMS
    assert 1 <= plan.splits <= 8 and plan.chunk % 64 == 0
    assert (plan.splits - 1) * plan.chunk < rows <= plan.splits * plan.chunk
    assert 1 <= plan.stages <= 2 and plan.stage_rows % 16 == 0
    assert plan.stage_rows * plan.bn <= 4096
    assert (plan.stages - 1) * plan.stage_rows < plan.chunk // 4


class Recorder:
    """A C entry that records its arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __call__(self, fn, dev, *args):
        self.calls.append(args)
        return 0


def decode_call(monkeypatch, kind, dtype, K=1024, N=4096, seed=0):
    """One call of ``kind`` at M8 x K x N with ``dtype`` x through the
    public wrapper (``int8_matmul`` / ``int4_matmul``), as on a CUDA tensor,
    its C entry replaced by a recorder: (the recorded arguments, the
    kernel's launch-count name, the code rows, the C arguments between K
    and the form, the group, the counts it added)."""
    rec = Recorder()
    monkeypatch.setattr(quant, "resolve_impl", lambda impl, x: "kernel")
    monkeypatch.setattr(quant, "entry", lambda *a: (None, None))
    monkeypatch.setattr(quant, "call_on_stream", rec)
    monkeypatch.setattr(quant, "sm_count", lambda dev: SMS)
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(K, N, generator=gen)
    x = torch.randn(8, K, generator=gen).to(dtype)
    before = dict(quant.launch_counts)
    if kind == "int8":
        name, group, rows, extra = quant.KERNEL_INT8, None, K, ()
        quant.int8_matmul(x, *quant.quantize_weight(w))
    else:
        group = 128 if kind == "int4_g128" else None
        packed, scales, _ = quant.quantize_weight_int4(w, group_size=group)
        name = quant.KERNEL_INT4_GROUP if group else quant.KERNEL_INT4
        rows, extra = K // 2, (scales.shape[0] if group else 0,)
        quant.int4_matmul(x, packed, scales, k_dim=K)
    launched = {n: c - before.get(n, 0) for n, c in quant.launch_counts.items()
                if c != before.get(n, 0)}
    (args,) = rec.calls
    return args, name, rows, extra, group, launched


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g128"])
def test_a_decode_call_hands_the_kernel_its_plan_and_no_workspace(
        monkeypatch, kind):
    """One bf16 decode call at K1024 N4096: one launch of form 3 with the
    plan's tile, range, cluster and ring, no workspace pointer, counted
    under the kernel's name + ``_dec``; fp32 x takes form 5, the same plan
    and no workspace, counted with ``_dec_x3``, in every kernel."""
    bf16, name, rows, groups, group, launched = decode_call(monkeypatch,
                                                            kind, BF16)
    plan = quant._plan(8, 4096, rows, SMS, BF16, group)
    assert all(bf16[:4]) and bf16[4] is None
    assert bf16[5:] == (8, 4096, 1024, *groups, 3, plan.bn, plan.chunk,
                        plan.splits, plan.stage_rows, plan.stages, 1)
    assert launched == {name + "_dec": 1}
    fp32, *_, launched = decode_call(monkeypatch, kind, FP32)
    assert fp32[4] is None
    assert fp32[5:] == (8, 4096, 1024, *groups, 5, *bf16[9 + len(groups):
                                                          -1], 0)
    assert launched == {name + "_dec_x3": 1}


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g128"])
@pytest.mark.parametrize("K,N", SERVING_LINEARS)
def test_an_fp32_decode_call_hands_the_kernel_its_plan_and_no_workspace(
        monkeypatch, kind, K, N):
    """One fp32 decode call at each serving linear: one launch of form 5
    (the fp32 tensor-core decode form) with the plan's tile, range,
    cluster and ring, no workspace pointer and dtype 0, counted under the
    kernel's name + ``_dec_x3`` and under no other name."""
    args, name, rows, extra, group, launched = decode_call(
        monkeypatch, kind, FP32, K, N, seed=K + N)
    plan = quant._plan(8, N, rows, SMS, FP32, group)
    assert plan.form == "decode_tc_x3"
    assert all(args[:4]) and args[4] is None
    assert args[5:] == (8, N, K, *extra, 5, plan.bn, plan.chunk, plan.splits,
                        plan.stage_rows, plan.stages, 0)
    assert launched == {name + "_dec_x3": 1}


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g128"])
@pytest.mark.parametrize("K,N", SERVING_LINEARS)
def test_every_serving_fp32_decode_plan_fills_the_card(K, N, kind):
    """fp32 x at M <= 8 on each serving linear: int8, int4 per column and
    int4 in groups of 128 take the fp32 tensor-core decode form in one
    launch, with the bf16 form's tile, cluster and ring (the fp32 form's
    cap of 1024 code rows a block splits none of them further)."""
    rows, group = weights(kind, K)
    plan = quant._plan(8, N, rows, SMS, FP32, group)
    assert plan == quant._plan(1, N, rows, SMS, FP32, group)
    assert plan == quant._plan(8, N, rows, SMS, BF16, group)._replace(
        form="decode_tc_x3")
    assert plan.blocks >= SMS and plan.chunk <= 1024


@pytest.mark.parametrize("dtype,group", [(BF16, None), (BF16, 64),
                                         (FP32, None), (FP32, 24)])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_splits_cover_the_rows_in_whole_slabs(dtype, group, sms):
    """Every split is a whole number of the form's slabs (the C entry
    refuses others), the splits cover the code rows and none is empty."""
    slab = {"decode": 128, "cuda_core": 32, "tensor_core": 64,
            "decode_tc": 64, "tensor_core_x3": 64, "decode_tc_x3": 64}
    for M in (1, 8, 9, 64, 129, 1024):
        for N in (5, 64, 300, 4096):
            for rows in (1, 31, 96, 255, 512, 2048):
                plan = quant._plan(M, N, rows, sms, dtype, group)
                assert plan.chunk % slab[plan.form] == 0
                assert (plan.splits - 1) * plan.chunk < rows
                assert plan.splits * plan.chunk >= rows
                assert plan.blocks == (cdiv(N, plan.bn)
                                       * cdiv(M, plan.bm) * plan.splits)


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_g128"])
def test_an_fp32_prefill_call_hands_the_kernel_its_plan(monkeypatch, kind):
    """One fp32 call at M256 K1024 N4096: int8, int4 per column and int4
    in groups of 128 each launch form 4 (the fp32 tensor-core form) with
    the plan's 128 columns, 64-row chunks and its splits over an fp32
    workspace, counted under the kernel's name + ``_x3``."""
    rec = Recorder()
    monkeypatch.setattr(quant, "entry", lambda *a: (None, None))
    monkeypatch.setattr(quant, "call_on_stream", rec)
    monkeypatch.setattr(quant, "sm_count", lambda dev: SMS)
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(1024, 4096, generator=gen)
    x = torch.randn(256, 1024, generator=gen)
    before = dict(quant.launch_counts)
    if kind == "int8":
        name, group, rows, extra = quant.KERNEL_INT8, None, 1024, ()
        quant._launch(name, "tf_int8_matmul", name, x,
                      *quant.quantize_weight(w), rows, extra)
    else:
        group = 128 if kind == "int4_g128" else None
        packed, scales, _ = quant.quantize_weight_int4(w, group_size=group)
        name = quant.KERNEL_INT4_GROUP if group else quant.KERNEL_INT4
        rows, extra = 512, (scales.shape[0] if group else 0,)
        quant._launch(quant.KERNEL_INT4, "tf_int4_matmul", name, x, packed,
                      scales, rows, extra, group)
    plan = quant._plan(256, 4096, rows, SMS, FP32, group)
    (args,) = rec.calls
    assert plan.form == "tensor_core_x3"
    assert (args[4] is not None) == (plan.splits > 1)
    assert args[5:] == (256, 4096, 1024, *extra, 4, plan.bn, plan.chunk,
                        plan.splits, 0, 0, 0)
    launched = {n: c - before.get(n, 0) for n, c in quant.launch_counts.items()
                if c != before.get(n, 0)}
    assert launched == {name + "_x3": 1}
