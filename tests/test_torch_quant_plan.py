"""The quantized matmuls' launch plan (``kernels/quant.py`` ``_plan``), a
pure function of the shape, the dtype, the group and the card's count of
streaming multiprocessors, so it runs here without a card: which form each
shape takes (decode for M <= 8, the tensor-core form for bf16 x at M > 8
where its k depth of 16 divides the group, the CUDA-core form otherwise),
its tile, its splits of the code rows, and that every prefill shape of the
176M serving model fills an H100's 132 multiprocessors."""

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


@pytest.mark.parametrize("M,dtype,group,form", [
    (1, BF16, None, "decode"),
    (8, BF16, 128, "decode"),
    (8, FP32, None, "decode"),
    (9, BF16, None, "tensor_core"),
    (9, FP32, None, "cuda_core"),
    (100, BF16, 16, "tensor_core"),
    (256, BF16, 64, "tensor_core"),
    (1024, BF16, 128, "tensor_core"),
    (1024, FP32, 128, "cuda_core"),
    (100, BF16, 8, "cuda_core"),
    (100, BF16, 24, "cuda_core"),
])
def test_the_form_follows_m_dtype_and_group(M, dtype, group, form):
    assert quant._plan(M, 1024, 512, SMS, dtype, group).form == form


@pytest.mark.parametrize("M,N,rows,dtype,group,want", [
    # form, bm, bn, splits, chunk, blocks
    (1024, 4096, 1024, BF16, None, ("tensor_core", 128, 64, 1, 1024, 512)),
    (1024, 1024, 512, BF16, 128, ("tensor_core", 128, 64, 2, 256, 256)),
    (256, 1024, 512, BF16, None, ("tensor_core", 128, 64, 8, 64, 256)),
    (16, 1024, 512, BF16, None, ("tensor_core", 128, 64, 8, 64, 128)),
    (300, 300, 255, BF16, None, ("tensor_core", 128, 64, 4, 64, 60)),
    (8, 4096, 1024, BF16, None, ("decode", 8, 128, 8, 128, 256)),
    (8, 32768, 1024, BF16, None, ("decode", 8, 128, 2, 512, 512)),
    (1024, 4096, 1024, FP32, None, ("cuda_core", 64, 128, 1, 1024, 512)),
])
def test_tiles_and_splits(M, N, rows, dtype, group, want):
    assert tuple(quant._plan(M, N, rows, SMS, dtype, group)) == want


def pr4_plan(M, N, rows, sms):
    """The decode and CUDA-core forms' plan as it stood before the
    tensor-core form: (bm, splits, chunk)."""
    bm, bk = (8, 128) if M <= 8 else (64, 32)
    tiles = cdiv(N, 128) * cdiv(M, bm)
    splits = max(1, min(cdiv(2 * sms, tiles), cdiv(rows, bk)))
    chunk = round_up(cdiv(rows, splits), bk)
    return bm, cdiv(rows, chunk), chunk


@pytest.mark.parametrize("M,dtype", [(1, BF16), (8, BF16), (8, FP32),
                                     (9, FP32), (1024, FP32)])
def test_the_cuda_core_forms_keep_their_plan(M, dtype):
    for K, N in SERVING_LINEARS + ((255, 300), (96, 130)):
        for kind in ("int8", "int4"):
            rows, _ = weights(kind, K)
            plan = quant._plan(M, N, rows, SMS, dtype, None)
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


@pytest.mark.parametrize("dtype,group", [(BF16, None), (BF16, 64),
                                         (FP32, None)])
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_splits_cover_the_rows_in_whole_slabs(dtype, group, sms):
    """Every split is a whole number of the form's slabs (the C entry
    refuses others), the splits cover the code rows and none is empty."""
    slab = {"decode": 128, "cuda_core": 32, "tensor_core": 64}
    for M in (1, 8, 9, 64, 129, 1024):
        for N in (5, 64, 300, 4096):
            for rows in (1, 31, 96, 255, 512, 2048):
                plan = quant._plan(M, N, rows, sms, dtype, group)
                assert plan.chunk % slab[plan.form] == 0
                assert (plan.splits - 1) * plan.chunk < rows
                assert plan.splits * plan.chunk >= rows
                assert plan.blocks == (cdiv(N, plan.bn) * cdiv(M, plan.bm)
                                       * plan.splits)
