"""The operation and byte counts against values worked by hand for both
configurations."""

import pytest

from port_bench import arith
from port_bench.spec import load_json, shape_of

SC1B = shape_of(load_json("configs/starcoderbase-1b.json"))
# GPT-2-medium's published widths: a multi-head model, one KV head a head
GPT2M = shape_of(dict(n_embd=1024, n_head=16, n_layer=24, n_inner=None,
                      n_positions=1024, vocab_size=50257,
                      layer_norm_epsilon=1e-5, initializer_range=0.02))


def test_shapes():
    assert (SC1B.n_kv_head, SC1B.head_dim, SC1B.n_inner) == (1, 128, 8192)
    assert (GPT2M.n_kv_head, GPT2M.head_dim, GPT2M.n_inner) == (16, 64, 4096)


def test_matmul_params():
    # per layer q and out 2 * 2048^2, k and v 2 * 2048 * 128, FF 2 * 2048 *
    # 8192; then lm_head 49152 * 2048
    assert SC1B.matmul_params() == 24 * 42_467_328 + 100_663_296
    assert SC1B.matmul_params() == 1_119_879_168
    assert GPT2M.matmul_params() == 24 * 12_582_912 + 51_463_168


def test_train_step_flops():
    gemm = 6 * 1_119_879_168 * 16_384
    attn = 24 * 7 * 0.5 * (2 * 2 * 16 * 8192 ** 2 * 128)
    assert arith.train_step_flops(SC1B, 2, 8192) == pytest.approx(gemm + attn)
    assert attn == pytest.approx(4.6179e13, rel=1e-4)


def test_serving_flops_and_bytes():
    p = 3000
    assert arith.prefill_flops(GPT2M, p) == pytest.approx(
        2 * 353_453_056 * p + 24 * 2 * 16 * p * p * 64)
    assert arith.decode_token_flops(GPT2M, 500) == pytest.approx(
        2 * 353_453_056 + 24 * 4 * 16 * 64 * 500)
    # two live slots of 100 and 200 keys: K and V in bf16 over 16 heads of
    # 64, q and out of each slot
    assert arith.decode_call_bytes(GPT2M, [100, 200]) == 24 * (
        2 * 300 * 1024 * 2 + 2 * 2 * 1024 * 2)
    # one KV head of 128 for StarCoder
    assert arith.decode_call_bytes(SC1B, [1000]) == 24 * (
        2 * 1000 * 128 * 2 + 2 * 2048 * 2)


def test_flash_train_bytes():
    # forward: q, k, v in, out out; backward: q, k, v, out, dO in, dQ, dK,
    # dV out; q-like rows 2048 wide, one KV head of 128
    q, kv = 8192 * 2048 * 2, 8192 * 128 * 2
    assert arith.flash_train_bytes(SC1B, 1, 8192) == 24 * (
        (2 * q + 2 * kv) + (4 * q + 4 * kv))


def test_roofline_share():
    assert arith.roofline_share(989e12, 0, 2.0) == pytest.approx(50.0)
    assert arith.roofline_share(0, 3.35e12, 1.0) == pytest.approx(100.0)
    assert arith.roofline_share(1.0, 1.0, 0.0) is None
