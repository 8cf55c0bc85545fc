"""The CUDA flash-decode kernel against its plain PyTorch version, on the
card.  Every test here needs a CUDA device and skips without one; the file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: 2e-2 with bf16 q (outputs are rounded to bf16, and the kernel
rounds p to bf16 before P.V where the plain version keeps fp32); 1e-5 in
fp32 with TF32 off (summation order and ``__expf`` only).
"""

import pytest
import torch

from tpu_flash_torch import nn as tnn
from tpu_flash_torch.inference import KVCache, make_caches
from tpu_flash_torch.kernels import common
from tpu_flash_torch.kernels.decode import flash_decode_attention

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def filled_cache(gen, dev, B, Hkv, S, d, quant, dtype, lengths):
    cache = KVCache.create(B, Hkv, S, d, quant=quant, compute_dtype=dtype,
                           device=dev)
    k, v = (torch.randn(B, Hkv, S, d, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    cache.append(k, v)
    cache.lengths.copy_(torch.tensor(lengths, dtype=torch.int32))
    return cache


def kernel_and_plain(cache, q, window):
    args = (q, cache.k, cache.v, cache.lengths, cache.k_scale, cache.v_scale)
    before = common.launch_counts["flash_decode"]
    got = flash_decode_attention(*args, window=window)
    assert common.launch_counts["flash_decode"] == before + 1
    want = flash_decode_attention(*args, window=window, impl="plain")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    return got.float(), want.float()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("quant", ["none", "int8", "fp8"])
def test_kernel_matches_plain_bf16(cuda_device, quant, window):
    """bf16 q, ragged lengths (0 and 1 < Lq among them), GQA g=2, Lq=2."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    cache = filled_cache(gen, cuda_device, 4, 4, 512, 64, quant,
                         torch.bfloat16, [0, 1, 300, 512])
    q = torch.randn(4, 8, 2, 64, generator=gen,
                    device=cuda_device).bfloat16()
    got, want = kernel_and_plain(cache, q, window)
    torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
    assert torch.count_nonzero(got[0]) == 0          # length 0: all rows 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,Hq,Hkv,Lq", [(16, 4, 4, 1), (32, 16, 1, 8),
                                          (128, 8, 2, 3)])
def test_kernel_matches_plain_fp32(cuda_device, d, Hq, Hkv, Lq):
    gen = torch.Generator(cuda_device).manual_seed(1)
    cache = filled_cache(gen, cuda_device, 3, Hkv, 300, d, "none",
                         torch.float32, [2, 129, 300])
    q = torch.randn(3, Hq, Lq, d, generator=gen, device=cuda_device)
    got, want = kernel_and_plain(cache, q, None)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 1, 48, device=cuda_device)
    kv = torch.zeros(1, 8, 2 * 48, device=cuda_device)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_attention(q, kv, kv, lengths)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_decode_attention(q[..., :32].half(), kv[..., :64], kv[..., :64],
                               lengths)


@pytest.mark.cuda
def test_decode_step_logits_kernel_matches_plain(cuda_device):
    """One decode step of a small fp32 DecoderLM over an int8 cache: the
    logits through the kernel and through the plain version agree, and the
    kernel ran once per layer."""
    cfg = tnn.DecoderConfig(n_vocab=128, n_embd=64, n_head=4, n_positions=64,
                            n_layer=2, ff_middle_dim=128, p_dropout=0.0,
                            attention_kind="naive")
    model = tnn.DecoderLM(cfg, device=cuda_device)
    tnn.init_params(model, torch.Generator(cuda_device).manual_seed(2))
    ids = torch.randint(0, 128, (3, 20), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(3))
    logits = {}
    for impl in ("kernel", "plain"):
        caches = make_caches(model, 3, 32, quant="int8")
        with torch.no_grad():
            model(ids, kv_caches=caches)
            before = common.launch_counts["flash_decode"]
            out, _ = model(ids[:, -1:], kv_caches=caches,
                           positions=caches[0].lengths[:, None].long(),
                           impl=impl)
        launched = common.launch_counts["flash_decode"] - before
        assert launched == (cfg.n_layer if impl == "kernel" else 0)
        logits[impl] = out
    torch.testing.assert_close(logits["kernel"], logits["plain"], atol=1e-4,
                               rtol=1e-4)
