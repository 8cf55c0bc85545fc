"""tpu_flash_torch — the PyTorch and CUDA port of ``tpu_flash`` for NVIDIA
Hopper (H100).

The JAX package ``tpu_flash`` stays beside it as the reference; this package
imports neither JAX nor ``tpu_flash``.  Every Pallas kernel on a ported path
becomes a kernel written by hand in CUDA C++ for ``sm_90a``, built with
``nvcc`` at first use, with a plain PyTorch version beside it that CPU
tensors take.

Layering, as in the JAX package:
  kernels/   — CUDA kernels (flash decode, flash-attention forward and
               backward, fused LayerNorm and masked softmax forward and
               backward, int8 and packed-int4 weight-only matmuls) +
               build/launch helpers
  ops/       — the differentiable flash-attention, fused softmax and fused
               LayerNorm ops, plain PyTorch oracles (causal mask, naive
               attention, FA1/FA2 forward and backward, composed softmax and
               LayerNorm) and the process-wide default impl (registry)
  nn/        — layers (float and quantized Linear), functional ops (losses,
               rotary positions, pooling and convolution), the pre-LN
               decoder transformer with its routed MoE feed-forward
               (torch.nn), optimizers, ``tree_cast``
  inference/ — KV cache (fp/int8/fp8, heads-minor), sampler, beam search,
               speculative decoding, engine
  data/      — the MT corpora, byte-level BPE, collates, the C++ batch ring
               (``native/collate.cpp``, built with g++ at first use), the
               2-D point sets
  apps/      — the machine-translation app (CLI, training, BLEU,
               ``--profile``) and the points classifier
  utils/     — CUDA-event timing and the benchmark harness, roofline,
               profiling, grad_check, corpus BLEU, checkpoints, metrics log
  parallel/  — the parallel layer on ``torch.distributed``, one process a
               rank: DP, Megatron TP with the vocab-parallel loss and
               sequence-parallel activations, expert parallelism, ZeRO-1,
               GPipe, all-gather and ring attention, sharded decode

Entry points (``DecoderLM``, ``DecodeEngine``, ``generate``,
``apps.machine_translation.main``, ``apps.points_classifier.run``) run on
the card unless the caller passes ``device="cpu"``.  Ported: everything
the JAX package does (ROADMAP.md, queue A items A1-A8 and A9b's
single-card utilities): the serving path, with float or weight-only
quantized linears, beam search, speculative decoding and a shared prefix;
the training path, with flash, fused or naive attention, windows,
segments, dropout and quantized K/V, rotary positions and the routed MoE
feed-forward; the MT app from corpus to BLEU; the parallel layer; and the
small pieces around them.
"""

__version__ = "0.1.0"

from tpu_flash_torch.inference import (  # noqa: F401
    DecodeEngine,
    KVCache,
    SamplingConfig,
    generate,
)
from tpu_flash_torch.kernels import (  # noqa: F401
    flash_decode_attention,
    flash_decode_attention_plain,
)
from tpu_flash_torch.nn import DecoderConfig, DecoderLM  # noqa: F401
from tpu_flash_torch.ops import (  # noqa: F401
    attn_softmax,
    flash_attention,
    layer_norm,
    naive_attention,
)
from tpu_flash_torch.utils.grad_check import grad_check  # noqa: F401
