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
               LayerNorm ops, and plain PyTorch oracles (causal mask, naive
               attention, FA1/FA2 forward, composed softmax and LayerNorm)
  nn/        — layers (float and quantized Linear), the pre-LN decoder
               transformer (torch.nn), optimizers
  inference/ — KV cache (fp/int8/fp8, heads-minor), sampler, engine
  apps/      — the machine-translation training core (loss, step, epoch)
  utils/     — CUDA-event timing

Entry points (``DecoderLM``, ``DecodeEngine``, ``generate``) run on the card
unless the caller passes ``device="cpu"``.  Ported so far: the serving path,
with float or weight-only quantized linears (``nn.quantize_model_linears``),
and the training path, with flash, fused or naive attention and the fused
or composed LayerNorm (ROADMAP.md, queue A items A1-A4 and A7's quantized
linears).
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
