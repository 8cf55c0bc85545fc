"""Ops of the port: the differentiable flash-attention op, the fused
masked softmax and LayerNorm, and the plain PyTorch oracles they are held
against."""

from tpu_flash_torch.ops.attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_residuals,
    flash_attn,
    flash_attn2,
    flash_attn_causal,
)
from tpu_flash_torch.ops.fused import (  # noqa: F401
    attn_softmax,
    layer_norm,
    layer_norm_with_stats,
)
from tpu_flash_torch.ops.reference import (  # noqa: F401
    causal_mask,
    default_scale,
    naive_attention,
)
