"""Ops of the port: the differentiable flash-attention op, the fused
masked softmax and LayerNorm, the plain PyTorch oracles they are held
against, and the process-wide default implementation (``registry``)."""

from tpu_flash_torch.ops.attention import (  # noqa: F401
    dequantize_kv,
    flash_attention,
    flash_attention_with_residuals,
    flash_attn,
    flash_attn2,
    flash_attn_causal,
    quantize_kv,
)
from tpu_flash_torch.ops.fused import (  # noqa: F401
    attn_softmax,
    layer_norm,
    layer_norm_with_stats,
)
from tpu_flash_torch.ops.reference import (  # noqa: F401
    apply_segment_mask,
    causal_mask,
    default_scale,
    dropout_keep_oracle,
    naive_attention,
    window_mask,
)
from tpu_flash_torch.ops.registry import (  # noqa: F401
    get_default_impl,
    resolve_impl,
    set_default_impl,
)
