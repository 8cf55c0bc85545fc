"""Modules of the port: layers (float and weight-only quantized linears),
the decoder transformer and its routed MoE feed-forward, the optimizers
and the helpers that load, export or draw its parameters."""

from tpu_flash_torch.nn import functional, optim  # noqa: F401
from tpu_flash_torch.nn.layers import (  # noqa: F401
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
    QuantizedLinear,
    quantize_linear_params,
    quantize_model_linears,
)
from tpu_flash_torch.nn.moe import MoEConfig, MoEFeedForward  # noqa: F401
from tpu_flash_torch.nn.module import (  # noqa: F401
    init_params,
    load_jax_params,
    named_tree_leaves,
    num_parameters,
    to_jax_params,
)
from tpu_flash_torch.nn.optim import (  # noqa: F401
    adam,
    adamw,
    mixed_precision,
    sgd,
    skip_nonfinite,
)
from tpu_flash_torch.nn.transformer import (  # noqa: F401
    DecoderConfig,
    DecoderLM,
    FeedForward,
    MultiHeadAttention,
    TransformerLayer,
)
