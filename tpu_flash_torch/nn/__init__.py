"""Modules of the port: layers, the decoder transformer and the helpers
that load or draw its parameters."""

from tpu_flash_torch.nn import functional  # noqa: F401
from tpu_flash_torch.nn.layers import (  # noqa: F401
    Dropout,
    Embedding,
    LayerNorm,
    Linear,
)
from tpu_flash_torch.nn.module import (  # noqa: F401
    init_params,
    load_jax_params,
    named_tree_leaves,
    num_parameters,
)
from tpu_flash_torch.nn.transformer import (  # noqa: F401
    DecoderConfig,
    DecoderLM,
    FeedForward,
    MultiHeadAttention,
    TransformerLayer,
)
