"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  Ported so far: flash-decode attention, the
flash-attention forward and backward (fused single pass, and the two-pass
dK/dV and dQ kernels; sliding windows, packed segments, attention
dropout and quantized K/V in each), the fused LayerNorm forward and
backward, the fused masked attention-softmax forward and backward, and the
weight-only int8 and packed-int4 matmuls."""

from tpu_flash_torch.kernels.common import build, launch_counts  # noqa: F401
from tpu_flash_torch.kernels.decode import (  # noqa: F401
    flash_decode_attention,
    flash_decode_attention_plain,
)
from tpu_flash_torch.kernels.flash_attention import (  # noqa: F401
    dropout_keep_mask,
    flash_attention_backward,
    flash_attention_backward_dkv_plain,
    flash_attention_backward_dq_plain,
    flash_attention_backward_fused,
    flash_attention_backward_plain,
    flash_attention_backward_two_pass,
    flash_attention_forward,
    flash_attention_forward_plain,
)
from tpu_flash_torch.kernels.layernorm import (  # noqa: F401
    layernorm_backward,
    layernorm_backward_plain,
    layernorm_forward,
    layernorm_forward_plain,
)
from tpu_flash_torch.kernels.quant import (  # noqa: F401
    QuantizedLinearWeights,
    QuantizedLinearWeights4,
    dequantize,
    int4_linear,
    int4_matmul,
    int4_matmul_plain,
    int8_linear,
    int8_matmul,
    int8_matmul_plain,
    quantize_weight,
    quantize_weight_int4,
    unpack_int4,
)
from tpu_flash_torch.kernels.softmax import (  # noqa: F401
    attn_softmax_backward,
    attn_softmax_backward_plain,
    attn_softmax_forward,
    attn_softmax_forward_plain,
)
