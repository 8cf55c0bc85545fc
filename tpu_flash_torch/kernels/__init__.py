"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  Ported so far: flash-decode attention, the
flash-attention forward and backward, the fused LayerNorm forward and
backward, and the fused masked attention-softmax forward and backward."""

from tpu_flash_torch.kernels.common import build, launch_counts  # noqa: F401
from tpu_flash_torch.kernels.decode import (  # noqa: F401
    flash_decode_attention,
    flash_decode_attention_plain,
)
from tpu_flash_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_forward_plain,
)
from tpu_flash_torch.kernels.layernorm import (  # noqa: F401
    layernorm_backward,
    layernorm_backward_plain,
    layernorm_forward,
    layernorm_forward_plain,
)
from tpu_flash_torch.kernels.softmax import (  # noqa: F401
    attn_softmax_backward,
    attn_softmax_backward_plain,
    attn_softmax_forward,
    attn_softmax_forward_plain,
)
