"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  Ported so far: flash-decode attention, and the
flash-attention forward and backward."""

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
