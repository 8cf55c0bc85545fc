"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version.  Ported so far: flash-decode attention."""

from tpu_flash_torch.kernels.common import build, launch_counts  # noqa: F401
from tpu_flash_torch.kernels.decode import (  # noqa: F401
    flash_decode_attention,
    flash_decode_attention_plain,
)
