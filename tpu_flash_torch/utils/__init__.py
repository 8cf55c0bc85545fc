"""Utilities of the port: device timing and the benchmark harness
(``utils.timing``), roofline accounting (``utils.roofline``), profiling
(``utils.profiling``), gradient checking (``utils.grad_check``), corpus
BLEU (``utils.bleu``), checkpoints (``utils.checkpoint``) and the metrics
log (``utils.metrics``)."""

from tpu_flash_torch.utils.timing import (  # noqa: F401
    BenchResult,
    attention_flops,
    benchmark,
    compare,
    device_ms,
)
from tpu_flash_torch.utils.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from tpu_flash_torch.utils.profiling import (  # noqa: F401
    PhaseTimer,
    annotate,
    checked,
    trace,
)
