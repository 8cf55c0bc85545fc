"""Utilities of the port: device timing, corpus BLEU (``utils.bleu``),
checkpoints (``utils.checkpoint``) and the metrics log
(``utils.metrics``)."""

from tpu_flash_torch.utils.timing import device_ms  # noqa: F401
