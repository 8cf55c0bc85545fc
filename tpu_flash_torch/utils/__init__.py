"""Utilities of the port: device timing."""

from tpu_flash_torch.utils.timing import device_ms  # noqa: F401
