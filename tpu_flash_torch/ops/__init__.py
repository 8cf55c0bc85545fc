"""Ops of the port.  So far only the oracles the serving path needs."""

from tpu_flash_torch.ops.reference import causal_mask  # noqa: F401
