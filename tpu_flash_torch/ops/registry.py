"""The process-wide default implementation of the kernel-backed ops,
counterpart of ``tpu_flash/ops/registry.py``.

Every wrapper of a kernel takes ``impl=``: ``"kernel"`` launches the CUDA
kernel (CUDA tensors only), ``"plain"`` runs its plain PyTorch version.
A call that passes ``impl=None`` takes the default set here; the default's
own default, ``None``, picks by the tensor's device (the kernel for a CUDA
tensor, the plain version for a CPU one), and only under it do the fused
ops move a long last axis to their composed route.  ``set_default_impl``
switches the default for the whole process, as the JAX package's does for
its ``"pallas"``, ``"reference"`` and ``"xla"``.

This module imports nothing of the port: ``kernels.common.resolve_impl``
reads it.
"""

from __future__ import annotations

VALID_IMPLS = ("kernel", "plain")

_default_impl: str | None = None


def set_default_impl(impl: str | None) -> None:
    """``"kernel"``, ``"plain"``, or ``None`` (by the tensor's device)."""
    if impl is not None and impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS} or None, "
                         f"got {impl!r}")
    global _default_impl
    _default_impl = impl


def get_default_impl() -> str | None:
    return _default_impl


def resolve_impl(impl: str | None) -> str | None:
    """``impl`` if a call names one, else the default; ``None`` still
    means "by the tensor's device" (``kernels.common.resolve_impl``)."""
    if impl is None:
        return _default_impl
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    return impl
