"""Plain PyTorch oracles, counterpart of ``tpu_flash/ops/reference.py``.
Only what the serving path needs so far."""

from __future__ import annotations

import torch

from tpu_flash_torch.kernels.common import MASK_VALUE


def causal_mask(seq_q: int, seq_k: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal mask ``[seq_q, seq_k]``: 0 on and below the
    bottom-right-aligned diagonal, ``MASK_VALUE`` above."""
    q_ids = torch.arange(seq_q, device=device)[:, None] + (seq_k - seq_q)
    k_ids = torch.arange(seq_k, device=device)[None, :]
    return torch.where(k_ids <= q_ids, 0.0, MASK_VALUE).to(dtype)
