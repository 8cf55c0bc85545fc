"""Inference: KV cache, sampler and the continuous-batching engine."""

from tpu_flash_torch.inference.engine import (  # noqa: F401
    Completion,
    DecodeEngine,
    Request,
)
from tpu_flash_torch.inference.kv_cache import KVCache  # noqa: F401
from tpu_flash_torch.inference.sampler import (  # noqa: F401
    SamplingConfig,
    adjusted_logits,
    generate,
    make_caches,
    prefill_prompt,
)
