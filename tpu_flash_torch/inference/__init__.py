"""Inference: KV cache, sampler, beam search, speculative decoding and the
continuous-batching engine."""

from tpu_flash_torch.inference.beam import beam_generate  # noqa: F401
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
from tpu_flash_torch.inference.speculative import (  # noqa: F401
    speculative_generate,
)
