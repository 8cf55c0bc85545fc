"""Batched autoregressive generation over the KV cache, counterpart of
``tpu_flash/inference/sampler.py``.

The whole batch decodes together; ragged prompts are right-padded, prefilled
in one pass, and their cache lengths reset to the true prompt lengths.  The
JAX ``while_loop`` becomes a Python loop that stops once every sequence has
emitted ``eos_id`` (one host check per step).  Random sampling draws from an
explicit ``torch.Generator``; its numbers differ from ``jax.random``'s, so
only greedy decoding is comparable token for token.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_flash_torch.inference.kv_cache import KVCache
from tpu_flash_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0        # 0 => greedy argmax
    top_k: int = 0                  # 0 => no top-k filtering
    top_p: float = 1.0              # <1 => nucleus sampling
    eos_id: int = -1                # stop when generated (-1: never)


def adjusted_logits(logits: torch.Tensor, cfg: SamplingConfig) -> torch.Tensor:
    """Temperature, top-k and top-p filtering; the sampling distribution is
    ``softmax(adjusted_logits(...))``.  Requires ``cfg.temperature > 0``."""
    logits = logits / cfg.temperature
    if cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -cfg.top_k, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if cfg.top_p < 1.0:
        # keep the smallest prefix of the sorted distribution whose mass
        # reaches top_p (the argmax token always survives)
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < cfg.top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
        logits = torch.where(keep, logits, -torch.inf)
    return logits


def _sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64).  Greedy argmax takes the
    first index on ties, as ``jnp.argmax`` does."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(adjusted_logits(logits.float(), cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_caches(model, batch: int, max_len: int, *, quant: str = "none",
                compute_dtype=torch.float32) -> list[KVCache]:
    """One cache per layer, on the model's device."""
    c = model.cfg
    return [
        KVCache.create(batch, c.kv_heads, max_len, c.attn_hidden_dim,
                       quant=quant, compute_dtype=compute_dtype,
                       device=model.device)
        for _ in range(c.n_layer)
    ]


@torch.no_grad()
def prefill_prompt(model, prompt_ids, prompt_lengths, *, max_len: int,
                   kv_quant: str = "none", impl=None):
    """Run the right-padded prompt batch through fresh caches; returns
    ``(last_logits [B, V], caches)``.

    All Lp padded positions are written, then every cache's lengths are set
    back to the true prompt lengths, so decode never reads a pad position
    (later steps overwrite them)."""
    B, Lp = prompt_ids.shape
    caches = make_caches(model, B, max_len, quant=kv_quant,
                         compute_dtype=model.cfg.dtype)
    positions = torch.arange(Lp, device=prompt_ids.device)[None, :]
    logits, caches = model(prompt_ids, kv_caches=caches,
                           positions=positions.expand(B, Lp), impl=impl)
    prompt_lengths = prompt_lengths.to(torch.int32)
    for c in caches:
        c.lengths.copy_(prompt_lengths)
    # logits of the last real prompt token of each sequence
    last = logits[torch.arange(B, device=logits.device),
                  prompt_lengths.long() - 1]
    return last, caches


@torch.no_grad()
def generate(model, prompt_ids, prompt_lengths, sampling: SamplingConfig, *,
             max_len: int, kv_quant: str = "none", pad_id: int = 0,
             generator: torch.Generator | None = None, device=None,
             impl=None):
    """Returns (tokens [B, max_new_tokens], number generated [B]).

    ``prompt_ids`` [B, Lp] right-padded with ``pad_id`` and
    ``prompt_lengths`` [B] (tensors or arrays) are moved to ``device``:
    ``None`` means the card and raises without one, CPU runs pass
    ``device="cpu"``.  The model must live there already.  ``n_gen``
    counts the tokens that are not ``pad_id``, as the JAX version does."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, not {device}")
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device)
    B = prompt_ids.shape[0]
    last, caches = prefill_prompt(model, prompt_ids, prompt_lengths,
                                  max_len=max_len, kv_quant=kv_quant,
                                  impl=impl)
    out = torch.full((B, sampling.max_new_tokens), pad_id, dtype=torch.int64,
                     device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    for step in range(sampling.max_new_tokens):
        tok = _sample_token(last, sampling, generator)
        tok = torch.where(done, pad_id, tok)
        out[:, step] = tok
        done = done | (tok == sampling.eos_id)
        if step + 1 == sampling.max_new_tokens or bool(done.all()):
            break
        positions = caches[0].lengths[:, None].long()
        logits, caches = model(tok[:, None], kv_caches=caches,
                               positions=positions, impl=impl)
        last = logits[:, 0, :]
    n_gen = (out != pad_id).sum(dim=-1)
    return out, n_gen
