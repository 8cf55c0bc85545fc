"""Batched beam search over the KV cache, counterpart of
``tpu_flash/inference/beam.py``.

``B`` sequences x ``W`` beams decode together; the beam reorder each step is
a batch gather of every layer's cache (``_gather_cache``).  Scoring follows
GNMT: sum of token log-probs, finished beams frozen (their only
continuation is ``pad_id`` at zero cost), final selection by
``score / ((5 + len) / 6) ** length_penalty``.

The JAX ``while_loop`` becomes a Python loop with one host check a step.
The port's caches are updated in place, so the reorder builds new buffers
by ``index_select`` rather than writing a buffer another row still reads.
The top ``W`` candidates come from a stable descending sort, which orders
NaN first and ties by lower index, as ``jax.lax.top_k`` does (``torch.topk``
leaves the order of ties unspecified on CUDA); past the position table the
logits are NaN, as in JAX (``DecoderLM``'s ``nan_past_table``).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_flash_torch.inference.kv_cache import KVCache
from tpu_flash_torch.inference.sampler import prefill_prompt
from tpu_flash_torch.kernels.common import resolve_device

NEG_INF = -1e30


def _gather_cache(c: KVCache, idx: torch.Tensor) -> KVCache:
    """A new cache whose batch rows are ``c``'s rows ``idx`` [B*W]."""
    def take(a):
        return None if a is None else a.index_select(0, idx)

    return dataclasses.replace(c, k=take(c.k), v=take(c.v),
                               k_scale=take(c.k_scale),
                               v_scale=take(c.v_scale),
                               lengths=take(c.lengths))


@torch.no_grad()
def beam_generate(model, prompt_ids, prompt_lengths, *, beam_size: int = 4,
                  max_new_tokens: int = 64, max_len: int, eos_id: int,
                  pad_id: int = 0, kv_quant: str = "none",
                  length_penalty: float = 0.6, device=None, impl=None,
                  trace: list | None = None):
    """Returns (tokens [B, max_new_tokens], lengths [B]) of the best beam.

    ``prompt_ids`` [B, Lp] right-padded and ``prompt_lengths`` [B] (tensors
    or arrays) are moved to ``device`` (``None``: the card, raising without
    one; CPU runs pass ``"cpu"``), where the model must live.  ``impl``
    reaches the kernels' wrappers.  A ``trace`` list receives, a step at a
    time, the beams' scores and finished flags before the step and the
    flat indices (``beam * V + token``) of the candidates it keeps, each
    [B, W]: what a check of each choice against other logits needs."""
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model lives on {model.device}, not {device}")
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device)
    B, W, V = prompt_ids.shape[0], beam_size, model.cfg.n_vocab
    past_table = max_len > model.cfg.n_positions

    # ---- prefill once per sequence, then tile to B*W beams ----------------
    last, caches = prefill_prompt(model, prompt_ids, prompt_lengths,
                                  max_len=max_len, kv_quant=kv_quant,
                                  impl=impl)
    tile = torch.arange(B, device=device).repeat_interleave(W)   # [B*W]
    caches = [_gather_cache(c, tile) for c in caches]
    last = last.repeat_interleave(W, dim=0)                      # [B*W, V]

    # beam 0 active, the others at -inf: the first step fans out from one
    # root instead of W copies of the same prefix
    scores = torch.full((B, W), NEG_INF, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros((B, W), dtype=torch.bool, device=device)
    gen_len = torch.zeros((B, W), dtype=torch.int64, device=device)
    out = torch.full((B, W, max_new_tokens), pad_id, dtype=torch.int64,
                     device=device)
    # a finished beam may only emit pad_id, for free
    finished_row = torch.full((V,), NEG_INF, device=device)
    finished_row[pad_id] = 0.0
    rows = torch.arange(B, device=device)[:, None] * W

    for step in range(max_new_tokens):
        logp = torch.log_softmax(last.float(), dim=-1).view(B, W, V)
        logp = torch.where(done[:, :, None], finished_row, logp)
        cand = (scores[:, :, None] + logp).view(B, W * V)
        top_scores, flat_idx = (t[:, :W] for t in torch.sort(
            cand, dim=-1, descending=True, stable=True))
        if trace is not None:
            trace.append((scores, done, flat_idx))
        parent, token = flat_idx // V, flat_idx % V              # [B, W]

        # reorder the beam state by parent
        was_done = done.gather(1, parent)
        gen_len = gen_len.gather(1, parent) + (~was_done).long()
        out = out.gather(1, parent[:, :, None].expand(-1, -1,
                                                      max_new_tokens))
        out[:, :, step] = torch.where(was_done, pad_id, token)
        done = was_done | (token == eos_id)
        scores = top_scores
        if step + 1 == max_new_tokens or bool(done.all()):
            break
        gidx = (rows + parent).view(-1)                          # [B*W]
        caches = [_gather_cache(c, gidx) for c in caches]
        step_tok = torch.where(was_done, pad_id, token).view(-1, 1)
        logits, caches = model(step_tok, kv_caches=caches,
                               positions=caches[0].lengths[:, None].long(),
                               impl=impl, nan_past_table=past_table)
        last = logits[:, 0, :]

    # GNMT length normalisation; unfinished beams are eligible only where
    # no beam of the sequence finished
    norm = ((5.0 + gen_len.float()) / 6.0) ** length_penalty
    adj = scores / torch.clamp(norm, min=1e-6)
    any_done = done.any(dim=1, keepdim=True)
    adj = torch.where(any_done & ~done, NEG_INF, adj)
    best = torch.argmax(adj, dim=1)                              # [B]
    b = torch.arange(B, device=device)
    return out[b, best], gen_len[b, best]
