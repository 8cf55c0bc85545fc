"""Speculative decoding: draft-model proposals verified by the target model,
counterpart of ``tpu_flash/inference/speculative.py``.

  * both models follow the sampler's cache convention: the cache holds
    every fed token, ``pending`` is the newest emitted token not yet fed;
  * a round runs ``n_draft`` single-token draft steps (each through the
    flash-decode kernel) proposing ``d_1..d_{n_draft-1}`` after ``pending``
    (the last step only writes its keys and values, so that a fully
    accepted round leaves the draft cache complete);
  * the target runs ONE forward over ``[pending, d_1..d_{n_draft-1}]``
    (the flash-decode kernel at Lq = ``n_draft``), giving its distribution
    after every prefix;
  * greedy (temperature 0): a draft is accepted iff it equals the target's
    argmax, so the output is the target's own greedy decode token for token;
  * stochastic (temperature > 0): rejection sampling (Leviathan et al.,
    Chen et al.): a draft ``d`` drawn from ``q`` is accepted with
    probability ``min(1, p(d)/q(d))`` against the target's adjusted
    distribution ``p``; on rejection the replacement is drawn from
    ``norm(max(p - q, 0))``, after a fully accepted round the bonus token
    from ``p``.  Each token is distributed as target-only sampling; the
    random stream is the ``torch.Generator``'s, not ``jax.random``'s;
  * rollback: positions past a sequence's ``lengths`` are never attended,
    so rejecting drafts is setting ``lengths`` to the accepted prefix.

The port's caches are updated in place and ``append`` advances ``lengths``,
so the round clones the lengths it needs from before its forwards (JAX
reads them from its immutable caches) and sets every layer's lengths from
those clones at the rollback.
"""

from __future__ import annotations

import torch

from tpu_flash_torch.inference.sampler import (
    SamplingConfig,
    adjusted_logits,
    prefill_prompt,
)
from tpu_flash_torch.kernels.common import resolve_device


def _positions(lengths, n: int, model, clamp: bool) -> torch.Tensor:
    """``lengths[:, None] + arange(n)``; ``clamp`` keeps them inside
    ``model``'s position table where it has one (``positional="learned"``:
    the engine's idle slots count past it); a rotary model's positions are
    never clamped, as in the JAX package, which clamps none."""
    pos = lengths[:, None].long() + torch.arange(n, device=lengths.device)
    if clamp and model.cfg.positional == "learned":
        return pos.clamp(max=model.cfg.n_positions - 1)
    return pos


@torch.no_grad()
def speculative_round(model, draft_model, sampling: SamplingConfig,
                      t_caches, d_caches, pending, active, generator,
                      n_draft: int, pad_id: int, *,
                      clamp_positions: bool = False,
                      nan_past_table: bool = False):
    """One draft-verify round, the shared core of
    :func:`speculative_generate` and the engine's speculative step.

    Drafts ``n_draft - 1`` tokens, verifies ``[pending, drafts]`` in one
    target forward, and rolls both caches back to the accepted prefix (rows
    where ``active`` is False do not advance).  Returns ``(emitted [B,
    n_draft], m [B], g_m [B], t_caches, d_caches)``: ``emitted[:, :m+1]``
    are this round's tokens (accepted drafts, then the correction or bonus
    ``g_m``, the next round's ``pending``), the rest ``pad_id``.  The caches
    are the ones given, updated in place.  ``clamp_positions`` keeps
    positions inside the table of each model that has one (the engine);
    ``nan_past_table`` embeds a position past it as NaN, as JAX does
    (``speculative_generate``)."""
    W = n_draft
    stochastic = sampling.temperature > 0.0
    B = pending.shape[0]
    dev = pending.device
    ar = torch.arange(W, device=dev)[None, :]
    # the forwards below advance the live lengths: keep them from before
    t_len = t_caches[0].lengths.clone()
    d_len0 = [c.lengths.clone() for c in d_caches]

    # ---- W single-token draft steps (the last only for its KV write) -----
    x, fed, qs = pending, [], []
    for _ in range(W):
        fed.append(x)
        logits, d_caches = draft_model(
            x[:, None], kv_caches=d_caches, positions=_positions(
                d_caches[0].lengths, 1, draft_model, clamp_positions),
            nan_past_table=nan_past_table)
        if stochastic:
            al = adjusted_logits(logits[:, 0].float(), sampling)
            qprobs = torch.softmax(al, dim=-1)
            x = torch.multinomial(qprobs, 1, generator=generator)[:, 0]
        else:
            x = torch.argmax(logits[:, 0], dim=-1)
            qprobs = None
        qs.append(qprobs)
    seq = torch.stack(fed, dim=1)          # [B, W]: pending, d_1..d_{W-1}

    # ---- one verification forward over all W tokens ----------------------
    logits, t_caches = model(
        seq, kv_caches=t_caches,
        positions=_positions(t_len, W, model, clamp_positions),
        nan_past_table=nan_past_table)

    # ---- longest accepted draft prefix, then the correction or bonus -----
    if stochastic:
        q = torch.stack(qs, dim=1)         # [B, W, V]: q[:, t] drafts t+1
        p = torch.softmax(adjusted_logits(logits.float(), sampling), dim=-1)
        if W > 1:
            # accept d_{t+1} iff u * q(d) < p(d)  (u < min(1, p/q))
            d_next = seq[:, 1:, None]
            p_d = p[:, :-1].gather(-1, d_next)[..., 0]
            q_d = q[:, :-1].gather(-1, d_next)[..., 0]
            u = torch.rand((B, W - 1), generator=generator, device=dev)
            match = (u * q_d < p_d).long()
            m = torch.cumprod(match, dim=1).sum(dim=1)
        else:
            m = torch.zeros(B, dtype=torch.int64, device=dev)
        # the rejection residual, or the bonus where every draft was
        # accepted: q at the bonus slot is zero, so the residual is p
        idx = m[:, None, None].expand(-1, 1, p.shape[-1])
        p_m = p.gather(1, idx)[:, 0]
        q_m = torch.where((m == W - 1)[:, None], 0.0, q.gather(1, idx)[:, 0])
        resid = torch.clamp(p_m - q_m, min=0.0)
        z = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(z > 0, resid / z, p_m)
        g_m = torch.multinomial(resid, 1, generator=generator)   # [B, 1]
    else:
        g = torch.argmax(logits, dim=-1)                         # [B, W]
        if W > 1:
            match = (g[:, :-1] == seq[:, 1:]).long()
            m = torch.cumprod(match, dim=1).sum(dim=1)           # 0..W-1
        else:
            m = torch.zeros(B, dtype=torch.int64, device=dev)
        g_m = g.gather(1, m[:, None])                            # [B, 1]
    drafts = torch.cat([seq[:, 1:], torch.zeros_like(seq[:, :1])], dim=1)
    mm = m[:, None]
    emitted = torch.where(ar < mm, drafts,
                          torch.where(ar == mm, g_m, pad_id))

    # ---- rollback: keep keys only for the accepted prefix -----------------
    adv = torch.where(active, m + 1, 0).to(t_len.dtype)
    for c in t_caches:
        c.lengths.copy_(t_len + adv)
    for c, l0 in zip(d_caches, d_len0):
        c.lengths.copy_(l0 + adv)
    return emitted, m, g_m[:, 0], t_caches, d_caches


@torch.no_grad()
def speculative_generate(model, draft_model, prompt_ids, prompt_lengths,
                         sampling: SamplingConfig, *, max_len: int,
                         n_draft: int = 4, kv_quant: str = "none",
                         draft_kv_quant: str = "none", pad_id: int = 0,
                         generator: torch.Generator | None = None,
                         return_stats: bool = False, device=None):
    """Speculative decode; returns (tokens [B, max_new_tokens], number
    generated [B]) with :func:`sampler.generate`'s contract.  With
    ``return_stats`` a third element ``{"rounds", "drafted", "accepted"}``
    counts verification rounds and each sequence's drafts and accepted
    drafts.

    ``n_draft`` is the number of tokens the target takes a round (one
    draft-model step fewer); ``n_draft=1`` is plain decoding through the
    verification path.  Both models share the vocabulary and live on
    ``device`` (``None``: the card).  ``max_len`` must leave ``n_draft``
    rows beyond prompt + ``max_new_tokens`` (a round may overshoot before
    its rollback).  Where ``max_len`` passes a model's position table, a
    position past it embeds as NaN, as in the JAX version."""
    if n_draft < 1:
        raise ValueError("n_draft must be >= 1")
    device = resolve_device(device)
    for m_ in (model, draft_model):
        if m_.device != device:
            raise ValueError(f"model lives on {m_.device}, not {device}")
    prompt_ids = torch.as_tensor(prompt_ids, device=device).long()
    prompt_lengths = torch.as_tensor(prompt_lengths, device=device)
    stochastic = sampling.temperature > 0.0
    B, W = prompt_ids.shape[0], n_draft
    max_new, eos = sampling.max_new_tokens, sampling.eos_id
    past_table = max_len > min(model.cfg.n_positions,
                               draft_model.cfg.n_positions)

    t_last, t_caches = prefill_prompt(model, prompt_ids, prompt_lengths,
                                      max_len=max_len, kv_quant=kv_quant)
    # the draft always continues from the target's tokens
    _, d_caches = prefill_prompt(draft_model, prompt_ids, prompt_lengths,
                                 max_len=max_len, kv_quant=draft_kv_quant)
    if stochastic:
        probs = torch.softmax(adjusted_logits(t_last.float(), sampling), -1)
        pending = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        pending = torch.argmax(t_last, dim=-1)

    ar = torch.arange(W, device=device)[None, :]
    # the round that produces a token emits it (g_m is both emitted and the
    # next round's pending), so the prefill's token is emitted here; one
    # column past the end takes the writes a row drops
    out = torch.full((B, max_new + 1), pad_id, dtype=torch.int64,
                     device=device)
    if max_new > 0:
        out[:, 0] = pending
    out_n = torch.full((B,), min(1, max_new), dtype=torch.int64,
                       device=device)
    done = (pending == eos) | (max_new <= 0)
    rounds = 0
    drafted = torch.zeros(B, dtype=torch.int64, device=device)
    accepted = torch.zeros(B, dtype=torch.int64, device=device)
    while not bool((done | (out_n >= max_new)).all()):
        # rows already done or out of budget neither emit nor advance
        active = ~done & (out_n < max_new)
        emitted, m, g_m, t_caches, d_caches = speculative_round(
            model, draft_model, sampling, t_caches, d_caches, pending,
            active, generator, W, pad_id, nan_past_table=past_table)

        # ---- eos truncation, each sequence's output scatter ---------------
        is_eos = emitted == eos
        eos_before = torch.cumsum(is_eos.long(), dim=1) - is_eos.long()
        keep = ((ar <= m[:, None]) & (eos_before == 0) & active[:, None]
                & (out_n[:, None] + ar < max_new))
        cols = torch.where(keep, out_n[:, None] + ar, max_new)
        out.scatter_(1, cols, torch.where(keep, emitted, pad_id))
        out_n = out_n + keep.sum(dim=1)
        done = done | (keep & is_eos).any(dim=1)

        pending = torch.where(done, pad_id, g_m)
        rounds += 1
        drafted = drafted + torch.where(active, W - 1, 0)
        accepted = accepted + torch.where(active, m, 0)
    out = out[:, :max_new]
    n_gen = (out != pad_id).sum(dim=-1)
    if return_stats:
        return out, n_gen, {"rounds": rounds, "drafted": drafted,
                            "accepted": accepted}
    return out, n_gen
