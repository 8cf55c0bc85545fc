"""Continuous-batching decode engine, counterpart of
``tpu_flash/inference/engine.py``.

A fixed pool of batch slots decodes together, one token per slot per step;
when a sequence finishes (eos or length) its slot is refilled from the queue
by a prefill that writes the new prompt's keys and values into that slot.

Host/device split: the device runs the decode steps (all slots, attention
through the flash-decode kernel) and the prefills; the host keeps the queue,
the slot bookkeeping and a mirror of every slot's cache length, so that
retiring a slot needs no device read.  Only the sampled tokens come back,
once per ``step`` or once per ``step_many``.

Every slot's cache takes a row each step, idle slots included (their tokens
are discarded); an idle slot's length may run past ``max_len`` and its writes
then land on the buffer's last row, as in the JAX engine.

Not ported yet: speculative decoding with a ``draft_model`` and shared-prefix
caching (``set_prefix``): ROADMAP.md, queue A item A6.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_flash_torch.inference.kv_cache import KVCache
from tpu_flash_torch.inference.sampler import (
    SamplingConfig,
    _sample_token,
    make_caches,
)
from tpu_flash_torch.kernels.common import cdiv, resolve_device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: list[int]
    finished_reason: str    # "eos" | "length"


def _scatter_subcaches(caches: list[KVCache], subs: list[KVCache], slot: int,
                       length: int) -> None:
    """Copy 1-slot sub-caches into ``slot`` of the main caches and pin that
    slot's length, in place.  Sub-caches may be longer along the positions
    axis (chunked prefill over-allocates by one chunk so a pad-filled final
    chunk never clamp-writes at ``max_len``); the extra rows are dropped."""
    for main, one in zip(caches, subs):
        S = main.max_len
        main.k[slot].copy_(one.k[0, :S])
        main.v[slot].copy_(one.v[0, :S])
        if main.k_scale is not None:
            main.k_scale[slot].copy_(one.k_scale[0, :, :S])
            main.v_scale[slot].copy_(one.v_scale[0, :, :S])
        main.lengths[slot] = length


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class DecodeEngine:
    """Fixed-slot continuous batching around a ``DecoderLM``.

    ``device=None`` means the card and raises without one; CPU runs pass
    ``device="cpu"``.  The model must live on that device.  ``stats``
    counts decode steps and admissions, with their wall time (each closes
    on a host read of the sampled tokens)."""

    def __init__(self, model, *, n_slots: int, max_len: int,
                 sampling: SamplingConfig, kv_quant: str = "none",
                 pad_id: int = 0, seed: int = 0,
                 prefill_chunk: int | None = None, draft_model=None,
                 device=None):
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(f"model lives on {model.device}, not {device}")
        if draft_model is not None:
            raise NotImplementedError(
                "speculative decoding (draft_model) is not ported yet "
                "(ROADMAP.md, queue A item A6)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.model = model
        self.device = device
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampling = sampling
        self.pad_id = pad_id
        self.prefill_chunk = prefill_chunk
        self.generator = torch.Generator(device=device).manual_seed(seed)

        self.caches = make_caches(model, n_slots, max_len, quant=kv_quant,
                                  compute_dtype=model.cfg.dtype)
        self.last_tokens = torch.zeros(n_slots, dtype=torch.int64,
                                       device=device)
        # host-side bookkeeping
        self.slot_uid: list[int | None] = [None] * n_slots
        self.slot_tokens: list[list[int]] = [[] for _ in range(n_slots)]
        self.slot_budget: list[int] = [0] * n_slots
        self.slot_len: list[int] = [0] * n_slots    # host mirror of lengths
        self.queue: list[Request] = []
        self.completions: list[Completion] = []
        self.stats = dict(decode_steps=0, decode_s=0.0, admissions=0,
                          admit_s=0.0)

    # ------------------------------------------------------------------ API
    def set_prefix(self, prefix) -> None:
        raise NotImplementedError(
            "shared-prefix caching (set_prefix) is not ported yet "
            "(ROADMAP.md, queue A item A6)")

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(u is not None for u in self.slot_uid)

    def run(self) -> list[Completion]:
        """Drain the queue one decode step per host round trip."""
        while self.has_work():
            self.admit()
            self.step()
        out, self.completions = self.completions, []
        return out

    def run_many(self, n: int = 8) -> list[Completion]:
        """Drain the queue with up to ``n`` decode steps per round trip."""
        while self.has_work():
            self.admit()
            self.step_many(n)
        out, self.completions = self.completions, []
        return out

    # ------------------------------------------------------------ internals
    def _decode_step(self, tokens, active):
        """One token for every slot; inactive slots emit ``pad_id``."""
        # Idle slots keep counting past the position table; their logits
        # are discarded, but an out-of-range lookup would fault on the card.
        positions = self.caches[0].lengths[:, None].long().clamp(
            max=self.model.cfg.n_positions - 1)
        logits, self.caches = self.model(tokens[:, None],
                                         kv_caches=self.caches,
                                         positions=positions)
        nxt = _sample_token(logits[:, 0, :], self.sampling, self.generator)
        return torch.where(active, nxt, self.pad_id)

    def _new_subcaches(self, max_len: int) -> list[KVCache]:
        c = self.caches[0]
        return make_caches(self.model, 1, max_len, quant=c.quant,
                           compute_dtype=c.compute_dtype)

    def _prefill(self, slot: int, prompt: list[int]) -> torch.Tensor:
        """Bucketed prefill: the prompt, padded to a power-of-two bucket,
        runs through a detached 1-slot cache that is then copied into
        ``slot``.  Returns the last prompt token's logits."""
        bucket = min(_bucket(len(prompt)), self.max_len)
        ids = np.full((1, bucket), self.pad_id, np.int64)
        ids[0, : len(prompt)] = prompt
        sub = self._new_subcaches(self.max_len)
        logits, sub = self.model(torch.from_numpy(ids).to(self.device),
                                 kv_caches=sub)
        _scatter_subcaches(self.caches, sub, slot, len(prompt))
        return logits[0, len(prompt) - 1]

    def _chunked_prefill(self, slot: int, prompt: list[int]) -> torch.Tensor:
        """Admit one prompt in ``prefill_chunk``-sized pieces, running a
        decode step for the already-active slots after each chunk but the
        last, so an admission delays in-flight requests by at most one chunk
        of prefill.  The chunks write a detached sub-cache (the interleaved
        steps write every slot of the main caches).  Returns the prompt's
        last-token logits."""
        C = self.prefill_chunk
        n_chunks = cdiv(len(prompt), C)
        # over-allocated by one chunk: the pad-filled final chunk may write
        # past max_len (the scatter drops the tail)
        sub = self._new_subcaches(self.max_len + C)
        for t in range(n_chunks):
            ids = np.full((1, C), self.pad_id, np.int64)
            seg = prompt[t * C:(t + 1) * C]
            ids[0, : len(seg)] = seg
            positions = t * C + torch.arange(C, device=self.device)[None, :]
            logits, sub = self.model(torch.from_numpy(ids).to(self.device),
                                     kv_caches=sub, positions=positions)
            if t < n_chunks - 1:
                self.step()
        _scatter_subcaches(self.caches, sub, slot, len(prompt))
        return logits[0, (len(prompt) - 1) - (n_chunks - 1) * C]

    @torch.no_grad()
    def admit(self) -> None:
        """Fill free slots from the queue (one prefill per admission)."""
        for slot in range(self.n_slots):
            if self.slot_uid[slot] is not None or not self.queue:
                continue
            t0 = time.perf_counter()
            req = self.queue.pop(0)
            prompt = list(req.prompt[: self.max_len - 1])
            if self.prefill_chunk is not None:
                last_logits = self._chunked_prefill(slot, prompt)
            else:
                last_logits = self._prefill(slot, prompt)
            tok = int(_sample_token(last_logits[None, :], self.sampling,
                                    self.generator)[0])
            self.stats["admissions"] += 1
            self.stats["admit_s"] += time.perf_counter() - t0
            self.slot_uid[slot] = req.uid
            self.slot_tokens[slot] = []
            self.slot_budget[slot] = self.sampling.max_new_tokens
            self.slot_len[slot] = len(prompt)
            self._host_emit(slot, tok, self.slot_len[slot])

    def _host_emit(self, slot: int, tok: int, slot_len: int,
                   update_last: bool = True) -> None:
        """Record a generated token; retire the slot on eos or length.

        ``slot_len`` is the slot's host-known cache length as of this token.
        ``update_last=False`` skips the ``last_tokens`` write for callers
        that set it wholesale (``step_many``)."""
        uid = self.slot_uid[slot]
        if uid is None:
            return
        if tok == self.sampling.eos_id:
            self.completions.append(
                Completion(uid, self.slot_tokens[slot], "eos"))
            self.slot_uid[slot] = None
            return
        self.slot_tokens[slot].append(tok)
        self.slot_budget[slot] -= 1
        if update_last:
            self.last_tokens[slot] = tok
        if (self.slot_budget[slot] <= 0
                or len(self.slot_tokens[slot]) + slot_len
                >= self.max_len - 1):
            self.completions.append(
                Completion(uid, self.slot_tokens[slot], "length"))
            self.slot_uid[slot] = None

    def _active_mask(self) -> np.ndarray:
        return np.asarray([u is not None for u in self.slot_uid], bool)

    @torch.no_grad()
    def step(self) -> None:
        """One decode step over all slots (tokens of idle ones dropped)."""
        active = self._active_mask()
        if not active.any():
            return
        t0 = time.perf_counter()
        nxt = self._decode_step(self.last_tokens,
                                torch.from_numpy(active).to(self.device))
        nxt_host = nxt.cpu().numpy()     # the host read closes the step
        self.stats["decode_steps"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot in range(self.n_slots):
            self.slot_len[slot] += 1     # every slot's cache took a row
            if active[slot]:
                self._host_emit(slot, int(nxt_host[slot]),
                                self.slot_len[slot])

    @torch.no_grad()
    def step_many(self, n: int) -> None:
        """Up to ``n`` decode steps per host round trip.

        Slots that emit eos go inactive on the device; slots finishing
        mid-run are retired when the tokens come back (they decode masked
        tokens until the run ends).  ``n`` is clamped so no active slot can
        overrun its cache; a slot's token budget does not clamp it."""
        active = self._active_mask()
        if not active.any():
            return
        room = self.max_len - 1 - max(
            self.slot_len[i] for i in range(self.n_slots) if active[i])
        n_steps = max(1, min(n, room))
        t0 = time.perf_counter()
        live = torch.from_numpy(active).to(self.device)
        tokens = self.last_tokens
        emitted = []
        for _ in range(n_steps):
            nxt = self._decode_step(tokens, live)
            emitted.append(torch.where(live, nxt, self.pad_id))
            tokens = torch.where(live, nxt, tokens)
            live = live & (nxt != self.sampling.eos_id)
        self.last_tokens = tokens
        toks_host = torch.stack(emitted).cpu().numpy()   # [n_steps, slots]
        self.stats["decode_steps"] += n_steps
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot in range(self.n_slots):
            base = self.slot_len[slot]
            self.slot_len[slot] += n_steps
            if not active[slot]:
                continue
            for i in range(n_steps):
                if self.slot_uid[slot] is None:
                    break         # retired mid-run; the rest is masked
                self._host_emit(slot, int(toks_host[i, slot]),
                                base + i + 1, update_last=False)
