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
then land on the buffer's last rows, as in the JAX engine.

With a ``draft_model`` the engine keeps the draft's own slot caches and
``step_speculative`` / ``run_speculative`` emit up to ``n_draft`` tokens a
slot a round (``inference/speculative.py``).  ``set_prefix`` prefills a
shared system prompt once; admissions that start with it copy its caches
and prefill only the rest.  The port's caches are updated in place, so each
such admission starts from a clone of the stored prefix caches (JAX's
immutable arrays make that copy free).
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
from tpu_flash_torch.inference.speculative import (_positions,
                                                   speculative_round)
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


def _clone_caches(caches: list[KVCache]) -> list[KVCache]:
    def clone(a):
        return None if a is None else a.clone()

    return [dataclasses.replace(c, k=c.k.clone(), v=c.v.clone(),
                                k_scale=clone(c.k_scale),
                                v_scale=clone(c.v_scale),
                                lengths=c.lengths.clone()) for c in caches]


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class DecodeEngine:
    """Fixed-slot continuous batching around a ``DecoderLM``.

    ``device=None`` means the card and raises without one; CPU runs pass
    ``device="cpu"``.  The model (and ``draft_model``) must live on that
    device.  ``stats`` counts decode steps and admissions, with their wall
    time (each closes on a host read of the sampled tokens); ``_spec_stats``
    holds the JAX engine's speculative counters (``rounds``, ``proposed``,
    ``emitted``, ``accepted``, and the timed ``spec_*`` and ``plain_*``
    samples the guard of ``run_speculative`` compares) and
    ``draft_fed``, the plain steps that also fed the draft."""

    def __init__(self, model, *, n_slots: int, max_len: int,
                 sampling: SamplingConfig, kv_quant: str = "none",
                 pad_id: int = 0, seed: int = 0,
                 prefill_chunk: int | None = None, draft_model=None,
                 n_draft: int = 4, draft_kv_quant: str = "none",
                 device=None):
        device = resolve_device(device)
        for m in (model, draft_model):
            if m is not None and m.device != device:
                raise ValueError(f"model lives on {m.device}, not {device}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        if draft_model is not None and n_draft < 1:
            raise ValueError(f"n_draft must be >= 1, got {n_draft}")
        self.model = model
        self.device = device
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampling = sampling
        self.pad_id = pad_id
        self.prefill_chunk = prefill_chunk
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._prefix = None           # shared-prefix cache (set_prefix)
        self._prefix_caches = {}      # is_draft -> 1-slot caches
        self._prefix_last = None

        self.caches = make_caches(model, n_slots, max_len, quant=kv_quant,
                                  compute_dtype=model.cfg.dtype)
        self.last_tokens = torch.zeros(n_slots, dtype=torch.int64,
                                       device=device)
        # speculative decoding: a draft model with its own slot caches
        self.draft_model = draft_model
        self.n_draft = n_draft
        if draft_model is not None:
            self.draft_caches = make_caches(
                draft_model, n_slots, max_len, quant=draft_kv_quant,
                compute_dtype=draft_model.cfg.dtype)
        # host-side bookkeeping
        self.slot_uid: list[int | None] = [None] * n_slots
        self.slot_tokens: list[list[int]] = [[] for _ in range(n_slots)]
        self.slot_budget: list[int] = [0] * n_slots
        self.slot_len: list[int] = [0] * n_slots    # host mirror of lengths
        self.queue: list[Request] = []
        self.completions: list[Completion] = []
        self.stats = dict(decode_steps=0, decode_s=0.0, admissions=0,
                          admit_s=0.0)
        # the guard's samples of both modes, each mode's first call (the
        # JAX engine's compile) excluded, and the acceptance counters
        self._spec_stats = dict(rounds=0, proposed=0, emitted=0, accepted=0,
                                spec_timed=0, spec_s=0.0, spec_tok=0,
                                plain_timed=0, plain_s=0.0, plain_tok=0,
                                draft_fed=0)
        self._spec_compiled: set[int] = set()   # round widths already run
        self._plain_compiled = False
        self.spec_decision: dict | None = None

    # ------------------------------------------------------------------ API
    @torch.no_grad()
    def set_prefix(self, prefix) -> None:
        """Shared-prefix (system-prompt) caching: prefill ``prefix`` once
        into detached 1-slot caches; every admission whose prompt starts
        with it copies those caches and prefills only the remainder.
        Requires chunked-prefill mode."""
        if self.prefill_chunk is None:
            raise ValueError("set_prefix requires prefill_chunk mode "
                             "(DecodeEngine(prefill_chunk=C))")
        prefix = list(prefix)
        if not prefix or len(prefix) >= self.max_len - 1:
            raise ValueError(f"prefix length {len(prefix)} must be in "
                             f"[1, max_len-1)")
        C = self.prefill_chunk
        self._prefix = prefix
        self._prefix_caches = {}
        for is_draft, model, attr in self._prefill_targets():
            # over-allocated by one chunk, as _chunked_prefill's
            sub = self._new_subcaches(model, attr, self.max_len + C)
            logits, n_chunks = self._run_chunks(model, sub, prefix, 0)
            # the chunk padding advanced the lengths past the prefix: pin
            # them back, so that the remainder starts at len(prefix)
            for c in sub:
                c.lengths.fill_(len(prefix))
            self._prefix_caches[is_draft] = sub
            if not is_draft:
                self._prefix_last = logits[
                    0, (len(prefix) - 1) - (n_chunks - 1) * C]

    def _prefill_targets(self):
        """(is_draft, model, caches attribute) of each model to prefill."""
        targets = [(False, self.model, "caches")]
        if self.draft_model is not None:
            targets.append((True, self.draft_model, "draft_caches"))
        return targets

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
        # Idle slots keep counting past a learned position table; their
        # logits are discarded, but an out-of-range lookup would fault on
        # the card.  A rotary model's positions are not clamped.
        positions = _positions(self.caches[0].lengths, 1, self.model, True)
        logits, self.caches = self.model(tokens[:, None],
                                         kv_caches=self.caches,
                                         positions=positions)
        nxt = _sample_token(logits[:, 0, :], self.sampling, self.generator)
        return torch.where(active, nxt, self.pad_id)

    def _new_subcaches(self, model, attr: str, max_len: int):
        c = getattr(self, attr)[0]
        return make_caches(model, 1, max_len, quant=c.quant,
                           compute_dtype=c.compute_dtype)

    def _prefill(self, slot: int, prompt: list[int]) -> torch.Tensor:
        """Bucketed prefill: the prompt, padded to a power-of-two bucket,
        runs through detached 1-slot caches that are then copied into
        ``slot`` (the target's, and the draft's where there is one).
        Returns the last prompt token's logits."""
        bucket = min(_bucket(len(prompt)), self.max_len)
        ids = np.full((1, bucket), self.pad_id, np.int64)
        ids[0, : len(prompt)] = prompt
        ids = torch.from_numpy(ids).to(self.device)
        last = None
        for is_draft, model, attr in self._prefill_targets():
            sub = self._new_subcaches(model, attr, self.max_len)
            logits, sub = model(ids, kv_caches=sub)
            _scatter_subcaches(getattr(self, attr), sub, slot, len(prompt))
            if not is_draft:
                last = logits[0, len(prompt) - 1]
        return last

    def _run_chunks(self, model, sub, tokens: list[int], base: int,
                    interleave: bool = False):
        """``tokens`` through ``sub`` in ``prefill_chunk``-sized pieces
        from position ``base``, the last piece padded; with
        ``interleave`` a decode step of the active slots after each piece
        but the last.  Returns (the last piece's logits, the pieces)."""
        C = self.prefill_chunk
        n_chunks = cdiv(len(tokens), C)
        logits = None
        for t in range(n_chunks):
            ids = np.full((1, C), self.pad_id, np.int64)
            seg = tokens[t * C:(t + 1) * C]
            ids[0, : len(seg)] = seg
            positions = (base + t * C
                         + torch.arange(C, device=self.device)[None, :])
            logits, sub = model(torch.from_numpy(ids).to(self.device),
                                kv_caches=sub, positions=positions)
            if interleave and t < n_chunks - 1:
                self.step()
        return logits, n_chunks

    def _chunked_prefill(self, slot: int, prompt: list[int]) -> torch.Tensor:
        """Admit one prompt in ``prefill_chunk``-sized pieces, running a
        decode step for the already-active slots after each chunk but the
        last, so an admission delays in-flight requests by at most one chunk
        of prefill.  The chunks write detached sub-caches (the interleaved
        steps write every slot of the main caches).  A prompt that starts
        with the ``set_prefix`` prompt starts from a copy of its caches.
        With a draft model no step is interleaved: a plain step appends to
        the target's caches only.  Returns the prompt's last-token
        logits."""
        C = self.prefill_chunk
        base = 0
        if (self._prefix is not None
                and prompt[: len(self._prefix)] == self._prefix):
            base = len(self._prefix)
        rest = prompt[base:]
        last = None
        for is_draft, model, attr in self._prefill_targets():
            if base:
                # a copy: the remainder's chunks write into it in place
                sub = _clone_caches(self._prefix_caches[is_draft])
            else:
                # over-allocated by one chunk: the pad-filled final chunk
                # may write past max_len (the scatter drops the tail)
                sub = self._new_subcaches(model, attr, self.max_len + C)
            logits, n_chunks = self._run_chunks(
                model, sub, rest, base,
                interleave=not is_draft and self.draft_model is None)
            _scatter_subcaches(getattr(self, attr), sub, slot, len(prompt))
            if not is_draft:
                last = (self._prefix_last if n_chunks == 0
                        else logits[0, (len(rest) - 1) - (n_chunks - 1) * C])
        return last

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
    def _feed_draft(self) -> None:
        """The draft takes the tokens a plain step is about to give the
        target, so its caches stay level with the target's: the plain steps
        of ``run_speculative``'s probation, after which a speculative round
        may follow.  A stated deviation: the JAX engine feeds the target
        only, and its draft falls a token behind at each such step.  The
        card is waited for, so the feed is not in the step's timed
        sample."""
        if not self._active_mask().any():
            return                       # ``step`` takes no token either
        _, self.draft_caches = self.draft_model(
            self.last_tokens[:, None], kv_caches=self.draft_caches,
            positions=_positions(self.draft_caches[0].lengths, 1,
                                 self.draft_model, True))
        self._spec_stats["draft_fed"] += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def step(self) -> None:
        """One decode step over all slots (tokens of idle ones dropped).
        Appends to the target's caches only."""
        active = self._active_mask()
        if not active.any():
            return
        t0 = time.perf_counter()
        nxt = self._decode_step(self.last_tokens,
                                torch.from_numpy(active).to(self.device))
        nxt_host = nxt.cpu().numpy()     # the host read closes the step
        dt = time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["decode_s"] += dt
        if self._plain_compiled:
            st = self._spec_stats
            st["plain_timed"] += 1
            st["plain_s"] += dt
            st["plain_tok"] += int(active.sum())
        else:
            self._plain_compiled = True     # the first call is not timed
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

    # ------------------------------------------------- speculative stepping
    @torch.no_grad()
    def step_speculative(self) -> None:
        """One speculative round over all active slots (requires a
        ``draft_model``); emits up to ``n_draft`` tokens a slot.

        The round width is clamped so that no active slot's verification
        overruns its cache, as ``step_many``'s step count is: the last
        rounds near capacity shrink instead of retiring early, so
        ``_host_emit`` retires a slot at the same token as ``run()``."""
        if self.draft_model is None:
            raise ValueError("engine was built without a draft_model")
        # retire slots without room for a single-token round (unreachable
        # while _host_emit's length retirement holds; a guard)
        for slot in range(self.n_slots):
            if (self.slot_uid[slot] is not None
                    and self.slot_len[slot] + 1 >= self.max_len):
                self.completions.append(Completion(
                    self.slot_uid[slot], self.slot_tokens[slot], "length"))
                self.slot_uid[slot] = None
        active = self._active_mask()
        if not active.any():
            return
        # this round's keys land at positions len .. len+W-1 (< max_len)
        room = self.max_len - max(
            self.slot_len[i] for i in range(self.n_slots) if active[i])
        W = max(1, min(self.n_draft, room))
        live = torch.from_numpy(active).to(self.device)
        t0 = time.perf_counter()
        emitted, m, g_m, self.caches, self.draft_caches = speculative_round(
            self.model, self.draft_model, self.sampling, self.caches,
            self.draft_caches, self.last_tokens, live, self.generator, W,
            self.pad_id, clamp_positions=True)
        n_valid = torch.where(live, m + 1, 0)
        self.last_tokens = torch.where(live, g_m, self.last_tokens)
        emitted_host = emitted.cpu().numpy()
        n_valid_host = n_valid.cpu().numpy()   # the host read closes it
        dt = time.perf_counter() - t0
        st = self._spec_stats
        n_active = int(active.sum())
        n_emitted = int(n_valid_host[active].sum())
        st["rounds"] += 1
        st["proposed"] += W * n_active
        st["emitted"] += n_emitted
        # each active slot emits its accepted drafts and one correction:
        # the acceptance fraction leaves the round's bonus token out
        st["accepted"] += n_emitted - n_active
        if W in self._spec_compiled:
            st["spec_timed"] += 1
            st["spec_s"] += dt
            st["spec_tok"] += n_emitted
        else:
            self._spec_compiled.add(W)      # the first call is not timed
        for slot in range(self.n_slots):
            if not active[slot]:
                continue
            base = self.slot_len[slot]
            self.slot_len[slot] += int(n_valid_host[slot])
            for j in range(int(n_valid_host[slot])):
                if self.slot_uid[slot] is None:
                    break         # retired mid-round (eos); rest dropped
                self._host_emit(slot, int(emitted_host[slot, j]),
                                base + j + 1, update_last=False)

    def run_speculative(
            self, probe_rounds: int | None = 8) -> list[Completion]:
        """Drain the queue with speculative rounds under an
        acceptance-aware guard.

        Greedy speculative decoding emits exactly the target's own tokens,
        so the engine can time both modes on the live stream without
        changing a completion.  Probation alternates timed speculative
        rounds and plain decode steps (each mode's first call excluded);
        once both hold ``probe_rounds`` timed samples it compares their
        tokens a second and keeps the faster for the rest of the drain,
        recorded with the rates and the acceptance fraction in
        ``spec_decision``.  ``probe_rounds=None`` always takes the
        speculative round.  A plain step of the probation also feeds the
        draft (``_feed_draft``), so that the draft's context stays the
        target's."""
        if self.draft_model is None:
            raise ValueError("engine was built without a draft_model")
        while self.has_work():
            self.admit()
            st = self._spec_stats
            if probe_rounds is not None and self.spec_decision is None:
                if (st["spec_timed"] >= probe_rounds
                        and st["plain_timed"] >= probe_rounds):
                    spec_tps = st["spec_tok"] / max(st["spec_s"], 1e-12)
                    plain_tps = st["plain_tok"] / max(st["plain_s"], 1e-12)
                    self.spec_decision = dict(
                        mode=("speculative" if spec_tps >= plain_tps
                              else "plain"),
                        spec_tps=spec_tps, plain_tps=plain_tps,
                        acceptance=st["accepted"] / max(st["proposed"], 1))
                else:
                    # probation: alternate timed samples of each mode
                    if st["spec_timed"] <= st["plain_timed"]:
                        self.step_speculative()
                    else:
                        self._feed_draft()
                        self.step()
                    continue
            if (self.spec_decision is None
                    or self.spec_decision["mode"] == "speculative"):
                self.step_speculative()
            else:
                self.step()
        out, self.completions = self.completions, []
        return out
