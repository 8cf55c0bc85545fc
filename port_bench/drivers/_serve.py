"""What the serving drivers share: the traffic generator, the engine with the
benchmark's instruments, and the comparison of a sample of finished requests
with the reference.

The generator gives every seed the same set of prompt lengths (the
quantiles of the stated distribution at (i + 0.5) / N), in an order drawn
from the seed, and random token ids from the seed: the work of a run does
not move with its seed, only its order and its ids.  The order is
stratified (``blocked``): each run of ``BLOCK`` consecutive requests takes
one length from each of ``BLOCK`` equal strata of the sorted lengths, so
that no seed puts its longest prompts together inside the window.  This is
smoother than independent draws; it keeps the window's work the same from
seed to seed.

The engine's own ``_host_emit`` and ``step`` are wrapped on the instance
(the program is not changed): each generated token is stamped with the host
clock when it reaches the host, and ``pb.step`` spans every decode step,
those that a chunked prefill interleaves too."""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np

from port_bench import arith, compare, program, weights
from port_bench.harness import span
from port_bench.trace import LEAD_S, Tracer

SOURCES = ("flash_decode",)
DRAIN_S = 60.0        # how long finished work is waited for after the close
BLOCK = 8             # consecutive requests that take one of each stratum


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def prompt_lengths(tr: dict, n: int) -> np.ndarray:
    """``n`` lengths of the traffic's ``prompt`` distribution: the
    quantiles of a log-normal (median, sigma), clipped to [lo, hi]."""
    p = tr["prompt"]
    if p["dist"] != "log_normal":
        raise ValueError(f"unknown prompt distribution {p['dist']!r}")
    z = np.array([statistics.NormalDist().inv_cdf(v) for v in quantiles(n)])
    x = p["median"] * np.exp(p["sigma"] * z)
    return np.clip(np.rint(x), p["lo"], p["hi"]).astype(np.int64)


def blocked(rng, values: np.ndarray) -> np.ndarray:
    """``values`` (ascending) in an order from ``rng`` in which each
    ``BLOCK`` consecutive entries take one from each of ``BLOCK``
    contiguous strata (the last block short where ``BLOCK`` does not
    divide the count)."""
    cols = [rng.permutation(s) for s in
            np.array_split(np.arange(len(values)), BLOCK)]
    order = []
    for i in range(max(len(c) for c in cols)):
        order.extend(rng.permutation([c[i] for c in cols if i < len(c)]))
    return values[np.array(order, dtype=np.int64)]


def make_prompts(run, n: int) -> list[list[int]]:
    """``n`` prompts: the set of lengths fixed, their order (``blocked``)
    and ids drawn from the seed."""
    rng = np.random.default_rng(run.seed)
    lengths = blocked(rng, prompt_lengths(run.traffic, n))
    ids = rng.integers(0, run.shape.vocab, int(lengths.sum()))
    cuts = np.concatenate([[0], np.cumsum(lengths)])
    return [ids[cuts[i]:cuts[i + 1]].tolist() for i in range(n)]


@dataclasses.dataclass
class Served:
    """The engine, its instruments and what they recorded."""

    engine: object
    times: dict = dataclasses.field(default_factory=dict)  # uid -> stamps
    prompts: dict = dataclasses.field(default_factory=dict)
    decode_log: list | None = None     # live keys of each traced step
    on_step: object = None             # called before every decode step

    def __post_init__(self):
        eng = self.engine
        emit, step = eng._host_emit, eng.step

        def stamped_emit(slot, tok, slot_len, update_last=True):
            uid = eng.slot_uid[slot]
            if uid is not None:
                self.times.setdefault(uid, []).append(time.perf_counter())
            return emit(slot, tok, slot_len, update_last)

        def spanned_step():
            if self.on_step is not None:
                self.on_step()
            if self.decode_log is not None:
                live = [eng.slot_len[s] + 1 for s in range(eng.n_slots)
                        if eng.slot_uid[s] is not None]
                if live:
                    self.decode_log.append(live)
            with span("pb.step"):
                step()

        eng._host_emit = stamped_emit
        eng.step = spanned_step

    def submit(self, uid: int, prompt: list[int]) -> None:
        from tpu_flash_torch.inference.engine import Request

        self.prompts[uid] = prompt
        with span("pb.submit"):
            self.engine.submit(Request(uid, prompt))

    def turn(self) -> None:
        """One round of the engine's loop (``DecodeEngine.run``'s body)."""
        with span("pb.admit"):
            self.engine.admit()
        self.engine.step()


def build(run) -> Served:
    """Model, engine and warm-up: every prefill shape the traffic uses
    (``warmup_prompts``, each with a budget of two tokens) and the decode
    step."""
    tr, dev = run.traffic, run.device
    with run.phase("import"):
        from tpu_flash_torch.inference.engine import DecodeEngine, Request
        from tpu_flash_torch.inference.sampler import SamplingConfig
        from tpu_flash_torch.kernels import common
    with run.phase("build"):
        if dev.type == "cuda":
            common.build(SOURCES)
    with run.phase("weights"):
        model = program.build_model(
            run.shape, run.config, weights.make(run.shape, run.seed, dev),
            dev)
        sampling = SamplingConfig(max_new_tokens=tr["max_new_tokens"],
                                  temperature=0.0, eos_id=-1)
        engine = DecodeEngine(model, n_slots=tr["slots"],
                              max_len=tr["max_len"], sampling=sampling,
                              prefill_chunk=tr["prefill_chunk"],
                              device=dev)
    with run.phase("warmup"):
        engine.sampling = dataclasses.replace(sampling, max_new_tokens=2)
        rng = np.random.default_rng([run.seed, 2])
        for i, n in enumerate(tr["warmup_prompts"]):
            engine.submit(Request(-1 - i, rng.integers(
                0, run.shape.vocab, n).tolist()))
        engine.run()
        engine.sampling = sampling
    return Served(engine)


def window_work(run, srv: Served, t0: float, t1: float) -> dict:
    """Tokens emitted and model FLOPs done between t0 and t1: a prompt's
    prefill where its first token came in the window, then each decoded
    token over its live keys."""
    tokens, flops = 0, 0.0
    for uid, stamps in srv.times.items():
        if uid < 0:
            continue
        P = len(srv.prompts[uid])
        for j, t in enumerate(stamps):
            if not t0 <= t <= t1:
                continue
            tokens += 1
            flops += (arith.prefill_flops(run.shape, P) if j == 0
                      else arith.decode_token_flops(run.shape, P + j))
    return dict(tokens=tokens, model_flops=flops)


class TracedPart:
    """With ``--trace 1``, the profiler started ``trace.LEAD_S`` +
    ``trace_s`` before the window's end, over ``trace_s`` seconds from when
    it is up (past the end if need be), and the live keys of every decode
    step in it.  The counters are then taken over the window before it
    (``counted_s``)."""

    def __init__(self, run, srv: Served):
        self.tracer = (Tracer(run.out_dir, f"{run.name}-{run.seed}",
                              run.device) if run.trace else None)
        self.srv = srv
        self.trace_s = run.traffic["trace_s"]
        self.start = run.seconds - self.trace_s - LEAD_S
        self.counted_s = run.seconds
        self.stats = None
        self.log = None

    @property
    def active(self) -> bool:
        return self.tracer is not None and self.tracer.active

    def begin(self, t0: float) -> None:
        """The window starts at ``t0``.  Every decode step ticks from now
        on, those that a chunked prefill interleaves too: one turn of the
        engine's loop can admit many long prompts, and its driver's own
        ticks would pass the trace's start unseen."""
        if self.tracer is not None:
            self.srv.on_step = lambda: self.tick(time.perf_counter() - t0)

    def tick(self, now: float) -> None:
        t = self.tracer
        if t is None:
            return
        if not t.active and t.result is None and now >= self.start:
            self.counted_s = now
            self.stats = dict(self.srv.engine.stats)
            self.srv.decode_log = []
            t.start()
        elif t.active and t.elapsed() >= self.trace_s:
            self.finish()

    def finish(self) -> None:
        if self.tracer is not None and self.tracer.active:
            self.tracer.stop()
            self.log, self.srv.decode_log = self.srv.decode_log, None


def record(run, srv: Served, t0: float, stats0: dict, stats1: dict,
           part: TracedPart) -> None:
    """The window's tokens a second, the counters over the window (or the
    part of it before the trace) and the traced part's numbers."""
    work = window_work(run, srv, t0, t0 + run.seconds)
    run.e2e["serve_tokens_per_s"] = work["tokens"] / run.seconds
    counted = window_work(run, srv, t0, t0 + part.counted_s)
    run.counters.update(window_s=part.counted_s, **counted,
                        **{k: (part.stats or stats1)[k] - v
                           for k, v in stats0.items()})
    if part.tracer is not None:
        run.traced = part.tracer.result
        run.counters["decode_bytes"] = sum(
            arith.decode_call_bytes(run.shape, live)
            for live in part.log or [])


def check(run, srv: Served) -> None:
    """Free the program, then hold a sample of finished requests, drawn
    from the seed with the longest prompt among them, to the reference."""
    done = {c.uid: c.tokens for c in srv.engine.completions if c.uid >= 0}
    prompts = srv.prompts
    srv.engine.model = None
    srv.engine = None
    run.free()
    k = min(run.traffic["check_requests"], len(done))
    if k == 0:
        run.check("token_gap", float("nan"), run.limits.get("token_gap"))
        return
    uids = sorted(done)
    longest = max(uids, key=lambda u: len(prompts[u]))
    rng = np.random.default_rng([run.seed, 3])
    rest = [u for u in uids if u != longest]
    sample = [longest] + [rest[i] for i in rng.choice(
        len(rest), k - 1, replace=False)] if k > 1 else [longest]
    t_ref = time.perf_counter()
    w = weights.make(run.shape, run.seed, run.device)
    w32 = {n: t.float() for n, t in w.items()}
    del w
    run.sample = [(prompts[u], done[u]) for u in sample]
    widest = max(float(compare.serve_reference(run, w32, p, t).max())
                 for p, t in run.sample)
    tokens = sum(len(t) for _, t in run.sample)
    run.notes.update(checked_requests=len(sample), checked_tokens=tokens,
                     longest_prompt=len(prompts[longest]),
                     reference_s=time.perf_counter() - t_ref)
    run.check("token_gap", widest, run.limits.get("token_gap"))


def drain(srv: Served, deadline: float) -> None:
    """Run the engine until it is idle or the deadline passes."""
    while srv.engine.has_work() and time.perf_counter() < deadline:
        srv.turn()


def failed_of(srv: Served, uids) -> int:
    done = {c.uid for c in srv.engine.completions}
    return sum(u not in done for u in uids)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
