"""Offline serving: the engine's queue is kept at least ``queue_depth``
requests deep for the whole window, so that throughput is what is judged.
Set-up fills the slots one admission a turn, so that their requests stand
at staggered points and finish one or two a step, as in a server that has
been busy for a while (from empty slots the engine admits every slot in
one burst, and every request then finishes in the same step).

Traffic keys: ``queue_depth``, ``pool`` (prompts drawn from the seed and
cycled), ``prompt``, ``max_new_tokens``, ``slots``, ``max_len``,
``prefill_chunk`` (the chunked prefill's piece),
``warmup_prompts``, ``check_requests``, ``trace_s`` (the window's last
seconds, which ``--trace 1`` profiles).

The tokens a second are those emitted inside the window over the window.
At the close the queue's unstarted requests are dropped and the started
ones run to their end (up to a minute): a started request that does not
finish is failed."""

from __future__ import annotations

import time

from port_bench.drivers import _serve


def run(run) -> None:
    tr = run.traffic
    srv = _serve.build(run)
    pool = _serve.make_prompts(run, tr["pool"])
    part = _serve.TracedPart(run, srv)
    eng = srv.engine
    uid = 0

    def top_up():
        nonlocal uid
        while len(eng.queue) < tr["queue_depth"]:
            srv.submit(uid, pool[uid % len(pool)])
            uid += 1

    with run.phase("fill"):
        # one admission a turn, so that the slots' requests stand at
        # staggered points, as in a server that has been busy for a while
        for _ in range(tr["slots"]):
            srv.submit(uid, pool[uid % len(pool)])
            uid += 1
            srv.turn()
    top_up()
    t0 = run.start_window()
    part.begin(t0)
    stats0 = dict(eng.stats)
    while (now := time.perf_counter() - t0) < run.seconds or part.active:
        part.tick(now)
        top_up()
        srv.turn()
    part.finish()
    stats1 = dict(eng.stats)
    started = [u for u in range(uid) if u in srv.times]
    eng.queue.clear()            # never started: not attempted
    _serve.drain(srv, time.perf_counter() + _serve.DRAIN_S)
    run.close_window()

    _serve.record(run, srv, t0, stats0, stats1, part)
    run.attempted = len(started)
    run.failed = _serve.failed_of(srv, started)
    _serve.check(run, srv)
