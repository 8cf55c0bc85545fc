"""Training cells: ``apps.machine_translation.make_train_step`` over the
model with ``nn.optim.mixed_precision(adam)``, one object built once and
driven from the seed through its first three steps (set-up, and the
readings the reference is held to), then timed over the window.

Traffic keys: ``batch``, ``seq_len``, ``n_batches`` (distinct batches of
random ids from the seed, made on the card and cycled), ``lr``, ``beta1``,
``beta2``, ``eps``, ``trace_s`` (with ``--trace 1`` the profiler starts
``trace.LEAD_S`` + ``trace_s`` before the window's end and profiles
``trace_s`` seconds of steps from when it is up, past the end if need be;
the counters are taken over the steps before it)."""

from __future__ import annotations

import time

import torch

from port_bench import arith, compare, program, weights
from port_bench.harness import span
from port_bench.trace import LEAD_S, Tracer

SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
CHECK_STEPS = 3


def make_data(run) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``n_batches`` (ids, labels) pairs [B, L] of random ids from the
    seed, made on the device: the same seed gives the same rows."""
    tr, V = run.traffic, run.shape.vocab
    g = weights.generator(run.seed * 1_000_003 + 7, run.device)
    t = torch.randint(0, V, (tr["n_batches"], tr["batch"], tr["seq_len"] + 1),
                      generator=g, device=run.device)
    return [(t[i, :, :-1], t[i, :, 1:]) for i in range(tr["n_batches"])]


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {n: float(torch.linalg.vector_norm(t.float())) * scale
            for n, t in tree.items()}


def run(run) -> None:
    tr, shape, dev = run.traffic, run.shape, run.device
    with run.phase("import"):
        from tpu_flash_torch.apps.machine_translation import make_train_step
        from tpu_flash_torch.kernels import common
        from tpu_flash_torch.nn.optim import adam, mixed_precision
    with run.phase("build"):
        if dev.type == "cuda":
            common.build(SOURCES)
    with run.phase("weights"):
        model = program.build_model(
            shape, run.config, weights.make(shape, run.seed, dev), dev)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = mixed_precision(adam(lr=tr["lr"], beta1=tr["beta1"],
                                   beta2=tr["beta2"], eps=tr["eps"]))
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(model, opt)
        feed = [dict(input_ids=ids, labels=lab,
                     label_token_weights=torch.ones(ids.shape, device=dev))
                for ids, lab in make_data(run)]
    with run.phase("warmup"):
        # the first steps are the set-up's warm-up and the readings that
        # the reference is held to
        losses = []
        for i in range(CHECK_STEPS):
            with span("pb.train_step"):
                state, loss = step(state, feed[i])
            losses.append(loss)
            if i == 0:
                first = {n: m / (1.0 - tr["beta1"])
                         for n, m in state.inner.exp_avg.items()}
                grads = _norms(first)
                first = {n: g.to("cpu") for n, g in first.items()}
        prog = dict(losses=[float(x) for x in losses], grad_norms=grads,
                    change_norms={n: float(torch.linalg.vector_norm(
                        state.master[n] - start[n].float()))
                        for n in start})
        del start, losses

    tracer = (Tracer(run.out_dir, f"{run.name}-{run.seed}", dev)
              if run.trace else None)
    window_losses = []
    t0 = run.start_window()
    n, cut, n_cut, traced = 0, None, None, 0
    while (now := time.perf_counter() - t0) < run.seconds or \
            (tracer is not None and tracer.active):
        if tracer is not None and cut is None and \
                now >= run.seconds - tr["trace_s"] - LEAD_S:
            run.sync()
            cut, n_cut = time.perf_counter() - t0, n
            tracer.start()
        elif tracer is not None and tracer.active and \
                tracer.elapsed() >= tr["trace_s"]:
            tracer.stop()
        traced += tracer is not None and tracer.active
        with span("pb.train_step"):
            state, loss = step(state, feed[(CHECK_STEPS + n) % len(feed)])
        window_losses.append(loss)
        n += 1
    run.sync()
    elapsed = time.perf_counter() - t0
    if tracer is not None and tracer.active:
        tracer.stop()
    run.close_window()

    tokens = n * tr["batch"] * tr["seq_len"]
    run.e2e["train_tokens_per_s"] = tokens / elapsed
    run.attempted = n
    run.failed = int(sum(not torch.isfinite(x).item() for x in window_losses))
    counted, steps = (elapsed, n) if cut is None else (cut, n_cut)
    run.counters.update(
        window_s=counted, steps=steps, traced_steps=traced,
        model_flops=steps * arith.train_step_flops(shape, tr["batch"],
                                                   tr["seq_len"]))
    if tracer is not None:
        run.traced = tracer.result

    del model, state, step, feed, loss, window_losses, opt
    run.free()
    t_ref = time.perf_counter()
    ref = compare.train_reference(run, make_data(run)[:CHECK_STEPS],
                                  judge=first)
    got = compare.train_numbers(prog, ref, ref["grad_dists"])
    run.notes = dict(losses=prog["losses"], ref_losses=ref["losses"],
                     loss_gap=got["loss_gap"], grad_leaf=got["grad_leaf"],
                     change_leaf=got["change_leaf"],
                     dist_leaf=got["dist_leaf"],
                     left_out=len(got["left_out"]),
                     reference_s=time.perf_counter() - t_ref)
    for key in ("grad_gap", "change_gap", "grad_dist"):
        run.check(key, got[key], run.limits.get(key))
