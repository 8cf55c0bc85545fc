"""The JAX package's parallel modes at N ranks, counterpart of
``__graft_entry__.dryrun_multichip``: each mode runs sharded over a world of
spawned ranks and is pinned to the single-process port on the same
parameters and inputs.

    python -m tpu_flash_torch.parallel.dryrun --ranks 4 [--device cpu]

(the card by default, as ``dryrun()`` and ``run_world()``; ``cpu`` asks
for the CPU, as the tests do).

The eleven modes (``MULTICHIP_r05.json``): DP x TP x EP (MoE 8 experts
top-1, Megatron sequence parallelism, the vocab-parallel loss, packed
segments), the same with attention dropout, ZeRO-1 with mixed precision,
GPipe, all-gather and ring sequence attention, the DCN-hybrid mesh, and
sharded decode through the engine in four modes (plain, chunked, prefix,
``run_many``).  The toy widths are the JAX dryrun's (V512 E128 H8, 2
layers); ``chip_smoke.py`` and the tests call the same rank functions at
their own widths.

``run_world`` spawns the ranks (the ``spawn`` start method, a ``file://``
store in a temporary directory, one torch thread a rank), joins them under
a deadline -- a rank that has not finished by then is terminated and the
run fails -- and fails unless every rank exited 0 with a result.  On one
card every rank binds ``cuda:0`` and the world takes gloo (NCCL refuses two
ranks on one device), staging CUDA tensors through host memory
(``comm.py``); the kernels are built in the parent first
(``build_kernels``, which ``dryrun()`` calls), or each rank would run
every ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from tpu_flash_torch.kernels import common
from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.nn.moe import MoEConfig
from tpu_flash_torch.nn.module import init_params, load_jax_params
from tpu_flash_torch.nn.optim import adam, mixed_precision
from tpu_flash_torch.nn.transformer import DecoderConfig, DecoderLM
from tpu_flash_torch.parallel import comm
from tpu_flash_torch.parallel.context import (initialize_distributed,
                                              make_mesh, parallel_context)
from tpu_flash_torch.parallel.sharding import (gather_named, put_batch,
                                               shard_params)

# The JAX dryrun's model (__graft_entry__.py:25-34).
TOY = dict(n_vocab=512, n_embd=128, n_head=8, n_positions=64, n_layer=2,
           p_dropout=0.0, attention_kind="flash")
TOY_MOE = MoEConfig(n_experts=8, top_k=1)


# ------------------------------------------------------------------ worlds
def _worker(target: str, rank: int, world: int, store: str, device,
            backend, kwargs: dict, out: str) -> None:
    torch.set_num_threads(1)
    result: dict
    try:
        initialize_distributed(f"file://{store}", world, rank,
                               backend=backend, device=device)
        mod, name = target.rsplit(".", 1)
        fn = getattr(importlib.import_module(mod), name)
        result = {"ok": True, "value": fn(rank=rank, device=device,
                                          **kwargs)}
        dist.barrier()
    except Exception:                   # reported to the parent, which fails
        result = {"ok": False, "error": traceback.format_exc()}
    torch.save(result, out)
    if dist.is_initialized() and result["ok"]:
        dist.destroy_process_group()
    sys.stdout.flush()
    os._exit(0 if result["ok"] else 1)


def world_device(device=None) -> str:
    """``device`` as given, or ``"cuda"`` for None (each rank then binds
    its own card, ``context.rank_device``); raises without a card (CPU runs
    ask for ``"cpu"``)."""
    dev = "cuda" if device is None else str(device)
    if torch.device(dev).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return dev


def run_world(target: str, world: int, *, device=None, backend=None,
              timeout: float = 600.0, **kwargs) -> list:
    """``target`` (``"module.function"``) called as ``fn(rank=r,
    device=device, **kwargs)`` on each of ``world`` spawned ranks; returns
    their results in rank order.  ``device`` None is the card
    (``world_device``).  Raises if a rank fails, exits non-zero or is
    still running after ``timeout`` seconds (every rank is then
    terminated)."""
    device = world_device(device)
    mp = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tf_world_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [mp.Process(target=_worker, args=(
            target, r, world, store, device, backend, kwargs, outs[r]))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if late:
            raise TimeoutError(f"{target}: ranks {late} still running after "
                               f"{timeout:.0f} s; terminated")
        results = []
        for r, (p, path) in enumerate(zip(procs, outs)):
            res = (torch.load(path, weights_only=False)
                   if os.path.exists(path) else None)
            if res is None or not res["ok"]:
                err = "no result" if res is None else res["error"]
                raise RuntimeError(f"{target}: rank {r} failed (exit "
                                   f"{p.exitcode}):\n{err}")
            if p.exitcode != 0:
                raise RuntimeError(f"{target}: rank {r} exited "
                                   f"{p.exitcode}")
            results.append(res["value"])
        return results


def build_kernels() -> None:
    """Every CUDA source the parallel modes launch, built once here (one
    ``nvcc`` a source, all at once) before ranks are spawned."""
    from tpu_flash_torch.kernels import flash_attention as fa

    common.build(("flash_decode", fa.KERNEL_FWD, fa.KERNEL_BWD,
                  fa.SOURCE_TWO_PASS, "layernorm_fwd", "layernorm_bwd",
                  "attn_softmax_fwd", "attn_softmax_bwd"))


# --------------------------------------------------------------- helpers
def config(base: dict = TOY, **kw) -> DecoderConfig:
    c = {**base, **kw}
    if isinstance(c.get("moe"), dict):
        c["moe"] = MoEConfig(**c["moe"])
    return DecoderConfig(**c)


def build_model(cfg: DecoderConfig, device, params=None, seed: int = 0):
    """The full model on ``device``: ``params`` (a JAX tree of numpy
    arrays) loaded, else drawn from ``seed`` on the CPU (the same values on
    every rank and device)."""
    model = DecoderLM(cfg, device=device)
    if params is not None:
        load_jax_params(model, params)
    else:
        cpu = DecoderLM(dataclasses.replace(cfg, dtype=torch.float32),
                        device="cpu")
        init_params(cpu, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            for (_, p), (_, q) in zip(model.named_parameters(),
                                      cpu.named_parameters()):
                p.copy_(q)
    return model


def dryrun_batch(B: int, L: int, V: int, seed: int = 0,
                 segments: bool = True) -> dict:
    """The JAX dryrun's packed batch (__graft_entry__.py:98-111): sorted
    segment ids in [0, 3), positions restarting at each segment, random
    labels and loss weights (``segments=False``: the same without segment
    ids and positions, for the fused attention route)."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, 3, (B, L))).astype(np.int32)
    pos = np.zeros((B, L), np.int32)
    for b in range(B):
        for sid in np.unique(seg[b]):
            sl = np.where(seg[b] == sid)[0]
            pos[b, sl] = np.arange(len(sl))
    batch = {
        "input_ids": rng.integers(0, V, (B, L)).astype(np.int32),
        "labels": rng.integers(0, V, (B, L)).astype(np.int32),
        "label_token_weights": rng.random((B, L)).astype(np.float32),
    }
    return {**batch, "segment_ids": seg, "positions": pos} if segments \
        else batch


def make_loss(model, n_chunks: int = 2):
    """The JAX dryrun's objective: the vocab-parallel loss over the hidden
    state, ``mean(losses * weights)`` plus ``aux_weight * aux``.  Without a
    context (the single-process pin) the chunked loss."""
    from tpu_flash_torch.parallel.vocab_loss import \
        vocab_parallel_softmax_loss

    def loss_fn(batch, *, generator=None, training=False):
        out = model(batch["input_ids"].long(),
                    segment_ids=batch.get("segment_ids"),
                    positions=batch.get("positions"),
                    training=training, generator=generator,
                    return_aux=model.cfg.moe is not None, return_hidden=True)
        hidden, aux = out if model.cfg.moe is not None else (out, None)
        lm = model.lm_head
        losses = vocab_parallel_softmax_loss(
            hidden, lm.weight, lm.bias, batch["labels"], n_chunks=n_chunks)
        ce = (losses * batch["label_token_weights"]).mean()
        return ce if aux is None else ce + model.cfg.moe.aux_weight * aux

    return loss_fn


def _peak_mb(device) -> float | None:
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20


def _report(ctx_device, t0: float, group) -> dict:
    if torch.device(ctx_device).type == "cuda":
        torch.cuda.synchronize(ctx_device)
    return {"seconds": time.perf_counter() - t0,
            "peak_mb": _peak_mb(ctx_device),
            "transport": comm.transport(group),
            "launches": {k: v for k, v in common.launch_counts.items() if v}}


def jax_layout(model, named: dict) -> dict:
    """Name -> tensor in the port's layout to the JAX package's nested tree
    of float32 numpy arrays (Linear weights transposed)."""
    from tpu_flash_torch.nn.module import _transposed

    tr = _transposed(model)
    tree: dict = {}
    for name, t in named.items():
        x = t.detach().float().cpu()
        if name in tr:
            x = x.T
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = x.contiguous().numpy()
    return tree


def errors(got: dict, want: dict) -> dict:
    """Per-tensor differences: the worst max-abs error relative to the
    fp32 training limit ``1e-3 max|want| + 1e-5 max|all want|``, the
    largest absolute error, and the largest rms difference over the larger
    of the tensor's rms and 1e-3 of the largest tensor rms (the bf16
    measure; the floor for gradients that are 0 in exact arithmetic)."""
    g_max = max(float(w.float().abs().max()) for w in want.values())
    rms = {n: float(w.float().square().mean().sqrt())
           for n, w in want.items()}
    floor = 1e-3 * max(rms.values())
    worst, max_abs, worst_rms = (0.0, None), 0.0, 0.0
    for n, w in want.items():
        w32, d = w.float(), (got[n].float() - w.float())
        err = float(d.abs().max())
        tol = 1e-3 * float(w32.abs().max()) + 1e-5 * g_max
        if err / tol > worst[0]:
            worst = (err / tol, n)
        max_abs = max(max_abs, err)
        worst_rms = max(worst_rms, float(d.square().mean().sqrt())
                        / max(rms[n], floor, 1e-30))
    return {"worst_over_fp32_tol": worst[0], "worst_param": worst[1],
            "max_abs_err": max_abs, "worst_rms_rel_floored": worst_rms}


# ------------------------------------------------------- rank functions
def rank_train(rank: int, device, *, config_kw: dict, data: int, model: int,
               dcn: int = 1, batch: dict, params=None, seed: int = 0,
               mixed: bool = False, zero1: bool = False, steps: int = 1,
               n_chunks: int = 2, full: bool = False,
               reference: bool = True, logits: bool = True) -> dict:
    """Modes (1), (2), (3) and (6): ``steps`` Adam steps (``mixed``: under
    ``mixed_precision``; ``zero1``: ZeRO-1's step, beside the plain one on
    a copy) of the DP x TP (x EP, x SP) model over the ``[dcn, data,
    model]`` mesh on the global ``batch``, each loss and the first step's
    gradients held on rank 0 against the single-process port (the same
    parameters, the whole batch, no context).  ``full`` also returns the
    gradients, logits and (ZeRO-1) parameters and moments in the JAX
    layout."""
    from tpu_flash_torch.parallel.train import make_sharded_train_step
    from tpu_flash_torch.parallel.zero import (gather_state, init_zero1,
                                               make_zero1_train_step)

    common.launch_counts.clear()
    t0 = time.perf_counter()
    cfg = config(**config_kw)
    ctx = make_mesh(data=data, model=model, dcn_data=dcn, device=device)
    dev = ctx.device
    opt = mixed_precision(adam(lr=1e-3)) if mixed else adam(lr=1e-3)
    m = build_model(cfg, dev, params, seed)
    local = put_batch(ctx, batch)
    res: dict = {"mesh": ctx.mesh, "data_rank": ctx.data_rank,
                 "model_rank": ctx.model_rank}
    if zero1:
        state, _, zspecs = init_zero1(ctx, m, opt)
        step = make_zero1_train_step(ctx, m, opt, make_loss(m, n_chunks))
    else:
        shard_params(ctx, m)
        state = opt.init({n: p.detach() for n, p in m.named_parameters()})
        step = make_sharded_train_step(ctx, m, opt, make_loss(m, n_chunks))
    if logits and not zero1:        # before the step moves the parameters
        with torch.no_grad(), parallel_context(ctx):
            lg = m(local["input_ids"].long(),
                   segment_ids=local.get("segment_ids"),
                   positions=local.get("positions"))
        lg = comm.all_gather(lg.contiguous(), ctx.data_group, 0)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, local, gen)
        losses.append(float(loss))
        if i == 0 and not zero1:
            grads = gather_named(ctx, m, step.grads)
    res["loss"] = losses
    res.update(_report(dev, t0, ctx.model_group or ctx.data_group))
    if zero1:
        # the plain DP x TP step on a copy from the same parameters
        plain = build_model(cfg, dev, params, seed)
        shard_params(ctx, plain)
        pstate = opt.init({n: p.detach() for n, p in
                           plain.named_parameters()})
        pstep = make_sharded_train_step(ctx, plain, opt,
                                        make_loss(plain, n_chunks))
        pgen = torch.Generator(dev).manual_seed(seed + 1)
        plosses = []
        for _ in range(steps):
            pstate, ploss = pstep(pstate, local, pgen)
            plosses.append(float(ploss))
        own = state.inner if mixed else state
        zs = gather_state(ctx, state, zspecs)
        inner = zs.inner if mixed else zs
        pin = pstate.inner if mixed else pstate
        named = dict(m.named_parameters())
        want_p = gather_named(ctx, plain, {n: p.detach() for n, p in
                                          plain.named_parameters()})
        got_p = gather_named(ctx, m, {n: p.detach() for n, p in named.items()})
        full_m = {k: gather_named(ctx, m, getattr(inner, k))
                  for k in ("exp_avg", "exp_avg_sq")}
        got_m = {f"{k}.{n}": t for k, v in full_m.items()
                 for n, t in v.items()}
        want_m = {**{f"exp_avg.{n}": t for n, t in gather_named(
            ctx, plain, pin.exp_avg).items()},
            **{f"exp_avg_sq.{n}": t for n, t in gather_named(
                ctx, plain, pin.exp_avg_sq).items()}}
        res["plain_loss"] = plosses
        res["params_vs_plain"] = max(float((got_p[n] - want_p[n]).abs()
                                           .max()) for n in want_p)
        res["moments_vs_plain"] = max(float((got_m[n] - want_m[n]).abs()
                                            .max()) for n in want_m)
        res["state_bytes"] = sum(
            t.numel() * t.element_size() for t in
            [*own.exp_avg.values(), *own.exp_avg_sq.values()])
        res["plain_state_bytes"] = sum(
            t.numel() * t.element_size() for t in
            [*pin.exp_avg.values(), *pin.exp_avg_sq.values()])
        if full and rank == 0:
            res["params"] = jax_layout(m, got_p)
            res.update({k: jax_layout(m, v) for k, v in full_m.items()})
        return res
    if rank == 0 and reference:
        ref = build_model(cfg, dev, params, seed)
        whole = {k: torch.as_tensor(np.asarray(v)).to(dev)
                 for k, v in batch.items()}
        rgen = torch.Generator(dev).manual_seed(seed + 1)
        ref_loss = make_loss(ref, n_chunks)(whole, generator=rgen,
                                            training=True)
        ref_loss.backward()
        want = {n: p.grad for n, p in ref.named_parameters()}
        res["ref_loss"] = float(ref_loss.detach())
        res["grad_errors"] = errors(grads, want)
        if cfg.dtype != torch.float32:
            # bf16 against the fp32 step on the same (bf16) values: the
            # sharded step's distance from it beside the single-process
            # step's
            r32 = DecoderLM(dataclasses.replace(cfg, dtype=torch.float32),
                            device=dev)
            with torch.no_grad():
                for (_, p), (_, q) in zip(r32.named_parameters(),
                                          ref.named_parameters()):
                    p.copy_(q.float())
            loss32 = make_loss(r32, n_chunks)(
                whole, generator=torch.Generator(dev).manual_seed(seed + 1),
                training=True)
            loss32.backward()
            want32 = {n: p.grad for n, p in r32.named_parameters()}
            res["fp32_loss"] = float(loss32.detach())
            res["grad_errors_vs_fp32"] = errors(grads, want32)
            res["single_grad_errors_vs_fp32"] = errors(want, want32)
        if logits:
            with torch.no_grad():
                rl = ref(whole["input_ids"].long(),
                         segment_ids=whole.get("segment_ids"),
                         positions=whole.get("positions"))
            d = (lg.float() - rl.float())
            res["logits_max_abs_err"] = float(d.abs().max())
            res["logits_rms_rel"] = float(d.square().mean().sqrt()
                                          / rl.float().square().mean()
                                          .sqrt())
    if full and rank == 0:
        res["grads"] = jax_layout(m, grads)
        if logits:
            res["logits"] = lg.float().cpu().numpy()
    return res


def rank_vocab_loss(rank: int, device, *, data: int, model: int,
                    hidden, weight, bias, labels, cot, n_chunks: int = 2,
                    form: str = "vocab_parallel") -> dict:
    """The vocab-parallel loss alone: global ``hidden`` [B, L, E],
    ``weight`` [V, E] and ``bias`` [V] (port layout), ``labels``, and a
    cotangent ``cot`` on the losses; each rank takes its rows and its
    vocab shard.  ``form``: ``"vocab_parallel"``
    (``vocab_parallel_softmax_loss``), ``"axis_name"`` or ``"batch_axis"``
    (``chunked_softmax_loss`` with ``axis_name="model",
    batch_axis="data"``, or ``batch_axis`` alone).  Returns (rank 0) the
    losses and dx gathered over data, dW and db over the model group."""
    from tpu_flash_torch.parallel.vocab_loss import \
        vocab_parallel_softmax_loss

    ctx = make_mesh(data=data, model=model, device=device)
    dev = ctx.device
    rows = {k: comm.local_slice(torch.as_tensor(np.asarray(v)).to(dev),
                                ctx.data_group, 0)
            for k, v in (("h", hidden), ("y", labels), ("g", cot))}
    x = rows["h"].float().requires_grad_()
    w = comm.local_slice(torch.as_tensor(weight).to(dev), ctx.model_group,
                         0).requires_grad_()
    b = comm.local_slice(torch.as_tensor(bias).to(dev), ctx.model_group,
                         0).requires_grad_()
    if form == "vocab_parallel":
        losses = vocab_parallel_softmax_loss(x, w, b, rows["y"],
                                             n_chunks=n_chunks, ctx=ctx)
    else:
        axes = dict(batch_axis="data")
        if form == "axis_name":
            axes["axis_name"] = "model"
        with parallel_context(ctx):
            losses = F.chunked_softmax_loss(x, w, b, rows["y"],
                                            n_chunks=n_chunks, **axes)
    (losses * rows["g"]).sum().backward()
    if form == "vocab_parallel":
        # the function leaves dW and db over this rank's tokens: the sum
        # over data is the caller's, as the sharded step's all-reduce is
        for p in (w, b):
            p.grad = comm.all_reduce(p.grad, ctx.data_group)
    out = {
        "losses": comm.all_gather(losses.detach(), ctx.data_group, 0),
        "dx": comm.all_gather(x.grad, ctx.data_group, 0),
        "dw": comm.all_gather(w.grad, ctx.model_group, 0),
        "db": comm.all_gather(b.grad, ctx.model_group, 0),
    }
    return ({k: v.cpu().numpy() for k, v in out.items()} if rank == 0
            else {})


def rank_pipeline(rank: int, device, *, config_kw: dict, ids, tgt,
                  n_micro: int = 4, params=None, seed: int = 0,
                  full: bool = False) -> dict:
    """Mode (4): GPipe over every rank (one stage each), loss ``mean
    softmax_loss`` and every gradient held on rank 0 against the
    single-process model; ``full`` returns them (JAX layout)."""
    from tpu_flash_torch.parallel.pipeline import (make_pipeline_mesh,
                                                   pipelined_decoder_apply,
                                                   stage_layers)

    common.launch_counts.clear()
    t0 = time.perf_counter()
    cfg = config(**config_kw)
    mesh = make_pipeline_mesh(pipe=dist.get_world_size())
    dev = torch.device(device if torch.device(device).type == "cpu"
                       else f"cuda:{torch.cuda.current_device()}")
    m = build_model(cfg, dev, params, seed)
    ids_t = torch.as_tensor(np.asarray(ids)).long().to(dev)
    tgt_t = torch.as_tensor(np.asarray(tgt)).long().to(dev)
    t1 = time.perf_counter()
    logits = pipelined_decoder_apply(m, ids_t, mesh=mesh, n_micro=n_micro)
    loss = F.softmax_loss(logits, tgt_t).mean()
    res = {"loss": float(loss.detach())}
    t2 = time.perf_counter()
    loss.backward()
    res.update(_report(dev, t0, mesh.pipe_group))
    res.update(setup_s=t1 - t0, forward_s=t2 - t1,
               backward_s=time.perf_counter() - t2)
    # every stage's layer gradients to every rank, in layer order
    mine = {n: p.grad for n, p in m.named_parameters()
            if n.startswith("layers.") and p.grad is not None}
    per = cfg.n_layer // mesh.pipe_size
    ranks_layers = {}
    for n, g in mine.items():
        li = int(n.split(".")[1]) - mesh.pipe_rank * per
        ranks_layers[f"{li}.{n.split('.', 2)[2]}"] = g
    keys = sorted(ranks_layers)
    flat = torch.cat([ranks_layers[k].reshape(-1) for k in keys])
    parts = comm.all_gather(flat[None], mesh.pipe_group, 0)
    grads = {n: p.grad for n, p in m.named_parameters()
             if not n.startswith("layers.")}
    for s in range(mesh.pipe_size):
        off = 0
        for k in keys:
            li, rest = k.split(".", 1)
            shape = ranks_layers[k].shape
            n = ranks_layers[k].numel()
            grads[f"layers.{s * per + int(li)}.{rest}"] = \
                parts[s, off:off + n].view(shape)
            off += n
    res["stage_layers"] = len(stage_layers(m, mesh))
    if rank == 0:
        ref = build_model(cfg, dev, params, seed)
        rloss = F.softmax_loss(ref(ids_t), tgt_t).mean()
        rloss.backward()
        want = {n: p.grad for n, p in ref.named_parameters()}
        res["ref_loss"] = float(rloss.detach())
        res["grad_errors"] = errors(grads, want)
        res["grad_max_dev"] = max(float((grads[n] - want[n]).abs().max())
                                  for n in want)
        if full:
            res["grads"] = jax_layout(m, grads)
    return res


def _oracle_attention(q, k, v, window=None):
    s = (q.double() @ k.double().transpose(-1, -2)) / q.shape[-1] ** 0.5
    L = q.shape[-2]
    i = torch.arange(L, device=q.device)
    keep = i[None, :] <= i[:, None]
    if window is not None:
        keep &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.softmax(s, -1) @ v.double()


def rank_sequence(rank: int, device, *, q, k, v, w, strategy: str,
                  window=None, reference: str = "fp64",
                  full: bool = False, tol=None, seed=None, shape=None,
                  dtype=None) -> dict:
    """Mode (5): the global ``q, k, v`` [B, H, L, d] split along L over
    every rank; ``sum(attention * w)`` summed over the ranks, its backward,
    and (rank 0) out, dq, dk, dv gathered along L against ``reference``:
    ``"fp64"`` the dense float64 oracle, ``"kernel"`` the single-process
    flash kernels' call on the whole inputs.  ``tol`` (output -> (atol,
    arms, rtol)) adds each output's verdict, ``|got - want| <= atol + arms
    rms(want) + rtol |want|``.  With ``seed`` the inputs are drawn on the
    device (``shape``, ``dtype``), the same on every rank, in place of
    ``q, k, v, w``."""
    from tpu_flash_torch.ops.attention import flash_attention
    from tpu_flash_torch.parallel.sequence import sequence_parallel_attention

    common.launch_counts.clear()
    t0 = time.perf_counter()
    g = dist.group.WORLD
    dev = torch.device(device if torch.device(device).type == "cpu"
                       else f"cuda:{torch.cuda.current_device()}")

    def load(a):
        return torch.as_tensor(a).to(dev) if not torch.is_tensor(a) \
            else a.to(dev)

    if seed is not None:
        gen = torch.Generator(dev).manual_seed(seed)
        qf, kf, vf, wf = (torch.randn(shape, generator=gen, device=dev)
                          .to(dtype) for _ in range(4))
    else:
        qf, kf, vf, wf = (load(a) for a in (q, k, v, w))
    ql, kl, vl, wl = (comm.local_slice(t, g, 2).requires_grad_(t is not wf)
                      for t in (qf, kf, vf, wf))
    stats: dict = {}
    out = sequence_parallel_attention(ql, kl, vl, axis_name="world",
                                      strategy=strategy, window=window,
                                      stats=stats)
    local = (out.float() * wl.float()).sum()
    local.backward()
    loss = float(comm.all_reduce(local.detach(), g))
    got = {"out": out.detach(), "dq": ql.grad, "dk": kl.grad,
           "dv": vl.grad}
    got = {n: comm.all_gather(t.contiguous(), g, 2) for n, t in got.items()}
    res = {"loss": loss, **stats}
    res.update(_report(dev, t0, g))
    if rank == 0:
        if reference == "fp64":
            leaves = [t.detach().double().requires_grad_()
                      for t in (qf, kf, vf)]
            o = _oracle_attention(*leaves, window=window)
        else:
            leaves = [t.detach().clone().requires_grad_()
                      for t in (qf, kf, vf)]
            o = flash_attention(*leaves, causal=True, window=window)
        (o.float() * wf.float()).sum().backward()
        want = {"out": o.detach(), "dq": leaves[0].grad,
                "dk": leaves[1].grad, "dv": leaves[2].grad}
        res["ref_loss"] = float((o.detach().double() * wf.double()).sum())
        res["errors"] = {n: {
            "max_abs_err": float((got[n].double() - want[n].double()).abs()
                                 .max()),
            "rms_rel": float((got[n].double() - want[n].double()).square()
                             .mean().sqrt()
                             / want[n].double().square().mean().sqrt()),
            "ref_max": float(want[n].double().abs().max())}
            for n in got}
        if tol is not None:
            for n, e in res["errors"].items():
                atol, arms, rtol = tol[n]
                a, b = got[n].double(), want[n].double()
                rms = float(b.square().mean().sqrt())
                e["ok"] = bool(((a - b).abs() <= atol + arms * rms
                                + rtol * b.abs()).all())
        if full:
            res["got"] = {n: t.float().cpu().numpy() for n, t in got.items()}
    return res


DECODE_PROMPTS = {1: [5, 6, 7], 2: [9, 8, 7, 6], 3: [11, 12, 13, 14, 15],
                  4: [2, 3]}
DECODE_MODES = {
    "plain": dict(kw={}, method="run", prefix=None),
    "chunked": dict(kw=dict(prefill_chunk=2), method="run", prefix=None),
    "prefix": dict(kw=dict(prefill_chunk=2), method="run",
                   prefix=[3, 1, 4, 1, 5]),
    "run_many": dict(kw={}, method="run_many", prefix=None),
}


def run_engine(model, mode: str, *, prompts=None, n_slots: int = 2,
               max_len: int = 32, max_new: int = 6, kv_quant="none",
               modes=None):
    """One of the JAX dryrun's engine drives: completions by uid."""
    from tpu_flash_torch.inference.engine import DecodeEngine, Request
    from tpu_flash_torch.inference.sampler import SamplingConfig

    spec = (modes or DECODE_MODES)[mode]
    engine = DecodeEngine(model, n_slots=n_slots, max_len=max_len,
                          sampling=SamplingConfig(max_new_tokens=max_new),
                          kv_quant=kv_quant, device=model.device,
                          **spec["kw"])
    if spec["prefix"] is not None:
        engine.set_prefix(spec["prefix"])
    for uid, p in (prompts or DECODE_PROMPTS).items():
        engine.submit(Request(uid, list(p)))
    done = (engine.run_many(4) if spec["method"] == "run_many"
            else engine.run())
    return {c.uid: (tuple(c.tokens), c.finished_reason) for c in done}


def rank_decode(rank: int, device, *, config_kw: dict, data: int = 2,
                model: int = 2, params=None, seed: int = 0,
                prompts=None, n_slots: int = 2, max_len: int = 32,
                max_new: int = 6, kv_quants=("none",), modes=None,
                reference: bool = True) -> dict:
    """Mode (7): the engine's drives under a data x model mesh over the
    sharded model, against (rank 0) the single-process engine; returns
    every drive's completions by (mode, kv_quant)."""
    common.launch_counts.clear()
    t0 = time.perf_counter()
    cfg = config(**config_kw)
    ctx = make_mesh(data=data, model=model, device=device)
    m = build_model(cfg, ctx.device, params, seed)
    shard_params(ctx, m)
    kw = dict(prompts=prompts, n_slots=n_slots, max_len=max_len,
              max_new=max_new, modes=modes)
    out, ref = {}, {}
    with torch.no_grad():
        for q in kv_quants:
            for mode in (modes or DECODE_MODES):
                with parallel_context(ctx):
                    out[f"{mode}/{q}"] = run_engine(m, mode, kv_quant=q,
                                                    **kw)
        res = {"completions": out}
        res.update(_report(ctx.device, t0, ctx.model_group))
        if rank == 0 and reference:
            whole = build_model(cfg, ctx.device, params, seed)
            for q in kv_quants:
                for mode in (modes or DECODE_MODES):
                    ref[f"{mode}/{q}"] = run_engine(whole, mode, kv_quant=q,
                                                    **kw)
            res["reference"] = ref
    res["kv_heads_local"] = m.kv_heads_held
    return res


def rank_mt_main(rank: int, device, *, argv: list, params=None) -> dict:
    """The MT app's ``main(argv)`` on this rank (its flags build the mesh);
    the records it returned, without the model and tokenizer.  ``params``
    (a JAX-layout tree) replaces the seed's draw of the initial parameters,
    so that the run can be held against the JAX app's on the same ones."""
    from tpu_flash_torch.apps import machine_translation as app

    common.launch_counts.clear()
    t0 = time.perf_counter()
    drawn = app.init_params
    if params is not None:
        app.init_params = lambda model, gen: load_jax_params(model, params)
    try:
        out = app.main(list(argv), device=device)
    finally:
        app.init_params = drawn
    res = {k: v for k, v in out.items() if k not in ("model", "tokenizer")}
    res.update(_report(device if torch.device(device).type == "cpu"
                       else f"cuda:{torch.cuda.current_device()}", t0,
                       dist.group.WORLD))
    return res


def rank_mt_functions(rank: int, device, *, data: int, model: int,
                      argv: list, n_test: int = 8) -> dict:
    """``ctx=`` on the MT app's ``train_epoch``, ``evaluate_loss`` and
    ``generate_translations``: the app's model of ``argv``'s widths, cut to
    this rank's shards, against the same model whole (the single-process
    calls, on every rank).  Returns both runs' step losses, validation
    losses and hypotheses."""
    from tpu_flash_torch.apps import machine_translation as app
    from tpu_flash_torch.data import mt
    from tpu_flash_torch.parallel.train import init_sharded

    args = app._parser().parse_args(list(argv))
    ctx = make_mesh(data=data, model=model, device=device)
    L = args.model_max_length
    dataset, src, tgt = mt.get_dataset(args.dataset, L)
    tok = mt.get_tokenizer(dataset["train"], args.n_vocab, src, tgt, "",
                           save=False)

    def collate(examples):
        return mt.collate_batch(examples, src, tgt, tok, L)

    cfg = config({}, n_vocab=args.n_vocab, n_embd=args.n_embd,
                 n_head=args.n_head, n_positions=L, n_layer=args.n_layer,
                 p_dropout=0.0, attention_kind=args.attention_kind,
                 use_fused_kernel=args.use_fused_kernel)
    out = {}
    for name in ("single", "sharded"):
        m = build_model(cfg, ctx.device, seed=args.seed)
        opt = adam(lr=args.lr)
        c = ctx if name == "sharded" else None
        if c is None:
            state = opt.init({n: p.detach() for n, p in
                              m.named_parameters()})
        else:
            state, _ = init_sharded(ctx, m, opt)
        _, losses, _, _ = app.train_epoch(
            m, opt, state, dataset["train"], collate, args.batch_size,
            max_iters=args.max_iters_per_epoch, ctx=c, log=None)
        val = app.evaluate_loss(m, dataset["validation"][:64], collate,
                                args.batch_size, ctx=c)
        hyps = app.generate_translations(
            m, dataset["test"][:n_test], src, tgt, tok, L, batch_size=4,
            max_new_tokens=6, ctx=c)
        out[name] = {"losses": losses, "validation_loss": val,
                     "hyps": hyps}
    return out


def rank_nccl_step(rank: int, device, *, config_kw: dict, batch: dict,
                   seed: int = 0) -> dict:
    """A world of one over NCCL: a DP x TP (1 x 1) step whose collectives
    go through ``comm`` on CUDA tensors, against the plain step."""
    res = rank_train(rank, device, config_kw=config_kw, data=1, model=1,
                     batch=batch, seed=seed, logits=False)
    # the step's axes are of one rank (no collective), so comm's NCCL
    # forms are called on the world here: each primitive and the
    # differentiable forms' backward
    g = dist.group.WORLD
    x = torch.arange(8.0, device=f"cuda:{torch.cuda.current_device()}")
    y = x.clone().requires_grad_()
    z = comm.gather_sequence(comm.copy_to_group(y, g), g, 0)
    comm.scatter_sequence(comm.reduce_from_group(z * 2, g), g, 0).sum() \
        .backward()
    res["collectives"] = {
        "all_reduce": comm.all_reduce(x, g).tolist(),
        "all_gather": comm.all_gather(x, g).tolist(),
        "reduce_scatter": comm.reduce_scatter(x, g).tolist(),
        "broadcast": comm.broadcast(x, g, 0).tolist(),
        "grad": y.grad.tolist()}
    res["backend"] = dist.get_backend()
    res["transport_world"] = comm.transport(g)
    return res


def rank_many(rank: int, device, *, calls: list) -> list:
    """Several rank functions in one world, in order: ``calls`` holds
    ``(name, kwargs)`` pairs of this module's ``rank_*`` functions; returns
    their results."""
    out = []
    for name, kw in calls:
        out.append(globals()[name](rank=rank, device=device, **kw))
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
    return out


# -------------------------------------------------------------------- CLI
def _line(msg: str, rec: dict) -> dict:
    print("  " + msg, flush=True)
    return rec


def dryrun(n: int = 4, device=None, timeout: float = 900.0) -> list:
    """The eleven modes at ``n`` ranks on the toy widths, each pinned to
    the single-process port, on the card (``device`` None; the kernels
    built first) or the CPU (``"cpu"``); returns one record a mode and
    raises at the first that fails its limit (fp32: losses within 1e-5
    relative, gradients within the training limit, the pipeline's within
    1e-4, the sequence dq within 1e-3, decode tokens identical)."""
    if n < 4 or n % 2:
        raise ValueError("the dryrun's meshes need an even n >= 4")
    device = world_device(device)
    if torch.device(device).type == "cuda":
        build_kernels()
    recs = []
    print(f"dryrun({n}, {device}):", flush=True)
    tp = 2
    dp = n // tp
    B, L = 2 * dp, 64
    batch = dryrun_batch(B, L, TOY["n_vocab"])
    moe = dict(moe=TOY_MOE, sequence_parallel=True)
    for name, kw, extra in (
            ("dp_tp_ep", moe, {}),
            ("dp_tp_ep_dropout", {**moe, "attn_dropout": 0.1}, {}),
            ("zero1_mp", moe, dict(mixed=True, zero1=True, steps=2)),
            ("dcn", moe, dict(dcn=2))):
        d = dp // 2 if name == "dcn" else dp
        r0 = run_world(f"{__name__}.rank_train", n, device=device,
                       timeout=timeout, config_kw=kw, data=d, model=tp,
                       batch=batch, **extra)[0]
        if name == "zero1_mp":
            ok = (r0["params_vs_plain"] <= 1e-6
                  and r0["moments_vs_plain"] <= 1e-6
                  and abs(r0["loss"][0] - r0["plain_loss"][0]) <= 1e-5)
            recs.append(_line(
                f"zero1+mp dp={dp} tp={tp}: loss={r0['loss'][0]:.4f} == "
                f"plain {r0['plain_loss'][0]:.4f}; after 2 steps params "
                f"{r0['params_vs_plain']:.2e}, moments "
                f"{r0['moments_vs_plain']:.2e} from plain DP x TP "
                f"(state {r0['state_bytes']} of {r0['plain_state_bytes']} "
                f"bytes) [{r0['transport']}]", {"mode": name, **r0}))
        else:
            delta = abs(r0["loss"][0] - r0["ref_loss"])
            ok = (delta <= 1e-5 * abs(r0["ref_loss"])
                  and r0["grad_errors"]["worst_over_fp32_tol"] <= 1.0)
            tag = f"dcn={2}x dp={d}" if name == "dcn" else f"dp={dp}"
            recs.append(_line(
                f"{name}: {tag} tp={tp} ep(moe-8): loss="
                f"{r0['loss'][0]:.4f} == single-process "
                f"{r0['ref_loss']:.4f} (|delta|={delta:.2e}, grads "
                f"{r0['grad_errors']['max_abs_err']:.2e}) mesh "
                f"{r0['mesh']} [{r0['transport']}]", {"mode": name, **r0}))
        if not ok:
            raise AssertionError(f"{name} deviates from single-process: "
                                 f"{recs[-1]}")
    pp = run_world(f"{__name__}.rank_pipeline", n, device=device,
                   timeout=timeout, config_kw={"n_layer": n},
                   ids=np.random.default_rng(0).integers(0, 512, (4, 32)),
                   tgt=np.random.default_rng(1).integers(0, 512, (4, 32)))
    r0 = pp[0]
    recs.append(_line(
        f"pp={n} (GPipe, 4 microbatches): loss={r0['loss']:.4f} == "
        f"single-process {r0['ref_loss']:.4f} (grad max-dev "
        f"{r0['grad_max_dev']:.2e}) [{r0['transport']}]",
        {"mode": "pp", **r0}))
    if (abs(r0["loss"] - r0["ref_loss"]) > 1e-5 * abs(r0["ref_loss"])
            or r0["grad_max_dev"] > 1e-4):
        raise AssertionError(f"pp deviates: {recs[-1]}")
    rng = np.random.default_rng(0)
    qkvw = [rng.standard_normal((2, 4, 32 * n, 32)).astype(np.float32)
            for _ in range(4)]
    for strategy in ("allgather", "ring"):
        r0 = run_world(f"{__name__}.rank_sequence", n, device=device,
                       timeout=timeout, q=qkvw[0], k=qkvw[1], v=qkvw[2],
                       w=qkvw[3], strategy=strategy)[0]
        rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        dq = r0["errors"]["dq"]["max_abs_err"]
        recs.append(_line(
            f"sp[{strategy}] x{n}: loss={r0['loss']:.4f} == fp64 "
            f"{r0['ref_loss']:.4f} (rel {rel:.2e}, dq max-dev {dq:.2e}) "
            f"[{r0['transport']}]", {"mode": f"sp_{strategy}", **r0}))
        if rel > 1e-4 or dq > 1e-3:
            raise AssertionError(f"sp {strategy} deviates: {recs[-1]}")
    dec = run_world(f"{__name__}.rank_decode", n, device=device,
                    timeout=timeout, config_kw={}, data=dp, model=tp)[0]
    for key, comp in dec["completions"].items():
        same = comp == dec["reference"][key]
        n_tok = sum(len(t) for t, _ in comp.values())
        recs.append(_line(
            f"decode[engine/{key}] dp={dp} tp={tp}: {len(comp)} "
            f"completions, {n_tok} tokens "
            f"{'==' if same else '!='} single-process "
            f"[{dec['transport']}]", {"mode": f"decode_{key}",
                                      "same": same}))
        if not same:
            raise AssertionError(f"decode {key}: {comp} != "
                                 f"{dec['reference'][key]}")
    print(f"dryrun({n}, {device}): all parallel modes OK", flush=True)
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_flash_torch.parallel.dryrun")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)
    recs = dryrun(args.ranks, args.device, args.timeout)
    print(json.dumps({"modes": len(recs), "ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
