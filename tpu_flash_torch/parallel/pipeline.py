"""Pipeline parallelism: the decoder's layer stack split over the ranks of a
pipe group with a GPipe fill-drain schedule, counterpart of
``tpu_flash/parallel/pipeline.py``.

Stage s runs layers ``[s n_layer/S, (s+1) n_layer/S)``.  The batch is cut
into ``n_micro`` microbatches: the forward sends each microbatch's
activations stage to stage (``comm.send`` / ``comm.recv``), the backward
drains them in reverse with the gradients going the other way.  Both run
inside one ``autograd.Function`` (``_Pipeline``), which saves each
microbatch's stage graph in the forward and runs it in the backward, so the
order of every send and receive is fixed on every rank.  Embeddings, the
final LayerNorm and ``lm_head`` stay outside the pipeline, replicated over
the pipe group: the last stage's outputs are broadcast to every stage, and
the gradient of the first stage's inputs back to every stage.  The MoE
load-balancing term is summed over the stages and divided by ``n_micro``.

The bubble is GPipe's ``(S - 1) / (n_micro + S - 1)``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpu_flash_torch.parallel import comm

PIPE_AXIS = "pipe"


@dataclasses.dataclass(frozen=True, eq=False)
class PipelineMesh:
    """A ``[data, pipe]`` mesh of ranks, pipe innermost: this rank's stage
    and data replica, and the groups of both axes (None for one rank)."""

    pipe_size: int
    data_size: int
    pipe_rank: int
    data_rank: int
    pipe_group: object
    data_group: object


def make_pipeline_mesh(pipe: int, data: int = 1) -> PipelineMesh:
    """The ``[data, pipe]`` mesh over the world's ranks (every rank calls
    it); pipe stages are contiguous ranks."""
    from tpu_flash_torch.parallel.context import _groups

    world = dist.get_world_size()
    if pipe * data != world:
        raise ValueError(f"mesh {data}x{pipe} != {world} ranks")
    me = dist.get_rank()
    rows = [tuple(d * pipe + s for s in range(pipe)) for d in range(data)]
    pg = _groups(rows)
    dg = _groups([tuple(rows[d][s] for d in range(data))
                  for s in range(pipe)])
    data_rank, pipe_rank = divmod(me, pipe)
    return PipelineMesh(pipe, data, pipe_rank, data_rank, pg, dg)


def stack_layer_params(params: dict, n_layer: int) -> dict:
    """``{"layers.{i}.<name>": t}`` (a model's named parameters) to
    ``{"<name>": [n_layer, ...]}``: one stacked tensor a layer parameter."""
    names = sorted({k.split(".", 2)[2] for k in params
                    if k.startswith("layers.")})
    return {n: torch.stack([params[f"layers.{i}.{n}"]
                            for i in range(n_layer)]) for n in names}


def unstack_layer_params(stacked: dict, n_layer: int) -> dict:
    """The inverse of ``stack_layer_params``."""
    return {f"layers.{i}.{n}": t[i] for n, t in stacked.items()
            for i in range(n_layer)}


def stage_layers(model, mesh: PipelineMesh):
    """This stage's layers of ``model``."""
    S, n = mesh.pipe_size, model.cfg.n_layer
    if n % S:
        raise ValueError(f"n_layer {n} not divisible by stages {S}")
    per = n // S
    return list(model.layers[mesh.pipe_rank * per:(mesh.pipe_rank + 1)
                             * per])


class _Pipeline(torch.autograd.Function):
    """``(micros [n_micro, B_m, L, E], *stage params) -> (outs, aux)``,
    both replicated over the pipe group."""

    @staticmethod
    def forward(ctx, micros, mesh, layers, moe, kw, *params):
        S, s, g = mesh.pipe_size, mesh.pipe_rank, mesh.pipe_group
        n_micro = micros.shape[0]
        inputs, outputs, auxes = [], [], []
        outs = torch.empty_like(micros)
        with torch.enable_grad():
            for m in range(n_micro):
                x = micros[m] if s == 0 else comm.recv(micros[m], g, s - 1)
                x = x.detach().requires_grad_()
                h, aux = x, torch.zeros((), device=x.device)
                for layer in layers:
                    h = layer(h, **kw)
                    if moe:
                        h, layer_aux = h
                        aux = aux + layer_aux
                inputs.append(x)
                outputs.append(h)
                auxes.append(aux)
                if s < S - 1:
                    comm.send(h.detach(), g, s + 1)
                else:
                    outs[m] = h.detach()
        aux_tot = torch.stack([a.detach() for a in auxes]).sum()
        aux_tot = comm.all_reduce(aux_tot, g)
        outs = comm.broadcast(outs, g, S - 1)
        ctx.mesh, ctx.n_micro, ctx.moe = mesh, n_micro, moe
        ctx.graph = (inputs, outputs, auxes, params)
        return outs, aux_tot / n_micro

    @staticmethod
    def backward(ctx, g_outs, g_aux):
        mesh = ctx.mesh
        S, s, g = mesh.pipe_size, mesh.pipe_rank, mesh.pipe_group
        inputs, outputs, auxes, params = ctx.graph
        ctx.graph = None
        grads = [torch.zeros_like(p) for p in params]
        d_micros = torch.zeros((ctx.n_micro, *inputs[0].shape),
                               dtype=inputs[0].dtype,
                               device=inputs[0].device)
        g_aux_m = g_aux / ctx.n_micro
        for m in reversed(range(ctx.n_micro)):
            gy = (g_outs[m] if s == S - 1
                  else comm.recv(outputs[m].detach(), g, s + 1))
            # the stage's vector-Jacobian product as the gradient of a
            # scalar: torch.autograd.grad with grad_outputs imports sympy
            # at its first call (seconds), and down the drain's chain
            # those imports would run one stage after another
            with torch.enable_grad():
                obj = (outputs[m] * gy).sum()
                if ctx.moe and auxes[m].requires_grad:
                    obj = obj + auxes[m] * g_aux_m
                dx, *dps = torch.autograd.grad(
                    obj, [inputs[m], *params], allow_unused=True)
            for i, d in enumerate(dps):
                if d is not None:
                    grads[i] += d
            if s > 0:
                comm.send(dx, g, s - 1)
            else:
                d_micros[m] = dx
        d_micros = comm.broadcast(d_micros, g, 0)
        return (d_micros, None, None, None, None, *grads)


def pipelined_decoder_apply(model, idx, *, mesh: PipelineMesh, n_micro: int,
                            generator=None, training: bool = False,
                            return_aux: bool = False, impl=None):
    """The forward of a ``DecoderLM`` with its layer stack pipelined over
    ``mesh``'s pipe group: ``idx`` [B, L] (this data replica's rows, B a
    multiple of ``n_micro``) to logits [B, L, V] (and the MoE aux with
    ``return_aux``), the same on every stage.  Each rank runs only its
    stage's layers of ``model`` (its other layers are never touched);
    differentiable end to end."""
    c = model.cfg
    B, L = idx.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    layers = stage_layers(model, mesh)
    x = model.token_embeddings(idx)
    if c.positional == "learned":
        positions = torch.arange(L, device=idx.device)[None, :]
        x = x + model.position_embeddings(positions)
    x = model.dropout(x, training=training, generator=generator)
    micros = x.reshape(n_micro, B // n_micro, L, c.n_embd)
    params = [p for layer in layers for p in layer.parameters()]
    kw = dict(training=training, generator=generator, impl=impl)
    outs, aux = _Pipeline.apply(micros, mesh, layers, c.moe is not None, kw,
                                *params)
    x = model.ln(outs.reshape(B, L, c.n_embd), impl=impl)
    logits = model.lm_head(x, impl=impl)
    return (logits, aux) if return_aux else logits
