"""Weights made from the seed, on the device, in the type they are served
in.  One ``torch.randn`` call fills a flat buffer for every parameter; each
leaf is a view of it, scaled in place by its kind's rule.  The same seed on
the same device gives the same bits, so the reference regenerates the very
weights the program ran from, after the program is gone."""

from __future__ import annotations

import math

import torch

from port_bench.spec import Shape


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def make(shape: Shape, seed: int, device, dtype=torch.bfloat16
         ) -> dict[str, torch.Tensor]:
    """name -> tensor, views of one buffer.  Matrices and embeddings
    N(0, std); the two residual projections std / sqrt(2 n_layer);
    biases and LayerNorm betas N(0, std); gammas 1 + N(0, std)."""
    leaves = shape.leaves()
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device, dtype=dtype)
    std = shape.init_std
    scale = {"w": std, "wr": std / math.sqrt(2 * shape.n_layer), "b": std,
             "g": std}
    out, at = {}, 0
    for name, s, kind in leaves:
        n = math.prod(s)
        view = flat[at:at + n].view(s)
        view.mul_(scale[kind])
        if kind == "g":
            view.add_(1.0)
        out[name] = view
        at += n
    return out
