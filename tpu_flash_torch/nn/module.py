"""Parameter helpers, counterpart of ``tpu_flash/nn/module.py``.

The JAX package's modules are configuration objects over an external
parameter tree; the port uses ``torch.nn.Module`` state.  These helpers move
between the two: ``load_jax_params`` copies a JAX tree (as numpy arrays)
into a module, ``to_jax_params`` goes the other way, and ``init_params``
draws fresh values from the JAX init's distributions with an explicit
``torch.Generator``.  An MoE feed-forward's parameters keep the JAX layout
(``router`` [E, X], ``w_in`` [X, E, F], ``w_out`` [X, F, E]), so they load
and export as they are.
"""

from __future__ import annotations

import math
from typing import Any, Iterator

import numpy as np
import torch

from tpu_flash_torch.nn.layers import Embedding, LayerNorm, Linear
from tpu_flash_torch.nn.moe import MoEFeedForward


def num_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def named_tree_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Dot-joined (name, leaf) pairs of a nested dict, sorted by key: the
    JAX package's ``named_parameters``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_tree_leaves(tree[k], f"{prefix}{k}.")
    elif tree is not None:
        yield prefix[:-1], tree


def _state(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Every parameter and buffer by dotted name: a quantized Linear's
    codes and scales are buffers, leaves of the JAX tree like parameters."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _transposed(model: torch.nn.Module) -> set[str]:
    """The float Linear weights, ``[out, in]`` here and ``[in, out]`` in
    JAX; quantized codes keep the JAX layout."""
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, Linear)}


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, tree: Any) -> None:
    """Copy a JAX parameter tree into ``model``.

    Leaves may be JAX or numpy arrays.  Float leaves pass through float32
    (numpy's bf16 from ml_dtypes is not a type ``torch.from_numpy`` takes)
    and are cast to each tensor's dtype; the int8 and uint8 codes of a
    quantized Linear (``{"codes" | "codes4", "scales", "bias"}``, loaded
    into a model already converted by ``quantize_model_linears``) are
    copied as they are.  Float Linear weights are transposed from ``[in,
    out]`` to ``[out, in]``.  Every parameter and buffer must be covered
    once."""
    state = _state(model)
    transposed = _transposed(model)
    seen = set()
    for name, leaf in named_tree_leaves(tree):
        if name not in state:
            raise KeyError(f"JAX parameter {name!r} has no counterpart")
        dst = state[name]
        if dst.is_floating_point():
            t = torch.from_numpy(np.array(leaf, dtype=np.float32))
        else:
            t = torch.from_numpy(np.array(leaf))
            if t.dtype != dst.dtype:
                raise TypeError(f"{name}: JAX dtype {t.dtype} does not "
                                f"match {dst.dtype}")
        if name in transposed:
            t = t.T
        if t.shape != dst.shape:
            raise ValueError(f"{name}: JAX shape {tuple(t.shape)} does not "
                             f"match {tuple(dst.shape)}")
        dst.copy_(t)
        seen.add(name)
    missing = sorted(set(state) - seen)
    if missing:
        raise KeyError(f"parameters missing from the JAX tree: {missing}")


def to_jax_params(model: torch.nn.Module) -> dict:
    """The inverse of ``load_jax_params``: the module's parameters and
    buffers as the JAX package's nested tree of numpy arrays, float32 for
    float tensors (Linear weights transposed back to ``[in, out]``), int8
    and uint8 for quantized codes."""
    transposed = _transposed(model)
    tree: dict = {}
    for name, p in _state(model).items():
        x = p.detach().cpu()
        if x.is_floating_point():
            x = x.float()
        if name in transposed:
            x = x.T
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = x.contiguous().numpy()
    return tree


@torch.no_grad()
def init_params(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fresh values from the JAX init's distributions, drawn in float32 on
    the generator's device in module order, then cast to each parameter.
    A quantized Linear is left as it is (the JAX init makes float trees)."""

    def draw(p, fill):
        x = torch.empty(p.shape, dtype=torch.float32, device=generator.device)
        fill(x)
        p.copy_(x)

    for m in model.modules():
        if isinstance(m, Linear):
            a = 1.0 / math.sqrt(m.in_features)
            for p in (m.weight, m.bias):
                if p is not None:
                    draw(p, lambda x: x.uniform_(-a, a, generator=generator))
        elif isinstance(m, Embedding):
            draw(m.weight, lambda x: x.normal_(generator=generator))
        elif isinstance(m, LayerNorm):
            m.gamma.fill_(1.0)
            m.beta.fill_(0.0)
        elif isinstance(m, MoEFeedForward):
            # router and w_in ~ U(+-1/sqrt(E)), w_out ~ U(+-1/sqrt(F)),
            # biases 0 (the JAX package's moe.py:58-72)
            for p, fan_in in ((m.router, m.n_embd), (m.w_in, m.n_embd),
                              (m.w_out, m.middle_dim)):
                a = 1.0 / math.sqrt(fan_in)
                draw(p, lambda x: x.uniform_(-a, a, generator=generator))
            m.b_in.zero_()
            m.b_out.zero_()
