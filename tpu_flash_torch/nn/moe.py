"""Mixture-of-Experts feed-forward, counterpart of ``tpu_flash/nn/moe.py``:
``MoEConfig`` and ``MoEFeedForward``.

Routing is the JAX package's dense dispatch (GShard / Switch): top-k rounds
over the router's fp32 softmax, each token placed in its expert's buffer of
``capacity`` slots in token order on top of the fill the earlier rounds
left, a token past the capacity dropped (it passes through the residual
unchanged), and one-hot ``dispatch`` and gated ``combine`` tensors ``[T, X,
C]`` taken through einsums, so that every expert's work is one batched
product.  The router's Switch load-balancing term comes back beside the
output.

Under a parallel context the experts are split over the model ranks
(``expert_param_specs``): routing runs whole on every rank, each rank
computes its experts' part of the dense dispatch, and the parts are summed
over the model group -- the result of the JAX package's all-to-all.  On an
uncached forward whose rows are split over the data group, the buffer
positions, the capacity and the load-balancing term count the tokens of
every data rank, as the JAX package's global arrays do.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_flash_torch.nn import functional as F


@dataclasses.dataclass
class MoEConfig:
    n_experts: int = 8
    top_k: int = 1
    capacity_factor: float = 1.25
    aux_weight: float = 0.01     # multiplier applied by the training loss
    router_noise: float = 0.0    # jitter std on router logits (train only)


def expert_param_specs(expert_axis: str = "model") -> dict[str, tuple]:
    """Specs of the MoE parameters: experts over ``expert_axis``, the
    router replicated (JAX ``moe.py:155-167``)."""
    return {"router": (None, None), "w_in": (expert_axis, None, None),
            "b_in": (expert_axis, None), "w_out": (expert_axis, None, None),
            "b_out": (expert_axis, None)}


class MoEFeedForward(torch.nn.Module):
    """Routed GELU MLP: router -> top-k experts -> capacity-bounded dispatch.

    Parameters in the JAX tree's names and layouts, so that
    ``load_jax_params`` copies them as they are: ``router`` [E, X], ``w_in``
    [X, E, F], ``b_in`` [X, F], ``w_out`` [X, F, E], ``b_out`` [X, E].
    ``forward`` returns ``(y, aux)``: ``aux`` is the fp32 Switch term
    (about 1 when the load is balanced)."""

    def __init__(self, n_embd: int, middle_dim: int, moe: MoEConfig,
                 dtype=torch.float32, p_dropout: float = 0.0, device=None):
        super().__init__()
        self.n_embd = n_embd
        self.middle_dim = middle_dim
        self.moe = moe
        self.p_dropout = float(p_dropout)
        E, Fm, X = n_embd, middle_dim, moe.n_experts

        def param(*shape):
            return torch.nn.Parameter(
                torch.zeros(shape, dtype=dtype, device=device))

        self.router = param(E, X)
        self.w_in = param(X, E, Fm)
        self.b_in = param(X, Fm)
        self.w_out = param(X, Fm, E)
        self.b_out = param(X, E)

    def capacity(self, T: int) -> int:
        """Buffer slots an expert: ``ceil(k T / X * capacity_factor)``, at
        least 1, over all ``T`` tokens of the call (pad and idle rows
        included, as in the JAX package)."""
        m = self.moe
        return max(1, int(math.ceil(m.top_k * T / m.n_experts
                                    * m.capacity_factor)))

    def router_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """fp32 router logits [T, X] of ``tokens`` [T, E]."""
        return tokens.float() @ self.router.float()

    def _route(self, logits: torch.Tensor, *, capacity: int,
               data_group=None):
        """Top-k dispatch and combine tensors from router logits [T, X]:
        ``(dispatch [T, X, C] one-hot, combine [T, X, C] gated, aux)``, fp32,
        JAX's rounds step for step (a max and its first-index argmax a
        round, the buffer position by a cumulative sum over the tokens plus
        the fill carried from the earlier rounds).  With ``data_group`` the
        tokens are this rank's block of the global token order: the data
        ranks before it add their counts to each position, and the fill and
        the means take every rank's tokens."""
        if data_group is not None:
            return self._route_over(logits, capacity, data_group)
        T, X = logits.shape
        k = self.moe.top_k
        probs = torch.softmax(logits.float(), dim=-1)
        dispatch = combine = torch.zeros((), device=logits.device)
        remaining = probs
        fill = torch.zeros(X, device=logits.device)
        frac_routed = torch.zeros(X, device=logits.device)
        for _ in range(k):
            # amax shares a tie's gradient evenly, as jnp.max's does
            gate = remaining.amax(dim=-1)                         # [T]
            expert = remaining.argmax(dim=-1)                     # [T]
            onehot = F.one_hot(expert, X)                         # [T, X]
            # each token's position in its expert's buffer this round
            pos = (torch.cumsum(onehot, dim=0) - 1.0) + fill[None, :]
            pos_t = (pos * onehot).sum(dim=-1)                    # [T]
            keep = (pos_t < capacity).float()
            slot = F.one_hot(pos_t.long(), capacity)              # [T, C]
            d = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
            dispatch = dispatch + d
            combine = combine + d * gate[:, None, None]
            fill = fill + (onehot * keep[:, None]).sum(dim=0)
            frac_routed = frac_routed + onehot.mean(dim=0)
            remaining = remaining * (1.0 - onehot)
        aux = self.moe.n_experts * torch.sum(
            (frac_routed / k) * probs.mean(dim=0))
        return dispatch, combine, aux

    def _route_over(self, logits, capacity: int, group):
        from tpu_flash_torch.parallel import comm

        T, X = logits.shape
        k = self.moe.top_k
        n, me = comm.group_size(group), comm.group_rank(group)
        T_all = T * n
        probs = torch.softmax(logits.float(), dim=-1)
        dispatch = combine = torch.zeros((), device=logits.device)
        remaining = probs
        fill = torch.zeros(X, device=logits.device)
        routed = torch.zeros(X, device=logits.device)
        for _ in range(k):
            gate = remaining.amax(dim=-1)
            expert = remaining.argmax(dim=-1)
            onehot = F.one_hot(expert, X)
            counts = comm.all_gather(onehot.sum(dim=0)[None], group, 0)
            before = counts[:me].sum(dim=0)
            pos = (torch.cumsum(onehot, dim=0) - 1.0) + (fill + before)[None]
            pos_t = (pos * onehot).sum(dim=-1)
            keep = (pos_t < capacity).float()
            slot = F.one_hot(pos_t.long(), capacity)
            d = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
            dispatch = dispatch + d
            combine = combine + d * gate[:, None, None]
            fill = fill + comm.all_reduce(
                (onehot * keep[:, None]).sum(dim=0), group)
            routed = routed + counts.sum(dim=0)
            remaining = remaining * (1.0 - onehot)
        mean_probs = comm.all_reduce_sum(probs.sum(dim=0), group) / T_all
        aux = self.moe.n_experts * torch.sum(
            (routed / T_all / k) * mean_probs)
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor, *, training: bool = False,
                generator: torch.Generator | None = None, shard=None):
        """``x`` [B, L, E] -> ``(y [B, L, E], aux)``.  ``training`` with a
        ``generator`` draws the router's noise (``router_noise > 0``), then
        the dropout after the GELU, from it in that order.  The gates are
        cast to ``x.dtype`` before their products, as in the JAX package
        (in bf16 they are rounded).

        ``shard`` (``transformer._Shard``): under tensor parallelism this
        rank holds experts ``[r X/tp, (r+1) X/tp)``; the router sees the
        whole input on every rank, the experts their copy of it, and the
        parts of ``y`` are summed over the model group (reduce-scattered
        along L under sequence parallelism, where ``x`` is this rank's L
        slice)."""
        from tpu_flash_torch.nn.transformer import (_NO_SHARD, _enter,
                                                    _replicated)

        s = _NO_SHARD if shard is None else shard
        xr, xe = _replicated(x, s), _enter(x, s)
        B, L, E = xr.shape
        T = B * L
        tokens = xe.reshape(T, E)
        logits = self.router_logits(xr.reshape(T, E))
        if (training and self.moe.router_noise > 0.0
                and generator is not None):
            logits = logits + self.moe.router_noise * torch.randn(
                logits.shape, generator=generator, device=logits.device)
        n_data = 1
        if s.data_group is not None:
            from tpu_flash_torch.parallel import comm

            n_data = comm.group_size(s.data_group)
        dispatch, combine, aux = self._route(
            logits, capacity=self.capacity(T * n_data),
            data_group=s.data_group)
        if s.group is not None:     # this rank's experts
            from tpu_flash_torch.parallel import comm

            X_l = self.w_in.shape[0]
            x0 = comm.group_rank(s.group) * X_l
            combine = comm.copy_to_group(combine, s.group)[:, x0:x0 + X_l]
            dispatch = dispatch[:, x0:x0 + X_l]
        # [X, C, E] expert input buffers, one batched product each way
        expert_in = torch.einsum("txc,te->xce", dispatch.to(x.dtype), tokens)
        h = torch.einsum("xce,xef->xcf", expert_in, self.w_in)
        h = F.gelu(h + self.b_in[:, None, :])
        h = F.dropout(h, self.p_dropout, generator=generator,
                      training=training)
        expert_out = torch.einsum("xcf,xfe->xce", h, self.w_out)
        expert_out = expert_out + self.b_out[:, None, :]
        y = torch.einsum("txc,xce->te", combine.to(x.dtype), expert_out)
        y = y.reshape(B, L, E)
        if s.group is not None:
            y = (comm.scatter_sequence(y, s.group, 1) if s.sp
                 else comm.reduce_from_group(y, s.group))
        return y, aux
