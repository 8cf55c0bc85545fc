"""Pre-LN decoder-only transformer, counterpart of
``tpu_flash/nn/transformer.py``: ``DecoderConfig``, ``MultiHeadAttention``,
``FeedForward``, ``TransformerLayer``, ``DecoderLM``.

Ported so far: the cached forward (prefill and decode over a KV cache) and
the uncached forward, with training (dropout from an explicit
``torch.Generator``, attention dropout (``attn_dropout``) on every
attention route, gradients through every parameter, ``remat`` per layer,
``return_hidden`` for the chunked-vocab loss), rotary positions
(``positional="rope"``: q and k rotated before the cache takes k, so the
cache holds rotated keys), the routed feed-forward (``moe``, with
``return_aux``) and the one-hot embedding (``embedding_one_hot``).
Decode steps with at most 8 new tokens go through the flash-decode
kernel; longer prefills
attend over the cache with the composed graph, as in the JAX package.  The
uncached forward attends with the flash-attention kernels
(``attention_kind="flash"``, and ``"auto"`` from ``_FLASH_AUTO_MIN_L``), the
fused masked-softmax kernels (``"fused"``) or the composed ("naive") graph;
the flash and composed routes take ``cfg.window`` (sliding-window attention)
and ``segment_ids`` (packed sequences); ``kv_quant`` (quantized-K/V
training) runs the flash kernels' quantized forms, and below
``_FLASH_AUTO_MIN_L`` on ``"auto"`` the composed graph on straight-through
dequantized K/V, as in the JAX package; ``use_fused_kernel=True`` puts every LayerNorm, the cached forward's too, on
the fused LayerNorm kernels.  What is not ported raises
``NotImplementedError`` and names the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Literal

import torch
from torch.utils.checkpoint import checkpoint

from tpu_flash_torch.kernels.common import resolve_device
from tpu_flash_torch.kernels.decode import flash_decode_attention
from tpu_flash_torch.nn import functional as F
from tpu_flash_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from tpu_flash_torch.nn.moe import MoEConfig, MoEFeedForward
from tpu_flash_torch.ops.attention import (dequantize_kv, flash_attention,
                                           quantize_kv)
from tpu_flash_torch.ops.fused import attn_softmax
from tpu_flash_torch.ops.reference import (apply_segment_mask, causal_mask,
                                           dropout_keep_oracle, window_mask)

AttentionKind = Literal["flash", "fused", "naive", "auto"]

# "auto" takes the flash kernel from this length on (the JAX package's
# crossover, timed on a TPU; not measured on the GPU).
_FLASH_AUTO_MIN_L = 1024

# Cached steps with at most this many new tokens take the decode kernel.
DECODE_MAX_LQ = 8


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue A item {item})")


@dataclasses.dataclass
class DecoderConfig:
    """The JAX package's ``DecoderConfig``; ``dtype`` is a torch dtype."""

    n_vocab: int = 10_000
    n_embd: int = 256
    n_head: int = 8
    n_kv_head: int | None = None                  # GQA/MQA (None = MHA)
    positional: Literal["learned", "rope", "none"] = "learned"
    n_positions: int = 1024
    n_layer: int = 4
    ff_middle_dim: int = 256
    p_dropout: float = 0.1
    ln_eps: float = 1e-5
    bias: bool = True
    causal: bool = True
    attention_kind: AttentionKind = "flash"
    attn_dropout: float = 0.0
    window: int | None = None
    kv_quant: Literal["none", "int8", "fp8",
                      "int8_channel", "fp8_channel"] = "none"
    use_fused_kernel: bool = False
    dtype: Any = torch.float32
    remat: bool = False
    embedding_one_hot: bool = False
    moe: MoEConfig | None = None
    sequence_parallel: bool = False

    def __post_init__(self):
        if self.n_embd % self.n_head:
            raise ValueError(
                f"n_embd ({self.n_embd}) must divide by n_head "
                f"({self.n_head})")
        if self.n_kv_head is not None and self.n_head % self.n_kv_head:
            raise ValueError(
                f"n_head ({self.n_head}) must be a multiple of n_kv_head "
                f"({self.n_kv_head})")
        if self.window is not None:
            if not self.causal:
                raise ValueError("window requires causal=True")
            if self.window < 1:
                raise ValueError(
                    f"window must be >= 1 (got {self.window}); use "
                    f"window=None to disable sliding-window attention")
        if self.attention_kind not in ("flash", "fused", "naive", "auto"):
            raise ValueError(f"unknown attention_kind "
                             f"{self.attention_kind!r}")
        if self.kv_quant not in ("none", "int8", "fp8",
                                 "int8_channel", "fp8_channel"):
            raise ValueError(
                f"kv_quant must be 'none', 'int8', 'fp8', 'int8_channel' "
                f"or 'fp8_channel', got {self.kv_quant!r}")
        if self.kv_quant != "none" and self.attention_kind in (
                "fused", "naive"):
            raise ValueError(
                "kv_quant requires the flash attention path (got "
                f"attention_kind={self.attention_kind!r}); the dense graphs "
                "have no quantized-KV form")
        if self.sequence_parallel:
            raise _not_ported("sequence_parallel", "A8")

    @property
    def attn_hidden_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head


def _straight_through(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` with the value of its quantized-and-dequantized self and the
    gradient of the identity (JAX's ``x + stop_gradient(dq - x)``)."""
    dq = dequantize_kv(*quantize_kv(x, mode), mode).to(x.dtype)
    return x + (dq - x).detach()


def attention_seed(generator: torch.Generator) -> torch.Tensor:
    """One attention-dropout seed, int32 ``[1]`` in ``[0, 2**31 - 1)``,
    drawn from ``generator`` on its device (the JAX package's
    ``randint(key, (), 0, int32 max)``): it stays there, and the host
    never reads it."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


class MultiHeadAttention(torch.nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = c = cfg
        kv_dim = c.kv_heads * c.attn_hidden_dim
        kw = dict(bias=c.bias, dtype=c.dtype, device=device)
        self.q_projection = Linear(c.n_embd, c.n_embd, **kw)
        self.k_projection = Linear(c.n_embd, kv_dim, **kw)
        self.v_projection = Linear(c.n_embd, kv_dim, **kw)
        self.out_projection = Linear(c.n_embd, c.n_embd, **kw)

    def project_to_query_key_value(self, x, impl=None):
        """x [B, L, E] -> q [B, H, L, d], k and v [B, Hkv, L, d].
        ``impl`` reaches quantized projections' matmul kernels."""
        B, L, _ = x.shape
        d = self.cfg.attn_hidden_dim

        def split(y):
            return y.reshape(B, L, -1, d).transpose(1, 2)

        return (split(self.q_projection(x, impl=impl)),
                split(self.k_projection(x, impl=impl)),
                split(self.v_projection(x, impl=impl)))

    def self_attention(self, q, k, v, *, kv_mask=None, segment_ids=None,
                       impl=None, training: bool = False, generator=None):
        """Uncached attention: the flash-attention kernels (``"flash"``, and
        ``"auto"`` from ``_FLASH_AUTO_MIN_L``), the fused masked-softmax
        kernels over the materialized scores (``"fused"``) or the composed
        graph.  As in the JAX package, the flash path takes no ``kv_mask``
        and the fused one refuses ``window`` and ``segment_ids``, which its
        ``[B, Lk]`` mask cannot express; the flash and composed paths take
        both.  ``impl`` reaches the kernels' wrappers.

        ``training`` with ``cfg.attn_dropout > 0`` and a ``generator``
        draws one int32 seed from it on its device (``attention_seed``)
        and drops attention probabilities by the kernels' hash of it: the
        flash kernels in-kernel, the fused and composed routes by
        multiplying P by ``dropout_keep_oracle``, the same bits (the JAX
        package's transformer.py:204-249)."""
        c = self.cfg
        seed = (attention_seed(generator)
                if training and c.attn_dropout > 0.0 and generator is not None
                else None)
        kind = c.attention_kind
        if kind == "auto":
            if c.kv_quant != "none" and q.shape[-2] < _FLASH_AUTO_MIN_L:
                # below the crossover, quantized-K/V training runs the
                # composed graph on straight-through dequantized K/V, the
                # same codes and scales as the kernels' (the JAX package's
                # transformer.py:174-192)
                k, v = (_straight_through(x, c.kv_quant) for x in (k, v))
                kind = "naive"
            else:
                kind = ("flash" if c.kv_quant != "none"
                        or q.shape[-2] >= _FLASH_AUTO_MIN_L else "naive")
        if kind == "fused":
            if c.window is not None:
                raise NotImplementedError(
                    "window is not expressible in the fused attn_softmax "
                    "kernel's [B, Lk] mask; use flash or naive")
            if segment_ids is not None:
                raise NotImplementedError(
                    "segment_ids is not expressible in the fused "
                    "attn_softmax kernel's [B, Lk] mask; use flash or naive")
        if kind == "flash":
            return flash_attention(
                q, k, v, causal=c.causal, window=c.window,
                segment_ids=segment_ids, kv_quant=c.kv_quant,
                dropout_rate=0.0 if seed is None else c.attn_dropout,
                dropout_seed=0 if seed is None else seed, impl=impl)
        if k.shape[1] != q.shape[1]:     # GQA: repeat each KV head
            g = q.shape[1] // k.shape[1]
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        # the scale multiplies the product, as in the JAX package (not
        # folded into q)
        s = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(c.attn_hidden_dim))
        if kind == "fused":
            p = attn_softmax(s, kv_mask, mask_future=c.causal, impl=impl)
        else:
            if c.causal:
                s = s + causal_mask(q.shape[-2], k.shape[-2], s.dtype,
                                    s.device)
                if c.window is not None:
                    s = s + window_mask(q.shape[-2], k.shape[-2], c.window,
                                        s.dtype, s.device)
            if segment_ids is not None:
                s = apply_segment_mask(s, segment_ids)
            if kv_mask is not None:
                s = s + kv_mask[:, None, None, :].to(s.dtype)
            p = F.softmax(s, dim=-1)
        if seed is not None:
            p = p * dropout_keep_oracle(
                q.shape[0], q.shape[1], q.shape[2], k.shape[2], seed,
                c.attn_dropout, p.device).to(p.dtype)
        if p.dtype != v.dtype:   # fp32 p from the composed route, as in JAX
            dt = torch.promote_types(p.dtype, v.dtype)
            p, v = p.to(dt), v.to(dt)
        return p @ v

    def _cached_attention(self, q, cache, impl=None):
        """Attention over the cache (which already holds this step's keys).

        At most ``DECODE_MAX_LQ`` new tokens: the flash-decode kernel, which
        reads the cache codes up to each sequence's length.  Longer prefills:
        the composed graph over the dequantized cache with its length mask
        (and window band), as in the JAX package."""
        c = self.cfg
        if q.shape[2] <= DECODE_MAX_LQ:
            return flash_decode_attention(
                q, cache.k, cache.v, cache.lengths, cache.k_scale,
                cache.v_scale, window=c.window, impl=impl)
        k_full, v_full = cache.read_k(), cache.read_v()
        if k_full.shape[1] != q.shape[1]:   # GQA prefill: expand KV groups
            g = q.shape[1] // k_full.shape[1]
            k_full = k_full.repeat_interleave(g, dim=1)
            v_full = v_full.repeat_interleave(g, dim=1)
        s = (q @ k_full.transpose(-1, -2)) * (
            1.0 / math.sqrt(c.attn_hidden_dim))
        s = s + cache.attention_mask(q.shape[2])[:, None].to(s.dtype)
        if c.window is not None:
            # absolute query positions: this step's tokens end at lengths-1
            Lq, S = q.shape[2], k_full.shape[2]
            qpos = (cache.lengths[:, None] - Lq
                    + torch.arange(Lq, device=q.device)[None, :])
            kpos = torch.arange(S, device=q.device)
            band = kpos[None, None, :] > (qpos[:, :, None] - c.window)
            s = s + torch.where(band, 0.0, -1e9)[:, None].to(s.dtype)
        return F.softmax(s, dim=-1) @ v_full

    def forward(self, x, *, kv_cache=None, kv_mask=None, positions=None,
                segment_ids=None, impl=None, training: bool = False,
                generator=None):
        """Uncached: returns ``[B, L, E]`` (``training`` and ``generator``
        for attention dropout).  Cached: appends this step's keys and
        values to ``kv_cache`` in place and returns ``(out, kv_cache)``.
        With ``positional="rope"`` q and k are rotated at ``positions``
        ([B, L]; ``arange(L)`` where None) before the cache takes k."""
        B, L, E = x.shape
        q, k, v = self.project_to_query_key_value(x, impl)
        if self.cfg.positional == "rope":
            if positions is None:
                positions = torch.arange(L, device=x.device).expand(B, L)
            q = F.apply_rope(q, positions)
            k = F.apply_rope(k, positions)
        if kv_cache is not None:
            kv_cache.append(k, v)
            out = self._cached_attention(q, kv_cache, impl)
            out = out.transpose(1, 2).reshape(B, L, E)
            return self.out_projection(out, impl=impl), kv_cache
        out = self.self_attention(q, k, v, kv_mask=kv_mask,
                                  segment_ids=segment_ids, impl=impl,
                                  training=training, generator=generator)
        return self.out_projection(out.transpose(1, 2).reshape(B, L, E),
                                   impl=impl)


class FeedForward(torch.nn.Module):
    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        kw = dict(bias=cfg.bias, dtype=cfg.dtype, device=device)
        self.linear_in = Linear(cfg.n_embd, cfg.ff_middle_dim, **kw)
        self.linear_out = Linear(cfg.ff_middle_dim, cfg.n_embd, **kw)
        self.dropout = Dropout(cfg.p_dropout)

    def forward(self, x, *, training: bool = False, generator=None,
                impl=None):
        h = F.gelu(self.linear_in(x, impl=impl))
        return self.linear_out(self.dropout(h, training=training,
                                            generator=generator), impl=impl)


class TransformerLayer(torch.nn.Module):
    """Pre-LN: ``x + attn(ln_1(x))``, then ``out + ff(ln_2(out))``."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        ln = dict(eps=cfg.ln_eps, fused=cfg.use_fused_kernel,
                  dtype=cfg.dtype, device=device)
        self.ln_1 = LayerNorm(cfg.n_embd, **ln)
        self.ln_2 = LayerNorm(cfg.n_embd, **ln)
        self.attention = MultiHeadAttention(cfg, device)
        if cfg.moe is not None:
            self.ff = MoEFeedForward(cfg.n_embd, cfg.ff_middle_dim, cfg.moe,
                                     cfg.dtype, p_dropout=cfg.p_dropout,
                                     device=device)
        else:
            self.ff = FeedForward(cfg, device)

    def forward(self, x, *, kv_cache=None, kv_mask=None, positions=None,
                segment_ids=None, impl=None, training: bool = False,
                generator=None):
        """The JAX layer's results: ``x``, or ``(x, kv_cache)`` cached,
        each followed by the router's ``aux`` with an MoE feed-forward."""
        h = self.ln_1(x, impl=impl)
        if kv_cache is not None:
            attn_out, kv_cache = self.attention(h, kv_cache=kv_cache,
                                                positions=positions,
                                                impl=impl)
        else:
            attn_out = self.attention(h, kv_mask=kv_mask,
                                      positions=positions,
                                      segment_ids=segment_ids, impl=impl,
                                      training=training, generator=generator)
        out = x + attn_out
        h = self.ln_2(out, impl=impl)
        if self.cfg.moe is not None:
            ff_out, aux = self.ff(h, training=training, generator=generator)
            extras = (aux,)
        else:
            ff_out = self.ff(h, training=training, generator=generator,
                             impl=impl)
            extras = ()
        result = out + ff_out
        if kv_cache is not None:
            return (result, kv_cache, *extras)
        return (result, *extras) if extras else result


def _remat_layer(layer, x, *, generator, **kw):
    """``layer(x, generator=generator, **kw)`` under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward, as ``jax.checkpoint`` does per
    layer in the JAX package (transformer.py:500-509).

    The recompute must draw the same dropout masks as the forward.
    ``checkpoint``'s ``preserve_rng_state`` saves only the default
    generators, not an explicit ``torch.Generator``, so the state of
    ``generator`` is captured here: the forward draws from ``generator``
    itself (which ends where it would without remat) and every recompute
    from a fresh generator restored to the captured state.  An MoE
    layer's ``(x, aux)`` comes through as it is."""
    state = None if generator is None else generator.get_state()
    first = [True]

    def run(t):
        gen = generator
        if state is not None and not first[0]:      # a recompute
            gen = torch.Generator(generator.device)
            gen.set_state(state)
        first[0] = False
        return layer(t, generator=gen, **kw)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class DecoderLM(torch.nn.Module):
    """Token (+ learned position) embeddings, ``n_layer`` pre-LN layers,
    final LayerNorm, lm_head.

    ``device=None`` means the card and raises without one; CPU runs pass
    ``device="cpu"``.  Parameters start from PyTorch's defaults (the same
    distributions as the JAX init); set them with ``nn.init_params`` or
    ``nn.load_jax_params``.  Parameters require gradients: serving entries
    run under ``torch.no_grad()``."""

    def __init__(self, cfg: DecoderConfig, device=None):
        super().__init__()
        self.cfg = cfg
        device = resolve_device(device)
        emb = dict(one_hot_matmul=cfg.embedding_one_hot, dtype=cfg.dtype,
                   device=device)
        self.token_embeddings = Embedding(cfg.n_vocab, cfg.n_embd, **emb)
        if cfg.positional == "learned":
            self.position_embeddings = Embedding(
                cfg.n_positions, cfg.n_embd, **emb)
        self.layers = torch.nn.ModuleList(
            [TransformerLayer(cfg, device) for _ in range(cfg.n_layer)])
        self.dropout = Dropout(cfg.p_dropout)
        self.ln = LayerNorm(cfg.n_embd, cfg.ln_eps,
                            fused=cfg.use_fused_kernel, dtype=cfg.dtype,
                            device=device)
        self.lm_head = Linear(cfg.n_embd, cfg.n_vocab, bias=cfg.bias,
                              dtype=cfg.dtype, device=device)

    @property
    def device(self) -> torch.device:
        return self.token_embeddings.weight.device   # lm_head may be quantized

    def forward(self, idx, *, kv_caches=None, kv_mask=None, positions=None,
                segment_ids=None, training: bool = False, generator=None,
                impl=None, return_aux: bool = False,
                return_hidden: bool = False, nan_past_table: bool = False):
        """idx [B, L] -> logits [B, L, n_vocab], or ``(logits, caches)``
        with ``kv_caches`` (one ``KVCache`` per layer, updated in place).
        ``return_hidden=True`` returns the post-LN hidden state [B, L,
        n_embd] instead of logits (lm_head is skipped), for
        ``functional.chunked_softmax_loss`` to train without the [B, L,
        n_vocab] logits.  With ``cfg.remat`` each layer of the uncached
        forward runs under ``torch.utils.checkpoint`` (``_remat_layer``).

        ``positions`` ([1, L] or [B, L]) overrides ``arange(L)``, as decode
        needs.  ``nan_past_table`` embeds a position past ``n_positions`` as
        NaN, as ``jnp.take``'s fill mode does in the JAX package, for a
        generation that runs past the table (without it such a position is
        an index error); the one-hot embedding (``embedding_one_hot``)
        embeds it as 0 either way, as JAX's one-hot does.  ``training``
        with a ``generator`` applies the embedding and feed-forward
        dropouts and, with ``cfg.attn_dropout``, attention dropout (the JAX
        layer has no residual dropout).
        ``impl`` reaches the kernels' wrappers.  ``segment_ids`` ([B, L])
        reaches the uncached attention: packed sequences, each row attending
        only its own segment (the fused path refuses them, as the JAX
        package does); with ``positions`` per segment a packed row gives
        each example's logits alone.  With ``positional="rope"``
        ``positions`` (broadcast to [B, L]) rotate q and k in every layer.

        ``return_aux=True`` appends the router's load-balancing term summed
        over the layers (fp32; None without ``cfg.moe``): JAX's order,
        ``logits[, caches][, aux_total]``.  The training objective adds
        ``cfg.moe.aux_weight * aux_total`` itself."""
        if segment_ids is not None and kv_caches is not None:
            raise NotImplementedError(
                "segment_ids (packed training) is not supported on the "
                "cached decode path")
        B, L = idx.shape
        c = self.cfg
        if positions is None:
            positions = torch.arange(L, device=idx.device)[None, :]
        rope_positions = (positions.expand(B, L) if c.positional == "rope"
                          else None)
        x = self.token_embeddings(idx)
        if (c.positional == "learned" and nan_past_table
                and not c.embedding_one_hot):
            inside = (positions < c.n_positions)[..., None]
            x = x + torch.where(inside, self.position_embeddings(
                positions.clamp(max=c.n_positions - 1)), torch.nan)
        elif c.positional == "learned":
            # the one-hot product embeds a position past the table as 0
            x = x + self.position_embeddings(positions)
        x = self.dropout(x, training=training, generator=generator)
        new_caches = [] if kv_caches is not None else None
        moe = c.moe is not None
        aux_total = torch.zeros((), device=x.device) if moe else None
        for li, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, cache, *extras = layer(
                    x, kv_cache=kv_caches[li], positions=rope_positions,
                    impl=impl, training=training, generator=generator)
                new_caches.append(cache)
            else:
                kw = dict(kv_mask=kv_mask, positions=rope_positions,
                          segment_ids=segment_ids, impl=impl,
                          training=training)
                out = (_remat_layer(layer, x, generator=generator, **kw)
                       if c.remat else layer(x, generator=generator, **kw))
                x, *extras = out if moe else (out,)
            if moe:
                aux_total = aux_total + extras[0]
        x = self.ln(x, impl=impl)
        out = x if return_hidden else self.lm_head(x, impl=impl)
        result = (out,)
        if kv_caches is not None:
            result += (new_caches,)
        if return_aux:
            result += (aux_total,)
        return result if len(result) > 1 else result[0]
