"""The shapes of a GPT-style decoder, read from a configuration file of
``port_bench/configs/``: the one place that turns a published config.json's
keys into widths.  The weights, the reference, the operation counts and the
adapter to the program all take their shapes from here."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Shape:
    n_embd: int
    n_head: int
    n_kv_head: int
    n_layer: int
    n_inner: int
    n_positions: int
    vocab: int
    ln_eps: float
    init_std: float

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_head * self.head_dim

    def leaves(self) -> list[tuple[str, tuple[int, ...], str]]:
        """(name, shape, kind) of every parameter, in one fixed order.
        ``kind`` picks the initial distribution (``weights.make``)."""
        E, F, V, P, kv = (self.n_embd, self.n_inner, self.vocab,
                          self.n_positions, self.kv_dim)
        out = [("token_embeddings.weight", (V, E), "w"),
               ("position_embeddings.weight", (P, E), "w")]
        for i in range(self.n_layer):
            p = f"layers.{i}."
            out += [(p + "ln_1.gamma", (E,), "g"),
                    (p + "ln_1.beta", (E,), "b")]
            for name, rows, kind in (("q", E, "w"), ("k", kv, "w"),
                                     ("v", kv, "w"), ("out", E, "wr")):
                a = p + f"attention.{name}_projection."
                out += [(a + "weight", (rows, E), kind),
                        (a + "bias", (rows,), "b")]
            out += [(p + "ln_2.gamma", (E,), "g"),
                    (p + "ln_2.beta", (E,), "b"),
                    (p + "ff.linear_in.weight", (F, E), "w"),
                    (p + "ff.linear_in.bias", (F,), "b"),
                    (p + "ff.linear_out.weight", (E, F), "wr"),
                    (p + "ff.linear_out.bias", (E,), "b")]
        out += [("ln.gamma", (E,), "g"), ("ln.beta", (E,), "b"),
                ("lm_head.weight", (V, E), "w"), ("lm_head.bias", (V,), "b")]
        return out

    def matmul_params(self) -> int:
        """Parameters that multiply activations: every Linear's weight
        (the embeddings are gathers, not products)."""
        E, F = self.n_embd, self.n_inner
        per_layer = E * E * 2 + 2 * E * self.kv_dim + 2 * E * F
        return self.n_layer * per_layer + self.vocab * E


def shape_of(cfg: dict) -> Shape:
    """A config.json (gpt2 or gpt_bigcode keys) as a ``Shape``."""
    E, H = int(cfg["n_embd"]), int(cfg["n_head"])
    kv = 1 if cfg.get("multi_query") else H
    inner = cfg.get("n_inner")
    return Shape(n_embd=E, n_head=H, n_kv_head=kv, n_layer=int(cfg["n_layer"]),
                 n_inner=int(inner) if inner else 4 * E,
                 n_positions=int(cfg["n_positions"]),
                 vocab=int(cfg["vocab_size"]),
                 ln_eps=float(cfg["layer_norm_epsilon"]),
                 init_std=float(cfg["initializer_range"]))


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())
