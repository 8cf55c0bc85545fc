"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``port_bench/reference/``), as numbers each
held to a limit of its cell (``port_bench/limits/<workload>.json``).

Training: each leaf's gradient norm as the optimizer got it at the first
step and each leaf's change after the third, taken by the worst leaf as the
gap of the two norms over the larger of the reference's norm of that leaf
and of the median leaf; and, because a norm moves with rounding only at the
second order, each leaf's distance between the two first gradients over the
same denominator.  Leaves whose reference gradient is under a thousandth of
the median leaf's (a key's bias under softmax) move by round-off alone and
are left out of the change and the distance.  The first three steps' loss
is read and not compared (the program's loss carries bf16 rounding that no
control or fault exceeds).

Serving: the widest gap by which a served token's reference logit lies
below the reference's best at that position."""

from __future__ import annotations

import statistics

import torch

from port_bench import weights
from port_bench.reference import gpt

ZERO_GRAD = 1e-3      # of the median leaf's gradient norm


def _worst(prog: dict, ref: dict, names) -> tuple[float, str]:
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_numbers(prog: dict, ref: dict, dists: dict) -> dict:
    """``prog`` and ``ref``: ``losses``, ``grad_norms``, ``change_norms``
    (the last two name -> norm); ``dists``: each leaf's distance between
    the two sides' first gradients."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad_norms"])
    grad_gap, grad_leaf = _worst(prog["grad_norms"], ref["grad_norms"],
                                 names)
    med = statistics.median(ref["grad_norms"].values())
    moved = [n for n in names if ref["grad_norms"][n] >= ZERO_GRAD * med]
    change_gap, change_leaf = _worst(prog["change_norms"],
                                     ref["change_norms"], moved)
    floor = statistics.median(ref["grad_norms"][n] for n in moved)
    dist = {n: dists[n] / max(ref["grad_norms"][n], floor) for n in moved}
    dist_leaf = max(dist, key=dist.get)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap,
                grad_dist=dist[dist_leaf], grad_leaf=grad_leaf,
                change_leaf=change_leaf, dist_leaf=dist_leaf,
                left_out=sorted(set(names) - set(moved)))


def train_reference(run, data, *, quant=None, half=False, judge=None,
                    capture=False) -> dict:
    """The reference's three steps from the seed's weights on ``data``
    (``gpt.adam_train``'s ``judge`` and ``capture`` passed on)."""
    tr = run.traffic
    w = weights.make(run.shape, run.seed, run.device)
    w32 = {n: t.float() for n, t in w.items()}
    del w
    with gpt.exact_fp32():
        return gpt.adam_train(w32, run.shape, data, lr=tr["lr"],
                              beta1=tr["beta1"], beta2=tr["beta2"],
                              eps=tr["eps"], quant=quant, half=half,
                              judge=judge, capture=capture)


def token_gaps(ref_logits: torch.Tensor, tokens) -> torch.Tensor:
    """Per position: the best reference logit less the logit of the token
    chosen there."""
    tok = torch.as_tensor(tokens, device=ref_logits.device)[:, None]
    return ref_logits.max(dim=-1).values - ref_logits.gather(-1, tok)[:, 0]


def serve_reference(run, w32, prompt, served, *, control: str | None = None):
    """The gaps of one finished request: teacher-forced through the
    reference over its prompt and served tokens.  With ``control`` the
    lower precision's own first choices are judged instead of the served
    tokens."""
    seq = list(prompt) + list(served[:-1])
    rows = list(range(len(prompt) - 1, len(seq)))
    with gpt.exact_fp32():
        ref = gpt.logits_at(w32, run.shape, seq, rows)
        chosen = served
        if control is not None:
            chosen = gpt.logits_at(w32, run.shape, seq, rows,
                                   quant=control).argmax(dim=-1).tolist()
    return token_gaps(ref, chosen)
