"""A small MLP classifier on the 2-D point sets, counterpart of
``tpu_flash/apps/points_classifier.py``.

The whole dataset is one ``[N, 2]`` batch on the device.  The JAX loop is
one jitted ``lax.scan`` over full-batch Adam steps; here each step runs
eagerly (forward, ``torch.autograd.grad``, the port's ``optim.adam``
update copied into the parameters) and writes its loss into a device
tensor, which the host reads once, after the last step.

Run on the card:  python -m tpu_flash_torch.apps.points_classifier
--dataset Xor; on the CPU: ``run(..., device="cpu")`` or ``main(argv,
device="cpu")``.
"""

from __future__ import annotations

import argparse

import torch

from tpu_flash_torch.data import points
from tpu_flash_torch.kernels.common import resolve_device
from tpu_flash_torch.nn import optim
from tpu_flash_torch.nn.layers import Linear
from tpu_flash_torch.nn.module import init_params


class MLPClassifier(torch.nn.Module):
    """2 → hidden → hidden → 1 ReLU MLP giving one logit a point; its
    parameters are named as the JAX module's tree (``l1``, ``l2``,
    ``l3``), so ``nn.load_jax_params`` loads JAX's ``model.init(key)``."""

    def __init__(self, hidden: int = 32, device=None):
        super().__init__()
        self.l1 = Linear(2, hidden, device=device)
        self.l2 = Linear(hidden, hidden, device=device)
        self.l3 = Linear(hidden, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.l1(x))
        h = torch.relu(self.l2(h))
        return self.l3(h)[..., 0]  # logits [N]


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, the stable log-sigmoid form
    ``max(z, 0) - z y + log1p(exp(-|z|))``."""
    return torch.mean(torch.maximum(logits, logits.new_zeros(()))
                      - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def train_points(model: MLPClassifier, tx: optim.Transform, steps: int,
                 opt_state, X: torch.Tensor, y: torch.Tensor):
    """``steps`` full-batch gradient steps on ``(X, y)``; the parameters
    change in place.  Returns ``(opt_state, losses)``, ``losses`` a
    ``[steps]`` tensor on the device (no host read in the loop)."""
    params = dict(model.named_parameters())
    losses = torch.empty(steps, dtype=torch.float32, device=X.device)
    for i in range(steps):
        loss = bce_with_logits(model(X), y)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            new, opt_state = tx.update(
                dict(zip(params, grads)), opt_state,
                {n: p.detach() for n, p in params.items()})
            for n, p in params.items():
                p.copy_(new[n])
            losses[i] = loss
    return opt_state, losses


def run(dataset: str = "Xor", hidden: int = 32, steps: int = 500,
        lr: float = 0.05, n_points: int = 256, seed: int = 0, *,
        device=None) -> tuple[float, float]:
    """Train on one named dataset with parameters drawn from ``seed``
    (``nn.init_params``); returns ``(final_loss, accuracy)``.  ``device``
    ``None`` is the card (raising without one)."""
    device = resolve_device(device)
    graph = points.datasets[dataset](n_points, seed=seed)
    X = torch.from_numpy(graph.X).to(device)
    y = torch.from_numpy(graph.y).to(device, torch.float32)

    model = MLPClassifier(hidden, device=device)
    init_params(model, torch.Generator(device).manual_seed(seed))
    tx = optim.adam(lr)
    opt_state = tx.init({n: p.detach() for n, p in model.named_parameters()})
    _, losses = train_points(model, tx, steps, opt_state, X, y)

    with torch.no_grad():
        preds = (model(X) > 0.0).float()
        acc = float(torch.mean((preds == y).float()))
    return float(losses[-1]), acc


def main(argv=None, *, device=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="Xor", choices=sorted(points.datasets))
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--n-points", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    loss, acc = run(args.dataset, args.hidden, args.steps, args.lr,
                    args.n_points, args.seed, device=device)
    print(f"{args.dataset}: loss={loss:.4f} accuracy={acc:.3f}")


if __name__ == "__main__":
    main()
