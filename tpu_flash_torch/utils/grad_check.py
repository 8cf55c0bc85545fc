"""Central-difference gradient checking, counterpart of
``tpu_flash/utils/grad_check.py``.

``grad_check(fn, *args)`` samples random positions of each floating
argument, perturbs each by ``±eps`` and compares the central difference of
``sum(fn(*args))`` with the gradient ``torch.autograd`` gives.  Everything
runs where the tensors are, the card or the CPU, in their own dtype: the
perturbed value is formed in float64 and cast back to the argument's
dtype, as the JAX package forms it in numpy.  The default tolerances are
the JAX package's, loose enough for fp32 evaluation noise and tight
enough to catch a wrong backward (a flipped sign, a missing rescale, a
dropped mask).
"""

from __future__ import annotations

import numpy as np
import torch


def central_difference(fn, *args, arg: int = 0, idx: tuple,
                       eps: float = 1e-3) -> float:
    """``d sum(fn(*args)) / d args[arg][idx]`` by symmetric difference."""

    @torch.no_grad()
    def shifted(delta):
        moved = list(args)
        pert = args[arg].detach().double().clone()
        pert[idx] += delta
        moved[arg] = pert.to(args[arg].dtype)
        return float(torch.sum(fn(*moved)))

    return (shifted(eps) - shifted(-eps)) / (2.0 * eps)


def grad_check(fn, *args, n_samples: int = 4, eps: float = 1e-3,
               rtol: float = 1e-2, atol: float = 1e-2, seed: int = 0) -> bool:
    """Check ``torch.autograd.grad`` of ``sum(fn(*args))`` at random
    positions of every floating argument against central differences.

    ``args`` are tensors; integer ones take no gradient and are not
    checked, and a float argument ``fn``'s output does not depend on has
    gradient 0.  The positions of each argument are ``n_samples`` distinct
    flat indices drawn by ``np.random.default_rng(seed)``, as in the JAX
    package.  Raises ``AssertionError`` naming the argument, index,
    analytic and numeric values on a mismatch; returns True otherwise."""
    args = tuple(torch.as_tensor(a) for a in args)
    float_argnums = [i for i, a in enumerate(args) if a.is_floating_point()]
    leaves = [a.detach().requires_grad_(True) if i in float_argnums else a
              for i, a in enumerate(args)]
    with torch.enable_grad():
        total = torch.sum(fn(*leaves))
        # an output that does not depend on the arguments (a comparison,
        # an argmax) has gradient 0, as jax.grad gives
        grads = dict(zip(float_argnums, torch.autograd.grad(
            total, [leaves[i] for i in float_argnums], allow_unused=True)
            if total.requires_grad else [None] * len(float_argnums)))
    rng = np.random.default_rng(seed)
    for i in float_argnums:
        a, g = args[i], grads[i]
        g = (torch.zeros(a.shape, dtype=torch.float64) if g is None
             else g.detach().double().cpu())
        flat_positions = rng.choice(a.numel(), size=min(n_samples, a.numel()),
                                    replace=False)
        for flat in flat_positions:
            idx = tuple(int(j) for j in np.unravel_index(int(flat), a.shape))
            numeric = central_difference(fn, *args, arg=i, idx=idx, eps=eps)
            analytic = float(g[idx])
            if not np.isclose(analytic, numeric, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"grad_check failed for argument {i} at index {idx}: "
                    f"analytic {analytic:.6g} vs central-difference "
                    f"{numeric:.6g} (eps={eps}, rtol={rtol}, atol={atol})")
    return True
