"""The port's point sets (``data/points.py``) and points classifier
(``apps/points_classifier.py``) against the JAX package's:

* the six generators give JAX's arrays bit for bit at several N and seeds;
* JAX's ``model.init(key)`` loaded through ``load_jax_params``: logits and
  ``bce_with_logits`` within 1e-6, and the first 20 ``train_points``
  losses (full-batch Adam, lr 0.05) within 1e-5 of JAX's scan;
* ``run`` on the CPU learns each set to JAX's test thresholds
  (``tests/test_points.py``), from the port's own initial draw;
* the CLI prints JAX's line."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_flash.apps import points_classifier as japp
from tpu_flash.data import points as jpoints
from tpu_flash.nn import optim as joptim
from tpu_flash_torch.apps import points_classifier as tapp
from tpu_flash_torch.data import points as tpoints
from tpu_flash_torch.nn import load_jax_params
from tpu_flash_torch.nn import optim as toptim

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(jpoints.datasets))
def test_generators_equal_jax(name):
    assert sorted(tpoints.datasets) == sorted(jpoints.datasets)
    for N, seed in ((1, 0), (64, 0), (257, 3), (1000, 11)):
        gj = jpoints.datasets[name](N, seed=seed)
        gt = tpoints.datasets[name](N, seed=seed)
        assert gt.N == gj.N
        for a, b in ((gt.X, gj.X), (gt.y, gj.y)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def pair(seed=0, hidden=32):
    jmodel = japp.MLPClassifier(hidden)
    params = jmodel.init(jax.random.key(seed))
    tmodel = tapp.MLPClassifier(hidden, device="cpu")
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def test_forward_and_loss_match_jax():
    jmodel, params, tmodel = pair()
    g = tpoints.circle(128, seed=2)
    logits_j = jmodel(params, jnp.asarray(g.X))
    with torch.no_grad():
        logits_t = tmodel(torch.from_numpy(g.X))
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-6, rtol=1e-6)
    y = g.y.astype(np.float32)
    for z in (np.array(logits_j), np.array([-40.0, -1.0, 0.0, 3.0, 60.0],
                                             np.float32)):
        yy = y[:len(z)]
        np.testing.assert_allclose(
            float(tapp.bce_with_logits(torch.from_numpy(z),
                                       torch.from_numpy(yy))),
            float(japp.bce_with_logits(jnp.asarray(z), jnp.asarray(yy))),
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["Xor", "Spiral"])
def test_first_20_losses_match_jax(name):
    jmodel, params, tmodel = pair(seed=1)
    g = tpoints.datasets[name](256, seed=0)
    X, y = g.X, g.y.astype(np.float32)
    jtx = joptim.adam(0.05)
    _, _, losses_j = japp.train_points(jmodel, jtx, 20, params,
                                       jtx.init(params), jnp.asarray(X),
                                       jnp.asarray(y))
    ttx = toptim.adam(0.05)
    state = ttx.init({n: p.detach() for n, p in tmodel.named_parameters()})
    _, losses_t = tapp.train_points(tmodel, ttx, 20, state,
                                    torch.from_numpy(X), torch.from_numpy(y))
    assert losses_t.shape == (20,) and losses_t.device.type == "cpu"
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,steps,min_acc", [
    ("Simple", 200, 0.97),
    ("Diag", 200, 0.97),
    ("Xor", 500, 0.95),
    ("Circle", 500, 0.93),
])
def test_classifier_learns(name, steps, min_acc):
    loss, acc = tapp.run(name, hidden=32, steps=steps, device="cpu")
    assert acc >= min_acc, (name, loss, acc)


def test_run_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.run("Simple", steps=1)


def test_cli_prints_the_jax_line(capsys):
    tapp.main(["--dataset", "Diag", "--steps", "30", "--n-points", "64",
               "--seed", "2"], device="cpu")
    line = capsys.readouterr().out.strip()
    m = re.fullmatch(r"Diag: loss=(\d+\.\d{4}) accuracy=(\d\.\d{3})", line)
    assert m, line
    loss, acc = tapp.run("Diag", steps=30, n_points=64, seed=2, device="cpu")
    assert m.groups() == (f"{loss:.4f}", f"{acc:.3f}")
