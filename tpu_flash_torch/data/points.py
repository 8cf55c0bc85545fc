"""2-D point-set datasets for the small classifier demo, a copy of
``tpu_flash/data/points.py`` (numpy only, so the port keeps its own): the
six labelled sets Simple, Diag, Split, Xor, Circle and Spiral as ``[N, 2]``
float32 points and ``[N]`` int32 labels, the same arrays bit for bit for
the same ``N`` and ``seed``.  Labelling rules: thresholds 0.5 / 0.2 / 0.8,
circle radius² 0.1, the parametric spiral with its mirrored second arm.
Consumed by ``tpu_flash_torch.apps.points_classifier``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Graph:
    """A labeled 2-D point set (reference ``datasets.py:16-20``)."""

    N: int
    X: np.ndarray  # [N, 2] float32 in [0, 1]²
    y: np.ndarray  # [N] int32 in {0, 1}


def _make_pts(N: int, rng: np.random.Generator) -> np.ndarray:
    return rng.random((N, 2), dtype=np.float32)


def _graph(X: np.ndarray, y: np.ndarray) -> Graph:
    return Graph(len(X), X.astype(np.float32), y.astype(np.int32))


def simple(N: int, seed: int = 0) -> Graph:
    """Label 1 iff x₁ < 0.5 (reference ``datasets.py:23-29``)."""
    X = _make_pts(N, np.random.default_rng(seed))
    return _graph(X, X[:, 0] < 0.5)


def diag(N: int, seed: int = 0) -> Graph:
    """Label 1 iff x₁ + x₂ < 0.5 (reference ``datasets.py:32-38``)."""
    X = _make_pts(N, np.random.default_rng(seed))
    return _graph(X, X[:, 0] + X[:, 1] < 0.5)


def split(N: int, seed: int = 0) -> Graph:
    """Label 1 iff x₁ < 0.2 or x₁ > 0.8 (reference ``datasets.py:41-47``)."""
    X = _make_pts(N, np.random.default_rng(seed))
    return _graph(X, (X[:, 0] < 0.2) | (X[:, 0] > 0.8))


def xor(N: int, seed: int = 0) -> Graph:
    """Label 1 iff exactly one coordinate exceeds 0.5
    (reference ``datasets.py:50-56``)."""
    X = _make_pts(N, np.random.default_rng(seed))
    return _graph(X, (X[:, 0] < 0.5) ^ (X[:, 1] < 0.5))


def circle(N: int, seed: int = 0) -> Graph:
    """Label 1 outside the radius-√0.1 circle about (0.5, 0.5)
    (reference ``datasets.py:59-66``)."""
    X = _make_pts(N, np.random.default_rng(seed))
    c = X - 0.5
    return _graph(X, (c * c).sum(axis=1) > 0.1)


def spiral(N: int, seed: int = 0) -> Graph:
    """Two interleaved Archimedean spiral arms, one per class
    (reference ``datasets.py:69-85``; deterministic — no noise, so ``seed``
    is accepted for registry uniformity but unused)."""
    del seed
    half = N // 2
    t = 10.0 * (np.arange(5, 5 + half, dtype=np.float32) / half)
    x_t = t * np.cos(t) / 20.0
    y_t = t * np.sin(t) / 20.0
    arm0 = np.stack([x_t + 0.5, y_t + 0.5], axis=1)
    # Second arm: the reference evaluates its helpers at -t and swaps the
    # coordinate roles, i.e. (y(-t), x(-t)).
    x_mt = -t * np.cos(-t) / 20.0
    y_mt = -t * np.sin(-t) / 20.0
    arm1 = np.stack([y_mt + 0.5, x_mt + 0.5], axis=1)
    X = np.concatenate([arm0, arm1], axis=0)
    y = np.concatenate([np.zeros(half), np.ones(half)])
    return _graph(X, y)


datasets = {
    "Simple": simple,
    "Diag": diag,
    "Split": split,
    "Xor": xor,
    "Circle": circle,
    "Spiral": spiral,
}
