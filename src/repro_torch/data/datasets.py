"""Synthetic datasets following the paper's generation protocol (§V-A.2),
the port of the JAX package's ``repro/data/datasets.py``: isotropic and
anisotropic Gaussian blobs per class, augmented with random noise features
and redundant features (linear combinations of informative ones).  Also
shape-faithful stand-ins for the paper's real datasets (HEPMASS 7M x 27,
MNIST 60k x 784) at configurable scale.

The rows are drawn on the host by numpy's ``default_rng``, exactly as the
reference draws them, so one seed gives the same rows in both packages;
they are returned as tensors (X float64, y int64) on ``device``, which
defaults to the card (``resolve_device``: no silent CPU fallback).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _on(device: torch.device, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def gaussian_blobs(n_rows: int, n_cols: int, *, n_classes: int = 4,
                   anisotropic: bool = False, noise_frac: float = 0.2,
                   redundant_frac: float = 0.2, seed: int = 0,
                   device: str = "cuda"):
    """Returns (X [n, m] float64, y [n] int64) on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_noise = int(n_cols * noise_frac)
    n_red = int(n_cols * redundant_frac)
    n_inf = max(1, n_cols - n_noise - n_red)

    counts = np.full(n_classes, n_rows // n_classes)
    counts[: n_rows % n_classes] += 1
    xs, ys = [], []
    for c in range(n_classes):
        center = rng.normal(0, 4.0, n_inf)
        x = rng.normal(0, 1.0, (counts[c], n_inf))
        if anisotropic:
            a = rng.normal(0, 1.0, (n_inf, n_inf)) / np.sqrt(n_inf)
            x = x @ (np.eye(n_inf) + 0.5 * a)
        xs.append(x + center)
        ys.append(np.full(counts[c], c))
    X = np.concatenate(xs)
    y = np.concatenate(ys)

    parts = [X]
    if n_red:
        w = rng.normal(0, 1.0, (n_inf, n_red)) / np.sqrt(n_inf)
        parts.append(X @ w)
    if n_noise:
        parts.append(rng.normal(0, 1.0, (n_rows, n_noise)))
    X = np.concatenate(parts, axis=1)[:, :n_cols]

    perm = rng.permutation(n_rows)
    return _on(device, X[perm], y[perm])


def hepmass_like(scale: float = 1.0, seed: int = 1, device: str = "cuda"):
    """HEPMASS-1000 stand-in: 2 clusters, 27 features (paper: 7M rows)."""
    n = max(1000, int(7_000_000 * scale))
    return gaussian_blobs(n, 27, n_classes=2, noise_frac=0.3,
                          redundant_frac=0.1, seed=seed, device=device)


def mnist_like(scale: float = 1.0, seed: int = 2, device: str = "cuda"):
    """MNIST stand-in: 10 classes, 784 features (paper: 60k rows)."""
    n = max(500, int(60_000 * scale))
    return gaussian_blobs(n, 784, n_classes=10, noise_frac=0.5,
                          redundant_frac=0.2, seed=seed, device=device)


# the paper's three synthetic shape cases (§V-A.2), at configurable scale
def shape_cases(scale: float = 1.0, seed: int = 3, device: str = "cuda"):
    def f(v):
        return max(8, int(v * scale))
    return {
        "row_imbalanced": gaussian_blobs(f(500_000), f(1000), seed=seed,
                                         device=device),
        "column_imbalanced": gaussian_blobs(f(1000), f(500_000),
                                            seed=seed + 1, device=device),
        "balanced": gaussian_blobs(f(10_000), f(10_000), seed=seed + 2,
                                   device=device),
    }


def trajectory_like(n_rows: int, n_cols: int, seed: int = 4,
                    device: str = "cuda"):
    """Smooth correlated columns (GROMACS-trajectory stand-in for PCA)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    k = min(32, n_cols)
    basis = rng.normal(0, 1.0, (k, n_cols))
    t = np.linspace(0, 8 * np.pi, n_rows)[:, None]
    phases = rng.uniform(0, 2 * np.pi, k)[None, :]
    coefs = np.sin(t * np.arange(1, k + 1)[None, :] * 0.25 + phases)
    X = coefs @ basis + 0.05 * rng.normal(0, 1, (n_rows, n_cols))
    return _on(device, X)[0]
