"""Cascade SVM (CSVM) -- dislib's SVM, the port of the JAX package's
``repro/algorithms/svm.py``: per-row-block linear SVMs whose support
vectors merge pairwise up a cascade, retraining at each level.  The inner
solver is Pegasos-style hinge subgradient descent: its index draws are
numpy draws on the host, as in the reference, and its products run on the
blocks' device.  Column-partitioned inputs pay an explicit per-row-block
"stitch" task first; each block's level-0 fit chains off its own stitch
future.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.distarray import DistArray
from repro_torch.data.taskgraph import TaskGraph


def _pegasos(xy, *, lam=1e-3, iters=60, cap=256, seed=0):
    x, y = xy
    rng = np.random.default_rng(seed)
    n, m = x.shape
    w = torch.zeros(m, dtype=x.dtype, device=x.device)
    b = torch.zeros((), dtype=x.dtype, device=x.device)
    bs = min(256, n)
    for t in range(1, iters + 1):
        idx = torch.from_numpy(rng.integers(0, n, bs)).to(x.device)
        xi, yi = x[idx], y[idx]
        margin = yi * (xi @ w + b)
        viol = margin < 1.0
        eta = 1.0 / (lam * t)
        gw = lam * w - (yi[viol, None] * xi[viol]).sum(0) / bs
        gb = -torch.sum(yi[viol]) / bs
        w = w - eta * gw
        b = b - eta * gb
    # support vectors = margin violators (capped)
    margin = y * (x @ w + b)
    sv = torch.argsort(margin, stable=True)[:cap]
    return w, float(b), (x[sv], y[sv])


def _merge_train(a, b):
    (wa, ba, (xa, ya)), (wb, bb, (xb, yb)) = a, b
    x = torch.cat([xa, xb])
    y = torch.cat([ya, yb])
    return _pegasos((x, y), seed=1)


def _fit_block(xb, yy, lam):
    return _pegasos((xb, yy), lam=lam)


def fit(ex: TaskGraph, X: DistArray, y: torch.Tensor, *, lam: float = 1e-3):
    rows = X.row_stitched(ex, defer=True)
    yb = X.split_rows(torch.where(torch.as_tensor(y, device=X.device) > 0,
                                  1.0, -1.0).to(torch.float64))
    level0 = [ex.submit(_fit_block, rows[i], yb[i], lam, name="csvm_fit")
              for i in range(X.p_r)]
    top = level0[0] if len(level0) == 1 else ex.reduce_tree(
        _merge_train, level0, name="csvm_cascade")
    w, b, _ = ex.collect(top)[0]
    return {"w": w, "b": b}


def predict(model, X: torch.Tensor) -> torch.Tensor:
    return (X @ model["w"] + model["b"] >= 0).to(torch.int64)


def run(ex: TaskGraph, X: DistArray, y=None, **kw):
    """Uniform registry entry point (supervised: ``y`` is required)."""
    if y is None:
        raise ValueError("csvm is supervised: y is required")
    return fit(ex, X, y, **kw)
