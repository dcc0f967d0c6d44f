"""Distributed Random Forest -- dislib workload #2, the port of the JAX
package's ``repro/algorithms/rf.py``.

Trees distribute over row blocks (each block trains its share of the
ensemble on local rows with feature subsampling); prediction is a
vote-merge.  Each block's training task chains off that block's stitch
future.  The base learner is the repo's own CART
(``repro_torch.core.trees``), host numpy in both packages: ``_train_block``
copies its block to the host inside the body, so the copy is part of the
task's measured cost.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.trees import DecisionTreeClassifier, _BaseTree
from repro_torch.data.distarray import DistArray
from repro_torch.data.taskgraph import TaskGraph


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _train_block(xb, yb, n_trees, classes, max_depth, seed):
    xb, yb = _host(xb), _host(yb)
    rng = np.random.default_rng(seed)
    trees = []
    n = len(xb)
    mf = max(1, int(np.sqrt(xb.shape[1])))
    for _ in range(n_trees):
        rows = rng.integers(0, n, n)
        t = DecisionTreeClassifier(max_depth=max_depth, max_features=mf,
                                   random_state=int(rng.integers(1 << 31)))
        t.classes_ = classes
        t.n_classes_ = len(classes)
        yy = np.searchsorted(classes, yb[rows])
        _BaseTree.fit(t, xb[rows], yy)
        trees.append(t)
    return trees


def fit(ex: TaskGraph, X: DistArray, y, *, n_trees: int = 16,
        max_depth: int = 8, seed: int = 0):
    y = torch.as_tensor(y, device=X.device)
    classes = torch.unique(y).cpu().numpy()
    rows = X.row_stitched(ex, defer=True)
    yb = X.split_rows(y)
    per_block = max(1, int(np.ceil(n_trees / X.p_r)))
    fs = [ex.submit(_train_block, rows[i], yb[i], per_block, classes,
                    max_depth, seed + i, name="rf_fit")
          for i in range(X.p_r)]
    tree_lists = ex.collect(*fs)
    trees = [t for lst in tree_lists for t in lst]
    return {"trees": trees, "classes": classes}


def predict(model, X: torch.Tensor) -> torch.Tensor:
    xh = _host(X)
    proba = np.mean([t.predict_proba(xh) for t in model["trees"]], axis=0)
    return torch.from_numpy(
        model["classes"][np.argmax(proba, axis=1)]).to(X.device)


def run(ex: TaskGraph, X: DistArray, y=None, **kw):
    """Uniform registry entry point (supervised: ``y`` is required)."""
    if y is None:
        raise ValueError("rf is supervised: y is required")
    return fit(ex, X, y, **kw)
