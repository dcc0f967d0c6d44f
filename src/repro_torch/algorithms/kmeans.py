"""Data-parallel K-means (Lloyd) over a DistArray -- dislib workload #1, the
port of the JAX package's ``repro/algorithms/kmeans.py``.

Every step is a set of per-block tasks submitted as futures: partial
squared distances per (row-block, col-block), a tree-reduce over column
blocks, per-row-block assignment, then per-block center partial sums
reduced over row blocks.  One ``collect`` per Lloyd iteration lets the
DAG scheduler overlap independent row blocks.  The bodies are torch ops
on the blocks' device; the k-means++ seeding and the global row sample
draw from numpy's generator on the host, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.distarray import DistArray
from repro_torch.data.taskgraph import TaskGraph


def _partial_dist(xb: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """[rows, k] partial ||x - c||^2 restricted to this column block."""
    x2 = torch.sum(xb * xb, dim=1, keepdim=True)
    c2 = torch.sum(cb * cb, dim=1)[None, :]
    return x2 - 2.0 * xb @ cb.T + c2


def _add(a, b):
    return a + b


def _assign(d: torch.Tensor):
    lab = torch.argmin(d, dim=1)
    return lab, float(torch.sum(d.gather(1, lab[:, None])))


def _center_partial(xb: torch.Tensor, assign, k: int):
    """Per-center sums and counts of this block's rows.  The sums are a
    one-hot product, ``onehot(labels).T @ xb``: a GEMM sums in a fixed
    order, so a re-executed body is bit-identical on the card, where
    ``index_add_`` (the literal form of the reference's ``np.add.at``)
    sums float64 by atomics in no fixed order.  The counts are integer
    (exact in any order)."""
    lab = assign[0]                        # (labels, objective) from _assign
    onehot = torch.nn.functional.one_hot(lab, k).to(xb.dtype)
    sums = onehot.T @ xb
    counts = torch.bincount(lab, minlength=k).to(torch.float64)
    return sums, counts


def _merge_cp(a, b):
    return a[0] + b[0], a[1] + b[1]


def _gather_rows(X: DistArray, idx: np.ndarray) -> np.ndarray:
    """Fetch rows by *global* index (partitioning-independent), in the
    order of ``idx``, from the blocks' device to a host float64 array."""
    idx = np.asarray(idx)
    out = np.empty((len(idx), X.shape[1]))
    owner = np.searchsorted(X.row_edges, idx, side="right") - 1
    for i in np.unique(owner):
        sel = np.nonzero(owner == i)[0]
        local = torch.as_tensor(idx[sel] - X.row_edges[i], device=X.device)
        rows = torch.cat([X.blocks[i][j].index_select(0, local)
                          for j in range(X.p_c)], dim=1)
        out[sel] = rows.cpu().numpy()
    return out


def _kmeanspp(sample: np.ndarray, k: int, rng) -> np.ndarray:
    """k-means++ seeding on a row sample (master-side, on the host)."""
    centers = [sample[rng.integers(len(sample))]]
    for _ in range(k - 1):
        d2 = np.min([np.sum((sample - c) ** 2, axis=1) for c in centers],
                    axis=0)
        p = d2 / max(d2.sum(), 1e-12)
        centers.append(sample[rng.choice(len(sample), p=p)])
    return np.stack(centers)


def fit(ex: TaskGraph, X: DistArray, *, k: int = 8, iters: int = 5,
        seed: int = 0, init_centers=None):
    n, m = X.shape
    if init_centers is not None:
        # resume from given centers; the trajectory continues exactly where
        # the previous segment stopped
        centers = torch.as_tensor(init_centers, dtype=torch.float64,
                                  device=X.device)
        k = len(centers)
    else:
        rng = np.random.default_rng(seed)
        # init: k-means++ over a globally-indexed row sample, so the fit
        # is exactly invariant to (p_r, p_c) -- partitioning may change
        # cost, never results
        samp_idx = rng.choice(n, size=min(n, max(32 * k, 256)),
                              replace=False)
        centers = torch.from_numpy(
            _kmeanspp(_gather_rows(X, np.sort(samp_idx)), k, rng)
        ).to(X.device)
    ce = X.col_edges

    labels, inertia = [], np.inf
    for _ in range(iters):
        cblocks = [centers[:, ce[j]:ce[j + 1]] for j in range(X.p_c)]
        # partial distances for every (i, j) block
        dist = [ex.submit(_partial_dist, X.blocks[i][j], cblocks[j],
                          name="kmeans_dist")
                for i in range(X.p_r) for j in range(X.p_c)]
        # per row block: reduce over column blocks, then assign; new
        # center partial sums chain off the assignment future
        assigns = []
        for i in range(X.p_r):
            row = dist[i * X.p_c:(i + 1) * X.p_c]
            d = row[0] if len(row) == 1 else ex.reduce_tree(
                _add, row, name="kmeans_red")
            assigns.append(ex.submit(_assign, d, name="kmeans_assign"))
        cps = [ex.submit(_center_partial, X.blocks[i][j], assigns[i], k,
                         name="kmeans_cp")
               for i in range(X.p_r) for j in range(X.p_c)]
        creds = []
        for j in range(X.p_c):
            col = [cps[i * X.p_c + j] for i in range(X.p_r)]
            creds.append(col[0] if len(col) == 1 else ex.reduce_tree(
                _merge_cp, col, name="kmeans_cred"))
        # one barrier per Lloyd iteration: the next centers are needed
        # master-side before the next round of tasks can be built
        vals = ex.collect(*creds, *assigns)
        new_cols = [s / torch.clamp(c, min=1.0)[:, None]
                    for s, c in vals[:X.p_c]]
        centers = torch.cat(new_cols, dim=1)
        labels = [lab for lab, _ in vals[X.p_c:]]
        inertia = float(sum(obj for _, obj in vals[X.p_c:]))
    return {"centers": centers, "inertia": inertia, "labels": labels}


def predict(model, X: torch.Tensor) -> torch.Tensor:
    d = _partial_dist(X, model["centers"])
    return torch.argmin(d, dim=1)


def run(ex: TaskGraph, X: DistArray, y=None, **kw):
    """Uniform registry entry point (unsupervised: ``y`` is ignored)."""
    return fit(ex, X, **kw)
