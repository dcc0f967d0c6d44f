"""Data-parallel PCA over a DistArray -- the paper's MareNostrum-4 workload,
the port of the JAX package's ``repro/algorithms/pca.py``.

Column sums and the Gram/covariance matrix are per-block tasks chained by
futures: each Gram task depends only on its two column sums, so under the
DAG scheduler a column pair whose means are ready starts immediately while
other columns are still reducing; the final (m x m) eigendecomposition
runs as a master task (as in dislib, whose PCA gathers the covariance),
``torch.linalg.eigh`` in float64 on the blocks' device.
"""
from __future__ import annotations

import torch

from repro_torch.data.distarray import DistArray
from repro_torch.data.taskgraph import TaskGraph


def _col_sum(xb):
    return torch.sum(xb, dim=0)


def _add(a, b):
    return a + b


def _gram_pair(xa, xb, sa, sb, n):
    mu_a = sa / n
    mu_b = sb / n
    return (xa - mu_a[None, :]).T @ (xb - mu_b[None, :])


def _eigh_top(cov, n_components):
    w, v = torch.linalg.eigh(cov)
    order = torch.argsort(w, descending=True)[:n_components]
    return w[order], v[:, order]


def fit(ex: TaskGraph, X: DistArray, *, n_components: int = 8):
    n, m = X.shape
    # ---- column sums (means are formed inside each Gram task) -------------
    sums = [[ex.submit(_col_sum, X.blocks[i][j], name="pca_colsum")
             for j in range(X.p_c)] for i in range(X.p_r)]
    colred = []
    for j in range(X.p_c):
        col = [sums[i][j] for i in range(X.p_r)]
        colred.append(col[0] if len(col) == 1 else ex.reduce_tree(
            _add, col, name="pca_mred"))

    # ---- blocked covariance -----------------------------------------------
    pair_parts: dict = {}
    for i in range(X.p_r):
        for j1 in range(X.p_c):
            for j2 in range(j1, X.p_c):
                g = ex.submit(_gram_pair, X.blocks[i][j1], X.blocks[i][j2],
                              colred[j1], colred[j2], n, name="pca_gram")
                pair_parts.setdefault((j1, j2), []).append(g)
    pair_red = {pair: (parts[0] if len(parts) == 1 else ex.reduce_tree(
        _add, parts, name="pca_gred")) for pair, parts in pair_parts.items()}

    vals = ex.collect(*pair_red.values(), *colred)
    grams = dict(zip(pair_red, vals[:len(pair_red)]))
    mu = [s / n for s in vals[len(pair_red):]]
    ce = X.col_edges
    cov = torch.zeros((m, m), dtype=torch.float64, device=X.device)
    for (j1, j2), g in grams.items():
        cov[ce[j1]:ce[j1 + 1], ce[j2]:ce[j2 + 1]] = g
        if j1 != j2:
            cov[ce[j2]:ce[j2 + 1], ce[j1]:ce[j1 + 1]] = g.T
    cov /= max(n - 1, 1)

    # ---- master eigendecomposition (serial, unwarmed: runs exactly once) --
    f = ex.submit(_eigh_top, cov, n_components, name="pca_eigh", warm=False)
    w, v = ex.collect(f)[0]
    return {"mean": torch.cat(mu), "variance": w, "components": v}


def transform(model, X: torch.Tensor) -> torch.Tensor:
    return (X - model["mean"][None, :]) @ model["components"]


def run(ex: TaskGraph, X: DistArray, y=None, **kw):
    """Uniform registry entry point (unsupervised: ``y`` is ignored)."""
    return fit(ex, X, **kw)
