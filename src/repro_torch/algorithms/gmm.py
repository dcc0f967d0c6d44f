"""Data-parallel diagonal-covariance Gaussian Mixture Model (EM) -- dislib
workload, the port of the JAX package's ``repro/algorithms/gmm.py``.
E-step log-densities accumulate per column block and tree-reduce per row
block; responsibilities chain off each row's reduction future, and M-step
weighted sufficient statistics reduce over row blocks -- all inside one
DAG epoch per EM iteration.  The init draws are numpy draws on the host,
as in the reference; the bodies and the M-step run on the blocks' device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algorithms.kmeans import _gather_rows
from repro_torch.data.distarray import DistArray
from repro_torch.data.taskgraph import TaskGraph

_EPS = 1e-6


def _partial_logpdf(xb, mu_b, var_b):
    """[rows, k] sum over this column block of -0.5*((x-mu)^2/var + log var)."""
    diff = xb[:, None, :] - mu_b[None, :, :]
    return -0.5 * torch.sum(diff * diff / var_b[None] + torch.log(var_b[None]),
                            dim=2)


def _add(a, b):
    return a + b


def _resp(ll, log_pi):
    z = ll + log_pi[None, :]
    z = z - z.max(dim=1, keepdim=True).values
    r = torch.exp(z)
    return r / r.sum(dim=1, keepdim=True)


def _mstats(xb, r):
    return r.T @ xb, r.T @ (xb * xb), r.sum(dim=0)


def _merge3(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] + b[2]


def fit(ex: TaskGraph, X: DistArray, *, k: int = 4, iters: int = 5,
        seed: int = 0):
    rng = np.random.default_rng(seed)
    n, m = X.shape
    dev = X.device
    mu = torch.from_numpy(
        _gather_rows(X, rng.choice(n, size=k, replace=n < k))).to(dev)
    var = torch.ones((k, m), dtype=torch.float64, device=dev)
    pi = torch.full((k,), 1.0 / k, dtype=torch.float64, device=dev)
    ce = X.col_edges

    for _ in range(iters):
        mu_b = [mu[:, ce[j]:ce[j + 1]] for j in range(X.p_c)]
        var_b = [var[:, ce[j]:ce[j + 1]] for j in range(X.p_c)]
        parts = [ex.submit(_partial_logpdf, X.blocks[i][j], mu_b[j], var_b[j],
                           name="gmm_logpdf")
                 for i in range(X.p_r) for j in range(X.p_c)]
        log_pi = torch.log(pi)
        resp = []
        for i in range(X.p_r):
            row = parts[i * X.p_c:(i + 1) * X.p_c]
            ll = row[0] if len(row) == 1 else ex.reduce_tree(
                _add, row, name="gmm_red")
            resp.append(ex.submit(_resp, ll, log_pi, name="gmm_resp"))
        stats = [ex.submit(_mstats, X.blocks[i][j], resp[i],
                           name="gmm_mstats")
                 for i in range(X.p_r) for j in range(X.p_c)]
        sred = []
        for j in range(X.p_c):
            col = [stats[i * X.p_c + j] for i in range(X.p_r)]
            sred.append(col[0] if len(col) == 1 else ex.reduce_tree(
                _merge3, col, name="gmm_sred"))
        # one barrier per EM iteration: the M-step update is master-side
        vals = ex.collect(*sred)
        nk = None
        mu_new = torch.zeros_like(mu)
        ex2 = torch.zeros_like(var)
        for j, (sx, sxx, cnt) in enumerate(vals):
            denom = torch.clamp(cnt[:, None], min=_EPS)
            mu_new[:, ce[j]:ce[j + 1]] = sx / denom
            ex2[:, ce[j]:ce[j + 1]] = sxx / denom
            nk = cnt
        mu = mu_new
        var = torch.clamp(ex2 - mu * mu, min=_EPS)
        pi = torch.clamp(nk / n, min=_EPS)
        pi = pi / pi.sum()
    return {"mu": mu, "var": var, "pi": pi}


def predict(model, X: torch.Tensor) -> torch.Tensor:
    ll = _partial_logpdf(X, model["mu"], model["var"])
    return torch.argmax(ll + torch.log(model["pi"])[None, :], dim=1)


def run(ex: TaskGraph, X: DistArray, y=None, **kw):
    """Uniform registry entry point (unsupervised: ``y`` is ignored)."""
    return fit(ex, X, **kw)
