"""Feature extraction for the block-size estimator (paper §III-B, Table I).

An execution is described by dataset features (rows, columns, size in MB,
shape ratios), algorithm identity (one-hot), and execution-environment
features (workers, nodes, memory).  The same schema serves the LM-layer
tuner with a different vocabulary (see core/meshtune.py).
"""
from __future__ import annotations

import math

import numpy as np

ALGOS = ("kmeans", "pca", "gmm", "csvm", "rf")


def dataset_features(n_rows: int, n_cols: int, dtype_bytes: int = 8) -> dict:
    # math.log2, not np.log2: scalar numpy calls cost ~1-2us each and this
    # runs once per query on the serving hot path (identical doubles)
    size_mb = n_rows * n_cols * dtype_bytes / 2**20
    return {
        "rows": float(n_rows),
        "cols": float(n_cols),
        "size_mb": size_mb,
        "log_rows": math.log2(max(n_rows, 1)),
        "log_cols": math.log2(max(n_cols, 1)),
        "aspect": math.log2(max(n_rows, 1) / max(n_cols, 1)),
    }


def featurize(d: dict, algo: str, e: dict) -> dict:
    f = dict(d)
    for a in ALGOS:
        f[f"algo_{a}"] = 1.0 if algo == a else 0.0
    for k, v in e.items():
        try:
            f[f"env_{k}"] = float(v)
        except (TypeError, ValueError):
            continue    # non-numeric env metadata (e.g. cluster name)
    return f


def featurize_batch(triples) -> list[dict]:
    """``featurize`` over many ``(dataset_dict, algo, env_dict)`` triples —
    the single entry point every tuner's serving path funnels through."""
    return [featurize(d, algo, e) for d, algo, e in triples]


def vectorize(feature_dicts: list[dict], order: list[str] | None = None):
    """Stable feature matrix; returns (X, order)."""
    if order is None:
        keys = set()
        for f in feature_dicts:
            keys.update(f)
        order = sorted(keys)
    X = np.array([[float(f.get(k, 0.0)) for k in order]
                  for f in feature_dicts], np.float64)
    return X, order
