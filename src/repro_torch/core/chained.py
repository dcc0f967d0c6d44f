"""Chained multi-output classifier: DT_r -> DT_c (paper §III-C, Fig. 2).

The first tree predicts the row-partition class p_r*; the second tree is
trained on the features *concatenated with the row target* and predicts the
column-partition class p_c*.  Rows come first in the chain "since
partitioning along the rows is generally more relevant" (paper).  At
inference the second tree consumes DT_r's prediction.

``base_factory`` defaults to the paper's decision tree; passing
``RandomForestClassifier`` gives the beyond-paper ensemble variant
benchmarked in benchmarks/ablation_models.py.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from repro_torch.core.trees import DecisionTreeClassifier


def _chain(X: np.ndarray, target) -> np.ndarray:
    """Features ++ row-target column, written into one preallocated matrix
    (column_stack's list-of-arrays round trip costs an extra copy per call
    on the serving hot path)."""
    Xc = np.empty((X.shape[0], X.shape[1] + 1), np.float64)
    Xc[:, :-1] = X
    Xc[:, -1] = np.asarray(target, np.float64)
    return Xc


def make_model(name: str, *, s: int = 2, max_depth: int = 10):
    """Cascade-model registry shared by every tuner (``core/tuner.py``):
    "tree" is the paper-faithful chained DT cascade, the rest are the
    ablations/upgrades benchmarked in benchmarks/ablation_models.py.
    ``s`` reaches the regression baseline, whose snap-to-class step is the
    only model that depends on the partition base."""
    from repro_torch.core.trees import RandomForestClassifier
    # partial() of named classes, not lambdas: models must pickle into
    # serving-fleet worker processes (serve/transport.py)
    if name == "tree":
        return ChainedClassifier(
            partial(DecisionTreeClassifier, max_depth=max_depth))
    if name == "forest":
        return ChainedClassifier(
            partial(RandomForestClassifier, n_estimators=30,
                    max_depth=max_depth))
    if name == "independent":
        return IndependentClassifier(
            partial(DecisionTreeClassifier, max_depth=max_depth))
    if name == "regression":
        return RegressionBaseline(s=s)
    raise KeyError(f"unknown cascade model {name!r}")


class ChainedClassifier:
    def __init__(self, base_factory=None):
        self.base_factory = base_factory or partial(
            DecisionTreeClassifier, max_depth=10)
        self.model_r = None
        self.model_c = None

    def fit(self, X, y_r, y_c):
        X = np.asarray(X, np.float64)
        self.model_r = self.base_factory().fit(X, y_r)
        self.model_c = self.base_factory().fit(_chain(X, y_r), y_c)
        return self

    def predict(self, X):
        """Row-batched: both cascade stages classify the whole query matrix
        in one pass each (the estimator's batched serving path relies on
        this -- never loop rows through here)."""
        X = np.asarray(X, np.float64)
        if len(X) == 0:
            return np.zeros((0, 2), int)
        pr = self.model_r.predict(X)
        pc = self.model_c.predict(_chain(X, pr))
        return np.stack([pr, pc], axis=1)


class IndependentClassifier:
    """Ablation: two unchained trees (ignores target dependence)."""

    def __init__(self, base_factory=None):
        self.base_factory = base_factory or partial(
            DecisionTreeClassifier, max_depth=10)

    def fit(self, X, y_r, y_c):
        self.model_r = self.base_factory().fit(X, y_r)
        self.model_c = self.base_factory().fit(X, y_c)
        return self

    def predict(self, X):
        return np.stack([self.model_r.predict(X),
                         self.model_c.predict(X)], axis=1)


class RegressionBaseline:
    """The regression formulation the paper argues against (§III):
    predicts block *sizes* directly; outputs are unconstrained and get
    snapped to the nearest feasible power-of-s partition count."""

    def __init__(self, base_factory=None, s: int = 2):
        from repro_torch.core.trees import DecisionTreeRegressor
        self.base_factory = base_factory or partial(
            DecisionTreeRegressor, max_depth=10)
        self.s = s

    def fit(self, X, y_r, y_c):
        # regress on the raw partition counts (not class indices)
        self.model_r = self.base_factory().fit(X, self.s ** np.asarray(y_r))
        self.model_c = self.base_factory().fit(X, self.s ** np.asarray(y_c))
        return self

    def predict(self, X):
        def snap(v):
            v = np.maximum(np.asarray(v, np.float64), 1.0)
            return np.rint(np.log(v) / np.log(self.s)).astype(int)
        return np.stack([snap(self.model_r.predict(X)),
                         snap(self.model_c.predict(X))], axis=1)
