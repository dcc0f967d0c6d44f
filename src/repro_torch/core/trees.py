"""Decision trees from scratch (no sklearn in the container).

CART with gini impurity (classifier) / variance reduction (regressor),
vectorized split search over sorted feature columns, plus a bagging
RandomForest.  These are both (a) the paper's learning models -- the chained
DT_r -> DT_c block-size classifier -- and (b) the per-block base learner of
the distributed Random Forest workload in repro.algorithms.rf.

Hot-path layout: ``fit`` argsorts every feature column exactly once and
partitions the sorted index sets down the tree (a stable sort of a subset of
an already stably-sorted sequence is the sequence filtered, so per-node
re-sorting is pure waste).  Fitted trees are stored twice: as a ``_Node``
list for introspection, and as flat numpy arrays (``feature_``,
``threshold_``, ``left_``, ``right_``, ``leaf_value_``) that drive a
vectorized level-synchronous batch traversal.  ``_walk_scalar`` keeps the
original one-row-at-a-time walker as the equivalence reference
(tests/test_hotpath.py proves bit-identical predictions).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: np.ndarray | float | None = None     # leaf payload

    @property
    def is_leaf(self):
        return self.feature < 0


def _gini_gain(y_sorted: np.ndarray, n_classes: int):
    """Best split position and impurity decrease for one sorted column.

    Returns (best_pos, best_score); split is  "< value at pos".  Vectorized:
    prefix class counts give gini left/right at every cut in O(n*k).
    """
    n = len(y_sorted)
    onehot = np.zeros((n, n_classes), np.float64)
    onehot[np.arange(n), y_sorted] = 1.0
    left = np.cumsum(onehot, axis=0)[:-1]              # counts left of cut i+1
    nl = np.arange(1, n, dtype=np.float64)
    nr = n - nl
    right = left[-1] + onehot[-1] - left
    gini_l = 1.0 - np.sum((left / nl[:, None]) ** 2, axis=1)
    gini_r = 1.0 - np.sum((right / nr[:, None]) ** 2, axis=1)
    score = (nl * gini_l + nr * gini_r) / n            # weighted child gini
    pos = int(np.argmin(score))
    return pos + 1, float(score[pos])


def _var_gain(y_sorted: np.ndarray):
    n = len(y_sorted)
    cs = np.cumsum(y_sorted)
    cs2 = np.cumsum(y_sorted ** 2)
    nl = np.arange(1, n, dtype=np.float64)
    nr = n - nl
    sl, sr = cs[:-1], cs[-1] - cs[:-1]
    s2l, s2r = cs2[:-1], cs2[-1] - cs2[:-1]
    var_l = s2l / nl - (sl / nl) ** 2
    var_r = s2r / nr - (sr / nr) ** 2
    score = (nl * var_l + nr * var_r) / n
    pos = int(np.argmin(score))
    return pos + 1, float(score[pos])


class _BaseTree:
    def __init__(self, max_depth=8, min_samples_split=2, min_samples_leaf=1,
                 max_features=None, random_state=0):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.random_state = random_state
        self.nodes: list[_Node] = []

    # subclass API
    def _leaf_value(self, y):
        raise NotImplementedError

    def _node_score(self, y):
        raise NotImplementedError

    def _best_split_col(self, y_sorted):
        raise NotImplementedError

    def _pack_values(self, values):
        raise NotImplementedError

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.n_features_ = X.shape[1]
        rng = np.random.default_rng(self.random_state)
        self.nodes = []
        self._X, self._y = X, y
        # one stable argsort per column for the whole fit; ties keep row
        # order, so filtering these to any row subset reproduces a stable
        # argsort of that subset exactly
        sorted_idx = np.argsort(X, axis=0, kind="stable").T    # (k, n)
        self._grow(sorted_idx, depth=0, rng=rng)
        del self._X, self._y
        self._pack()
        return self

    def _grow(self, sorted_idx, depth, rng) -> int:
        idx = len(self.nodes)
        X, yfull = self._X, self._y
        y = yfull[sorted_idx[0]]
        self.nodes.append(_Node(value=self._leaf_value(y)))
        n = len(y)
        if (depth >= self.max_depth or n < self.min_samples_split
                or self._node_score(y) <= 1e-12):
            return idx
        k = sorted_idx.shape[0]
        if self.max_features is not None:
            m = max(1, int(self.max_features * k)) if isinstance(
                self.max_features, float) else min(self.max_features, k)
            feats = rng.choice(k, size=m, replace=False)
        else:
            feats = np.arange(k)

        best = (None, None, np.inf)                     # (feat, thresh, score)
        for f in feats:
            order = sorted_idx[f]
            cs = X[order, f]
            if cs[0] == cs[-1]:
                continue
            pos, score = self._best_split_col(yfull[order])
            # snap pos to a value boundary (can't split identical values)
            while pos < n and cs[pos] == cs[pos - 1]:
                pos += 1
            if pos >= n or pos < self.min_samples_leaf \
                    or n - pos < self.min_samples_leaf:
                continue
            if score < best[2]:
                best = (f, 0.5 * (cs[pos - 1] + cs[pos]), score)
        if best[0] is None or best[2] >= self._node_score(y) - 1e-12:
            return idx

        f, t, _ = best
        # every row of sorted_idx holds the same row set, so the left count
        # is shared and boolean masking reshapes back to rectangles
        go_left = X[sorted_idx, f] < t                  # (k, n)
        n_left = int(np.count_nonzero(go_left[0]))
        left_idx = sorted_idx[go_left].reshape(k, n_left)
        right_idx = sorted_idx[~go_left].reshape(k, n - n_left)
        node = self.nodes[idx]
        node.feature, node.threshold = int(f), float(t)
        node.left = self._grow(left_idx, depth + 1, rng)
        node.right = self._grow(right_idx, depth + 1, rng)
        return idx

    def _pack(self):
        """Freeze the node list into flat arrays for batch traversal."""
        self.feature_ = np.array([nd.feature for nd in self.nodes], np.int64)
        self.threshold_ = np.array([nd.threshold for nd in self.nodes],
                                   np.float64)
        self.left_ = np.array([nd.left for nd in self.nodes], np.int64)
        self.right_ = np.array([nd.right for nd in self.nodes], np.int64)
        self.leaf_value_ = self._pack_values([nd.value for nd in self.nodes])

    def _walk(self, X):
        """Vectorized traversal: leaf node index for every row of X."""
        X = np.asarray(X, np.float64)
        cur = np.zeros(len(X), np.int64)
        if len(X) == 0 or len(self.feature_) == 0:
            return cur
        active = np.nonzero(self.feature_[cur] >= 0)[0]
        while active.size:
            node = cur[active]
            go_left = X[active, self.feature_[node]] < self.threshold_[node]
            nxt = np.where(go_left, self.left_[node], self.right_[node])
            cur[active] = nxt
            active = active[self.feature_[nxt] >= 0]
        return cur

    def _walk_scalar(self, X):
        """Original per-row walker, retained as the equivalence oracle."""
        X = np.asarray(X, np.float64)
        out = np.zeros(len(X), int)
        for i, row in enumerate(X):
            j = 0
            while not self.nodes[j].is_leaf:
                nd = self.nodes[j]
                j = nd.left if row[nd.feature] < nd.threshold else nd.right
            out[i] = j
        return out

    @property
    def n_nodes(self):
        return len(self.nodes)


class DecisionTreeClassifier(_BaseTree):
    def fit(self, X, y):
        y = np.asarray(y)
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self.n_classes_ = len(self.classes_)
        return super().fit(X, y_enc)

    def _leaf_value(self, y):
        return np.bincount(y, minlength=self.n_classes_) / max(len(y), 1)

    def _node_score(self, y):
        p = np.bincount(y, minlength=self.n_classes_) / max(len(y), 1)
        return 1.0 - np.sum(p ** 2)

    def _best_split_col(self, y_sorted):
        return _gini_gain(y_sorted, self.n_classes_)

    def _pack_values(self, values):
        return np.stack(values).astype(np.float64, copy=False)

    def predict_proba(self, X):
        return self.leaf_value_[self._walk(X)]

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


class DecisionTreeRegressor(_BaseTree):
    def fit(self, X, y):
        return super().fit(X, np.asarray(y, np.float64))

    def _leaf_value(self, y):
        return float(np.mean(y)) if len(y) else 0.0

    def _node_score(self, y):
        return float(np.var(y)) if len(y) else 0.0

    def _best_split_col(self, y_sorted):
        return _var_gain(y_sorted)

    def _pack_values(self, values):
        return np.array(values, np.float64)

    def predict(self, X):
        return self.leaf_value_[self._walk(X)]


class RandomForestClassifier:
    """Bagged CART ensemble (bootstrap rows, sqrt-feature subsampling).

    ``fit`` concatenates the member trees' flat arrays (child pointers
    rebased, leaf tables stacked) so ``predict_proba`` walks all trees for
    all rows in one traversal instead of T sequential tree passes.
    """

    def __init__(self, n_estimators=20, max_depth=10, max_features="sqrt",
                 random_state=0, min_samples_leaf=1):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.max_features = max_features
        self.random_state = random_state
        self.min_samples_leaf = min_samples_leaf
        self.trees: list[DecisionTreeClassifier] = []

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        self.classes_ = np.unique(y)
        rng = np.random.default_rng(self.random_state)
        n = len(X)
        k = X.shape[1]
        mf = max(1, int(np.sqrt(k))) if self.max_features == "sqrt" else \
            self.max_features
        self.trees = []
        for t in range(self.n_estimators):
            rows = rng.integers(0, n, n)
            tree = DecisionTreeClassifier(
                max_depth=self.max_depth, max_features=mf,
                min_samples_leaf=self.min_samples_leaf,
                random_state=int(rng.integers(1 << 31)))
            tree.classes_ = self.classes_              # align class space
            tree.n_classes_ = len(self.classes_)
            yy = np.searchsorted(self.classes_, y[rows])
            _BaseTree.fit(tree, X[rows], yy)
            self.trees.append(tree)
        self._pack_forest()
        return self

    def _pack_forest(self):
        offs = np.cumsum([0] + [t.n_nodes for t in self.trees])
        self._roots = offs[:-1]
        self._feature = np.concatenate([t.feature_ for t in self.trees])
        self._threshold = np.concatenate([t.threshold_ for t in self.trees])
        self._left = np.concatenate(
            [np.where(t.left_ >= 0, t.left_ + o, -1)
             for t, o in zip(self.trees, offs)])
        self._right = np.concatenate(
            [np.where(t.right_ >= 0, t.right_ + o, -1)
             for t, o in zip(self.trees, offs)])
        self._leaf = np.concatenate([t.leaf_value_ for t in self.trees])

    def predict_proba(self, X):
        X = np.asarray(X, np.float64)
        n = len(X)
        T = len(self.trees)
        cur = np.repeat(self._roots, n)                # tree-major (T*n,)
        rows = np.tile(np.arange(n), T)
        if n and len(self._feature):
            active = np.nonzero(self._feature[cur] >= 0)[0]
            while active.size:
                node = cur[active]
                go_left = X[rows[active], self._feature[node]] \
                    < self._threshold[node]
                nxt = np.where(go_left, self._left[node], self._right[node])
                cur[active] = nxt
                active = active[self._feature[nxt] >= 0]
        return self._leaf[cur].reshape(T, n, -1).mean(axis=0)

    def predict_proba_scalar(self, X):
        """Per-tree scalar-walk reference (equivalence oracle)."""
        return np.mean([t.leaf_value_[t._walk_scalar(X)]
                        for t in self.trees], axis=0)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]
