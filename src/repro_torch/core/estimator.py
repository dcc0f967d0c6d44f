"""BlockSizeEstimator -- the paper's contribution, end to end (§III), the
port of the JAX package's ``repro/core/estimator.py`` (the same code over
the port's copies of ``core/{tuner,log,features,trees,chained}.py``).

fit():   execution log -> group by <d,a,e> -> argmin labels -> chained
         DT_r -> DT_c classifier over power-of-s partition classes.
predict(): (dataset, algorithm, environment) -> (p_r*, p_c*) and the block
         size S = (n/p_r*, m/p_c*).

The pipeline itself is ``core/tuner.py``'s shared
:class:`~repro_torch.core.tuner.Tuner`, which ``BlockSizeEstimator``
instantiates with the paper's power-of-``s`` search space and the model
registry in ``core/chained.py`` (``"tree"`` is the paper-faithful cascade).
``refit(new_records)`` folds fresh log records incrementally, retraining
only when some group's argmin label moved.

``EstimatorService`` is the block-size instantiation of the generic
``TunerService``: a shape-bucketed LRU memo with model-version-aware
invalidation, so serving a refit estimator never replays stale memos.
"""
from __future__ import annotations

import copy
import math

import numpy as np

from repro_torch.core.features import dataset_features
from repro_torch.core.log import canon_items
from repro_torch.core.tuner import (SearchSpace, Tuner, TuneQuery,
                                    TunerService)


class BlockSizeEstimator:
    def __init__(self, model: str = "tree", s: int = 2):
        self.model_name = model
        self.s = s
        self._tuner = Tuner(space=SearchSpace(s=s), model=model)

    # shared-subsystem internals, exposed read-only for introspection
    @property
    def model(self):
        return self._tuner.model

    @property
    def feature_order(self):
        return self._tuner.feature_order

    @property
    def model_version(self) -> int:
        return self._tuner.model_version

    @property
    def is_fit(self) -> bool:
        return self._tuner.is_fit

    @property
    def known_algos(self) -> frozenset:
        return self._tuner.known_algos

    def abstains(self, algo: str) -> bool:
        """True when the estimator declines to predict for ``algo`` (unfit,
        or no labeled training group for it).  The closed loop (the JAX
        package's ``eval/autorun.py``) falls back to the ds-array default
        square heuristic then."""
        return self._tuner.abstains(algo)

    def fit(self, log):
        self._tuner.fit(log)
        return self

    def refit(self, new_records) -> bool:
        """Incremental refit on fresh records (see ``Tuner.refit``); True
        iff the model changed -- services watching ``model_version`` drop
        their memos then."""
        return self._tuner.refit(new_records)

    def snapshot(self) -> "BlockSizeEstimator":
        """Deep copy for off-request-path refits (see ``Tuner.snapshot``):
        the serving tier's refit daemon folds new records into a snapshot
        and swaps it in, so the live estimator is never mutated while a
        shard is mid-predict."""
        return copy.deepcopy(self)

    # ------------------------------------------------------------- predict
    def predict_partitions(self, n_rows: int, n_cols: int, algo: str,
                           env_features: dict) -> tuple:
        return self.predict_partitions_batch(
            [(n_rows, n_cols, algo, env_features)])[0]

    def predict_partitions_batch(self, queries) -> list[tuple]:
        """Vectorized serving path: one featurize + one model pass for many
        ``(n_rows, n_cols, algo, env_features)`` queries."""
        return self._tuner.predict_batch(
            TuneQuery(dataset_features(nr, nc), algo, env,
                      cap_r=nr, cap_c=nc)
            for nr, nc, algo, env in queries)

    def predict_block_size(self, n_rows: int, n_cols: int, algo: str,
                           env_features: dict) -> tuple:
        """(r*, c*) = (n/p_r*, m/p_c*) -- the paper's §III-C output."""
        p_r, p_c = self.predict_partitions(n_rows, n_cols, algo, env_features)
        return int(np.ceil(n_rows / p_r)), int(np.ceil(n_cols / p_c))


class EstimatorService(TunerService):
    """Serving front-end over a fitted estimator: shape-bucketed LRU memo.

    Partition classes are powers of ``s``, so queries are canonicalized to
    the next power-of-two shape (``2^ceil(log2 rows)`` x same for cols) and
    memoized per (bucket shape, algo, env).  A memo hit skips the model
    entirely; all misses in a batch are answered by one
    ``predict_partitions_batch`` pass on the canonical shapes.  Results are
    clamped to each query's true shape on the way out, matching
    ``predict_partitions`` whenever the raw class fits the bucket shape.
    Inherited from ``TunerService``: post-``refit`` memo invalidation and
    the ``submit()``/``flush()`` micro-batching path.
    """

    def __init__(self, estimator: BlockSizeEstimator, maxsize: int = 4096):
        super().__init__(estimator, maxsize)
        self.estimator = estimator

    def swap_backend(self, backend) -> None:
        super().swap_backend(backend)
        self.estimator = backend

    @staticmethod
    def _bucket(n_rows: int, n_cols: int, algo: str, env: dict) -> tuple:
        br = 1 << max(0, math.ceil(math.log2(max(n_rows, 1))))
        bc = 1 << max(0, math.ceil(math.log2(max(n_cols, 1))))
        return (br, bc, algo, canon_items(env))

    # --- TunerService hooks: queries are (n_rows, n_cols, algo, env) ---
    def _key(self, query) -> tuple:
        return self._bucket(*query)

    def _canon_query(self, key, query):
        br, bc, algo, env = key
        return (br, bc, algo, dict(env))

    def _predict(self, queries):
        return self.estimator.predict_partitions_batch(queries)

    def _finalize(self, query, pred):
        p_r, p_c = pred
        return (min(p_r, query[0]), min(p_c, query[1]))

    predict_partitions_batch = TunerService.predict_batch
