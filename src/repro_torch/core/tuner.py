"""Shared tuning subsystem (DESIGN.md §8), the port of the JAX package's
``repro/core/tuner.py``: the search space, the argmin labeler, the tuner,
the serving memo and the one learning decision (``fold_records``).

The paper's pipeline — execution log → argmin labels → chained DT_r→DT_c →
predict — used to be implemented three separate times (ds-array block
sizes, Pallas tile exponents, mesh (dp, microbatch) cells).  This module is
the one implementation all three instantiate:

* :class:`SearchSpace` — two power-of-``s`` exponent axes with floor/cap
  clamping (the only per-tuner decode difference).
* :class:`ArgminLabeler` — incremental §III-B extraction: records fold into
  running per-group argmin state, so a refit scans only the *new* records
  and knows whether any group's label actually moved.
* :class:`Tuner` — fit/refit/predict_batch over a pluggable cascade model
  (``core/chained.py``'s registry, or any ``fit(X, y_r, y_c)`` /
  ``predict(X) -> (n, 2)`` object).  ``model_version`` increments on every
  retrain; ``refit`` warm-retrains only when new records change labels.
* :class:`TunerService` — memoizing, refit-aware serving front-end:
  LRU memo, model-version-aware invalidation (a refit can never serve a
  stale prediction), and a micro-batching ``submit()``/``flush()`` path.

``BlockSizeEstimator`` (core/estimator.py), ``KernelTuner``
(core/kerneltune.py) and ``MeshTuner`` (core/meshtune.py) are thin
instantiations; persistent multi-sweep log storage is
``data/logstore.py``'s :class:`LogStore`.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from collections import OrderedDict
from functools import partial

import numpy as np

from repro_torch.core.chained import make_model
from repro_torch.core.features import featurize, featurize_batch, vectorize
from repro_torch.core.log import ExecutionLog, canon_items

__all__ = ["SearchSpace", "TuneQuery", "ArgminLabeler", "Tuner",
           "TunerService", "fold_records"]


def fold_records(model, records) -> bool:
    """Fold measured records into a tuner-like ``model`` (anything with
    ``is_fit``/``refit``/``fit``): incremental ``refit`` when fitted, a
    first-evidence ``fit`` otherwise (a one-group log is enough to stand a
    model up).  Returns True iff the model changed; False also covers the
    all-OOM case where no finite-time group exists yet.  The one learning
    decision shared by ``ShardRouter.refit``, the ``serve/refit.py``
    daemon, and ``eval/autorun.py``'s in-place path."""
    if model.is_fit:
        return bool(model.refit(records))
    try:
        model.fit(records)
    except ValueError:                    # no finite-time groups yet
        return False
    return True


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Two power-of-``s`` exponent axes, row axis first (cascade order:
    "partitioning along the rows is generally more relevant", paper
    §III-C).  ``decode`` clamps exponents to ``min_exp`` and values to the
    per-query caps."""
    s: int = 2
    row: str = "p_r"
    col: str = "p_c"
    min_exp: int = 0

    def decode(self, e_r, e_c, cap_r=None, cap_c=None) -> tuple[int, int]:
        r = self.s ** max(int(e_r), self.min_exp)
        c = self.s ** max(int(e_c), self.min_exp)
        if cap_r is not None:
            r = min(r, cap_r)
        if cap_c is not None:
            c = min(c, cap_c)
        return int(r), int(c)

    def encode(self, value) -> int:
        """Partition count -> class exponent (log base ``s``, rounded)."""
        return int(round(math.log(max(value, 1)) / math.log(self.s)))


@dataclasses.dataclass(frozen=True)
class TuneQuery:
    """One serving query in the paper's <d, a, e> schema, plus the caps the
    decoded partition counts must respect (rows/cols for ds-arrays, m/n for
    tiles, chips for mesh dp)."""
    dataset: dict
    algo: str
    env: dict
    cap_r: int | None = None
    cap_c: int | None = None

    def key(self) -> tuple:
        return (canon_items(self.dataset), self.algo, canon_items(self.env),
                self.cap_r, self.cap_c)


def _featurize_record(r):
    """Default record featurization — module-level (not a lambda) so a
    fitted tuner pickles into serving-fleet worker processes."""
    return featurize(r.dataset, r.algo, r.env)


class ArgminLabeler:
    """Incremental argmin labeling: ``observe`` folds records into running
    per-group minima, ``pairs`` emits (feature dicts, y_r, y_c).

    Group order is first occurrence and ties keep the earliest record, so
    on the same record stream ``pairs()`` reproduces
    ``ExecutionLog.training_set`` exactly — the byte-identical-parity
    contract the port of the three tuners rests on.  Featurization is
    cached per group, so a refit featurizes only changed groups.
    """

    def __init__(self, space: SearchSpace, featurize_record=None):
        self.space = space
        self._featurize = featurize_record or _featurize_record
        # key -> (best time, p_r, p_c) | None while the group has no finite
        # cell; dict order = first-occurrence order
        self._best: dict = {}
        self._feats: dict = {}

    def observe(self, records) -> bool:
        """Fold records; True iff any group's argmin *label* changed (a
        better time at the same (p_r, p_c) is not a label change)."""
        changed = False
        for r in records:
            key = r.triple_key()
            cur = self._best.setdefault(key, None)
            if not math.isfinite(r.time_s):
                continue
            if cur is None or r.time_s < cur[0]:
                if cur is None or (cur[1], cur[2]) != (r.p_r, r.p_c):
                    changed = True
                self._best[key] = (r.time_s, r.p_r, r.p_c)
                self._feats[key] = self._featurize(r)
        return changed

    def pairs(self):
        feats, yr, yc = [], [], []
        for key, cur in self._best.items():
            if cur is None:
                continue
            feats.append(self._feats[key])
            yr.append(self.space.encode(cur[1]))
            yc.append(self.space.encode(cur[2]))
        return feats, np.array(yr), np.array(yc)

    @property
    def n_labeled(self) -> int:
        return sum(1 for v in self._best.values() if v is not None)

    def algos(self) -> set:
        """Algorithm names with at least one finite-time (labeled) group —
        what the tuner has actually seen argmin evidence for."""
        return {key[1] for key, v in self._best.items() if v is not None}


class Tuner:
    """The shared tuner: log -> labels -> cascade -> batched predictions.

    ``model`` names a registry entry (``core/chained.py``); pass
    ``model_factory`` for a custom cascade (e.g. MeshTuner's deeper trees).
    """

    def __init__(self, space: SearchSpace | None = None,
                 model: str = "tree", model_factory=None,
                 labeler_factory=None):
        self.space = space or SearchSpace()
        self.model_name = model if model_factory is None else "custom"
        # partial() of named callables, not lambdas: a Tuner (and every
        # estimator wrapping one) must pickle across the serving-fleet
        # process boundary (serve/transport.py)
        self._factory = model_factory or partial(
            make_model, model, s=self.space.s)
        self._labeler_factory = labeler_factory or partial(
            ArgminLabeler, self.space)
        self.labeler = self._labeler_factory()
        self.model = None
        self.feature_order = None
        self.model_version = 0
        self._known_algos: frozenset = frozenset()

    # ----------------------------------------------------------- training
    def fit(self, log) -> "Tuner":
        """Full fit from an ``ExecutionLog`` (or record iterable).  Resets
        any previously folded state: like the pre-refactor tuners, fitting
        twice trains on the second log alone (``refit`` accumulates)."""
        self.labeler = self._labeler_factory()
        self.labeler.observe(self._records(log))
        self._train()
        return self

    def refit(self, new_records) -> bool:
        """Incremental refit: fold only the new records (O(new), not
        O(log)) and retrain just when some group's argmin label changed.
        Returns True iff the model was retrained — ``model_version`` bumps
        then, which is what flushes :class:`TunerService` memos."""
        if not self.labeler.observe(self._records(new_records)):
            return False
        self._train()
        return True

    @staticmethod
    def _records(log):
        return log.records if isinstance(log, ExecutionLog) else list(log)

    def _train(self):
        feats, yr, yc = self.labeler.pairs()
        if not feats:
            raise ValueError("log has no finite-time groups")
        X, self.feature_order = vectorize(feats)
        self.model = self._factory()
        self.model.fit(X, yr, yc)
        self._known_algos = frozenset(self.labeler.algos())
        self.model_version += 1

    # ------------------------------------------------------------ serving
    @property
    def is_fit(self) -> bool:
        return self.model is not None

    @property
    def known_algos(self) -> frozenset:
        """Algorithms the current model was trained on (labeled groups at
        the last (re)train).  Empty before ``fit``."""
        return self._known_algos

    def abstains(self, algo: str) -> bool:
        """True when the tuner declines to predict for ``algo``: either no
        model is fitted yet, or the training log contained no labeled group
        for that algorithm (the one-hot column is all-zero, so the cascade
        would answer from unrelated workloads).  Callers fall back to their
        domain default — see ``eval/autorun.py``'s closed loop."""
        return not self.is_fit or algo not in self._known_algos

    def predict_batch(self, queries) -> list[tuple[int, int]]:
        """One featurize + one cascade pass for any number of
        :class:`TuneQuery`; decoded through the search space's clamps."""
        queries = list(queries)
        if not queries:
            return []
        if self.model is None:
            raise RuntimeError("predict before fit()")
        feats = featurize_batch((q.dataset, q.algo, q.env) for q in queries)
        X, _ = vectorize(feats, self.feature_order)
        E = self.model.predict(X)
        return [self.space.decode(er, ec, q.cap_r, q.cap_c)
                for q, (er, ec) in zip(queries, E)]

    def predict(self, query: TuneQuery) -> tuple[int, int]:
        return self.predict_batch([query])[0]

    def snapshot(self) -> "Tuner":
        """Deep copy of the whole tuner (labeler state, model, version) for
        off-request-path refits: fold and retrain the copy while the
        original keeps serving, then atomically swap the copy in
        (``TunerService.swap_backend``).  ``model_version`` carries over,
        so a retrained snapshot invalidates serving memos for free."""
        return copy.deepcopy(self)


class _Pending:
    """Handle returned by ``TunerService.submit``; resolved at ``flush``."""
    __slots__ = ("query", "done", "_result")

    def __init__(self, query):
        self.query = query
        self.done = False
        self._result = None

    def result(self):
        if not self.done:
            raise RuntimeError("prediction pending -- flush() the service")
        return self._result


class TunerService:
    """Serving front-end over a fitted tuner: LRU memo + refit awareness.

    The memo is valid for exactly one ``backend.model_version``: every
    entry point compares the backend's version against the one the memo
    was filled under and clears it on mismatch, so a ``refit`` can never
    serve stale predictions (``invalidations`` counts the flushes).

    ``submit()`` queues a query and returns a handle; ``flush()`` answers
    the whole queue through one memo pass + one batched model call — the
    request-aggregation path for high-traffic serving.

    Subclasses override ``_key`` (memo key), ``_canon_query`` (the query
    actually sent to the model for a missed key — e.g. EstimatorService's
    power-of-two bucket shapes), ``_predict`` and ``_finalize`` (per-query
    post-processing of a memoized result).
    """

    def __init__(self, backend, maxsize: int = 4096):
        self.backend = backend
        self.maxsize = maxsize
        self._memo: OrderedDict = OrderedDict()
        self._seen_version = getattr(backend, "model_version", None)
        self._queue: list[_Pending] = []
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    # ------------------------------------------------------- overridables
    def _key(self, query) -> tuple:
        return query.key()

    def _canon_query(self, key, query):
        return query

    def _predict(self, queries) -> list:
        return self.backend.predict_batch(queries)

    def _finalize(self, query, pred):
        return pred

    # ------------------------------------------------------------ serving
    def swap_backend(self, backend) -> None:
        """Point the service at a new backend (typically a refit
        ``Tuner.snapshot``).  The memo is not cleared here: the next entry
        point's version check flushes it iff the versions differ.  When a
        *different* backend object arrives carrying the version the memo
        was filled under (two refitters racing from the same snapshot),
        the memo is flushed eagerly — version equality would otherwise
        mask the swap.  Callers must serialize this with in-flight
        predictions (the shard router holds its per-shard lock across
        both; see ``serve/router.py``)."""
        if backend is not self.backend and \
                getattr(backend, "model_version", None) == self._seen_version:
            if self._memo:
                self.invalidations += 1
            self._memo.clear()
        self.backend = backend

    def _check_version(self):
        v = getattr(self.backend, "model_version", None)
        if v != self._seen_version:
            if self._memo:
                self.invalidations += 1
            self._memo.clear()
            self._seen_version = v

    def predict_batch(self, queries) -> list:
        queries = list(queries)
        self._check_version()
        keys = [self._key(q) for q in queries]
        resolved: dict = {}
        missing: list = []
        miss_queries: list = []
        for q, key in zip(queries, keys):
            if key in resolved:
                self.hits += 1
            elif key in self._memo:
                self._memo.move_to_end(key)
                resolved[key] = self._memo[key]
                self.hits += 1
            else:
                resolved[key] = ()                 # placeholder; filled below
                missing.append(key)
                miss_queries.append(q)
                self.misses += 1
        if missing:
            canon = [self._canon_query(k, q)
                     for k, q in zip(missing, miss_queries)]
            preds = self._predict(canon)
            for key, pred in zip(missing, preds):
                resolved[key] = pred
                self._memo[key] = pred
                if len(self._memo) > self.maxsize:
                    self._memo.popitem(last=False)
        return [self._finalize(q, resolved[key])
                for q, key in zip(queries, keys)]

    def predict(self, query):
        return self.predict_batch([query])[0]

    # ----------------------------------------------- micro-batching path
    def submit(self, query) -> _Pending:
        p = _Pending(query)
        self._queue.append(p)
        return p

    def flush(self) -> list:
        """Answer every queued query in one batched pass; resolves the
        handles ``submit`` returned and returns the results in order.  The
        queue is consumed only on success, so a failed flush (e.g. against
        an unfitted tuner) leaves every submission intact for retry."""
        if not self._queue:
            return []
        results = self.predict_batch([p.query for p in self._queue])
        pending, self._queue = self._queue, []
        for p, r in zip(pending, results):
            p._result = r
            p.done = True
        return results

    def discard_pending(self) -> int:
        """Drop every queued submission (handles stay unresolved); the
        recovery path for callers that answer each request exactly once —
        e.g. a shard worker failing a batch — where ``flush``'s
        keep-for-retry contract would replay dead queries.  Returns the
        number discarded."""
        n = len(self._queue)
        self._queue.clear()
        return n

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0
