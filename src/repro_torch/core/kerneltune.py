"""Block-size estimation for kernel tiles (the JAX package's
``core/kerneltune.py``, with the hardware and the tile rule as parameters).

The kernel-level instance of the paper's problem: choose (block_m, block_n,
block_k) / (block_q, block_k) for a given problem shape.  Two
execution-time oracles feed the same LogStore→Tuner loop:

* the **analytic cost model** (``matmul_tile_times`` / ``flash_tile_times``)
  -- a roofline over the tile choice (matrix-unit-aligned tiles, the tile
  rule's working-set fit with OOM -> inf, HBM-refetch traffic vs tile
  size, grid-launch overhead) on ``hw``;
* **measured timings** (``measure_case``) -- a pluggable
  ``kernels/timing.py`` backend (the CUDA kernel timed on the card, or the
  deterministic seeded simulator) over a *roofline-seeded* candidate set:
  the backend's own hardware model ranks the tile cube, tiles its rule
  refuses are pruned before any measurement, the survivors are
  batch-measured per power-of-two shape bucket, and results memoize in the
  LogStore under the ``kernel_measured`` source so re-measuring a bucket
  is free.

The defaults are the H100 (``core/roofline.py::H100``) and the blocked
matmul's shared-memory and register rule (``kernels/timing.py::
SMEM_RULE``).  ``hw=V5E`` with ``rule=VMEM_RULE`` reproduces the
reference tile for tile.  The H100 cost model keeps the reference's
formula (its 128-wide efficiency shape and launch overhead) and changes
only the roofline constants and the rule: it is the prior that the
measured tiles correct.

The estimator is the paper's chained DT cascade predicting tile exponents,
extended one link: a third chained stage (features ++ e_bm ++ e_bn ->
e_bk) predicts the reduction tile, so ``KernelTuner.predict`` returns a
full ``(bm, bn, bk)``.  ``KernelTunerService`` is the serving-tier
instantiation (shape-bucketed memo behind ``TunerService``).  A predicted
tile is returned as the cascade decodes it, as the reference does: a tile
the rule refuses is never swapped, and the kernel wrapper raises on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np

from repro_torch.core.features import featurize_batch, vectorize
from repro_torch.core.log import ExecutionLog, ExecutionRecord
from repro_torch.core.roofline import (H100, Hardware, mxu_efficiency,
                                       roofline_time)
from repro_torch.core.trees import DecisionTreeClassifier
from repro_torch.core.tuner import (ArgminLabeler, SearchSpace, Tuner,
                                    TuneQuery, TunerService)
from repro_torch.kernels.timing import (DTYPE_BYTES, SMEM_RULE, KernelCase,
                                        TileRule)

MXU = 128                         # matrix-unit edge of the efficiency model

#: LogStore source tag for backend-measured tile records.  Together with
#: the ``measured_env`` keys (kernel, dtype, timing backend) this keys the
#: measurement memo by (kernel, m, k, n, dtype, backend).
MEASURED_SOURCE = "kernel_measured"


def matmul_tile_times(m: int, k: int, n: int, bm, bn, bk,
                      *, hw: Hardware = H100, dtype_bytes: int = 2,
                      rule: TileRule = SMEM_RULE) -> np.ndarray:
    """Modeled kernel time, broadcast over whole tile grids at once.

    ``bm``/``bn``/``bk`` are any mutually-broadcastable integer arrays (or
    scalars); one numpy evaluation scores every tile candidate:
    max(MXU compute, HBM traffic) + launch overhead.  Tiling determines
    refetch: A is re-read n/bn times, B m/bm times -- the classic blocking
    trade-off the paper's "block size" controls.  Infeasible tiles
    (overhanging the problem, or refused by ``rule`` -- the paper's OOM)
    score ``inf``.
    """
    bm, bn, bk = np.broadcast_arrays(np.asarray(bm, np.float64),
                                     np.asarray(bn, np.float64),
                                     np.asarray(bk, np.float64))
    bad = (bm > m) | (bn > n) | (bk > k) \
        | ~rule.matmul_ok(bm, bn, bk, dtype_bytes)
    gm, gn, gk = np.ceil(m / bm), np.ceil(n / bn), np.ceil(k / bk)
    flops = 2.0 * (gm * bm) * (gn * bn) * (gk * bk)   # padded compute
    # MXU efficiency: partial tiles and sub-128 dims waste systolic slots
    eff = mxu_efficiency(bm, bn, mxu=MXU)
    traffic = (gn * m * k + gm * k * n) * dtype_bytes \
        + m * n * dtype_bytes                      # A refetched gn x, B gm x
    launch = gm * gn * gk * 1e-6                   # per-grid-step overhead
    t = roofline_time(flops, traffic, hw=hw, eff=eff) + launch
    return np.where(bad, np.inf, t)


def matmul_tile_time(m: int, k: int, n: int, bm: int, bn: int, bk: int,
                     *, hw: Hardware = H100, dtype_bytes: int = 2,
                     rule: TileRule = SMEM_RULE) -> float:
    """Scalar view of ``matmul_tile_times`` (kept for single-tile callers)."""
    return float(matmul_tile_times(m, k, n, bm, bn, bk, hw=hw,
                                   dtype_bytes=dtype_bytes, rule=rule))


def flash_tile_times(m: int, k: int, n: int, bq, bk, *, batch: int = 1,
                     heads: int = 1, causal: bool = True,
                     hw: Hardware = H100, dtype_bytes: int = 2,
                     rule: TileRule = SMEM_RULE) -> np.ndarray:
    """Analytic flash-attention tile cost, broadcast over (bq, bk) grids.

    ``m`` = query length, ``k`` = head dim, ``n`` = key/value length (the
    same (m, k, n) vocabulary as :class:`repro_torch.kernels.timing.KernelCase`).
    Q/O stream once; K and V are re-read once per query-row block -- the
    flash refetch trade-off bq controls.  Infeasible tiles (overhang, or
    refused by ``rule``) score ``inf``.
    """
    bq, bk = np.broadcast_arrays(np.asarray(bq, np.float64),
                                 np.asarray(bk, np.float64))
    bad = (bq > m) | (bk > n) | ~rule.flash_ok(bq, bk, k, dtype_bytes)
    gq, gk = np.ceil(m / bq), np.ceil(n / bk)
    live = 0.5 * (gk + 1.0) if causal else gk      # causal skips ~half
    flops = batch * heads * gq * (4.0 * bq * live * bk * k
                                  + 10.0 * bq * live * bk)
    eff = mxu_efficiency(bq, bk, mxu=MXU)
    traffic = batch * heads * (2.0 * m * k                 # Q in, O out
                               + gq * 2.0 * n * k) * dtype_bytes
    launch = batch * heads * gq * live * 1e-6
    t = roofline_time(flops, traffic, hw=hw, eff=eff) + launch
    return np.where(bad, np.inf, t)


def shape_features(m: int, k: int, n: int) -> dict:
    return {"rows": float(m), "cols": float(n), "inner": float(k),
            "log_rows": math.log2(m), "log_cols": math.log2(n),
            "log_inner": math.log2(k), "size_mb": m * k * 2 / 2**20}


BM_SWEEP = (64, 128, 256, 512)
BN_SWEEP = (64, 128, 256, 512)
BK_SWEEP = (128, 256, 512)

DEFAULT_BK = 128                  # fallback reduction tile (MXU-aligned)


def grid_search_matmul(m: int, k: int, n: int,
                       log: ExecutionLog | None = None, *, store=None,
                       hw: Hardware = H100, rule: TileRule = SMEM_RULE):
    """Sweep power-of-2 tiles; record modeled times (inf where ``rule``
    refuses the tile -- the paper's OOM).

    The whole (bm, bn, bk) cube is scored in a single broadcast evaluation
    of the cost model, and -- unlike the old fixed ``bk`` heuristic -- the
    reduction dimension is swept too.  The grid stays keyed by (bm, bn)
    (the tuner's two predicted exponents) with the best time over bk; the
    winning bk lands in the record meta.  ``store`` (a
    ``data/logstore.py`` LogStore) persists the sweep's records.
    """
    log = log or ExecutionLog()
    n0 = len(log.records)
    d = shape_features(m, k, n)
    bms = np.array(BM_SWEEP)[:, None, None]
    bns = np.array(BN_SWEEP)[None, :, None]
    bks = np.array(sorted({min(b, k) for b in BK_SWEEP}))[None, None, :]
    times = matmul_tile_times(m, k, n, bms, bns, bks, hw=hw,
                              rule=rule)                  # (bm, bn, bk)
    best_k = np.argmin(times, axis=2)
    grid = {}
    for i, bm in enumerate(BM_SWEEP):
        for j, bn in enumerate(BN_SWEEP):
            t = float(times[i, j, best_k[i, j]])
            grid[(bm, bn)] = t
            log.add(ExecutionRecord(d, "matmul_tile", dict(rule.env),
                                    bm, bn, t,
                                    {"bk": int(bks[0, 0, best_k[i, j]])}))
    if store is not None:
        store.append(log.records[n0:], source="kernel_grid")
    return log, grid


# ---------------------------------------------------------------------------
# Measured autotuning: roofline-seeded search over a timing backend
# ---------------------------------------------------------------------------

def bucket_pow2(x: int) -> int:
    """Next power of two >= x -- the shape-bucket granularity shared by
    measurement memoization and the serving memo (power-of-s tile classes
    cannot tell bucketed shapes apart anyway)."""
    return 1 << max(0, math.ceil(math.log2(max(int(x), 1))))


def bucket_case(case: KernelCase) -> KernelCase:
    """Canonical measurement target: free dims rounded up to powers of two
    (flash keeps the head dim exact -- it is an architecture constant, not
    a problem size), label dropped so zoo cases sharing a bucket share
    measurements."""
    if case.kernel == "flash":
        return dataclasses.replace(case, m=bucket_pow2(case.m),
                                   n=bucket_pow2(case.n), label="")
    return dataclasses.replace(case, m=bucket_pow2(case.m),
                               k=bucket_pow2(case.k),
                               n=bucket_pow2(case.n), label="")


def case_features(case: KernelCase) -> dict:
    """Dataset-feature dict for a measured record's <d> slot: the matmul
    ``shape_features`` vocabulary plus numeric dtype width (per-(model,
    shape, dtype) labels need dtype to reach the trees -- string env
    values never become features) and, for flash, the grid multipliers."""
    d = shape_features(case.m, case.k, case.n)
    d["dtype_bytes"] = float(case.dtype_bytes)
    if case.kernel == "flash":
        d["batch"] = float(case.batch)
        d["heads"] = float(case.heads)
        d["causal"] = 1.0 if case.causal else 0.0
    return d


def measured_env(case: KernelCase, backend) -> dict:
    """<e> slot for measured records: the backend's tile-rule env plus the
    string keys (kernel, dtype, timing backend), which separate measured
    triples from the analytic grid's triples in the LogStore and complete
    the (kernel, m, k, n, dtype, backend) memo key."""
    return {**backend.rule.env, "kernel": case.kernel, "dtype": case.dtype,
            "timing": getattr(backend, "name", str(backend))}


def tile_algo(kernel: str) -> str:
    return "flash_tile" if kernel == "flash" else "matmul_tile"


def prior_times(case: KernelCase, tiles, *, hw: Hardware = H100,
                rule: TileRule = SMEM_RULE) -> np.ndarray:
    """Analytic cost-model scores for candidate tiles of ``case`` -- the
    roofline prior that seeds (and ranks) the measured search."""
    if case.kernel == "flash":
        return np.array([float(flash_tile_times(
            case.m, case.k, case.n, t[0], t[1], batch=case.batch,
            heads=case.heads, causal=case.causal, hw=hw,
            dtype_bytes=case.dtype_bytes, rule=rule)) for t in tiles])
    return np.array([float(matmul_tile_times(
        case.m, case.k, case.n, t[0], t[1], t[2], hw=hw,
        dtype_bytes=case.dtype_bytes, rule=rule)) for t in tiles])


def candidate_tiles(case: KernelCase) -> list[tuple]:
    """The full sweep cube clamped to the case's (bucketed) shape:
    ``(bm, bn, bk)`` triples for matmul, ``(bq, bk)`` pairs for flash."""
    if case.kernel == "flash":
        bqs = sorted({min(b, bucket_pow2(case.m)) for b in BM_SWEEP})
        bks = sorted({min(b, bucket_pow2(case.n)) for b in BN_SWEEP})
        return [(bq, bk) for bq in bqs for bk in bks]
    bms = sorted({min(b, bucket_pow2(case.m)) for b in BM_SWEEP})
    bns = sorted({min(b, bucket_pow2(case.n)) for b in BN_SWEEP})
    bks = sorted({min(b, bucket_pow2(case.k)) for b in BK_SWEEP})
    return [(bm, bn, bk) for bm in bms for bn in bns for bk in bks]


def feasible_tiles(case: KernelCase, tiles, *,
                   rule: TileRule = SMEM_RULE) -> list[tuple]:
    """Prune tiles that ``rule`` refuses (working set over its budget, or
    any further limit it sets) -- applied *before* any backend call, so an
    infeasible tile is never measured."""
    if case.kernel == "flash":
        return [t for t in tiles if rule.fits(case, t[0], t[1])]
    return [t for t in tiles if rule.fits(case, t[0], t[1], t[2])]


def seed_tiles(case: KernelCase, *, max_pairs: int = 6,
               bk_per_pair: int = 2, hw: Hardware = H100,
               rule: TileRule = SMEM_RULE) -> list[tuple]:
    """Roofline-seeded candidate set: rank the (feasible) sweep cube by the
    analytic prior and keep the ``max_pairs`` best (bm, bn) pairs, each
    with its ``bk_per_pair`` best reduction tiles -- the shortlist a
    backend actually measures, instead of the full cube.  ``case`` should
    already be bucketed (``bucket_case``); overhanging tiles never appear
    because candidates are clamped to the bucketed shape.
    """
    tiles = feasible_tiles(case, candidate_tiles(case), rule=rule)
    times = prior_times(case, tiles, hw=hw, rule=rule)
    order = np.argsort(times, kind="stable")
    if case.kernel == "flash":
        keep = [tiles[i] for i in order if np.isfinite(times[i])]
        return keep[:max_pairs]
    # dict insertion order = best-first pair order (a pair first appears
    # in `order` at its best bk); each pair's list is time-ascending
    by_pair: dict[tuple, list] = {}
    for i in order:
        if not np.isfinite(times[i]):
            continue
        bm, bn, bk = tiles[i]
        by_pair.setdefault((bm, bn), []).append((bm, bn, bk))
    out = []
    for pair in list(by_pair)[:max_pairs]:
        out.extend(by_pair[pair][:bk_per_pair])
    return out


def measure_case(case: KernelCase, backend, store=None, *, tiles=None,
                 max_pairs: int = 6, bk_per_pair: int = 2):
    """Measure one case through a timing backend, memoized in ``store``.

    The case is bucketed, candidates come from ``seed_tiles`` on the
    backend's ``hw`` and ``rule`` (or the caller's ``tiles``), tiles the
    rule refuses are pruned, and (bm, bn) pairs
    already present in the store under ``MEASURED_SOURCE`` are *not*
    re-measured (the cache-hit path).  Missing pairs go to the backend in
    one batched ``measure`` call; each pair's best-over-bk time is
    appended as an ``ExecutionRecord`` with the winning ``bk`` (matmul) in
    its meta.  Returns ``(records, stats)`` where ``records`` covers both
    cached and fresh pairs and ``stats`` counts
    ``{"measured", "cached", "pruned"}``.
    """
    bcase = bucket_case(case)
    env = measured_env(bcase, backend)
    dataset = case_features(bcase)
    algo = tile_algo(bcase.kernel)
    if tiles is None:
        tiles = seed_tiles(bcase, max_pairs=max_pairs,
                           bk_per_pair=bk_per_pair, hw=backend.hw,
                           rule=backend.rule)
    n_raw = len(tiles)
    tiles = feasible_tiles(bcase, tiles, rule=backend.rule)
    stats = {"measured": 0, "cached": 0, "pruned": n_raw - len(tiles)}
    cached = {}
    if store is not None:
        cached = store.group_cells(dataset, algo, env,
                                   source=MEASURED_SOURCE)
    pairs = []
    for t in tiles:                       # first-occurrence pair order
        if (t[0], t[1]) not in pairs:
            pairs.append((t[0], t[1]))
    hit = [p for p in pairs if p in cached]
    stats["cached"] = len(hit)
    missing = [t for t in tiles if (t[0], t[1]) not in cached]
    fresh: list[ExecutionRecord] = []
    if missing:
        secs = backend.measure(bcase, missing)
        stats["measured"] = len(missing)
        best: dict[tuple, tuple] = {}
        for t, sec in zip(missing, secs):
            pair = (int(t[0]), int(t[1]))
            if pair not in best or sec < best[pair][0]:
                best[pair] = (float(sec), t)
        for pair, (sec, t) in best.items():
            meta = {"backend": env["timing"], "label": case.label}
            if bcase.kernel != "flash":
                meta["bk"] = int(t[2])
            fresh.append(ExecutionRecord(dataset, algo, env,
                                         pair[0], pair[1], sec, meta))
        if store is not None:
            store.append(fresh, source=MEASURED_SOURCE)
    records = [cached[p] for p in hit] + fresh
    return records, stats


def measure_cases(cases, backend, store=None, **kw):
    """Batch-measure many cases, deduplicated per shape bucket: zoo
    configs landing in the same bucketed ``KernelCase`` are timed once.
    Returns ``(records, stats)`` with aggregate counters (``bucket_hits``
    counts cases answered entirely by an earlier case's bucket)."""
    stats = {"cases": 0, "measured": 0, "cached": 0, "pruned": 0,
             "bucket_hits": 0}
    seen: set = set()
    records: list[ExecutionRecord] = []
    for case in cases:
        stats["cases"] += 1
        bkey = (bucket_case(case).key(),
                getattr(backend, "name", str(backend)))
        if bkey in seen:
            stats["bucket_hits"] += 1
            continue
        seen.add(bkey)
        recs, st = measure_case(case, backend, store, **kw)
        records.extend(recs)
        for key in ("measured", "cached", "pruned"):
            stats[key] += st[key]
    return records, stats


# ---------------------------------------------------------------------------
# The tuner: chained DT over (e_bm, e_bn) plus the e_bk third stage
# ---------------------------------------------------------------------------

def _tile_query(m: int, k: int, n: int, dtype: str = "bfloat16",
                env: dict | None = None) -> TuneQuery:
    d = shape_features(m, k, n)
    d["dtype_bytes"] = float(DTYPE_BYTES.get(dtype, 2))
    return TuneQuery(d, "matmul_tile", dict(env or SMEM_RULE.env),
                     cap_r=m, cap_c=n)


def _flash_query(m: int, k: int, n: int, dtype: str = "bfloat16",
                 env: dict | None = None) -> TuneQuery:
    case = KernelCase("flash", m, k, n, dtype=dtype)
    return TuneQuery(case_features(case), "flash_tile",
                     dict(env or SMEM_RULE.env), cap_r=m, cap_c=n)


class _TileLabeler(ArgminLabeler):
    """ArgminLabeler that also remembers the winning record's meta (where
    the grid search and ``measure_case`` stash the best ``bk``), and
    treats a moved ``bk`` as a label change so the third stage retrains."""

    def __init__(self, space, featurize_record=None):
        super().__init__(space, featurize_record)
        self.meta: dict = {}

    def observe(self, records) -> bool:
        changed = False
        for r in records:
            key = r.triple_key()
            cur = self._best.setdefault(key, None)
            if not math.isfinite(r.time_s):
                continue
            if cur is None or r.time_s < cur[0]:
                new_meta = dict(r.meta or {})
                if cur is None or (cur[1], cur[2]) != (r.p_r, r.p_c) \
                        or self.meta.get(key, {}).get("bk") \
                        != new_meta.get("bk"):
                    changed = True
                self._best[key] = (r.time_s, r.p_r, r.p_c)
                self._feats[key] = self._featurize(r)
                self.meta[key] = new_meta
        return changed


class _BkStage:
    """DT_bk -- the third link of the cascade: features ++ e_bm ++ e_bn ->
    e_bk, trained on the per-group winning ``bk`` the labeler carries in
    record meta.  Fixes the pre-refactor gap where the swept ``block_k``
    winner was stored but never predicted."""

    def __init__(self, max_depth: int = 10):
        self.max_depth = max_depth
        self.clf = None

    def fit(self, tuner: Tuner) -> "_BkStage":
        lab = tuner.labeler
        meta = getattr(lab, "meta", {})
        feats, e_r, e_c, y = [], [], [], []
        for key, cur in lab._best.items():
            if cur is None:
                continue
            bk = meta.get(key, {}).get("bk")
            if bk is None:
                continue
            feats.append(lab._feats[key])
            e_r.append(tuner.space.encode(cur[1]))
            e_c.append(tuner.space.encode(cur[2]))
            y.append(tuner.space.encode(bk))
        if not feats:
            self.clf = None
            return self
        X, _ = vectorize(feats, tuner.feature_order)
        Xc = np.column_stack([X, np.asarray(e_r, np.float64),
                              np.asarray(e_c, np.float64)])
        self.clf = DecisionTreeClassifier(max_depth=self.max_depth) \
            .fit(Xc, np.asarray(y))
        return self

    def predict(self, X, e_r, e_c) -> np.ndarray:
        """Vectorized bk values (not exponents) for a query matrix."""
        Xc = np.column_stack([np.asarray(X, np.float64),
                              np.asarray(e_r, np.float64),
                              np.asarray(e_c, np.float64)])
        return 2 ** self.clf.predict(Xc)


class KernelTuner:
    """Chained DT over tile exponents -- the kernel instantiation of the
    shared ``core/tuner.py`` subsystem, one per kernel family.

    ``kernel="matmul"`` predicts full ``(bm, bn, bk)`` tiles (the third
    chained stage supplies ``bk``; ``DEFAULT_BK`` when the training log
    carries no ``bk`` evidence).  ``kernel="flash"`` predicts
    ``(block_q, block_k)`` pairs.  Fit it on the analytic grid
    (``grid_search_matmul``/``build_training_log``) or on measured records
    (``store.load(algos=..., source=MEASURED_SOURCE)``) -- the label
    pipeline is identical.  ``rule`` is the tile rule of the records it
    learns from: its env fills the queries.
    """

    def __init__(self, kernel: str = "matmul", *,
                 rule: TileRule = SMEM_RULE):
        if kernel not in ("matmul", "flash"):
            raise ValueError(f"kernel must be matmul|flash, got {kernel!r}")
        self.kernel = kernel
        self.rule = rule
        row, col = (("block_q", "block_k") if kernel == "flash"
                    else ("block_m", "block_n"))
        self.tuner = Tuner(
            space=SearchSpace(s=2, row=row, col=col),
            labeler_factory=lambda: _TileLabeler(
                SearchSpace(s=2, row=row, col=col)))
        self._bk = _BkStage() if kernel == "matmul" else None
        self.model_version = 0    # bumps when either cascade stage retrains

    # ----------------------------------------------------------- training
    def fit(self, log) -> "KernelTuner":
        self.tuner.fit(log)
        self._post_train()
        return self

    def refit(self, new_records) -> bool:
        if not self.tuner.refit(new_records):
            return False
        self._post_train()
        return True

    def _post_train(self):
        if self._bk is not None:
            self._bk.fit(self.tuner)
        self.model_version += 1

    # ------------------------------------------------------------ serving
    @property
    def is_fit(self) -> bool:
        return self.tuner.is_fit

    @property
    def known_algos(self) -> frozenset:
        return self.tuner.known_algos

    def abstains(self, algo: str) -> bool:
        return self.tuner.abstains(algo)

    def snapshot(self) -> "KernelTuner":
        import copy
        return copy.deepcopy(self)

    def _query(self, m, k, n, dtype="bfloat16") -> TuneQuery:
        q = _flash_query if self.kernel == "flash" else _tile_query
        return q(m, k, n, dtype, self.rule.env)

    def predict(self, m: int, k: int, n: int, dtype: str = "bfloat16"):
        return self.predict_batch([(m, k, n, dtype)])[0]

    def predict_batch(self, shapes) -> list[tuple]:
        """Tiles for many ``(m, k, n[, dtype])`` shapes in one cascade
        pass: ``(bm, bn, bk)`` triples for matmul, ``(bq, bk)`` pairs for
        flash."""
        shapes = [tuple(s) for s in shapes]
        if not shapes:
            return []
        if not self.is_fit:
            raise RuntimeError("predict before fit()")
        queries = [self._query(*s) for s in shapes]
        tuner = self.tuner
        feats = featurize_batch((q.dataset, q.algo, q.env) for q in queries)
        X, _ = vectorize(feats, tuner.feature_order)
        E = tuner.model.predict(X)
        pairs = [tuner.space.decode(er, ec, q.cap_r, q.cap_c)
                 for q, (er, ec) in zip(queries, E)]
        if self.kernel == "flash":
            return pairs
        if self._bk.clf is not None:
            bks = self._bk.predict(X, E[:, 0], E[:, 1])
        else:
            bks = np.full(len(shapes), DEFAULT_BK)
        return [(bm, bn, int(min(int(bk), bucket_pow2(s[1]))))
                for (bm, bn), bk, s in zip(pairs, bks, shapes)]


class KernelQuery(NamedTuple):
    """One tile-serving query; carries ``algo`` for the serving tier's
    abstain checks."""
    m: int
    k: int
    n: int
    dtype: str = "bfloat16"
    algo: str = "matmul_tile"


def default_tile(query) -> tuple:
    """Abstain fallback: the default the kernel wrappers use, clamped to
    the problem -- ``(128, 128, 128)`` for matmul, ``(128, 128)`` for
    flash."""
    if getattr(query, "algo", "matmul_tile") == "flash_tile":
        return (min(128, query.m), min(128, query.n))
    return (min(128, query.m), min(128, query.n), min(128, query.k))


class KernelTunerService(TunerService):
    """Tile-serving instantiation of :class:`TunerService`: queries are
    :class:`KernelQuery`; the memo key is the power-of-two shape bucket
    (plus dtype and algo), predictions are computed on the bucket dims and
    clamped back to the raw problem on the way out -- the same
    canonicalization ``EstimatorService`` does for ds-array shapes, so
    serving-path predictions match direct ``KernelTuner.predict`` on
    power-of-two shapes exactly."""

    def __init__(self, tuner: KernelTuner, maxsize: int = 4096):
        super().__init__(tuner, maxsize)
        self.tuner = tuner

    def swap_backend(self, backend) -> None:
        super().swap_backend(backend)
        self.tuner = backend

    def _key(self, query) -> tuple:
        return (bucket_pow2(query.m), bucket_pow2(query.k),
                bucket_pow2(query.n), query.dtype, query.algo)

    def _canon_query(self, key, query):
        return key

    def _predict(self, canon) -> list:
        return self.tuner.predict_batch(
            [(m, k, n, dtype) for m, k, n, dtype, _algo in canon])

    def _finalize(self, query, pred):
        if len(pred) == 3:
            bm, bn, bk = pred
            return (min(bm, query.m), min(bn, query.n), min(bk, query.k))
        bq, bk = pred
        return (min(bq, query.m), min(bk, query.n))


def build_training_log(seed: int = 0, n_shapes: int = 40, *,
                       store=None, hw: Hardware = H100,
                       rule: TileRule = SMEM_RULE) -> ExecutionLog:
    """The analytic training log: cost-model grids over ``n_shapes``
    seeded power-of-two GEMM shapes on ``hw`` under ``rule``."""
    rng = np.random.default_rng(seed)
    log = ExecutionLog()
    for _ in range(n_shapes):
        m = 2 ** rng.integers(7, 14)
        k = 2 ** rng.integers(7, 13)
        n = 2 ** rng.integers(7, 14)
        log, _ = grid_search_matmul(int(m), int(k), int(n), log, store=store,
                                    hw=hw, rule=rule)
    return log
