"""Closed-loop autotuned execution (DESIGN.md §9), the port of the JAX
package's ``repro/eval/autorun.py``.

The paper's deployment story, end to end: an application hands
``AutoTunedRun`` a ``<dataset, algorithm, environment>`` triple; the
driver asks the serving estimator for a partitioning ``(p_r, p_c)``
(falling back to the ds-array-style default square heuristic when the
model abstains — unfit, or no labeled group for the algorithm), builds
the ``DistArray`` from the tensor on its device, executes the real
workload on the task-graph runtime, appends the measured record to the
persistent ``LogStore`` under the ``"autorun"`` provenance tag, and
triggers an incremental ``Tuner.refit`` — so every live run becomes
training data and the next prediction is at least as informed.  The §8
invalidation contract is what makes this safe to serve through: a refit
that moves any argmin label bumps ``model_version``, and the
``EstimatorService`` memo flushes before the next prediction.

A record's copy in the store carries the device that timed it
(``logstore.ds_timing``); the record the result holds, and the one the
model learns from, is the reference's, untagged.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.algorithms import kmeans as kmeans_mod
from repro_torch.algorithms import partition_and_run
from repro_torch.core.estimator import BlockSizeEstimator, EstimatorService
from repro_torch.core.features import dataset_features
from repro_torch.core.log import ExecutionRecord
from repro_torch.core.tuner import fold_records
from repro_torch.data.distarray import DistArray
from repro_torch.data.executor import Environment, TaskExecutor, TaskMemoryError
from repro_torch.data.logstore import timed_copies
from repro_torch.device import synchronize

#: Algorithms the elastic runner can pause at an iteration boundary and
#: resume on a repartitioned array (they expose ``init_centers``-style
#: warm starts).  The others would need checkpointed state threading.
ELASTIC_ALGOS = {"kmeans"}


def default_partitioning(n_rows: int, n_cols: int, env: Environment,
                         s: int = 2) -> tuple[int, int]:
    """The ds-array-style default square-blocking heuristic the paper
    compares against: the smallest power-of-``s`` grid with at least one
    block per worker, grown as square as the shape allows (rows split
    first on ties — "partitioning along the rows is generally more
    relevant", §III-C), with each axis capped by the array's extent."""
    target = max(int(env.n_workers), 1)
    p_r = p_c = 1
    while p_r * p_c < target and (p_r * s <= n_rows or p_c * s <= n_cols):
        if p_r * s <= n_rows and (p_r <= p_c or p_c * s > n_cols):
            p_r *= s
        else:
            p_c *= s
    return p_r, p_c


@dataclasses.dataclass(frozen=True)
class EnvChange:
    """A mid-run cluster event: after Lloyd iteration ``after_iter`` the
    environment becomes ``env`` (worker loss, scale-up, re-mesh...)."""
    after_iter: int
    env: Environment
    reason: str = "resize"


def live_repartition(Xd: DistArray, p_r: int, p_c: int):
    """Repartition an in-flight ``DistArray`` toward a ``p_r x p_c`` grid
    with the cheapest valid move; returns ``(array, method)``.

    * ``refine`` -- the target nests inside the current grid (both factors
      integral): pure views via :meth:`DistArray.refine`, no copies.
    * ``keep`` -- the target is the current grid, or coarser on both axes:
      a finer-than-asked grid is still a correct partitioning, so the
      array is kept and only the remaining DAG is re-costed (coarsening
      in flight would pay a full copy for no correctness gain).
    * ``rebuild`` -- mixed finer/coarser target that does not nest:
      assemble and re-partition (the copy a restart would also pay).
    """
    if (p_r, p_c) == (Xd.p_r, Xd.p_c):
        return Xd, "keep"
    if p_r % Xd.p_r == 0 and p_c % Xd.p_c == 0:
        return Xd.refine(p_r // Xd.p_r, p_c // Xd.p_c), "refine"
    if p_r <= Xd.p_r and p_c <= Xd.p_c:
        return Xd, "keep"
    return DistArray.from_array(Xd.to_array(), p_r, p_c), "rebuild"


@dataclasses.dataclass
class ElasticRunResult:
    """Outcome of one elastic closed-loop run (recovery vs restart)."""
    algo: str
    shape: tuple
    partitions: list            # [(p_r, p_c), ...] per segment
    chosen_by: list             # per-segment "model" | "default"
    repartition: str            # "refine" | "keep" | "rebuild"
    repartition_s: float        # measured wall cost of the repartition
    recovery_time_s: float      # seg1 + repartition + remaining iters
    restart_time_s: float       # seg1 (wasted) + full rerun on new env
    results_close: bool         # recovered result ~ restarted result
    record: ExecutionRecord     # the "recovery" provenance record
    appended: bool
    retrained: bool
    output: object = None

    @property
    def speedup(self) -> float:
        """Restart-from-scratch time over recovery time (>1 = recovery
        wins)."""
        return self.restart_time_s / max(self.recovery_time_s, 1e-12)


@dataclasses.dataclass
class AutoRunResult:
    """Outcome of one closed-loop run."""
    algo: str
    shape: tuple
    p_r: int
    p_c: int
    chosen_by: str             # "model" | "default"
    time_s: float              # modeled makespan; inf on OOM
    record: ExecutionRecord
    appended: bool             # False when the store already had this cell
    retrained: bool            # did refit actually move a label / retrain?
    model_version: int
    output: object = None      # the workload's result (None on OOM)


class AutoTunedRun:
    """Predict → partition → execute → log → refit, as one driver.

    ``service`` is an :class:`EstimatorService` (or a bare
    :class:`BlockSizeEstimator`, which gets wrapped) — or the sharded
    ``serve/router.py`` ``ShardRouter``, in which case predictions go
    through the concurrent tier and learning goes through the router's
    snapshot→refit→swap path instead of mutating the live backend.
    ``store`` is a ``data/logstore.py`` ``LogStore`` — pass ``None`` to
    run without persistence (records still feed the in-process refit).
    ``refit=False`` turns the learning half of the loop off (pure
    serving — e.g. when a ``serve/refit.py`` daemon tails the store and
    owns learning instead).
    """

    def __init__(self, service, store=None, *, refit: bool = True,
                 source: str = "autorun"):
        if isinstance(service, BlockSizeEstimator):
            service = EstimatorService(service)
        self.service = service
        self.store = store
        self.refit = refit
        self.source = source
        self.history: list[AutoRunResult] = []

    @property
    def estimator(self):
        """The service's *current* backend — resolved per access, because a
        router-style service swaps backends on refit and the abstain check
        must see the live model."""
        return self.service.estimator

    # ----------------------------------------------------------- choosing
    def choose(self, n_rows: int, n_cols: int, algo: str,
               env: Environment) -> tuple[int, int, str]:
        """The abstain-aware serving decision: ``(p_r, p_c, chosen_by)``."""
        if self.estimator.abstains(algo):
            p_r, p_c = default_partitioning(n_rows, n_cols, env)
            return p_r, p_c, "default"
        p_r, p_c = self.service.predict(
            (n_rows, n_cols, algo, env.features()))
        return p_r, p_c, "model"

    def _append(self, record, source: str, device) -> bool:
        """Store ``record``'s copy tagged with the device that timed it;
        True iff the store did not have the cell yet."""
        if self.store is None:
            return False
        return bool(self.store.append(timed_copies([record], device),
                                      source=source))

    # ------------------------------------------------------------ running
    def run(self, X: torch.Tensor, y, algo: str, env: Environment, *,
            algo_kw: dict | None = None) -> AutoRunResult:
        """One closed-loop execution of ``algo`` on ``X`` (a tensor on its
        device) under ``env``."""
        n, m = X.shape
        p_r, p_c, chosen_by = self.choose(n, m, algo, env)
        ex = TaskExecutor(env)
        output = None
        try:
            output, Xd = partition_and_run(algo, ex, X, y, p_r=p_r, p_c=p_c,
                                           **(algo_kw or {}))
            t = ex.sim_time
            meta = {"chosen_by": chosen_by, "tasks": ex.n_tasks,
                    "real_s": ex.real_time}
        except TaskMemoryError as e:
            t = float("inf")
            meta = {"chosen_by": chosen_by, "reason": str(e), "oom": True}
        record = ExecutionRecord(dataset_features(n, m), algo,
                                 env.features(), p_r, p_c, t, meta)
        appended = self._append(record, self.source, X.device)
        retrained = False
        if self.refit and math.isfinite(t):
            retrained = self._learn([record])
        result = AutoRunResult(algo, (n, m), p_r, p_c, chosen_by, t, record,
                               appended, retrained,
                               self.estimator.model_version, output)
        self.history.append(result)
        return result

    def _learn(self, records) -> bool:
        """Fold measured records into the model.  A router-style service
        (anything exposing ``refit``) learns through its snapshot→swap
        path, so the live backend is never mutated while shards serve
        from it; a plain service refits the estimator in place — fitting
        from scratch on the first evidence ever, since a one-group log is
        enough to stand the model up."""
        if hasattr(self.service, "refit"):
            return bool(self.service.refit(records))
        return fold_records(self.estimator, records)

    # ------------------------------------------------------------ elastic
    def _clamped_choice(self, n: int, m: int, algo: str,
                        env: Environment) -> tuple[int, int, str]:
        p_r, p_c, by = self.choose(n, m, algo, env)
        return max(1, min(int(p_r), n)), max(1, min(int(p_c), m)), by

    def run_elastic(self, X: torch.Tensor, y, algo: str, env: Environment,
                    change: EnvChange, *, iters: int = 6,
                    algo_kw: dict | None = None) -> ElasticRunResult:
        """Closed-loop execution that survives a mid-run cluster change.

        Runs ``change.after_iter`` iterations under ``env``, then the
        environment becomes ``change.env`` (worker loss or scale-up): the
        estimator is re-queried for the new worker count, the in-flight
        ``DistArray`` is live-repartitioned (:func:`live_repartition` --
        ``refine`` views whenever the new grid nests; the repartition is
        timed between two device synchronizations, since ``rebuild`` is
        an asynchronous copy on the card), the remaining iterations are
        re-costed on the new environment, and the measured recovery
        segment is logged to the store under the ``"recovery"``
        provenance tag and folded into the model, so refit learns the
        degraded (or grown) regime.  The restart-from-scratch baseline --
        throw seg-1 work away, re-partition, run all ``iters`` on the new
        environment -- is executed too, so every result carries a
        recovery-vs-restart speedup.
        """
        if algo not in ELASTIC_ALGOS:
            raise ValueError(f"{algo!r} is not elastically steppable "
                             f"(supported: {sorted(ELASTIC_ALGOS)})")
        if not 0 < change.after_iter < iters:
            raise ValueError(f"after_iter={change.after_iter} must fall "
                             f"inside the run (0 < it < {iters})")
        n, m = X.shape
        kw = dict(algo_kw or {})
        kw.pop("iters", None)
        # ---- segment 1: the run as planned under the original env
        p1r, p1c, by1 = self._clamped_choice(n, m, algo, env)
        Xd = DistArray.from_array(X, p1r, p1c)
        ex1 = TaskExecutor(env)
        seg1 = kmeans_mod.fit(ex1, Xd, iters=change.after_iter, **kw)
        # ---- the event: re-query for the new worker count, repartition
        env2 = change.env
        p2r, p2c, by2 = self._clamped_choice(n, m, algo, env2)
        synchronize(X.device)
        t0 = time.perf_counter()
        Xd2, method = live_repartition(Xd, p2r, p2c)
        synchronize(X.device)
        repartition_s = time.perf_counter() - t0
        # ---- segment 2: re-cost the remaining DAG on the new env
        ex2 = TaskExecutor(env2)
        oom = False
        try:
            seg2 = kmeans_mod.fit(ex2, Xd2, iters=iters - change.after_iter,
                                  init_centers=seg1["centers"])
            seg2_time = ex2.sim_time
        except TaskMemoryError:
            seg2, seg2_time, oom = None, float("inf"), True
        recovery = ex1.sim_time + repartition_s + seg2_time
        # ---- restart-from-scratch baseline on the new environment
        ex3 = TaskExecutor(env2)
        try:
            full = kmeans_mod.fit(ex3, DistArray.from_array(X, p2r, p2c),
                                  iters=iters, **kw)
            restart = ex1.sim_time + ex3.sim_time
        except TaskMemoryError:
            full, restart = None, float("inf")
        results_close = bool(
            seg2 is not None and full is not None
            and torch.allclose(seg2["centers"], full["centers"]))
        record = ExecutionRecord(
            dataset_features(n, m), algo, env2.features(),
            Xd2.p_r, Xd2.p_c, seg2_time,
            {"recovery": True, "reason": change.reason,
             "repartition": method, "after_iter": change.after_iter,
             "chosen_by": by2, "oom": oom})
        appended = self._append(record, "recovery", X.device)
        retrained = False
        if self.refit and math.isfinite(seg2_time):
            retrained = self._learn([record])
        return ElasticRunResult(
            algo, (n, m), [(p1r, p1c), (Xd2.p_r, Xd2.p_c)], [by1, by2],
            method, repartition_s, recovery, restart, results_close,
            record, appended, retrained,
            None if seg2 is None else seg2)

    def run_many(self, workloads) -> list[AutoRunResult]:
        """Sequence of ``(X, y, algo, env)`` tuples through the loop — the
        estimator refits between runs, so later identical triples are
        answered by the model instead of the default heuristic."""
        return [self.run(X, y, algo, env) for X, y, algo, env in workloads]


def closed_loop_demo(store=None, *, verbose: bool = False,
                     sharded: bool = False, n_shards: int = 2,
                     device: str = "cuda") -> dict:
    """The full predict → execute → log → refit → invalidate chain on a
    small live scenario with the data on ``device``; returns the audit
    trail the bench and tests assert on.

    An estimator is trained on grid-search records for kmeans only; the
    first gmm run therefore *abstains* and executes under the default
    square heuristic, but its measured record refits the estimator, so the
    second gmm run is answered by the model — and the serving memo is
    provably flushed in between (``invalidations`` bumps).

    ``sharded=True`` runs the same loop through the concurrent serving
    tier (``serve/router.py``'s ``ShardRouter``) instead of a bare
    ``EstimatorService``: predictions route through per-shard replicas
    (on the host) and the refit lands via snapshot→swap.
    """
    from repro_torch.core.gridsearch import grid_search
    from repro_torch.data.datasets import gaussian_blobs

    env = Environment(name="laptop", n_workers=4, n_nodes=1,
                      mem_limit_mb=2048.0, dispatch_overhead_s=1e-4,
                      ram_gb=16)
    Xk, yk = gaussian_blobs(256, 16, seed=7, device=device)
    log, _ = grid_search(Xk, yk, "kmeans", env, mult=1,
                         reuse_measurements=True, store=store)
    est = BlockSizeEstimator("tree").fit(log)
    if sharded:
        from repro_torch.serve.router import ShardRouter
        service = ShardRouter(est, n_shards=n_shards, window_s=0.0)
    else:
        service = EstimatorService(est)
    try:
        loop = AutoTunedRun(service, store)
        # prime the serving memo so the post-refit flush is observable
        primed = service.predict((256, 16, "kmeans", env.features()))

        Xg, yg = gaussian_blobs(192, 12, seed=8, device=device)
        v0 = est.model_version
        first = loop.run(Xg, yg, "gmm", env)
        second = loop.run(Xg, yg, "gmm", env)
        # touch the primed bucket again: its shard/memo was filled under
        # v0, so this access is what observably flushes it post-refit
        service.predict((256, 16, "kmeans", env.features()))
        invalidations = (service.stats()["invalidations"] if sharded
                         else service.invalidations)
    finally:
        if sharded:
            service.close()
    trail = {
        "primed_kmeans": list(primed),
        "first_chosen_by": first.chosen_by,          # "default" (abstained)
        "second_chosen_by": second.chosen_by,        # "model" (refit took)
        "first_retrained": first.retrained,
        "versions": [v0, first.model_version, second.model_version],
        "invalidations": invalidations,
        "appended": [first.appended, second.appended],
        "partitions": [[first.p_r, first.p_c], [second.p_r, second.p_c]],
        "times_s": [first.time_s, second.time_s],
        "store_sources": store.sources() if store is not None else None,
        "sharded": n_shards if sharded else 0,
    }
    if verbose:
        print(f"  closed loop: run1 by {first.chosen_by} "
              f"({first.p_r},{first.p_c}) {first.time_s:.4f}s -> refit "
              f"(v{v0}->v{first.model_version}) -> run2 by "
              f"{second.chosen_by} ({second.p_r},{second.p_c}) "
              f"{second.time_s:.4f}s; service invalidations="
              f"{invalidations}", flush=True)
    return trail
