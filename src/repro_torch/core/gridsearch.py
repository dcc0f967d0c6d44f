"""Grid-search training-data generation (paper §III-B), the port of the
JAX package's ``repro/core/gridsearch.py``: the data is a tensor (on the
card by default), each cell's blocks are tensors on its device, and a
cell's time is composed of its task bodies' measured durations.

For a triple <d, a, e> builds the k x k grid G with
(p_r, p_c) = (s^i, s^j), runs the real workload at every cell on the task
executor, and records the measured (modeled-makespan) time -- failures
(per-task memory budget exceeded) score infinity.  The annotated argmin
becomes one training sample.

Hot-path structure: the DistArray for every cell is derived once by
refining the previous cell's blocks (``DistArray.refine`` view-splits; the
source array is sliced exactly once), and cells execute fine -> coarse so
that a measured OOM at (p_r, p_c) prunes every coarser-or-equal cell
(p_r' <= p_r, p_c' <= p_c) without execution: coarser cells have
per-task working sets at least as large, so they are recorded ``inf``
directly (meta ``pruned: True``).  Argmin labels are provably unchanged --
pruned cells would have scored ``inf`` anyway.

Opt-in cross-cell measurement reuse (``reuse_measurements=True``): one
:class:`MeasurementCache` is shared across the whole sweep, so each unique
(task body, argument-signature) executes and is timed once; every other
occurrence -- later iterations of the same cell, and cells sharing a row
or column partitioning -- replays the measured duration through the DAG
scheduler without re-executing.  Wall time drops several-fold while every
cell's modeled makespan is still composed of real measured durations.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.algorithms import run as run_algo
from repro_torch.core.features import dataset_features
from repro_torch.core.log import ExecutionLog, ExecutionRecord
from repro_torch.data.distarray import DistArray
from repro_torch.data.logstore import timed_copies
from repro_torch.data.executor import (Environment, MeasurementCache,
                                       TaskExecutor, TaskMemoryError)


def grid_powers(n_cores: int, s: int = 2, mult: int = 4,
                min_power: int = 0) -> list[int]:
    """Partition counts s^i up to mult x n_cores (paper uses 4x).

    Uses an exact integer logarithm: ``int(math.log(243, 3))`` is 4 (float
    truncation), which silently dropped the top power of the sweep.
    """
    cap = max(n_cores * mult, s)
    k = 0
    while s ** (k + 1) <= cap:
        k += 1
    return [s ** i for i in range(min_power, k + 1)]


def run_cell(X: torch.Tensor, y, algo: str, env: Environment, p_r: int, p_c: int,
             *, algo_kw=None, repeats: int = 1, task_repeats: int = 1,
             Xd: DistArray | None = None,
             measure_cache: MeasurementCache | None = None) -> tuple[float, dict]:
    """One grid cell: real execution, modeled makespan; inf on OOM.

    ``Xd`` lets the caller supply a pre-partitioned array (grid_search
    derives them by block refinement); otherwise the source is sliced here.
    Refined blocks can be column-strided views -- those are copied to
    contiguous storage (``.contiguous()``) *before* the timed execution, so
    measured task durations (the training labels) match ``from_array``
    partitioning exactly and never pay a GEMM's strided-input copies.
    """
    n, m = X.shape
    if p_r > n or p_c > m:
        return float("inf"), {"reason": "degenerate"}
    if Xd is None:
        Xd = DistArray.from_array(X, p_r, p_c)
    elif any(not b.is_contiguous() for row in Xd.blocks for b in row):
        Xd = DistArray([[b.contiguous() for b in row]
                        for row in Xd.blocks], Xd.shape)
    best = float("inf")
    info = {}
    for rep in range(repeats):
        ex = TaskExecutor(env, repeats=task_repeats,
                          measure_cache=measure_cache)
        try:
            run_algo(algo, ex, Xd, y)
        except TaskMemoryError as e:
            return float("inf"), {"reason": str(e), "oom": True}
        best = min(best, ex.sim_time)
        info = {"tasks": ex.n_tasks, "real_s": ex.real_time}
        if measure_cache is not None:
            info["replayed"] = ex.replayed_tasks
    return best, info


def _refined_cells(X: torch.Tensor, ps, col_ps) -> dict:
    """DistArray per feasible cell, each derived from its coarser neighbour
    by view-splitting (the source array is sliced exactly once)."""
    n, m = X.shape
    cells: dict[tuple[int, int], DistArray] = {}
    base, prev_r = None, None
    for p_r in ps:
        if p_r > n:
            break
        base = DistArray.from_array(X, p_r, 1) if base is None \
            else base.refine(p_r // prev_r, 1)
        prev_r = p_r
        cur, prev_c = base, 1
        for p_c in col_ps:
            if p_c > m:
                break
            cur = cur.refine(1, p_c // prev_c)
            prev_c = p_c
            cells[(p_r, p_c)] = cur
    return cells


def grid_search(X: torch.Tensor, y, algo: str, env: Environment, *, s: int = 2,
                mult: int = 4, repeats: int = 1, task_repeats: int = 1,
                log: ExecutionLog | None = None,
                row_only: bool = False, verbose: bool = False,
                prune_oom: bool = True, reuse_blocks: bool = True,
                reuse_measurements: bool = False, store=None):
    """Sweep the (p_r, p_c) grid; returns (log, grid dict).

    ``repeats`` re-runs whole cells (best-of) while ``task_repeats``
    re-runs individual task bodies (best-of per measurement -- cheaper
    noise damping, and the damped duration is what a measurement cache
    stores).  Under ``reuse_measurements`` cell-level ``repeats`` is
    inert beyond the first rep (later reps replay the shared cache and
    re-measure nothing); use ``task_repeats`` for damping there.
    ``prune_oom`` skips execution of cells coarser than a
    measured OOM cell
    (recorded ``inf`` with meta ``pruned``); ``reuse_blocks`` derives each
    cell's partitioning by refining the previous one instead of re-slicing
    ``X``; ``reuse_measurements`` shares one cross-cell
    :class:`MeasurementCache` over the sweep, executing each unique task
    body/signature once and replaying its measured duration elsewhere.
    Disabling all three reproduces the exhaustive scalar path cell for
    cell.  ``store`` (a ``data/logstore.py`` LogStore) persists the
    sweep's records alongside the returned in-memory log, each copy
    tagged with the device that timed it (``logstore.ds_timing``); the
    returned records stay untagged.
    """
    log = log or ExecutionLog(s=s)
    n0 = len(log.records)
    d = dataset_features(*X.shape)
    e = env.features()
    ps = grid_powers(env.n_workers, s=s, mult=mult)
    col_ps = [1] if row_only else ps
    cells = _refined_cells(X, ps, col_ps) if reuse_blocks else {}
    cache = MeasurementCache() if reuse_measurements else None
    grid = {}
    oom_cells: list[tuple[int, int]] = []
    for p_r in sorted(ps, reverse=True):
        for p_c in sorted(col_ps, reverse=True):
            if prune_oom and any(qr >= p_r and qc >= p_c
                                 for qr, qc in oom_cells):
                t, info = float("inf"), {"reason": "coarser than an OOM cell",
                                         "pruned": True}
            else:
                t, info = run_cell(X, y, algo, env, p_r, p_c, repeats=repeats,
                                   task_repeats=task_repeats,
                                   Xd=cells.get((p_r, p_c)),
                                   measure_cache=cache)
                if info.get("oom"):
                    oom_cells.append((p_r, p_c))
            grid[(p_r, p_c)] = t
            log.add(ExecutionRecord(d, algo, e, p_r, p_c, t, info))
            if verbose:
                print(f"  grid {algo} ({p_r},{p_c}): "
                      f"{t if math.isfinite(t) else 'OOM':>8} s", flush=True)
    if store is not None:
        store.append(timed_copies(log.records[n0:], X.device),
                     source="grid_search")
    return log, grid


def grid_stats(grid: dict) -> dict:
    """best/average/worst over finite cells (paper's comparison points)."""
    finite = {k: v for k, v in grid.items() if math.isfinite(v)}
    if not finite:
        return {}
    best_key = min(finite, key=finite.get)
    worst_key = max(finite, key=finite.get)
    return {
        "best": finite[best_key], "best_part": best_key,
        "worst": finite[worst_key], "worst_part": worst_key,
        "avg": float(np.mean(list(finite.values()))),
        "n_finite": len(finite), "n_oom": len(grid) - len(finite),
    }
