"""Paper-§V-style evaluation harness (DESIGN.md §9) and the kernel tile
tuner's evaluation, the port of the JAX package's ``repro/eval/harness.py``.

The paper evaluates BLEST-ML two ways: *prediction accuracy* — how close
the estimated block size lands to the grid-search optimum, including
generalization to infrastructures never seen in training — and
*execution time* — how much faster the predicted partitioning runs than
the default ds-array blocking.  This module reproduces both over all five
dislib workloads, with the data on a device (the card by default):

* ground truth: a real ``grid_search`` per ``<dataset, algorithm,
  environment>`` (measurement reuse on, labels identical to exhaustive);
* **exact-hit rate** — predicted ``(p_r, p_c)`` equals the argmin cell;
* **exponent distance** — ``|log_s p̂_r − log_s p*_r| + |log_s p̂_c −
  log_s p*_c|`` (the paper's "distance in the class lattice"); also the
  fraction within one exponent step;
* **modeled speedup vs default** — ``t(default square blocking) /
  t(predicted)`` from the measured grid, plus regret vs the optimum;
* **leave-one-out splits** — hold out one algorithm (train on the other
  four) and one environment (train on the other profiles), mirroring the
  paper's cross-infrastructure evaluation.

``evaluate`` returns a report dict; ``write_report`` serializes it to
``<artifacts>/eval_report.json`` (the port's artifacts directory,
``<artifacts>/torch/`` by default).  The records a store receives carry the
device that timed them (``logstore.ds_timing``); the in-memory records the
fits and splits use are the reference's, untagged.

``evaluate_kernels`` times, for every kernel case of the zoo, the tile the
measured tuner predicts, the cost model's argmin tile and the measured
argmin over the roofline-seeded shortlist, all through one timing backend
(the seeded H100 simulator by default, the CUDA kernel on the card with
``WallClockBackend``).  ``write_kernel_report`` serializes the table to
``<artifacts>/kernel_eval.json``.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np

from repro_torch.artifacts import artifacts_dir
from repro_torch.core.estimator import BlockSizeEstimator
from repro_torch.core.gridsearch import grid_search
from repro_torch.core.log import canon_items
from repro_torch.data.datasets import gaussian_blobs
from repro_torch.data.executor import Environment
from repro_torch.eval.autorun import default_partitioning

ALGOS = ("kmeans", "pca", "gmm", "csvm", "rf")

# the three paper-style infrastructure profiles: a laptop, a small
# cluster partition, and an MN4-like node (48 cores, 96 GB)
ENV_PROFILES = {
    "laptop": Environment(name="laptop", n_workers=4, n_nodes=1,
                          mem_limit_mb=2048.0, dispatch_overhead_s=1e-4,
                          ram_gb=16),
    "cluster16": Environment(name="cluster16", n_workers=16, n_nodes=4,
                             mem_limit_mb=1024.0, dispatch_overhead_s=2e-4,
                             ram_gb=64),
    "mn4_48": Environment(name="mn4_48", n_workers=48, n_nodes=1,
                          mem_limit_mb=1365.0, dispatch_overhead_s=2e-4,
                          ram_gb=96),
}

# synthetic dataset grid (rows, cols): small in smoke so the whole sweep
# stays cheap, larger in full mode
SMOKE_SHAPES = ((256, 16), (512, 8), (128, 48))
FULL_SHAPES = ((1024, 32), (4096, 16), (512, 128), (2048, 64))


def _exp_dist(pred, true, s: int = 2) -> float:
    logs = math.log(s)
    return (abs(math.log(pred[0]) - math.log(true[0]))
            + abs(math.log(pred[1]) - math.log(true[1]))) / logs


def _metrics(entries, s: int = 2) -> dict:
    """Aggregate per-group evaluation entries (each carries ``pred``,
    ``argmin``, and the measured grid times at pred/default/best)."""
    if not entries:
        return {"groups": 0}
    dists = [_exp_dist(e["pred"], e["argmin"], s) for e in entries]
    # "not swept" (cell outside the measured grid, e.g. a big-cluster model
    # predicting beyond a laptop sweep) is not the same as "measured
    # infeasible" (a swept cell that OOMed) — report both, and only
    # compute time ratios over cells the sweep actually measured finite
    in_grid = [e for e in entries if e["pred_in_grid"]]
    feasible = [e for e in in_grid if math.isfinite(e["t_pred"])]
    speedups = [e["t_default"] / e["t_pred"] for e in feasible
                if math.isfinite(e["t_default"])]
    regrets = [e["t_pred"] / e["t_best"] for e in feasible]
    out = {
        "groups": len(entries),
        "exact_hit_rate": float(np.mean(
            [e["pred"] == e["argmin"] for e in entries])),
        "mean_exp_distance": float(np.mean(dists)),
        "within_one_exp": float(np.mean([d <= 1.0 for d in dists])),
        "pred_in_grid_rate": len(in_grid) / len(entries),
        "pred_feasible_rate": (len(feasible) / len(in_grid)
                               if in_grid else 0.0),
    }
    if speedups:
        out["mean_speedup_vs_default"] = float(np.mean(speedups))
        out["geomean_speedup_vs_default"] = float(
            np.exp(np.mean(np.log(np.maximum(speedups, 1e-12)))))
    if regrets:
        out["mean_regret_vs_best"] = float(np.mean(regrets))
    return out


_env_key = canon_items     # record<->profile matching uses the shared
                           # grouping identity (core/log.py)


def _predict_groups(est: BlockSizeEstimator, groups) -> list[dict]:
    """One batched prediction pass over evaluation groups; returns entries
    joining the prediction with each group's measured grid."""
    preds = est.predict_partitions_batch(
        [(g["n"], g["m"], g["algo"], g["env_features"]) for g in groups])
    entries = []
    for g, pred in zip(groups, preds):
        grid = g["grid"]
        entries.append({
            "algo": g["algo"], "shape": [g["n"], g["m"]],
            "env": g["env_name"],
            "pred": tuple(pred), "argmin": g["argmin"],
            "default": g["default"],
            "pred_in_grid": tuple(pred) in grid,
            "t_pred": grid.get(tuple(pred), float("inf")),
            "t_default": g["t_default"], "t_best": g["t_best"],
        })
    return entries


def build_ground_truth(*, shapes=SMOKE_SHAPES, envs=None, algos=ALGOS,
                       mult: int = 1, seed: int = 0, store=None,
                       device: str = "cuda", verbose: bool = False):
    """Grid-search every ``<dataset, algorithm, environment>`` cell of the
    evaluation cube with the data on ``device``; returns ``(records,
    groups)`` where each group holds the measured grid, the argmin label,
    and the default-heuristic cell.  ``store`` receives each sweep's
    records tagged with ``device``."""
    envs = dict(envs or ENV_PROFILES)
    records = []
    groups = []
    for ai, algo in enumerate(algos):
        for si, (n, m) in enumerate(shapes):
            X, y = gaussian_blobs(n, m, seed=seed + 31 * ai + si,
                                  device=device)
            for env_name, env in envs.items():
                t0 = time.time()
                log, grid = grid_search(X, y, algo, env, mult=mult,
                                        reuse_measurements=True, store=store)
                records.extend(log.records)
                finite = {k: v for k, v in grid.items()
                          if math.isfinite(v)}
                if not finite:
                    continue                     # all-OOM group: no label
                argmin = min(finite, key=finite.get)
                d_cell = default_partitioning(n, m, env)
                groups.append({
                    "algo": algo, "n": n, "m": m,
                    "env_name": env_name, "env_features": env.features(),
                    "grid": grid, "argmin": argmin,
                    "t_best": finite[argmin],
                    "default": d_cell,
                    "t_default": grid.get(d_cell, float("inf")),
                    "sweep_wall_s": time.time() - t0,
                })
                if verbose:
                    print(f"  [truth] {algo} {n}x{m} @{env_name}: "
                          f"argmin={argmin} default={d_cell} "
                          f"({time.time()-t0:.2f}s)", flush=True)
    return records, groups


def evaluate(*, smoke: bool = True, envs=None, mult: int = 1, seed: int = 0,
             model: str = "tree", store=None, device: str = "cuda",
             verbose: bool = False) -> dict:
    """Run the full §V-style evaluation with the data on ``device``;
    returns the report dict."""
    shapes = SMOKE_SHAPES if smoke else FULL_SHAPES
    envs = dict(envs or ENV_PROFILES)
    t0 = time.time()
    records, groups = build_ground_truth(shapes=shapes, envs=envs, mult=mult,
                                         seed=seed, store=store,
                                         device=device, verbose=verbose)

    # ---- in-sample accuracy: fit on everything, predict every group ----
    est = BlockSizeEstimator(model).fit(records)
    entries = _predict_groups(est, groups)
    per_algo = {a: _metrics([e for e in entries if e["algo"] == a])
                for a in ALGOS}
    per_env = {name: _metrics([e for e in entries if e["env"] == name])
               for name in envs}

    # ---- leave-one-algorithm-out: can four workloads predict the fifth?
    holdout_algo = {}
    for a in ALGOS:
        train = [r for r in records if r.algo != a]
        test_groups = [g for g in groups if g["algo"] == a]
        if not train or not test_groups:
            continue
        e2 = BlockSizeEstimator(model).fit(train)
        assert e2.abstains(a), "held-out algo must be unknown to the model"
        holdout_algo[a] = _metrics(_predict_groups(e2, test_groups))

    # ---- leave-one-environment-out: the paper's cross-infrastructure
    # split (train on two profiles, predict the third)
    holdout_env = {}
    for name, env in envs.items():
        key = _env_key(env.features())
        train = [r for r in records if _env_key(r.env) != key]
        test_groups = [g for g in groups if g["env_name"] == name]
        if not train or not test_groups:
            continue
        e2 = BlockSizeEstimator(model).fit(train)
        holdout_env[name] = _metrics(_predict_groups(e2, test_groups))

    return {
        "config": {
            "smoke": smoke, "model": model, "mult": mult, "seed": seed,
            "algos": list(ALGOS), "shapes": [list(s) for s in shapes],
            "envs": {n: e.features() for n, e in envs.items()},
            "n_records": len(records), "n_groups": len(groups),
        },
        "overall": _metrics(entries),
        "per_algo": per_algo,
        "per_env": per_env,
        "holdout_algo": holdout_algo,
        "holdout_env": holdout_env,
        "groups": [{k: v for k, v in e.items()} for e in entries],
        "wall_s": time.time() - t0,
    }


def bench_payload(report: dict) -> dict:
    """Distill a report into the ``BENCH_eval.json`` key metrics the CI
    regression gate compares run over run (machine-independent rates and
    ratios only — no wall-clock absolutes)."""
    overall = report["overall"]
    payload = {
        "groups": report["config"]["n_groups"],
        "exact_hit_rate": overall.get("exact_hit_rate"),
        "mean_exp_distance": overall.get("mean_exp_distance"),
        "within_one_exp": overall.get("within_one_exp"),
        "mean_speedup_vs_default": overall.get("mean_speedup_vs_default"),
        "mean_regret_vs_best": overall.get("mean_regret_vs_best"),
        "per_algo": {
            a: {"exact_hit_rate": m.get("exact_hit_rate"),
                "mean_exp_distance": m.get("mean_exp_distance"),
                "mean_speedup_vs_default": m.get("mean_speedup_vs_default")}
            for a, m in report["per_algo"].items()},
        "holdout_algo_within_one": {
            a: m.get("within_one_exp")
            for a, m in report.get("holdout_algo", {}).items()},
        "holdout_env_hit_rate": {
            n: m.get("exact_hit_rate")
            for n, m in report.get("holdout_env", {}).items()},
    }
    if "closed_loop" in report:
        cl = report["closed_loop"]
        payload["closed_loop"] = {
            "first_chosen_by": cl["first_chosen_by"],
            "second_chosen_by": cl["second_chosen_by"],
            "refit_retrained": cl["first_retrained"],
            "invalidations": cl["invalidations"],
        }
    return payload


# ---------------------------------------------------------------------------
# Kernel autotuning evaluation: measured tiles vs the closed-form cost model
# ---------------------------------------------------------------------------

def evaluate_kernels(*, backend=None, arch_ids=None, shape_names=None,
                     seed: int = 0, store=None, max_pairs: int = 6,
                     bk_per_pair: int = 2, verbose: bool = False) -> dict:
    """The measured-autotuning eval table (DESIGN.md §12): for every
    (model config, shape) kernel case in the zoo, the *achieved* time —
    under ``backend``, the seeded H100 simulator by default — of (a) the
    measured tuner's predicted tile, (b) the closed-form cost model's
    argmin tile, and (c) the measured argmin over the roofline-seeded
    shortlist.  The headline ratio is (b)/(a): how much faster measured
    tuning runs than trusting the analytic model.

    One measurement sweep (``measure_cases``, bucket-deduplicated and
    LogStore-memoized when ``store`` is given) both labels the tuners and
    grounds the table.  The shortlist and the cost model are the backend's
    own (``backend.hw``, ``backend.rule``); a case whose rule admits no tile
    (K2 at a head dim it does not compile) has no row.
    """
    from repro_torch.configs.workloads import EVAL_SHAPES, zoo_cases
    from repro_torch.core import kerneltune as kt
    from repro_torch.kernels.timing import SimulatorBackend

    backend = backend or SimulatorBackend(seed=seed)
    hw, rule = backend.hw, backend.rule
    shape_names = shape_names or EVAL_SHAPES
    t0 = time.time()
    cases = zoo_cases(arch_ids, shape_names)
    records, mstats = kt.measure_cases(cases, backend, store,
                                       max_pairs=max_pairs,
                                       bk_per_pair=bk_per_pair)

    tuners: dict = {}
    for kernel, algo in (("matmul", "matmul_tile"), ("flash", "flash_tile")):
        recs = [r for r in records if r.algo == algo]
        if recs:
            tuners[kernel] = kt.KernelTuner(kernel, rule=rule).fit(recs)

    achieved: dict = {}               # (bucket key, tile) -> seconds

    def timed(bcase, tiles):
        """Achieved times via the backend, memoized per (bucket, tile)."""
        missing = [t for t in tiles if (bcase.key(), t) not in achieved]
        if missing:
            for t, sec in zip(missing, backend.measure(bcase, missing)):
                achieved[(bcase.key(), t)] = float(sec)
        return [achieved[(bcase.key(), t)] for t in tiles]

    rows = []
    for case in cases:
        tuner = tuners.get(case.kernel)
        if tuner is None:
            continue
        bcase = kt.bucket_case(case)
        shortlist = kt.seed_tiles(bcase, max_pairs=max_pairs,
                                  bk_per_pair=bk_per_pair, hw=hw, rule=rule)
        if not shortlist:             # no tile the rule admits: nothing to time
            continue
        prior = kt.prior_times(bcase, shortlist, hw=hw, rule=rule)
        cost_tile = shortlist[int(np.argmin(prior))]
        pred = tuner.predict(bcase.m, bcase.k, bcase.n, bcase.dtype)
        pred = tuple(int(v) for v in pred)
        times = timed(bcase, [tuple(t) for t in shortlist] + [pred, cost_tile])
        short_times = times[:len(shortlist)]
        t_pred, t_cost = times[-2], times[-1]
        i_best = int(np.argmin(short_times))
        best_tile, t_best = tuple(shortlist[i_best]), short_times[i_best]
        arch = case.label.split("/")[0]
        rows.append({
            "arch": arch, "label": case.label, "kernel": case.kernel,
            "shape": [case.m, case.k, case.n], "dtype": case.dtype,
            "pred": list(pred), "cost_tile": list(cost_tile),
            "argmin_tile": list(best_tile),
            "t_pred": t_pred, "t_cost_model": t_cost, "t_best": t_best,
            "speedup_vs_costmodel": t_cost / t_pred,
            "regret_vs_best": t_pred / t_best,
            "argmin_hit": pred == best_tile,
        })
        if verbose:
            print(f"  [kernel] {case.label}: pred={pred} "
                  f"cost={cost_tile} best={best_tile} "
                  f"speedup={t_cost / t_pred:.3f}", flush=True)

    per_arch = {}
    for arch in sorted({r["arch"] for r in rows}):
        sub = [r for r in rows if r["arch"] == arch]
        sp = [r["speedup_vs_costmodel"] for r in sub]
        per_arch[arch] = {
            "cases": len(sub),
            "geomean_speedup_vs_costmodel": float(
                np.exp(np.mean(np.log(np.maximum(sp, 1e-12))))),
            "argmin_hit_rate": float(np.mean([r["argmin_hit"]
                                              for r in sub])),
            "mean_regret_vs_best": float(np.mean([r["regret_vs_best"]
                                                  for r in sub])),
        }
    beats = [a for a, m in per_arch.items()
             if m["geomean_speedup_vs_costmodel"] > 1.0]
    sp_all = [r["speedup_vs_costmodel"] for r in rows]
    return {
        "config": {
            "backend": getattr(backend, "name", str(backend)),
            "deterministic": bool(getattr(backend, "deterministic", False)),
            "seed": seed, "shapes": list(shape_names),
            "max_pairs": max_pairs, "bk_per_pair": bk_per_pair,
            "n_cases": len(cases), "n_rows": len(rows),
            "n_configs": len(per_arch),
        },
        "measurement": dict(mstats),
        "overall": {
            "beat_costmodel_frac": (len(beats) / len(per_arch)
                                    if per_arch else 0.0),
            "geomean_speedup_vs_costmodel": float(
                np.exp(np.mean(np.log(np.maximum(sp_all, 1e-12)))))
            if sp_all else 0.0,
            "argmin_hit_rate": float(np.mean([r["argmin_hit"]
                                              for r in rows]))
            if rows else 0.0,
            "mean_regret_vs_best": float(np.mean([r["regret_vs_best"]
                                                  for r in rows]))
            if rows else 0.0,
        },
        "per_arch": per_arch,
        "rows": rows,
        "wall_s": time.time() - t0,
    }


def bench_kernel_payload(report: dict, **extra) -> dict:
    """Distill a kernel eval report into the ``BENCH_kernel.json`` metrics
    the CI regression gate compares run over run (rates and ratios only).
    ``extra`` lets the bench driver attach flags it established itself
    (determinism across runs, wall-clock verification, cache hit rate)."""
    overall = report["overall"]
    payload = {
        "backend": report["config"]["backend"],
        "configs": report["config"]["n_configs"],
        "cases": report["config"]["n_rows"],
        "beat_costmodel_frac": overall["beat_costmodel_frac"],
        "geomean_speedup_vs_costmodel":
            overall["geomean_speedup_vs_costmodel"],
        "argmin_hit_rate": overall["argmin_hit_rate"],
        "mean_regret_vs_best": overall["mean_regret_vs_best"],
        "per_arch_speedup": {
            a: m["geomean_speedup_vs_costmodel"]
            for a, m in report["per_arch"].items()},
    }
    payload.update(extra)
    return payload


def write_kernel_report(report: dict, artifacts=None) -> Path:
    """Serialize to ``<artifacts>/kernel_eval.json``; returns the path."""
    root = artifacts_dir(artifacts)
    root.mkdir(parents=True, exist_ok=True)
    path = root / "kernel_eval.json"
    path.write_text(json.dumps(_jsonable(report), indent=2) + "\n")
    return path


def write_report(report: dict, artifacts=None) -> Path:
    """Serialize to ``<artifacts>/eval_report.json``; returns the path."""
    root = artifacts_dir(artifacts)
    root.mkdir(parents=True, exist_ok=True)
    path = root / "eval_report.json"
    path.write_text(json.dumps(_jsonable(report), indent=2) + "\n")
    return path


def _jsonable(x):
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, float) and math.isinf(x):
        return "inf"
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x
