"""Kernel autotuning evaluation: measured tiles vs the closed-form cost
model (the kernel part of the JAX package's ``eval/harness.py``).

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


def evaluate_kernels(*, backend=None, arch_ids=None, shape_names=None,
                     seed: int = 0, store=None, max_pairs: int = 6,
                     bk_per_pair: int = 2, verbose: bool = False,
                     with_flash: bool = True) -> dict:
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
    own (``backend.hw``, ``backend.rule``).  ``with_flash=False`` leaves the
    flash cases out, as the H100 rule and the wall-clock backend need (both
    raise on them until the flash kernel takes its tile at launch).
    """
    from repro_torch.configs.workloads import EVAL_SHAPES, zoo_cases
    from repro_torch.core import kerneltune as kt
    from repro_torch.kernels.timing import SimulatorBackend

    backend = backend or SimulatorBackend(seed=seed)
    hw, rule = backend.hw, backend.rule
    shape_names = shape_names or EVAL_SHAPES
    t0 = time.time()
    cases = zoo_cases(arch_ids, shape_names, with_flash=with_flash)
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
