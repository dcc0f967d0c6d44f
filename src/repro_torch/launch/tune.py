"""The three tuner families end to end: ``python -m repro_torch tune``.

The port of the JAX package's ``launch/tune.py``.  Each family sweeps its
grid, persists the records into ONE schema-versioned ``LogStore``, fits
through the shared ``Tuner`` protocol and reports predictions:

* ds-array block sizes (the paper's BLEST-ML pipeline): measured grid
  searches over ``(p_r, p_c)`` of the dislib workloads, their task bodies
  run as torch ops on ``--device`` and timed there (each record's ``<e>``
  carries the device's ``timing`` tag, so one store keeps the CPU's and the
  card's labels apart), then the
  ``BlockSizeEstimator`` and its ``EstimatorService``; ``--refit-demo``
  appends label-shifting records and shows the incremental refit and the
  service's memo invalidation;
* kernel tiles: the analytic cost-model grids are swept and fitted, the
  zoo's kernel cases (GEMM and flash attention) are measured through a
  timing backend, a measured tuner per kernel prints a tile for every
  case, and the evaluation table (predicted tile vs the cost model's
  argmin vs the measured best) is written beside the store;
* mesh ``(dp, microbatch)`` cells from the roofline grids over
  ``--chips`` chips, priced on the H100's constants.

    python -m repro_torch tune --arch yi-6b                       # on the card
    python -m repro_torch tune --skip kernel --refit-demo         # ds + mesh
    python -m repro_torch tune --arch yi-6b --device cpu --backend sim

``--backend wallclock`` (the default) times the CUDA kernels on the card
at every candidate tile: K1 (blocked matmul) for the GEMM cases and K2
(flash attention) for the flash cases; ``--backend sim`` uses the seeded
H100 simulator, whose seconds are a model, not a measurement.  The store
is ``--store PATH`` > ``$REPRO_ARTIFACTS/torch/tune_store.jsonl`` > the
checkout's ``artifacts/torch/``.  Re-running is idempotent: the store
dedups records by (group, partition) key, and measured tiles already in
the store are not measured again.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from repro_torch.artifacts import artifacts_dir
from repro_torch.data.logstore import ds_timing

SHAPES = [(4096, 4096, 4096), (8192, 1024, 2048), (512, 512, 512)]


def _banner(msg: str):
    print(f"\n== {msg}", flush=True)


def _own(records, env_items: dict):
    """The records whose ``<e>`` slot carries ``env_items`` -- one
    backend's or one rule's, when a store holds several."""
    return [r for r in records
            if all(r.env.get(k) == v for k, v in env_items.items())]


# the reference's ds-array sweeps: (rows, cols, workload), seed 10 + index
DS_SWEEPS = [(512, 32, "kmeans"), (1024, 16, "rf"), (2048, 8, "kmeans"),
             (256, 64, "pca")]


def tune_dsarray(store, *, device: str = "cuda",
                 refit_demo: bool = False) -> dict:
    """Paper pipeline: measured (modeled-makespan) grid searches with the
    data on ``device`` -> store -> BlockSizeEstimator -> EstimatorService.
    The estimator fits on ``device``'s records alone.  Returns the
    predictions, the record count, the wall seconds and, with
    ``refit_demo``, the refit's outcome."""
    from repro_torch.core.estimator import BlockSizeEstimator, EstimatorService
    from repro_torch.core.gridsearch import grid_search
    from repro_torch.core.log import ExecutionLog
    from repro_torch.data.datasets import gaussian_blobs
    from repro_torch.data.executor import Environment

    _banner(f"ds-array block sizes (core/estimator.py) on {device}")
    env = Environment(n_workers=4, mem_limit_mb=64.0)
    timing = ds_timing(device)
    t0 = time.time()
    for i, (n, m, algo) in enumerate(DS_SWEEPS):
        X, y = gaussian_blobs(n, m, seed=10 + i, device=device)
        grid_search(X, y, algo, env, mult=1, store=store)
    log = ExecutionLog(_own(store.load(algos=("kmeans", "rf", "pca")).records,
                            timing), s=store.s)
    est = BlockSizeEstimator("tree").fit(log)
    svc = EstimatorService(est)
    wall = time.time() - t0
    print(f"  swept+fit in {wall:.1f}s on {len(log.records)} records")
    predictions = {}
    for nr, nc in ((1024, 32), (4096, 8)):
        pr, pc = svc.predict((nr, nc, "kmeans", env.features()))
        predictions[(nr, nc)] = (pr, pc)
        print(f"  kmeans {nr}x{nc}: p=({pr},{pc}) "
              f"block={int(np.ceil(nr/pr))}x{int(np.ceil(nc/pc))}")
    out = {"predictions": predictions, "records": len(log.records),
           "wall_s": wall}

    if refit_demo:
        from repro_torch.core.log import ExecutionRecord
        _banner("refit demo: shifted labels invalidate the service memo")
        before = svc.predict((1024, 32, "kmeans", env.features()))
        # a new, much faster measurement at a different partitioning for
        # every kmeans group -> argmin labels move -> retrain
        shifted = [ExecutionRecord(r.dataset, r.algo, r.env,
                                   4 if r.p_r == 1 else 1, r.p_c, 1e-9)
                   for r in log.best_per_group() if r.algo == "kmeans"]
        retrained = est.refit(shifted)
        after = svc.predict((1024, 32, "kmeans", env.features()))
        print(f"  retrained={retrained} version={est.model_version} "
              f"invalidations={svc.invalidations}")
        print(f"  prediction before={before} after={after}")
        out["refit"] = {"retrained": retrained,
                        "version": est.model_version,
                        "invalidations": svc.invalidations,
                        "before": before, "after": after}
    return out


def tune_kernel(store, backend, *, arch_ids=None, seed: int = 0,
                artifacts=None) -> dict:
    """Analytic fit, measured fits over the zoo's GEMM and flash cases,
    evaluation table.  Returns the predictions (``(bm, bn, bk)`` for a GEMM
    case, ``(bq, bk)`` for a flash case), the report and the backend's
    counts."""
    from repro_torch.configs.workloads import zoo_cases
    from repro_torch.core.kerneltune import (MEASURED_SOURCE, KernelTuner,
                                             build_training_log,
                                             measure_cases, tile_algo)
    from repro_torch.eval.harness import evaluate_kernels, write_kernel_report

    t_start = time.time()
    hw, rule = backend.hw, backend.rule
    _banner(f"matmul tiles: cost model on {hw.name}, {rule.name} rule")
    t0 = time.time()
    build_training_log(n_shapes=12, store=store, hw=hw, rule=rule)
    grid = _own(store.load(algos="matmul_tile", source="kernel_grid").records,
                rule.env)
    tun = KernelTuner(rule=rule).fit(grid)
    print(f"  swept+fit in {time.time() - t0:.1f}s on {len(grid)} records")
    for (m, k, n), tile in zip(SHAPES, tun.predict_batch(SHAPES)):
        print(f"  matmul {m}x{k}x{n}: (block_m, block_n, block_k)={tile}")

    _banner(f"measured tiles ({backend.name})")
    t0 = time.time()
    cases = zoo_cases(arch_ids)
    _, stats = measure_cases(cases, backend, store)
    print(f"  measured {stats['measured']} tiles ({stats['cached']} cached, "
          f"{stats['bucket_hits']} bucket hits, {stats['pruned']} pruned) "
          f"in {time.time() - t0:.1f}s")
    print("  predictions:")
    predicted = {}
    for kernel, names in (("matmul", "block_m, block_n, block_k"),
                          ("flash", "block_q, block_k")):
        kcases = [c for c in cases if c.kernel == kernel]
        measured = _own(store.load(algos=tile_algo(kernel),
                                   source=MEASURED_SOURCE).records,
                        {"timing": backend.name})
        if not kcases or not measured:
            continue
        mtun = KernelTuner(kernel, rule=rule).fit(measured)
        preds = mtun.predict_batch([(c.m, c.k, c.n, c.dtype) for c in kcases])
        for case, tile in zip(kcases, preds):
            predicted[case.label] = tuple(int(v) for v in tile)
            print(f"  {case.label} (m,k,n)=({case.m},{case.k},{case.n}): "
                  f"({names})={predicted[case.label]}")

    _banner(f"evaluation: predicted vs cost-model vs measured best ({backend.name})")
    report = evaluate_kernels(backend=backend, arch_ids=arch_ids, seed=seed,
                              store=store)
    path = write_kernel_report(report, artifacts)
    ov = report["overall"]
    print(f"  {report['config']['n_rows']} cases: geomean speedup vs cost "
          f"model {ov['geomean_speedup_vs_costmodel']:.4f}, argmin hit rate "
          f"{ov['argmin_hit_rate']:.4f}, mean regret vs best "
          f"{ov['mean_regret_vs_best']:.4f} -> {path}")
    counts = {"measured": backend.measured, "reps": getattr(backend, "reps", 0),
              "verified": getattr(backend, "verified", 0),
              "verify_failures": getattr(backend, "verify_failures", 0),
              "measured_by": dict(getattr(backend, "measured_by", {}))}
    return {"predicted": predicted, "eval": report, "backend": counts,
            "wall_s": time.time() - t_start}


def tune_mesh(store, chips: int) -> dict:
    """(dp, microbatch) cells from the roofline grids, priced on the H100's
    constants (``meshtune``'s default)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.meshtune import MeshTuner, tune_all

    _banner(f"mesh (dp, microbatch) over {chips} chips on the H100 "
            "(core/meshtune.py)")
    t0 = time.time()
    tune_all(["yi-6b", "mamba2-370m", "mixtral-8x7b"], shapes=("train_4k",),
             chips=chips, store=store)
    tun = MeshTuner(chips).fit(store.load(algos="meshtune"))
    wall = time.time() - t0
    print(f"  swept+fit in {wall:.1f}s on "
          f"{len(store.load(algos='meshtune').records)} records")
    predictions = {}
    for arch in ("deepseek-7b",):
        dp, tp, mb = tun.predict(get_config(arch), SHAPES["train_4k"])
        predictions[arch] = (dp, tp, mb)
        print(f"  {arch} train_4k: dp={dp} tp={tp} microbatches={mb}")
    return {"predictions": predictions, "wall_s": wall}


def main(argv=None) -> dict:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.data.logstore import LogStore
    from repro_torch.device import resolve_device
    from repro_torch.kernels.timing import SimulatorBackend, WallClockBackend

    ap = argparse.ArgumentParser(
        description="drive the three tuner families (ds-array block sizes, "
                    "kernel tiles, mesh) through the shared subsystem")
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=["ds", "kernel", "mesh"])
    ap.add_argument("--chips", type=int, default=64,
                    help="chips the mesh family factorizes")
    ap.add_argument("--refit-demo", action="store_true")
    ap.add_argument("--arch", nargs="*", default=None, choices=ARCH_IDS,
                    help="architectures whose kernel cases are measured "
                         "(default: the whole zoo)")
    ap.add_argument("--backend", choices=["wallclock", "sim"],
                    default="wallclock")
    ap.add_argument("--device", default="cuda",
                    help="device the ds-array sweeps run on and the "
                         "wallclock backend times on")
    ap.add_argument("--store", default=None,
                    help="LogStore path (shared by every tuner family); "
                         "defaults to <artifacts>/torch/tune_store.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # a missing card refuses the run before the store is touched
    ds_device = None if "ds" in args.skip else str(resolve_device(args.device))
    store_path = Path(args.store) if args.store else \
        artifacts_dir() / "tune_store.jsonl"
    store = LogStore(store_path)
    result: dict = {}
    if ds_device is not None:
        result["ds"] = tune_dsarray(store, device=ds_device,
                                    refit_demo=args.refit_demo)
    if "kernel" not in args.skip:
        if args.backend == "wallclock":
            backend = WallClockBackend(device=args.device, seed=args.seed)
        else:
            backend = SimulatorBackend(seed=args.seed)
        result.update(tune_kernel(store, backend, arch_ids=args.arch,
                                  seed=args.seed,
                                  artifacts=store_path.parent))
    if "mesh" not in args.skip:
        result["mesh"] = tune_mesh(store, args.chips)
    _banner(f"store {store.path}: {len(store)} records by source "
            f"{store.sources()}")
    result["sources"] = store.sources()
    return result


if __name__ == "__main__":
    main()
