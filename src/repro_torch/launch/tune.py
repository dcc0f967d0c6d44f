"""The kernel tile tuner end to end: ``python -m repro_torch tune``.

The kernel family of the JAX package's ``launch/tune.py``: the analytic
cost-model grids are swept and fitted, the zoo's GEMM cases are measured
through a timing backend into the ``LogStore``, the measured tuner is
fitted and prints a tile for every case, and the evaluation table
(predicted tile vs the cost model's argmin vs the measured best) is
written beside the store.

    python -m repro_torch tune --arch yi-6b                       # on the card
    python -m repro_torch tune --arch yi-6b --device cpu --backend sim

``--backend wallclock`` (the default) times the blocked-matmul CUDA kernel
on the card at every candidate tile; ``--backend sim`` uses the seeded
H100 simulator, whose seconds are a model, not a measurement.  The store
is ``--store PATH`` > ``$REPRO_ARTIFACTS/torch/tune_store.jsonl`` > the
checkout's ``artifacts/torch/``.  Re-running is idempotent: measured
tiles already in the store are not measured again.  The ds-array and mesh
families are not ported yet.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from repro_torch.artifacts import artifacts_dir

SHAPES = [(4096, 4096, 4096), (8192, 1024, 2048), (512, 512, 512)]


def _banner(msg: str):
    print(f"\n== {msg}", flush=True)


def _own(records, env_items: dict):
    """The records whose ``<e>`` slot carries ``env_items`` -- one
    backend's or one rule's, when a store holds several."""
    return [r for r in records
            if all(r.env.get(k) == v for k, v in env_items.items())]


def tune_kernel(store, backend, *, arch_ids=None, seed: int = 0,
                artifacts=None) -> dict:
    """Analytic fit, measured fit over the zoo's GEMM cases, evaluation
    table.  Returns the predictions, the report and the backend's counts."""
    from repro_torch.configs.workloads import zoo_cases
    from repro_torch.core.kerneltune import (MEASURED_SOURCE, KernelTuner,
                                             build_training_log,
                                             measure_cases)
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
    cases = zoo_cases(arch_ids, with_flash=False)
    _, stats = measure_cases(cases, backend, store)
    measured = _own(store.load(algos="matmul_tile",
                               source=MEASURED_SOURCE).records,
                    {"timing": backend.name})
    mtun = KernelTuner(rule=rule).fit(measured)
    print(f"  measured {stats['measured']} tiles ({stats['cached']} cached, "
          f"{stats['bucket_hits']} bucket hits, {stats['pruned']} pruned) "
          f"in {time.time() - t0:.1f}s")
    preds = mtun.predict_batch([(c.m, c.k, c.n, c.dtype) for c in cases])
    print("  predictions:")
    predicted = {}
    for case, tile in zip(cases, preds):
        predicted[case.label] = tuple(int(v) for v in tile)
        print(f"  {case.label} (m,k,n)=({case.m},{case.k},{case.n}): "
              f"(block_m, block_n, block_k)={predicted[case.label]}")

    _banner(f"evaluation: predicted vs cost-model vs measured best ({backend.name})")
    report = evaluate_kernels(backend=backend, arch_ids=arch_ids, seed=seed,
                              store=store, with_flash=False)
    path = write_kernel_report(report, artifacts)
    ov = report["overall"]
    print(f"  {report['config']['n_rows']} cases: geomean speedup vs cost "
          f"model {ov['geomean_speedup_vs_costmodel']:.4f}, argmin hit rate "
          f"{ov['argmin_hit_rate']:.4f}, mean regret vs best "
          f"{ov['mean_regret_vs_best']:.4f} -> {path}")
    counts = {"measured": backend.measured, "reps": getattr(backend, "reps", 0),
              "verified": getattr(backend, "verified", 0),
              "verify_failures": getattr(backend, "verify_failures", 0)}
    return {"predicted": predicted, "eval": report, "backend": counts,
            "wall_s": time.time() - t_start}


def main(argv=None) -> dict:
    from repro_torch.configs import ARCH_IDS
    from repro_torch.data.logstore import LogStore
    from repro_torch.kernels.timing import SimulatorBackend, WallClockBackend

    ap = argparse.ArgumentParser(
        description="measure, fit and evaluate the blocked-matmul tile tuner")
    ap.add_argument("--arch", nargs="*", default=None, choices=ARCH_IDS,
                    help="architectures whose GEMM cases are measured "
                         "(default: the whole zoo)")
    ap.add_argument("--backend", choices=["wallclock", "sim"],
                    default="wallclock")
    ap.add_argument("--device", default="cuda",
                    help="device the wallclock backend times on")
    ap.add_argument("--store", default=None,
                    help="LogStore path; defaults to "
                         "<artifacts>/torch/tune_store.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    store_path = Path(args.store) if args.store else \
        artifacts_dir() / "tune_store.jsonl"
    if args.backend == "wallclock":
        backend = WallClockBackend(device=args.device, seed=args.seed)
    else:
        backend = SimulatorBackend(seed=args.seed)
    store = LogStore(store_path)
    result = tune_kernel(store, backend, arch_ids=args.arch, seed=args.seed,
                         artifacts=store_path.parent)
    _banner(f"store {store.path}: {len(store)} records by source "
            f"{store.sources()}")
    return result


if __name__ == "__main__":
    main()
