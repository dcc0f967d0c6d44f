"""The paper's evaluation protocol and the closed loop:
``python -m repro_torch evaluate``.

    python -m repro_torch evaluate --smoke               # on the card
    python -m repro_torch evaluate --smoke --device cpu  # on the CPU
    python -m repro_torch evaluate --skip-loop           # harness only

The port of the JAX package's ``launch/evaluate.py``.  Runs the paper-§V
evaluation harness (exact-hit rate, exponent distance, modeled speedup vs
the default ds-array blocking, leave-one-out splits) with the data and the
task bodies on ``--device``, and the closed-loop autorun demo (predict →
execute → log → refit → invalidate), then writes
``<artifacts>/eval_report.json`` and ``<artifacts>/BENCH_eval.json``.  The
artifacts directory is ``--artifacts PATH`` > ``$REPRO_ARTIFACTS/torch`` >
the checkout's ``artifacts/torch/``, so the port never writes the
checkout's own ``BENCH_eval.json``; ``--bench-out PATH`` moves the payload.
``--store PATH`` persists every executed record into a LogStore as well,
each tagged with the device that timed it.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path


def _fmt(m: dict) -> str:
    if m.get("groups", 0) == 0:
        return "no groups"
    parts = [f"hit={m['exact_hit_rate']:.2f}",
             f"expdist={m['mean_exp_distance']:.2f}"]
    if "mean_speedup_vs_default" in m:
        parts.append(f"speedup_vs_default={m['mean_speedup_vs_default']:.2f}x")
    return " ".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="closed-loop autotuning + paper-style evaluation")
    ap.add_argument("--smoke", action="store_true",
                    help="small dataset grid (seconds; what CI runs)")
    ap.add_argument("--artifacts", default=None,
                    help="artifacts directory (default: $REPRO_ARTIFACTS/"
                         "torch or the checkout's artifacts/torch/)")
    ap.add_argument("--store", default=None,
                    help="optional LogStore path; measured records persist "
                         "there with run-provenance source tags")
    ap.add_argument("--bench-out", default=None,
                    help="BENCH_eval.json path (default: <artifacts>/"
                         "BENCH_eval.json)")
    ap.add_argument("--model", default="tree",
                    help="cascade registry entry (see core/chained.py)")
    ap.add_argument("--skip-loop", action="store_true",
                    help="skip the closed-loop demo (harness only)")
    ap.add_argument("--device", default="cuda",
                    help="device the datasets and task bodies run on")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.artifacts import artifacts_dir
    from repro_torch.data.logstore import LogStore
    from repro_torch.device import resolve_device
    from repro_torch.eval.autorun import closed_loop_demo
    from repro_torch.eval.harness import bench_payload, evaluate, write_report

    # a missing card refuses the run before anything is written
    device = str(resolve_device(args.device))
    store = LogStore(args.store) if args.store else None

    print(f"== paper-§V evaluation harness on {device}", flush=True)
    report = evaluate(smoke=args.smoke, model=args.model, seed=args.seed,
                      store=store, device=device, verbose=True)
    for algo, m in report["per_algo"].items():
        print(f"  {algo:>7}: {_fmt(m)}", flush=True)
    print(f"  overall: {_fmt(report['overall'])}  "
          f"({report['config']['n_groups']} groups, "
          f"{report['wall_s']:.1f}s)", flush=True)

    if not args.skip_loop:
        print("== closed loop: predict -> execute -> log -> refit -> "
              "invalidate", flush=True)
        report["closed_loop"] = closed_loop_demo(store, verbose=True,
                                                 device=device)

    path = write_report(report, args.artifacts)
    print(f"# wrote {path}", flush=True)

    bench_out = Path(args.bench_out) if args.bench_out else \
        artifacts_dir(args.artifacts) / "BENCH_eval.json"
    bench_out.parent.mkdir(parents=True, exist_ok=True)
    bench_out.write_text(json.dumps(bench_payload(report), indent=2) + "\n")
    print(f"# wrote {bench_out}", flush=True)

    if store is not None:
        print(f"# store {store.path}: {len(store)} records by source "
              f"{store.sources()}", flush=True)
    return report


if __name__ == "__main__":
    main()
