"""The online serving tier's front door: ``python -m repro_torch serve-estimator``.

    python -m repro_torch serve-estimator --demo               # sweep on the card
    python -m repro_torch serve-estimator --demo --device cpu  # on the CPU
    python -m repro_torch serve-estimator --store S --shards 8 --clients 8

The port of the JAX package's ``launch/serve_estimator.py``, in-process
path.  Warm a ``BlockSizeEstimator`` from a persistent ``LogStore``, stand
up the sharded router plus the background refit daemon, replay a seeded
closed-loop trace against it, and print a latency table — throughput,
p50/p95/p99 (host latencies: the router predicts on the host), per-shard
hit rates, load balance, and the staleness audit.  ``--demo`` grid-sweeps
a tiny corpus into a temporary store first, with the data and the task
bodies on ``--device`` (its records tagged with that device), so the
command works on a fresh checkout.  An empty/unfitted store still serves:
every query abstains to the default square heuristic until records arrive
and the daemon's first refit lands.

The reference's fleet mode (``--processes``, ``--transport``,
``--replicas``, ``--autoscale``, ``--workers``, ``--registry``,
``--wait-workers``, ``--auth-key``, ``--heartbeat``) is not ported yet:
any of those flags raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

DISLIB_ALGOS = ("kmeans", "pca", "gmm", "csvm", "rf")

# the reference's fleet-mode flags, as it parses them
FLEET_FLAGS = {"--processes": {"action": "store_true"},
               "--transport": {}, "--workers": {}, "--replicas": {},
               "--autoscale": {"action": "store_true"}, "--registry": {},
               "--wait-workers": {"type": int, "default": 0},
               "--auth-key": {},
               "--heartbeat": {"action": "store_true"}}


def _demo_store(tmp: str, device):
    """Sweep a tiny two-algorithm corpus, the data on ``device``, into a
    store under ``tmp``."""
    from repro_torch.core.gridsearch import grid_search
    from repro_torch.data.datasets import gaussian_blobs
    from repro_torch.data.executor import Environment
    from repro_torch.data.logstore import LogStore

    env = Environment(name="laptop", n_workers=4, n_nodes=1,
                      mem_limit_mb=2048.0, dispatch_overhead_s=1e-4,
                      ram_gb=16)
    store = LogStore(Path(tmp) / "serve_demo_store.jsonl")
    for algo, (n, m), seed in (("kmeans", (256, 16), 7),
                               ("gmm", (192, 12), 8)):
        X, y = gaussian_blobs(n, m, seed=seed, device=device)
        grid_search(X, y, algo, env, mult=1, reuse_measurements=True,
                    store=store)
    return store


def _universe_from_store(store, known, limit: int = 16) -> list:
    """Distinct ``(n_rows, n_cols, algo, env)`` queries the store has
    evidence for — the replayable traffic."""
    seen, universe = set(), []
    for rec, _src in store.iter_records():
        n = int(rec.dataset.get("rows", 0))
        m = int(rec.dataset.get("cols", 0))
        if n < 1 or m < 1 or rec.algo not in known:
            continue
        key = (n, m, rec.algo, tuple(sorted(rec.env.items())))
        if key in seen:
            continue
        seen.add(key)
        universe.append((n, m, rec.algo, dict(rec.env)))
        if len(universe) >= limit:
            break
    return universe


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="online block-size estimation service: warm from a "
                    "store, serve a seeded trace, print the latency table")
    ap.add_argument("--store", default=None,
                    help="LogStore path to warm from (and for the refit "
                         "daemon to tail)")
    ap.add_argument("--demo", action="store_true",
                    help="build a tiny temporary store first (no --store "
                         "needed)")
    ap.add_argument("--device", default="cuda",
                    help="device the --demo sweep's data and task bodies "
                         "run on (the router itself runs on the host)")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="tree",
                    help="cascade registry entry (see core/chained.py)")
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--admission", choices=("block", "reject"),
                    default="block")
    ap.add_argument("--batch-max", type=int, default=32)
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="micro-batch window per shard")
    ap.add_argument("--no-refit", action="store_true",
                    help="serve without the background refit daemon")
    ap.add_argument("--json", default=None,
                    help="also write the full serving report to this path")
    fleet = ap.add_argument_group(
        "fleet mode (not ported yet: any of these raises)")
    for flag, kw in FLEET_FLAGS.items():
        fleet.add_argument(flag, **kw)
    args = ap.parse_args(argv)

    asked = [flag for flag in FLEET_FLAGS
             if getattr(args, flag[2:].replace("-", "_"))]
    if asked:
        raise NotImplementedError(
            f"serve-estimator's fleet mode ({', '.join(asked)}) is not ported "
            "yet (ROADMAP.md, the serving fleet and its launchers)")
    if args.store is None and not args.demo:
        ap.error("pass --store PATH (or --demo for a self-contained run)")

    from repro_torch.core.estimator import BlockSizeEstimator
    from repro_torch.data.logstore import LogStore
    from repro_torch.device import resolve_device
    from repro_torch.serve import RefitDaemon, ShardRouter, make_trace, run_load

    # a missing card refuses the run before anything is swept
    device = resolve_device(args.device)
    tmp = None
    if args.store is not None:
        store = LogStore(args.store)
    else:
        tmp = tempfile.TemporaryDirectory()
        print(f"== demo: sweeping a tiny corpus on {device} into a temporary "
              "store", flush=True)
        store = _demo_store(tmp.name, device)

    est = BlockSizeEstimator(args.model)
    if len(store):
        try:
            est.fit(store.load())
        except ValueError:
            pass                     # all-OOM store: serve cold via default
    known = set(est.known_algos) or {"kmeans"}
    print(f"== warmed {args.model} estimator from {store.path} "
          f"({len(store)} records, algos={sorted(known)})", flush=True)

    universe = _universe_from_store(store, known)
    if not universe:
        # empty store: synthesize a tiny universe; everything abstains
        env = {"n_workers": 4, "n_nodes": 1, "mem_limit_mb": 2048.0,
               "ram_gb": 16}
        universe = [(256, 16, "kmeans", env), (512, 32, "kmeans", env),
                    (1024, 16, "kmeans", env)]
    cold_algo = next((a for a in DISLIB_ALGOS if a not in known), None)
    n0, m0, _a, env0 = universe[0]
    cold = [(n0, m0, cold_algo, env0)] if cold_algo else []

    router = ShardRouter(est, n_shards=args.shards,
                         queue_depth=args.queue_depth,
                         admission=args.admission,
                         batch_max=args.batch_max,
                         window_s=args.window_ms / 1e3)
    daemon = None
    if not args.no_refit:
        daemon = RefitDaemon(router, store, interval_s=0.05).start()
    try:
        trace = make_trace(args.requests, universe, seed=args.seed,
                           cold_queries=cold)
        t0 = time.time()
        report = run_load(router, trace, n_clients=args.clients)
        wall = time.time() - t0
    finally:
        if daemon is not None:
            daemon.stop()
        router.close()
        if tmp is not None:
            tmp.cleanup()

    st = report["router"]
    print(f"== served {report['served']}/{report['requests']} requests "
          f"({report['rejected']} rejected) from {args.clients} clients "
          f"over {st['n_shards']} shards in {wall:.2f}s", flush=True)
    print(f"  throughput  {report['throughput_rps']:8.0f} req/s")
    print(f"  latency     p50 {report['p50_ms']:.2f} ms   "
          f"p95 {report['p95_ms']:.2f} ms   p99 {report['p99_ms']:.2f} ms "
          "(host)")
    print(f"  memo        hit_rate {st['hit_rate']:.2f}  "
          f"invalidations {st['invalidations']}")
    print(f"  staleness   {report['staleness_violations']} violations "
          f"across {st['swaps']} model swaps "
          f"(daemon refits: {daemon.swaps if daemon else 'off'})")
    print("  shard  served  hit_rate  abstained  max_batch  rejected")
    for p in st["per_shard"]:
        print(f"  {p['shard']:>5}  {p['served']:>6}  {p['hit_rate']:8.2f}  "
              f"{p['abstained']:>9}  {p['max_batch']:>9}  "
              f"{p['rejected']:>8}")
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2) + "\n")
        print(f"# wrote {args.json}", flush=True)
    return report


if __name__ == "__main__":
    main()
