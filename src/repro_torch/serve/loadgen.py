"""Closed-loop load generator for the sharded serving tier, the port of
the JAX package's ``repro/serve/loadgen.py``.

``make_trace`` builds a seeded, fully deterministic request trace over a
realistic mix of query kinds:

* ``hot``      — a handful of keys replayed over and over (the memo-local
                 traffic consistent hashing is for);
* ``zipf``     — Zipf-distributed popularity over the whole universe
                 (few heavy keys, a long tail);
* ``uniform``  — uniform over the universe (memo-unfriendly);
* ``cold``     — queries for an algorithm the model abstains on, served
                 by the default-heuristic fallback until a refit lands.

``make_diurnal_trace`` scales that to fleet-sized workloads: the trace
is split into phases whose mix evolves like a day of traffic —
``diurnal`` (sinusoidal hot share), ``ramp``, ``spike``, ``cold_storm``
(a cold-start stampede at trace start), ``hot_migration`` (the hot
key set moves between shards mid-trace), and ``shifted_hotspot`` (a
heavily skewed hot set that jumps once at half-time — the workload that
exercises the autoscaler's cross-shard replica *migration* rather than
in-place growth).  Every entry carries a request
class (``interactive``/``batch``/``best_effort``) for the fleet's
admission control; same seed → byte-identical trace at any size
(10⁵–10⁶ requests is the intended range).

``run_load`` replays a trace from K client threads, closed-loop (each
client waits for its answer before sending the next request), and
reports throughput, p50/p95/p99 latency, per-shard hit rates,
**load balance** (``served_skew`` — max/mean served across serving
units, replicas when the router reports them, else shards — plus
per-shard served fractions), and **staleness violations**: a request
enqueued after a ``swap`` completed but served by an older
``model_version`` — the router's staleness contract says this count is
always zero, and the serving bench gates on exactly that.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.serve.router import DeadlineExceeded, RouterRejected

KINDS = ("hot", "zipf", "uniform", "cold")
DEFAULT_WEIGHTS = {"hot": 0.45, "zipf": 0.30, "uniform": 0.15, "cold": 0.10}

CLASSES = ("interactive", "batch", "best_effort")
DEFAULT_CLASS_WEIGHTS = (0.6, 0.3, 0.1)

DIURNAL_PATTERNS = ("diurnal", "ramp", "spike", "cold_storm",
                    "hot_migration", "shifted_hotspot")


def make_universe(shapes, algos, envs) -> list:
    """Cross shapes x algos x environments into estimator-style queries
    ``(n_rows, n_cols, algo, env_features)``.  ``envs`` may hold
    ``Environment`` objects or ready feature dicts."""
    universe = []
    for env in envs:
        feats = env.features() if hasattr(env, "features") else dict(env)
        for algo in algos:
            for n, m in shapes:
                universe.append((int(n), int(m), algo, feats))
    return universe


def make_trace(n_requests: int, universe, *, seed: int = 0,
               cold_queries=(), weights=None, hot_size: int = 4,
               zipf_a: float = 1.4) -> list:
    """Deterministic ``[(kind, query), ...]`` trace: same seed, same
    universe → byte-identical trace, equal to the reference's (asserted in
    tests/test_torch_serving.py).  With no ``cold_queries`` the cold share
    is folded into ``uniform``."""
    if not universe:
        raise ValueError("empty query universe")
    universe = list(universe)
    cold_queries = list(cold_queries)
    w = dict(DEFAULT_WEIGHTS)
    w.update(weights or {})
    if not cold_queries:
        w["uniform"] = w.get("uniform", 0.0) + w.pop("cold", 0.0)
        w["cold"] = 0.0
    names = [k for k in KINDS if w.get(k, 0.0) > 0.0]
    probs = np.array([w[k] for k in names], dtype=float)
    probs /= probs.sum()
    rng = np.random.default_rng(seed)
    hot = universe[:max(1, min(hot_size, len(universe)))]
    kinds = rng.choice(len(names), size=n_requests, p=probs)
    trace = []
    for k in kinds:
        name = names[k]
        if name == "hot":
            q = hot[rng.integers(len(hot))]
        elif name == "zipf":
            q = universe[(int(rng.zipf(zipf_a)) - 1) % len(universe)]
        elif name == "uniform":
            q = universe[rng.integers(len(universe))]
        else:
            q = cold_queries[rng.integers(len(cold_queries))]
        trace.append((name, q))
    return trace


def _phase_plan(pattern: str, n_phases: int, has_cold: bool) -> list[dict]:
    """Per-phase (hot share, cold share, hot-set offset, hot-set size
    multiplier) for each diurnal pattern."""
    plan = []
    for p in range(n_phases):
        frac = p / max(n_phases - 1, 1)
        hot, cold, offset, hot_mult = 0.45, 0.05, 0, 1
        if pattern == "diurnal":
            # sinusoidal day: quiet shoulders, a hot midday peak
            hot = 0.2 + 0.5 * (0.5 - 0.5 * np.cos(2 * np.pi * frac))
        elif pattern == "ramp":
            hot = 0.1 + 0.7 * frac
        elif pattern == "spike":
            hot = 0.3
            if p == n_phases // 2:
                hot, hot_mult = 0.9, 0          # one key takes the spike
        elif pattern == "cold_storm":
            cold = 0.7 if p == 0 else 0.05      # cold-start stampede
        elif pattern == "hot_migration":
            hot, offset = 0.6, p                # hot set moves each phase
        elif pattern == "shifted_hotspot":
            # heavily skewed, then the hot set jumps once at half-time:
            # the workload that makes replica *migration* (not growth)
            # the right autoscaler move.
            hot = 0.75
            offset = 0 if frac < 0.5 else max(n_phases, 2)
        else:
            raise ValueError(f"unknown pattern {pattern!r}; expected one "
                             f"of {DIURNAL_PATTERNS}")
        if not has_cold:
            cold = 0.0
        rest = max(1.0 - hot - cold, 0.0)
        plan.append({"hot": hot, "cold": cold, "zipf": rest * 0.6,
                     "uniform": rest * 0.4, "offset": offset,
                     "hot_mult": hot_mult})
    return plan


def make_diurnal_trace(n_requests: int, universe, *, seed: int = 0,
                       cold_queries=(), pattern: str = "diurnal",
                       n_phases: int = 8, hot_size: int = 4,
                       zipf_a: float = 1.4,
                       class_weights=DEFAULT_CLASS_WEIGHTS) -> list:
    """Seeded deterministic fleet-scale trace: ``[(kind, query, cls),
    ...]`` over ``n_phases`` phases whose mix follows ``pattern`` (see
    module docstring).  Phases partition the trace evenly, so replaying
    the list in order reproduces the diurnal shape; classes are drawn
    per-request for the fleet's admission control."""
    if not universe:
        raise ValueError("empty query universe")
    if n_requests < n_phases:
        n_phases = max(1, n_requests)
    universe = list(universe)
    cold_queries = list(cold_queries)
    plan = _phase_plan(pattern, n_phases, bool(cold_queries))
    rng = np.random.default_rng(seed)
    cw = np.array(class_weights, dtype=float)
    cw /= cw.sum()
    trace = []
    per_phase = [n_requests // n_phases] * n_phases
    per_phase[-1] += n_requests - sum(per_phase)
    for phase, n_phase in zip(plan, per_phase):
        names = [k for k in KINDS if phase.get(k, 0.0) > 0.0]
        probs = np.array([phase[k] for k in names], dtype=float)
        probs /= probs.sum()
        size = max(1, min(hot_size * max(phase["hot_mult"], 0) or 1,
                          len(universe)))
        start = (phase["offset"] * hot_size) % len(universe)
        hot = [universe[(start + i) % len(universe)] for i in range(size)]
        kinds = rng.choice(len(names), size=n_phase, p=probs)
        classes = rng.choice(len(CLASSES), size=n_phase, p=cw)
        for k, c in zip(kinds, classes):
            name = names[k]
            if name == "hot":
                q = hot[rng.integers(len(hot))]
            elif name == "zipf":
                q = universe[(int(rng.zipf(zipf_a)) - 1) % len(universe)]
            elif name == "uniform":
                q = universe[rng.integers(len(universe))]
            else:
                q = cold_queries[rng.integers(len(cold_queries))]
            trace.append((name, q, CLASSES[c]))
    return trace


def _percentile_ms(latencies_s, p: float) -> float:
    if len(latencies_s) == 0:
        # every request rejected/expired (exactly the overload-shedding
        # scenarios): an empty percentile is 0, not a crash
        return 0.0
    return float(np.percentile(np.asarray(latencies_s), p) * 1e3)


def staleness_violations(served, swap_log) -> int:
    """Count requests enqueued after a swap completed yet served by an
    older model version.  ``swap_log`` is ``ShardRouter.swap_log``:
    ``(monotonic completion time, version)`` in swap order, epoch 0
    included.  A request that was enqueued at ``t_enq`` must observe the
    version of the latest swap with completion time <= ``t_enq`` (newer is
    fine — the swap may have landed while it waited in queue)."""
    if not swap_log:
        return 0
    times = [t for t, _ in swap_log]
    versions = [v for _, v in swap_log]
    bad = 0
    for r in served:
        v = r.get("model_version")
        if v is None:
            continue
        # latest swap completed at or before enqueue
        i = 0
        for j, t in enumerate(times):
            if t <= r["t_enq"]:
                i = j
        if v < versions[i]:
            bad += 1
    return bad


def _unit_served(stats: dict) -> dict:
    """Served count per serving unit: replicas when the router reports
    them (the fleet), else logical shards."""
    units = stats.get("per_replica") or stats.get("per_shard") or []
    return {(u.get("shard"), u.get("replica")): u.get("served", 0)
            for u in units}


def served_skew(before: dict, after: dict) -> tuple[float, dict]:
    """Load balance of one run: ``max/mean`` served across units (1.0 is
    perfectly even) plus the per-unit deltas.  Units that appeared
    mid-run (autoscaler scale-out, crash respawn) count from zero."""
    b, a = _unit_served(before), _unit_served(after)
    deltas = {k: max(v - b.get(k, 0), 0) for k, v in a.items()}
    counts = list(deltas.values())
    if not counts or sum(counts) == 0:
        return 0.0, deltas
    mean = sum(counts) / len(counts)
    return max(counts) / mean, deltas


def run_load(router, trace, *, n_clients: int = 4, timeout: float = 30.0,
             include_latencies: bool = False, deadline_s: float | None = None,
             class_deadlines: dict | None = None) -> dict:
    """Replay ``trace`` against ``router`` from ``n_clients`` closed-loop
    client threads (client *i* owns ``trace[i::n_clients]``, so the
    per-client request order is deterministic) and aggregate the serving
    report.  Trace entries are ``(kind, query)`` or ``(kind, query,
    cls)``; classes are passed through to routers that support them.
    ``deadline_s`` (or the per-class ``class_deadlines``) attaches a
    server-side budget to every request — expired/shed requests are
    reported, never raised at the client."""
    results: list = [None] * len(trace)
    with_classes = getattr(router, "supports_classes", False)

    def client(ci: int):
        for i in range(ci, len(trace), n_clients):
            entry = trace[i]
            kind, query = entry[0], entry[1]
            cls = entry[2] if len(entry) > 2 else None
            dl = (class_deadlines or {}).get(cls, deadline_s)
            kw = {"cls": cls} if cls is not None and with_classes else {}
            base = {"kind": kind, "cls": cls, "rejected": False,
                    "expired": False}
            try:
                r = router.request(query, timeout=timeout, deadline_s=dl,
                                   **kw)
            except RouterRejected:
                results[i] = dict(base, rejected=True)
                continue
            except DeadlineExceeded:
                results[i] = dict(base, expired=True)
                continue
            except Exception as e:
                # a serving failure must not kill the client thread and
                # silently drop the rest of its trace slice — record it so
                # the report surfaces the root cause
                results[i] = dict(base, error=repr(e))
                continue
            results[i] = dict(base, shard=r.shard,
                              model_version=r.model_version,
                              chosen_by=r.chosen_by, t_enq=r.t_enq,
                              latency_s=r.latency_s)

    stats_before = router.stats()
    threads = [threading.Thread(target=client, args=(ci,),
                                name=f"loadgen-client-{ci}", daemon=True)
               for ci in range(max(1, n_clients))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = max(time.monotonic() - t0, 1e-9)
    stats_after = router.stats()

    done = [r for r in results if r is not None]
    errors = [r for r in done if r.get("error")]
    served = [r for r in done if not r["rejected"] and not r["expired"]
              and not r.get("error")]
    lat = [r["latency_s"] for r in served]
    by_kind = {}
    for kind in KINDS:
        rs = [r for r in done if r["kind"] == kind]
        if not rs:
            continue
        ok = [r for r in rs if not r["rejected"] and not r["expired"]
              and not r.get("error")]
        by_kind[kind] = {
            "n": len(rs), "served": len(ok),
            "rejected": sum(1 for r in rs if r["rejected"]),
            "expired": sum(1 for r in rs if r["expired"]),
            "default_frac": (sum(1 for r in ok
                                 if r["chosen_by"] == "default") / len(ok)
                             if ok else 0.0)}
    by_class = {}
    for cls in CLASSES:
        rs = [r for r in done if r.get("cls") == cls]
        if not rs:
            continue
        by_class[cls] = {
            "n": len(rs),
            "served": sum(1 for r in rs if not r["rejected"]
                          and not r["expired"] and not r.get("error")),
            "rejected": sum(1 for r in rs if r["rejected"]),
            "expired": sum(1 for r in rs if r["expired"])}
    skew, unit_deltas = served_skew(stats_before, stats_after)
    shard_served: dict = {}
    for (shard, _rid), n in unit_deltas.items():
        shard_served[shard] = shard_served.get(shard, 0) + n
    total_shard = sum(shard_served.values())
    report = {
        "requests": len(trace),
        "served": len(served),
        "rejected": sum(1 for r in done if r["rejected"]),
        "expired": sum(1 for r in done if r["expired"]),
        "errors": len(errors),
        "first_error": errors[0]["error"] if errors else None,
        "n_clients": n_clients,
        "wall_s": wall,
        "throughput_rps": len(served) / wall,
        "p50_ms": _percentile_ms(lat, 50),
        "p95_ms": _percentile_ms(lat, 95),
        "p99_ms": _percentile_ms(lat, 99),
        "mean_ms": float(np.mean(lat) * 1e3) if lat else 0.0,
        "staleness_violations": staleness_violations(served,
                                                     router.swap_log),
        "served_skew": skew,
        "served_units": len(unit_deltas),
        "per_shard_served_frac": {
            str(s): n / total_shard for s, n in sorted(shard_served.items())
        } if total_shard else {},
        "by_kind": by_kind,
        "by_class": by_class,
        "router": stats_after,
    }
    if include_latencies:
        report["latencies_ms"] = [v * 1e3 for v in lat]
    return report
