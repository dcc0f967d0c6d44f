"""The serving fleet in the port (src/repro_torch/serve/fleet.py): replica
groups, crash respawn with zero lost requests, rolling-swap staleness,
admission classes, deadline shedding, the autoscaler, demand planning and
migration, the health prober and checkpoint/restore -- the counterparts of
tests/test_fleet.py's fleet tests, each wait bounded on its own -- and
parity with the JAX package on the same seeded inputs: the trace
histogram and the three replica planners, the answers of both fleets over
loopback and over process workers, the autoscaler's actions from injected
stats, and checkpoints that restore across the packages."""
import json
import threading
import time

import pytest

from repro.serve import fleet as jfleet
from repro_torch.core.estimator import BlockSizeEstimator
from repro_torch.serve import (STATS_SCHEMA, AutoscalePolicy, Autoscaler,
                               DeadlineExceeded, FleetRouter, HashRing,
                               HeartbeatPolicy, ShardRouter, ShedRejected,
                               StatsView, TransportSpec, demand_plan,
                               live_demand_plan, make_diurnal_trace,
                               normalize_stats, proportional_plan, run_load,
                               trace_histogram)
from repro_torch.serve import fleet as tfleet
from repro_torch.serve.fleet import CLASS_PRIORITY
from repro_torch.serve.loadgen import DIURNAL_PATTERNS, _percentile_ms, served_skew

from _torch_fleet import (SHAPES, SlowEstimator, bounded, fitted, q,
                          synth_records, universe, wait_until)


@pytest.fixture(autouse=True)
def _bounded():
    with bounded():
        yield


@pytest.fixture
def fitted_est():
    return fitted()


def lost(*reports):
    return sum(r["requests"] - r["served"] - r["rejected"] - r["expired"]
               for r in reports)


def test_percentile_of_empty_is_zero():
    assert _percentile_ms([], 50) == 0.0
    assert _percentile_ms([], 99) == 0.0


def test_weighted_ring_shifts_capacity():
    plain = HashRing(4, vnodes=32)
    heavy = HashRing(4, vnodes=32, weights=[1.0, 3.0, 1.0, 1.0])
    keys = [("k", i) for i in range(2000)]

    def share(ring, s):
        return sum(1 for k in keys if ring.shard_for(k) == s) / len(keys)
    assert share(heavy, 1) > share(plain, 1) * 1.5


# ------------------------------------------------------------ basic serving
def test_fleet_serves_and_matches_backend(fitted_est):
    with FleetRouter(fitted_est, n_shards=3, replicas=2, window_s=0.001) as fleet:
        for query in universe():
            r = fleet.request(query, timeout=30)
            assert r.value == fitted_est.predict_partitions(*query)
            assert r.shard == fleet.shard_for(query)
        st = fleet.stats()
        assert st["served"] == len(universe())
        assert st["n_replicas"] == 6
        assert sum(p["served"] for p in st["per_replica"]) == st["served"]


def test_fleet_diurnal_trace_deterministic():
    uni = universe()
    for pattern in DIURNAL_PATTERNS:
        t1 = make_diurnal_trace(500, uni, seed=11, pattern=pattern)
        t2 = make_diurnal_trace(500, uni, seed=11, pattern=pattern)
        assert t1 == t2
        assert len(t1) == 500
        assert all(cls in CLASS_PRIORITY for _, _, cls in t1)
    assert make_diurnal_trace(500, uni, seed=12) != make_diurnal_trace(500, uni, seed=11)


# --------------------------------------------------------- crash / respawn
def test_process_crash_respawn_zero_lost(fitted_est):
    """A worker process dying mid-batch loses nothing: orphans re-route
    inside the replica group, a fresh worker respawns, totals stay
    consistent."""
    trace = make_diurnal_trace(240, universe(("kmeans",)), seed=0, pattern="diurnal")
    with FleetRouter(fitted_est, n_shards=2, replicas=2, transport="process",
                     window_s=0.001, call_timeout_s=30.0) as fleet:
        fleet.inject_crash(fleet.shard_for(trace[0][1]), after_batches=1)
        rep = run_load(fleet, trace, n_clients=4, timeout=60)
        st = fleet.stats()
        assert rep["errors"] == 0, rep["first_error"]
        assert rep["served"] == rep["requests"]
        assert st["crashes"] == 1 and st["respawns"] == 1
        assert st["rerouted"] >= 1
        assert st["served"] == rep["requests"]   # retired counters folded


def test_loopback_crash_respawn_zero_lost(fitted_est):
    trace = make_diurnal_trace(240, universe(("kmeans",)), seed=2)
    with FleetRouter(fitted_est, n_shards=2, replicas=1, window_s=0.001) as fleet:
        fleet.inject_crash(fleet.shard_for(trace[0][1]), after_batches=1)
        rep = run_load(fleet, trace, n_clients=4, timeout=60)
        assert rep["errors"] == 0, rep["first_error"]
        assert rep["served"] == rep["requests"]
        assert fleet.stats()["crashes"] == 1


def test_single_replica_crash_never_refuses_a_caller(fitted_est, monkeypatch):
    """A one-replica shard between its worker's death and the respawn has
    no live replica: a request arriving then waits for the respawn instead
    of failing with ``RouterClosed``.  The respawn is slowed to 50 ms and a
    client that is not held by the crashed batch submits inside it."""
    slow = {"on": False}
    spawn = FleetRouter._spawn

    def slow_spawn(self, *a, **kw):
        if slow["on"]:
            time.sleep(0.05)
        return spawn(self, *a, **kw)

    monkeypatch.setattr(FleetRouter, "_spawn", slow_spawn)
    with FleetRouter(fitted_est, n_shards=1, replicas=1, window_s=0.0,
                     batch_max=1) as fleet:
        slow["on"] = True
        fleet.inject_crash(0, after_batches=0)
        first = fleet._submit(q(256, 16), None, "interactive")   # dies with it
        assert wait_until(lambda: fleet.crashes == 1, timeout=10)   # respawning
        r = fleet.request(q(512, 16), timeout=30)                 # in the window
        assert r.value == fitted_est.predict_partitions(*q(512, 16))
        assert fleet._await(first, 30).value == fitted_est.predict_partitions(*q(256, 16))
        st = fleet.stats()
        assert st["crashes"] == st["respawns"] == 1 and st["served"] == 2


def test_rolling_swap_under_load_no_staleness(fitted_est):
    """Swap mid-trace while 4 clients hammer the fleet: zero staleness
    violations, and requests admitted after swap() returns see the new
    version."""
    est2 = BlockSizeEstimator("tree").fit(
        synth_records("kmeans", SHAPES, 4) + synth_records("gmm", SHAPES, 2)
        + synth_records("pca", SHAPES, 8, best_s=0.01))
    trace = make_diurnal_trace(400, universe(), seed=7, pattern="ramp")
    with FleetRouter(fitted_est, n_shards=3, replicas=2, window_s=0.001) as fleet:
        swapped = threading.Event()

        def swapper():
            time.sleep(0.02)
            fleet.swap(est2)
            swapped.set()

        th = threading.Thread(target=swapper, daemon=True)
        th.start()
        rep = run_load(fleet, trace, n_clients=4, timeout=60)
        th.join(30)
        assert swapped.is_set()
        assert rep["errors"] == 0, rep["first_error"]
        assert rep["staleness_violations"] == 0
        assert fleet.stats()["read_barrier"] == est2.model_version
        r = fleet.request(q(256, 16, "pca"), timeout=30)
        assert r.model_version == est2.model_version
        assert r.chosen_by == "model"


@pytest.mark.parametrize("transport", ["process", "socket"])
def test_swap_during_crash_respawns_at_target(fitted_est, transport):
    """A replica (a worker process, or a dropped connection) crashing while
    a rolling swap is in flight respawns at the swap target, never at the
    stale model."""
    est2 = BlockSizeEstimator("tree").fit(
        synth_records("kmeans", SHAPES, 2, best_s=0.01))
    trace = make_diurnal_trace(200, universe(("kmeans",)), seed=9)
    with FleetRouter(fitted_est, n_shards=2, replicas=2, transport=transport,
                     window_s=0.001, call_timeout_s=30.0) as fleet:
        fleet.inject_crash(fleet.shard_for(trace[0][1]), after_batches=0)
        th = threading.Thread(target=lambda: (time.sleep(0.01), fleet.swap(est2)),
                              daemon=True)
        th.start()
        rep = run_load(fleet, trace, n_clients=4, timeout=60)
        th.join(30)
        assert not th.is_alive()
        assert rep["errors"] == 0, rep["first_error"]
        assert rep["staleness_violations"] == 0
        for row in fleet.stats()["per_replica"]:
            if row["alive"]:
                assert row["version"] == est2.model_version


# ------------------------------------------------- admission & shedding
def test_class_shedding_priority_order():
    """Background classes shed before interactive."""
    slow = SlowEstimator(delay=0.2)
    with FleetRouter(slow, n_shards=1, replicas=1, queue_depth=8, admission="block",
                     batch_max=1, window_s=0.0) as fleet:
        reqs = [fleet._submit(q(256 + i, 16), None, "interactive") for i in range(6)]
        with pytest.raises(ShedRejected) as ei:
            fleet._submit(q(999, 16), None, "best_effort")
        assert ei.value.cls == "best_effort"
        with pytest.raises(ShedRejected):
            fleet._submit(q(998, 16), None, "batch")
        reqs.append(fleet._submit(q(997, 16), None, "interactive"))
        for r in reqs:
            assert r.event.wait(30)
        st = fleet.stats()
        assert st["shed"] == 2
        assert st["per_replica"][0]["shed"] == 2


def test_early_deadline_drop_before_enqueue():
    slow = SlowEstimator(delay=0.1)
    with FleetRouter(slow, n_shards=1, replicas=1, queue_depth=64, admission="block",
                     batch_max=1, window_s=0.0) as fleet:
        fleet.request(q(256, 16), timeout=30)      # establish the EMA
        rep = fleet.groups[0].replicas[0]
        assert rep.ema_s > 0.0
        backlog = [fleet._submit(q(300 + i, 16), None, "interactive") for i in range(8)]
        with pytest.raises(DeadlineExceeded):
            fleet.request(q(888, 16), timeout=5, deadline_s=0.01)
        assert fleet.stats()["shed_deadline"] == 1
        for r in backlog:
            assert r.event.wait(30)


def test_unknown_class_rejected(fitted_est):
    with FleetRouter(fitted_est, n_shards=1) as fleet:
        with pytest.raises(ValueError):
            fleet.request(q(256, 16), cls="bulk")


# ------------------------------------------------------------- autoscaler
def test_autoscaler_scale_out_and_in_hysteresis():
    slow = SlowEstimator(delay=0.05)
    pol = AutoscalePolicy(hi=0.5, lo=0.05, up_after=2, down_after=2, cooldown=0,
                          min_replicas=1, max_replicas=3)
    with FleetRouter(slow, n_shards=1, replicas=1, queue_depth=8, admission="block",
                     batch_max=1, window_s=0.0) as fleet:
        scaler = Autoscaler(fleet, pol)
        rep = fleet.groups[0].replicas[0]
        rep.window_hw = 8
        assert scaler.tick() == []             # 1 hot tick: not yet
        rep.window_hw = 8
        assert scaler.tick() == [(2, "out", 0)]
        assert fleet.n_replicas == 2
        assert fleet.stats()["scale_outs"] == 1
        assert scaler.tick() == []
        assert scaler.tick() == [(4, "in", 0)]
        assert wait_until(lambda: fleet.n_replicas == 1, timeout=30)
        assert fleet.stats()["scale_ins"] == 1


def test_autoscaler_respects_max_total():
    slow = SlowEstimator(delay=0.01)
    pol = AutoscalePolicy(hi=0.5, up_after=1, cooldown=0, max_replicas=4, max_total=2)
    with FleetRouter(slow, n_shards=2, replicas=1, queue_depth=4, batch_max=1,
                     window_s=0.0) as fleet:
        scaler = Autoscaler(fleet, pol)
        for g in fleet.groups:
            g.replicas[0].window_hw = 4
        assert scaler.tick() == []
        assert fleet.n_replicas == 2


# ------------------------------------------------- replication & skew
def _skew_scenario(mods, est):
    trace = mods.make_diurnal_trace(600, universe(("kmeans",)), seed=3, pattern="diurnal")
    counts = {}
    with mods.ShardRouter(est, n_shards=4, window_s=0.001) as router:
        for (_k, query, _c) in trace:
            s = router.shard_for(query)
            counts[s] = counts.get(s, 0) + 1
        base = run_load(router, [(k, query) for k, query, _ in trace], n_clients=4,
                        timeout=60)
    mean = sum(counts.values()) / 4
    plan = {s: max(1, round(counts.get(s, 0) / mean)) for s in range(4)}
    return trace, counts, plan, base


def test_replication_fixes_served_skew(fitted_est):
    """Hot-key traffic concentrates on one shard; replicating it spreads
    its load.  The histogram and the plan are held to the reference's
    exactly; the timed half to its contract: no request lost, and skew
    below the single-replica router's and no lower than the plan allows
    (the reference's 1.6 leaves the read-any picker 3 requests of the 157
    each of the hot shard's two replicas should serve -- ROADMAP §3)."""
    import repro.serve as jserve
    import repro_torch.serve as tserve
    trace, counts, plan, base = _skew_scenario(tserve, fitted_est)
    _jt, jcounts, jplan, _jb = _skew_scenario(jserve, fitted("jax"))
    assert (trace, counts, plan) == (_jt, jcounts, jplan)
    with FleetRouter(fitted_est, n_shards=4, replicas=plan, window_s=0.001) as fleet:
        rep = run_load(fleet, trace, n_clients=4, timeout=60)
    assert rep["errors"] == 0, rep["first_error"]
    assert rep["served"] == rep["requests"] == 600
    ideal = max(counts.get(s, 0) / plan[s] for s in range(4)) / (600 / sum(plan.values()))
    assert ideal - 1e-9 <= rep["served_skew"] < base["served_skew"]


def test_stats_consistent_during_crash_respawn(fitted_est):
    trace = make_diurnal_trace(300, universe(("kmeans",)), seed=4)
    with FleetRouter(fitted_est, n_shards=2, replicas=2, window_s=0.001) as fleet:
        fleet.inject_crash(fleet.shard_for(trace[0][1]), after_batches=1)
        stop = threading.Event()
        seen, bad = [], []

        def poller():
            while not stop.is_set():
                st = fleet.stats()
                if seen and st["served"] < seen[-1]:
                    bad.append((seen[-1], st["served"]))
                seen.append(st["served"])

        th = threading.Thread(target=poller, daemon=True)
        th.start()
        try:
            rep = run_load(fleet, trace, n_clients=4, timeout=60)
        finally:
            stop.set()
            th.join(10)
        assert not bad, f"served went backwards: {bad[:3]}"
        assert rep["served"] == rep["requests"]
        assert fleet.stats()["served"] == rep["requests"]


def test_served_skew_helper_counts_new_units():
    before = {"per_replica": [{"shard": 0, "replica": 1, "served": 10}]}
    after = {"per_replica": [{"shard": 0, "replica": 1, "served": 30},
                             {"shard": 0, "replica": 2, "served": 20}]}
    skew, deltas = served_skew(before, after)
    assert deltas == {(0, 1): 20, (0, 2): 20}
    assert skew == 1.0


# ------------------------------------------------------------- lifecycle
def test_close_resolves_everything_queued():
    slow = SlowEstimator(delay=0.05)
    fleet = FleetRouter(slow, n_shards=1, replicas=1, queue_depth=64, batch_max=1,
                        window_s=0.0)
    reqs = [fleet._submit(q(256 + i, 16), None, "interactive") for i in range(10)]
    fleet.close(drain=True)
    for r in reqs:
        assert r.event.wait(30)
        assert r.result is not None or r.error is not None
    assert fleet.stats()["served"] == 10


def test_scale_in_never_drops_last_replica(fitted_est):
    with FleetRouter(fitted_est, n_shards=1, replicas=1) as fleet:
        assert fleet.scale_in(0) is None
        assert fleet.n_replicas == 1


# --------------------------------------------------------- socket fleets
def test_socket_crash_respawn_zero_lost(fitted_est):
    """Peer disconnect during an in-flight batch behaves exactly like a
    worker loss."""
    trace = make_diurnal_trace(240, universe(("kmeans",)), seed=3)
    with FleetRouter(fitted_est, n_shards=2, replicas=2, transport="socket",
                     window_s=0.001, call_timeout_s=30.0) as fleet:
        fleet.inject_crash(fleet.shard_for(trace[0][1]), after_batches=1)
        rep = run_load(fleet, trace, n_clients=4, timeout=60)
        st = fleet.stats()
        assert rep["errors"] == 0, rep["first_error"]
        assert rep["served"] == rep["requests"]
        assert st["crashes"] == 1 and st["respawns"] == 1
        assert st["served"] == rep["requests"]


def test_socket_attach_and_reattach_on_crash(fitted_est):
    """Attach mode: replicas bind to operator-run workers; a dropped
    connection reattaches to the *same* address."""
    from repro_torch.serve import serve_socket_worker
    from _torch_fleet import attached_worker
    workers = [attached_worker(serve_socket_worker) for _ in range(2)]
    addrs = [a for _, a in workers]
    trace = make_diurnal_trace(120, universe(("kmeans",)), seed=4)
    try:
        with FleetRouter(fitted_est, n_shards=2, replicas=1, transport="socket",
                         worker_addrs=list(addrs), window_s=0.001,
                         call_timeout_s=30.0) as fleet:
            crash_shard = fleet.shard_for(trace[0][1])
            fleet.inject_crash(crash_shard, after_batches=0)
            rep = run_load(fleet, trace, n_clients=4, timeout=60)
            st = fleet.stats()
            assert rep["errors"] == 0, rep["first_error"]
            assert rep["served"] == rep["requests"]
            assert st["crashes"] == 1 and st["respawns"] == 1
            with fleet.groups[crash_shard].lock:
                live = [r for r in fleet.groups[crash_shard].replicas if not r.dead]
            assert live and live[0].addr in addrs   # reattached, not local
            assert live[0].transport.proc is None
    finally:
        for srv, _ in workers:
            srv.close()


# ------------------------------------------- demand planning & migration
def test_proportional_plan_apportions_budget_exactly():
    plan = proportional_plan([90, 5, 5], 6)
    assert sum(plan.values()) == 6
    assert plan[0] > plan[1] and plan[0] > plan[2]
    assert min(plan.values()) >= 1
    plan = proportional_plan([0, 100, 0, 0], 8)
    assert plan[1] == 5 and plan[0] == plan[2] == plan[3] == 1
    plan = proportional_plan([1, 1, 1], 1)
    assert sum(plan.values()) == 3
    assert proportional_plan([10, 10], 5) == proportional_plan([10, 10], 5)


def test_live_demand_plan_uses_window_deltas():
    prior = {"per_shard": [{"shard": 0, "served": 1000}, {"shard": 1, "served": 1000}]}
    now = {"per_shard": [{"shard": 0, "served": 1010}, {"shard": 1, "served": 1900}]}
    plan = live_demand_plan(now, 4, prior=prior)
    assert sum(plan.values()) == 4
    assert plan[1] > plan[0]
    assert sum(live_demand_plan(now, 4).values()) == 4


def test_migrate_moves_a_replica_and_conserves_total(fitted_est):
    with FleetRouter(fitted_est, n_shards=2, replicas={0: 2, 1: 1},
                     window_s=0.001) as fleet:
        assert fleet.migrate(0, 1) is not None
        assert wait_until(lambda: fleet.n_replicas <= 3, timeout=10)
        st = fleet.stats()
        assert st["n_replicas"] == 3
        assert st["migrations"] == 1
        assert {p["shard"]: p["replicas"] for p in st["per_shard"]} == {0: 1, 1: 2}
        assert fleet.migrate(0, 1) is None   # donor at the floor
        assert fleet.migrate(1, 1) is None   # self-move is a no-op


def test_autoscaler_rebalance_follows_demand(fitted_est):
    with FleetRouter(fitted_est, n_shards=2, replicas={0: 3, 1: 1},
                     window_s=0.001) as fleet:
        pol = AutoscalePolicy(rebalance_every=1, rebalance_min_window=8,
                              moves_per_rebalance=4, max_replicas=8)
        scaler = Autoscaler(fleet, pol)
        hot = [query for query in universe(("kmeans",))
               if fleet.shard_for(query) == 1] or universe(("kmeans",))[:1]
        for _ in range(40):
            fleet.request(hot[0], timeout=30)
        actions = scaler.rebalance()
        assert actions and all(a[1] == "move" for a in actions)
        assert all(a[2] == 0 and a[3] == 1 for a in actions)
        assert wait_until(lambda: fleet.n_replicas <= 4, timeout=10)
        st = fleet.stats()
        assert st["migrations"] >= 1
        assert st["n_replicas"] == 4
        assert scaler.rebalance() == []


def test_shifted_hotspot_trace_moves_the_hot_set():
    trace = make_diurnal_trace(2000, universe(), seed=0, pattern="shifted_hotspot",
                               hot_size=2)
    half = len(trace) // 2
    first = {repr(query) for kind, query, _ in trace[:half] if kind == "hot"}
    second = {repr(query) for kind, query, _ in trace[half:] if kind == "hot"}
    assert first and second and not (first & second)


# ---------------------------------------------- control plane: heartbeats
def test_prober_replaces_silent_worker_before_callers_notice(fitted_est):
    fleet = FleetRouter(fitted_est, n_shards=1, replicas=2, transport="loopback",
                        window_s=0.001,
                        heartbeat=HeartbeatPolicy(interval_s=0.05, timeout_s=2.0,
                                                  miss_after=2))
    try:
        assert fleet.request(q(256, 16), timeout=30).value
        fleet.silent_kill(0, replica=0)
        assert wait_until(lambda: fleet.stats()["heartbeat_replacements"] >= 1,
                          timeout=30, tick=fleet.prober.probe_once)
        st = fleet.stats()
        assert st["heartbeat_replacements"] == 1
        assert st["crashes"] == 1 and st["respawns"] == 1
        assert fleet.request(q(256, 16), timeout=30).value
        assert fleet.stats()["rerouted"] == 0          # nobody saw it die
        assert fleet.stats()["heartbeats"] >= 2
    finally:
        fleet.close()


def test_prober_thread_replaces_a_killed_process_worker(fitted_est):
    """The prober's own thread (what ``--heartbeat`` starts) finds a
    SIGKILLed process worker and replaces it; callers see no error."""
    fleet = FleetRouter(fitted_est, n_shards=1, replicas=2, transport="process",
                        window_s=0.001, call_timeout_s=30.0,
                        heartbeat=HeartbeatPolicy(interval_s=0.02, timeout_s=5.0,
                                                  miss_after=2))
    try:
        fleet.prober.start()
        assert fleet.request(q(256, 16), timeout=30).value
        fleet.silent_kill(0, replica=0)
        assert wait_until(lambda: fleet.stats()["heartbeat_replacements"] >= 1,
                          timeout=30)
        rep = run_load(fleet, make_diurnal_trace(100, universe(), seed=1),
                       n_clients=4, timeout=60)
        assert rep["errors"] == 0 and rep["served"] == 100
        assert fleet.stats()["crashes"] == 1
    finally:
        fleet.close()


# ------------------------------------- control plane: checkpoint/restore
def test_checkpoint_restore_mid_trace_zero_lost(fitted_est, tmp_path):
    est_v2 = fitted_est.snapshot()
    assert est_v2.refit(synth_records("pca", SHAPES, 8))
    assert est_v2.model_version > fitted_est.model_version
    trace = make_diurnal_trace(400, universe(), seed=2)
    half = len(trace) // 2
    ckpt = tmp_path / "router.ckpt"
    fleet = FleetRouter(fitted_est, n_shards=2, replicas={0: 2, 1: 1},
                        transport="loopback", window_s=0.001)
    try:
        rep1 = run_load(fleet, trace[:half], n_clients=4, timeout=60)
        fleet.swap(est_v2)
        fleet.checkpoint(ckpt)
        st1 = fleet.stats()
    finally:
        fleet.close()
    assert rep1["errors"] == 0 and rep1["served"] == half
    with pytest.raises(ValueError, match="read barrier"):
        FleetRouter.restore(ckpt, fitted_est)
    fleet2 = FleetRouter.restore(ckpt, est_v2)
    try:
        st2 = fleet2.stats()
        assert st2["n_shards"] == 2
        assert st2["n_replicas"] == st1["n_replicas"]
        assert st2["read_barrier"] == est_v2.model_version
        rep2 = run_load(fleet2, trace[half:], n_clients=4, timeout=60)
    finally:
        fleet2.close()
    assert rep2["errors"] == 0 and rep2["served"] == len(trace) - half
    assert rep2["staleness_violations"] == 0
    assert lost(rep1, rep2) == 0


# -------------------------------------- control plane: spec, stats
def test_fleet_accepts_transport_spec(fitted_est):
    with FleetRouter(fitted_est, n_shards=2, transport=TransportSpec(kind="loopback"),
                     window_s=0.001) as fleet:
        assert fleet.request(q(256, 16), timeout=30).value
        assert fleet.stats()["transport"] == "loopback"


def test_stats_schema_normalization_and_compat_view(fitted_est):
    norm = normalize_stats({"served": 5, "model_version": 3, "n_shards": 2})
    assert norm["served"] == 5 and norm["crashes"] == 0
    assert norm["read_barrier"] == 3
    assert norm["n_replicas"] == 2
    view = StatsView(norm)
    assert view["version"] == 3
    assert view["n_workers"] == 2
    assert view["pending"] == norm["queued"]
    assert "served" in view and dict(view.to_dict())["served"] == 5
    with ShardRouter(fitted_est, n_shards=2, window_s=0.001) as router:
        router.request(q(256, 16), timeout=30)
        st = router.stats()
    assert not [k for k in STATS_SCHEMA if k not in st]
    with FleetRouter(fitted_est, n_shards=2, transport="loopback",
                     window_s=0.001) as fleet:
        fst = fleet.stats()
    assert not [k for k in STATS_SCHEMA if k not in fst]


# ======================================= parity with the JAX package
@pytest.fixture(scope="module")
def both():
    return fitted("torch"), fitted("jax")


TRACES = [(3000, 0, "diurnal"), (2000, 5, "spike"), (2000, 7, "ramp"),
          (2000, 1, "shifted_hotspot")]


@pytest.mark.parametrize("n,seed,pattern", TRACES, ids=lambda v: str(v))
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_trace_histogram_and_demand_plan_match_reference(both, n, seed, pattern,
                                                         n_shards):
    import repro.serve as jserve
    test, jest = both
    trace = make_diurnal_trace(n, universe(), seed=seed, pattern=pattern)
    jtrace = jserve.make_diurnal_trace(n, universe(), seed=seed, pattern=pattern)
    assert trace == jtrace
    hist = trace_histogram(test, trace, n_shards)
    assert hist == jfleet.trace_histogram(jest, jtrace, n_shards)
    assert sum(hist) == n
    for units in (4, 8, 10, 16):
        assert demand_plan(test, trace, n_shards, target_units=units) == \
            jfleet.demand_plan(jest, jtrace, n_shards, target_units=units)


def test_proportional_and_live_plans_match_reference():
    import numpy as np
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 9))
        counts = [int(c) for c in rng.integers(0, 1000, size=n)]
        if rng.random() < 0.2:
            counts[int(rng.integers(0, n))] = 0
        budget = int(rng.integers(0, 3 * n + 4))
        assert proportional_plan(counts, budget) == jfleet.proportional_plan(counts, budget)
        prior = {"per_shard": [{"shard": s, "served": int(c // 2)}
                               for s, c in enumerate(counts)]}
        now = {"per_shard": [{"shard": s, "served": c} for s, c in enumerate(counts)]}
        for pr in (None, prior):
            assert live_demand_plan(now, budget, prior=pr) == \
                jfleet.live_demand_plan(now, budget, prior=pr)
    assert CLASS_PRIORITY == jfleet.CLASS_PRIORITY
    assert tfleet.DEFAULT_CLASS_FRACS == jfleet.DEFAULT_CLASS_FRACS


@pytest.mark.parametrize("transport", ["loopback", "process"])
def test_both_fleets_give_the_same_answers(both, transport):
    test, jest = both
    trace = make_diurnal_trace(120, universe(("kmeans", "gmm", "pca")), seed=8,
                               pattern="spike")
    out = {}
    for name, mod, est in (("torch", tfleet, test), ("jax", jfleet, jest)):
        with mod.FleetRouter(est, n_shards=3, replicas={1: 2}, transport=transport,
                             window_s=0.001, call_timeout_s=30.0) as fleet:
            got = [fleet.request(query, timeout=60) for (_k, query, _c) in trace]
            out[name] = ([(r.value, r.shard, r.model_version, r.chosen_by) for r in got],
                         fleet.stats()["per_shard"])
    assert out["torch"][0] == out["jax"][0]
    assert [p["served"] for p in out["torch"][1]] == [p["served"] for p in out["jax"][1]]
    # the abstained pca queries answer from the same default in both
    assert any(by == "default" for _v, _s, _m, by in out["torch"][0])


class _FakeReplica:
    def __init__(self, hw, qsize):
        self.hw, self.q, self.dead, self.draining = hw, qsize, False, False
        self.queue = self

    def qsize(self):
        return self.q

    def take_window_hw(self):
        hw, self.hw = self.hw, self.q
        return hw


class _FakeGroup:
    def __init__(self, shard, reps):
        self.shard, self.replicas, self.lock = shard, reps, threading.Lock()


class _FakeFleet:
    """The fleet surface an ``Autoscaler`` reads and drives, with its
    queue high-waters and served histogram injected per tick."""
    queue_depth = 8

    def __init__(self, plan):
        self.groups = [_FakeGroup(s, [_FakeReplica(0, 0) for _ in range(n)])
                       for s, n in plan.items()]
        self.served = {s: 0 for s in plan}
        self.calls = []

    @property
    def n_replicas(self):
        return sum(len(g.replicas) for g in self.groups)

    def inject(self, hws, served):
        for g, hw in zip(self.groups, hws):
            for r in g.replicas:
                r.hw = hw
        for s, n in served.items():
            self.served[s] += n

    def stats(self):
        return {"per_shard": [{"shard": g.shard, "served": self.served[g.shard],
                               "replicas": len(g.replicas)} for g in self.groups]}

    def scale_out(self, s):
        self.calls.append(("out", s))
        self.groups[s].replicas.append(_FakeReplica(0, 0))
        return True

    def scale_in(self, s):
        reps = self.groups[s].replicas
        if len(reps) <= 1:
            return None
        self.calls.append(("in", s))
        reps.pop()
        return True

    def migrate(self, a, b):
        if a == b or self.scale_in(a) is None:
            return None
        self.calls.append(("move", a, b))
        self.groups[b].replicas.append(_FakeReplica(0, 0))
        return True


def _drive(mod, script, policy_kw):
    fleet = _FakeFleet({0: 1, 1: 2, 2: 1, 3: 1})
    scaler = mod.Autoscaler(fleet, mod.AutoscalePolicy(**policy_kw))
    actions = []
    for hws, served in script:
        fleet.inject(hws, served)
        actions.append(scaler.tick())
    actions.append(scaler.rebalance())
    return actions, fleet.calls, scaler.ticks, scaler.events


@pytest.mark.parametrize("policy_kw", [
    dict(hi=0.5, lo=0.05, up_after=2, down_after=2, cooldown=1, max_replicas=3),
    dict(hi=0.25, lo=0.1, up_after=1, down_after=3, cooldown=0, max_replicas=4,
         max_total=7, rebalance_every=3, rebalance_min_window=16, moves_per_rebalance=2),
    dict(up_after=3, down_after=1, cooldown=2, rebalance_every=2, budget=6,
         rebalance_min_window=4, moves_per_rebalance=3, max_replicas=5)],
    ids=["hysteresis", "rebalance", "budget"])
def test_autoscaler_actions_match_reference(policy_kw):
    import numpy as np
    rng = np.random.default_rng(1)
    script = []
    for t in range(24):
        hot = t // 8                       # the hot shard moves every 8 ticks
        hws = [int(rng.integers(0, 9)) if s == hot else int(rng.integers(0, 2))
               for s in range(4)]
        served = {s: int(rng.integers(40, 80)) if s == hot else int(rng.integers(0, 5))
                  for s in range(4)}
        script.append((hws, served))
    mine, ref = _drive(tfleet, script, policy_kw), _drive(jfleet, script, policy_kw)
    assert mine == ref
    assert any(mine[0]), "the script must make the autoscaler act"


def _checkpoint(mod, est, path, universe_queries):
    with mod.FleetRouter(est, n_shards=3, replicas={0: 2, 2: 3}, window_s=0.001,
                         weights=[1.0, 2.0, 1.0], vnodes=16, queue_depth=64,
                         batch_max=8) as fleet:
        for query in universe_queries:
            fleet.request(query, timeout=30)
        fleet.swap(est)
        state = fleet.checkpoint(path)
        routes = [fleet.shard_for(query) for query in universe_queries]
    return state, routes


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(both, tmp_path, writer):
    """A fleet checkpoint written by one package restores in the other
    with the same ring geometry, replica plan, barrier and counters."""
    test, jest = both
    mods = {"torch": (tfleet, test), "jax": (jfleet, jest)}
    reader = "jax" if writer == "torch" else "torch"
    uni = universe(("kmeans", "gmm", "pca"))
    ckpt = tmp_path / "fleet.ckpt"
    state, routes = _checkpoint(*mods[writer], ckpt, uni)
    assert json.loads(ckpt.read_text()) == state
    rmod, rest = mods[reader]
    fleet = rmod.FleetRouter.restore(ckpt, rest)
    try:
        st = fleet.stats()
        assert [fleet.shard_for(query) for query in uni] == routes
        assert {p["shard"]: p["replicas"] for p in st["per_shard"]} == {0: 2, 1: 1, 2: 3}
        assert st["read_barrier"] == state["read_barrier"] == rest.model_version
        assert st["swaps"] == len(state["swap_log"])
        assert fleet.queue_depth == 64 and fleet._vnodes == 16
        assert fleet._weights == [1.0, 2.0, 1.0]
        r = fleet.request(uni[0], timeout=30)
        assert r.value == rest.predict_partitions(*uni[0])
    finally:
        fleet.close()
    # and the state the reader would write back is the writer's
    again = tmp_path / "again.ckpt"
    state2, _ = _checkpoint(rmod, rest, again, uni)
    drop = ("swap_log",)
    assert {k: v for k, v in state2.items() if k not in drop} == \
        {k: v for k, v in state.items() if k not in drop}
