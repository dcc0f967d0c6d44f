"""The port's in-process serving tier (``repro_torch.serve``: the sharded
router, the refit daemon, the load generator, the stats schema) and its
``serve-estimator`` launcher, on the CPU: the reference's serving and
chaos cases (``tests/test_serving.py``, ``tests/test_chaos.py``) on the
port, and the pure parts held equal to the JAX package's on the same
inputs (ring placement, predictions, traces, staleness and skew audits,
stats)."""
import json
import threading
import time

import pytest
import torch

from repro.core.estimator import BlockSizeEstimator as JEstimator
from repro.core.estimator import EstimatorService as JService
from repro.serve import loadgen as jload
from repro.serve import router as jrouter
from repro.serve import stats as jstats
from repro_torch.core.estimator import BlockSizeEstimator, EstimatorService
from repro_torch.core.features import dataset_features
from repro_torch.core.log import ExecutionRecord
from repro_torch.data.executor import Environment
from repro_torch.data.logstore import LogStore
from repro_torch.eval.autorun import default_partitioning
from repro_torch.launch import serve_estimator
from repro_torch.serve import (DeadlineExceeded, HashRing, RefitDaemon,
                               RouterClosed, RouterRejected, ShardRouter,
                               StatsView, make_diurnal_trace, make_trace,
                               make_universe, normalize_stats, run_load,
                               served_skew, staleness_violations)
from repro_torch.serve import loadgen as tload

ENV = Environment(name="laptop", n_workers=4, n_nodes=1, mem_limit_mb=2048.0,
                  dispatch_overhead_s=1e-4, ram_gb=16)
SHAPES = ((256, 16), (512, 16), (128, 32), (64, 8), (1024, 64))


def synth_records(algo, shapes, best_pr, *, best_s=0.1, worse_s=2.0):
    """Synthetic grid cells with the argmin at (best_pr, 1): one fast
    record there, slower ones at the other row counts."""
    recs = []
    for n, m in shapes:
        for p_r in (1, 2, 4, 8):
            t = best_s if p_r == best_pr else worse_s + p_r
            recs.append(ExecutionRecord(dataset_features(n, m), algo,
                                        ENV.features(), p_r, 1, t, {}))
    return recs


def _fit_records():
    return (synth_records("kmeans", SHAPES, best_pr=4)
            + synth_records("gmm", SHAPES, best_pr=2))


@pytest.fixture
def fitted_est():
    return BlockSizeEstimator("tree").fit(_fit_records())


class SlowEstimator:
    """Stub backend whose batched predict sleeps — for backpressure and
    drain tests."""
    is_fit = True
    s = 2

    def __init__(self, delay=0.05):
        self.delay = delay
        self.model_version = 1
        self.calls = 0

    def abstains(self, algo):
        return False

    def predict_partitions_batch(self, queries):
        time.sleep(self.delay)
        self.calls += 1
        return [(2, 1)] * len(queries)


def q(n, m, algo="kmeans"):
    return (n, m, algo, ENV.features())


# ---------------------------------------------------------------- hashing
@pytest.mark.parametrize("ring", [(1, 32, None), (4, 32, None), (7, 16, None),
                                  (3, 32, [1.0, 2.5, 0.5])],
                         ids=["1", "4", "7x16", "weighted"])
def test_hash_ring_matches_reference(ring):
    n, vnodes, weights = ring
    got, want = HashRing(n, vnodes, weights), jrouter.HashRing(n, vnodes, weights)
    keys = [("k", i, "algo") for i in range(1000)]
    placed = [got.shard_for(k) for k in keys]
    assert placed == [want.shard_for(k) for k in keys]
    assert set(placed) == set(range(n))


def test_router_predicts_as_the_reference_service(fitted_est):
    """The router's answers are ``EstimatorService``'s, the port's and the
    JAX package's, query for query (bucketed keys, clamped shapes)."""
    jsvc = JService(JEstimator("tree").fit(_fit_records()))
    svc = EstimatorService(fitted_est)
    queries = ([q(*s) for s in SHAPES] + [q(*s, "gmm") for s in SHAPES]
               + [q(200, 16), q(3, 1000), q(100_000, 7, "gmm")])
    with ShardRouter(fitted_est, n_shards=4, window_s=0.0) as router:
        got = [router.predict(x) for x in queries]
        assert got == router.predict_batch(queries)
    assert got == [svc.predict(x) for x in queries]
    assert got == [jsvc.predict(x) for x in queries]


def test_router_key_affinity(fitted_est):
    with ShardRouter(fitted_est, n_shards=4, window_s=0.0) as router:
        queries = [q(*s) for s in SHAPES] + [q(192, 12, "gmm")]
        shards = {}
        for _ in range(3):
            for query in queries:
                res = router.request(query)
                key = router.shards[0].service._key(query)
                assert shards.setdefault(key, res.shard) == res.shard
                assert res.shard == router.shard_for(query)
        st = router.stats()
        assert st["hits"] >= 2 * len(queries)
        assert st["served"] == 3 * len(queries)


def test_bucketed_keys_share_a_shard(fitted_est):
    with ShardRouter(fitted_est, n_shards=4, window_s=0.0) as router:
        r1 = router.request(q(200, 16))      # bucket (256, 16)
        r2 = router.request(q(256, 16))
        assert r1.shard == r2.shard
        assert router.stats()["hits"] >= 1


# ----------------------------------------------------------- backpressure
def _fire(router, n, results):
    def one(i):
        try:
            results[i] = router.request(q(256 + i, 16), timeout=30)
        except (RouterRejected, RouterClosed) as e:
            results[i] = e
    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    return threads


def test_backpressure_reject():
    router = ShardRouter(SlowEstimator(delay=0.1), n_shards=1,
                         queue_depth=2, admission="reject", batch_max=1,
                         window_s=0.0)
    try:
        results = [None] * 10
        for t in _fire(router, 10, results):
            t.join()
        rejected = [r for r in results if isinstance(r, RouterRejected)]
        served = [r for r in results if not isinstance(r, Exception)]
        assert len(rejected) + len(served) == 10
        assert rejected and served
        assert router.stats()["rejected"] == len(rejected)
    finally:
        router.close()


def test_backpressure_block_drops_nothing():
    router = ShardRouter(SlowEstimator(delay=0.02), n_shards=1,
                         queue_depth=2, admission="block", batch_max=4,
                         window_s=0.0)
    try:
        results = [None] * 10
        for t in _fire(router, 10, results):
            t.join()
        assert all(not isinstance(r, Exception) and r is not None
                   for r in results)
        assert router.stats()["rejected"] == 0
        assert router.stats()["served"] == 10
    finally:
        router.close()


# ------------------------------------------------------------ refit/swap
def test_swap_serves_no_stale_memo(fitted_est):
    with ShardRouter(fitted_est, n_shards=1, window_s=0.0) as router:
        before = router.request(q(256, 16))
        assert before.value == (4, 1)            # argmin planted at p_r=4
        assert before.model_version == fitted_est.model_version
        moved = synth_records("kmeans", SHAPES, best_pr=8, best_s=0.01,
                              worse_s=5.0)
        assert router.refit(moved) is True
        assert router.backend is not fitted_est   # snapshot swapped in
        after = router.request(q(256, 16))
        assert after.model_version == before.model_version + 1
        assert after.value == (8, 1), "stale memo entry served after swap"
        assert router.stats()["invalidations"] == 1


def test_swap_backend_same_version_still_flushes(fitted_est):
    svc = EstimatorService(fitted_est)
    svc.predict(q(256, 16))
    assert svc._memo
    twin = fitted_est.snapshot()        # same model_version, new object
    svc.swap_backend(twin)
    assert not svc._memo and svc.invalidations == 1
    with ShardRouter(fitted_est, n_shards=1, window_s=0.0) as router:
        router.request(q(256, 16))
        router.swap(fitted_est.snapshot())
        assert router.request(q(256, 16)).value == (4, 1)
        assert router.stats()["invalidations"] == 1


def test_abstain_served_by_default_heuristic():
    est = BlockSizeEstimator("tree")            # never fit
    with ShardRouter(est, n_shards=2, window_s=0.0) as router:
        res = router.request(q(300, 20))
        assert res.chosen_by == "default"
        assert res.value == default_partitioning(300, 20, ENV)
        st = router.stats()
        assert st["abstained"] == 1 and st["hits"] == st["misses"] == 0


def test_predict_batch_enqueues_before_waiting():
    stub = SlowEstimator(delay=0.05)
    router = ShardRouter(stub, n_shards=1, batch_max=16, window_s=0.01)
    try:
        queries = [q(2 ** (i + 4), 16) for i in range(8)]  # distinct keys
        t0 = time.monotonic()
        out = router.predict_batch(queries)
        wall = time.monotonic() - t0
        assert out == [(2, 1)] * 8
        assert stub.calls <= 4, "queries served one-per-batch"
        assert wall < 8 * 0.05
    finally:
        router.close()


def test_poisoned_query_fails_batch_not_shard(fitted_est):
    def bad_fallback(query):
        raise RuntimeError("boom")

    with ShardRouter(fitted_est, n_shards=1, window_s=0.0,
                     abstain_fallback=bad_fallback) as router:
        with pytest.raises(RuntimeError, match="boom"):
            router.request(q(256, 16, "pca"), timeout=5)   # abstains
        res = router.request(q(256, 16), timeout=5)        # shard alive
        assert res.chosen_by == "model"
        assert router.shards[0].thread.is_alive()


# ------------------------------------------------------------ chaos
def test_shard_crash_respawns_and_loses_nothing(fitted_est):
    with ShardRouter(fitted_est, n_shards=3, window_s=0.0) as router:
        target = router.shard_for(q(*SHAPES[0]))
        dead = router.shards[target]
        router.inject_crash(target, after_batches=0)
        results = [router.request(q(*s)) for s in SHAPES for _ in range(4)]
        assert len(results) == len(SHAPES) * 4
        assert all(r.value is not None for r in results)
        stats = router.stats()
        assert stats["crashes"] == 1 and stats["respawns"] == 1
        assert stats["rerouted"] >= 1
        assert router.shards[target] is not dead
        assert router.shards[target].thread.is_alive()
        assert router.request(q(*SHAPES[0])).shard == target


def test_crash_counters_survive_in_totals(fitted_est):
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        for _ in range(6):
            router.request(q(*SHAPES[0]))
        target = router.shard_for(q(*SHAPES[0]))
        served_before = router.stats()["served"]
        router.inject_crash(target, after_batches=0)
        router.request(q(*SHAPES[0]))          # triggers crash + re-route
        stats = router.stats()
        assert stats["served"] == served_before + 1
        assert stats["crashes"] == 1


def test_crash_then_swap_preserves_staleness_contract(fitted_est):
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        target = router.shard_for(q(*SHAPES[0]))
        router.inject_crash(target, after_batches=0)
        router.request(q(*SHAPES[0]))
        assert router.refit(synth_records("pca", SHAPES[:2], best_pr=2))
        res = router.request(q(*SHAPES[0]))
        assert res.model_version == router.backend.model_version
        assert res.model_version > fitted_est.model_version


def test_deadline_expired_request_dropped_unserved(fitted_est):
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        with pytest.raises(DeadlineExceeded):
            router.request(q(*SHAPES[0]), deadline_s=-1e-3)
        ok = router.request(q(*SHAPES[0]), deadline_s=30.0)
        assert ok.value is not None
        stats = router.stats()
        assert stats["expired"] == 1
        assert stats["served"] == 1            # the expired one never counts


# ------------------------------------------------------------ refit daemon
def test_refit_daemon_poll_once(tmp_path, fitted_est):
    store = LogStore(tmp_path / "s.jsonl")
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        daemon = RefitDaemon(router, store)     # not started: driven by hand
        assert daemon.poll_once() is False      # nothing appended yet
        assert fitted_est.abstains("pca")
        store.append(synth_records("pca", SHAPES[:2], best_pr=2),
                     source="grid_search")
        assert daemon.poll_once() is True
        assert router.estimator is not fitted_est
        assert not router.estimator.abstains("pca")
        assert router.estimator.model_version == fitted_est.model_version + 1
        assert fitted_est.abstains("pca")       # snapshot-only learning


def test_refit_swap_under_load_no_staleness(tmp_path, fitted_est):
    store = LogStore(tmp_path / "s.jsonl")
    router = ShardRouter(fitted_est, n_shards=4, window_s=0.0)
    daemon = RefitDaemon(router, store, interval_s=0.005).start()
    try:
        universe = [q(*s) for s in SHAPES] + [q(*s, "gmm") for s in SHAPES]
        trace = make_trace(150, universe, seed=3,
                           cold_queries=[q(256, 16, "pca")])
        writer = threading.Thread(
            target=lambda: store.append(
                synth_records("pca", SHAPES[:3], best_pr=4), source="w"),
            daemon=True)
        writer.start()
        report = run_load(router, trace, n_clients=4)
        writer.join()
        deadline = time.time() + 10
        while daemon.swaps < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert daemon.swaps >= 1, daemon.last_error
        report2 = run_load(router, trace, n_clients=4)
        assert report["staleness_violations"] == 0
        assert report2["staleness_violations"] == 0
        assert report2["by_kind"]["cold"]["default_frac"] == 0.0
        versions = [v for _, v in router.swap_log]
        assert versions == sorted(versions)
    finally:
        daemon.stop()
        router.close()


def test_refit_daemon_persists_cursor_and_resumes(tmp_path, fitted_est):
    store = LogStore(tmp_path / "s.jsonl")
    cursor_file = tmp_path / "refit.cursor"
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        d1 = RefitDaemon(router, store, cursor_path=cursor_file)
        assert json.loads(cursor_file.read_text())["cursor"] == 0
        store.append(synth_records("pca", SHAPES[:2], best_pr=2), source="grid")
        assert d1.poll_once() is True
        persisted = json.loads(cursor_file.read_text())["cursor"]
        assert persisted == d1.cursor == len(store)
        d2 = RefitDaemon(router, store, cursor_path=cursor_file)
        assert d2.cursor == persisted
        store.append(synth_records("rf", SHAPES[:2], best_pr=4), source="grid")
        assert d2.poll_once() is True
        assert not router.estimator.abstains("rf")
        assert json.loads(cursor_file.read_text())["cursor"] == len(store)


def test_refit_daemon_holds_cursor_across_unswapped_folds(tmp_path, fitted_est):
    store = LogStore(tmp_path / "s.jsonl")
    cursor_file = tmp_path / "refit.cursor"
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        d1 = RefitDaemon(router, store, cursor_path=cursor_file)
        store.append(synth_records("kmeans", SHAPES[:1], best_pr=4,
                                   best_s=0.2, worse_s=9.0), source="grid")
        assert d1.poll_once() is False
        assert d1.cursor == len(store)
        assert json.loads(cursor_file.read_text())["cursor"] == 0
        d2 = RefitDaemon(router, store, cursor_path=cursor_file)
        assert d2.cursor == 0
        assert d2.poll_once() is False
        assert d2.cursor == len(store)


def test_refit_daemon_corrupt_cursor_falls_back_to_tail(tmp_path, fitted_est):
    store = LogStore(tmp_path / "s.jsonl")
    store.append(synth_records("pca", SHAPES[:1], best_pr=2), source="g")
    cursor_file = tmp_path / "refit.cursor"
    cursor_file.write_text("not json{{{")
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        d = RefitDaemon(router, store, cursor_path=cursor_file)
        assert d.cursor == len(store)
        assert json.loads(cursor_file.read_text())["cursor"] == len(store)


def test_refit_daemon_explicit_cursor_wins(tmp_path, fitted_est):
    store = LogStore(tmp_path / "s.jsonl")
    store.append(synth_records("pca", SHAPES[:1], best_pr=2), source="g")
    cursor_file = tmp_path / "refit.cursor"
    cursor_file.write_text(json.dumps({"cursor": len(store)}))
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        d = RefitDaemon(router, store, cursor=0, cursor_path=cursor_file)
        assert d.cursor == 0
        assert d.poll_once() is True


# ---------------------------------------------------------------- loadgen
UNIVERSE = make_universe(SHAPES, ("kmeans", "gmm"), [ENV, Environment(n_workers=16)])
COLD = [q(256, 16, "pca")]


@pytest.mark.parametrize("seed", [0, 11, 12])
def test_make_trace_matches_reference(seed):
    assert UNIVERSE == jload.make_universe(
        SHAPES, ("kmeans", "gmm"), [ENV.features(), Environment(n_workers=16).features()])
    for kw in ({"cold_queries": COLD}, {}, {"weights": {"hot": 0.9}, "hot_size": 2}):
        got = make_trace(300, UNIVERSE, seed=seed, **kw)
        assert got == jload.make_trace(300, UNIVERSE, seed=seed, **kw)
    kinds = {k for k, _ in make_trace(300, UNIVERSE, seed=seed, cold_queries=COLD)}
    assert kinds == {"hot", "zipf", "uniform", "cold"}
    assert all(k != "cold" for k, _ in make_trace(50, UNIVERSE[:1], seed=seed))


@pytest.mark.parametrize("pattern", tload.DIURNAL_PATTERNS)
def test_make_diurnal_trace_matches_reference(pattern):
    for cold in (COLD, ()):
        got = make_diurnal_trace(500, UNIVERSE, seed=4, cold_queries=cold,
                                 pattern=pattern)
        assert got == jload.make_diurnal_trace(500, UNIVERSE, seed=4,
                                               cold_queries=cold, pattern=pattern)
        assert len(got) == 500
    with pytest.raises(ValueError, match="unknown pattern"):
        make_diurnal_trace(10, UNIVERSE, pattern="nope")


def test_audits_match_reference():
    """staleness_violations and served_skew on the same served log, swap log
    and stats snapshots."""
    swap_log = [(0.0, 1), (1.0, 2), (2.5, 4)]
    served = [{"t_enq": t, "model_version": v}
              for t, v in ((0.1, 1), (1.1, 1), (1.2, 2), (2.6, 2), (2.7, 4),
                           (3.0, None), (0.5, 4), (2.5, 3))]
    assert staleness_violations(served, swap_log) == \
        jload.staleness_violations(served, swap_log) == 3
    assert staleness_violations(served, []) == 0
    before = {"per_shard": [{"shard": 0, "served": 5}, {"shard": 1, "served": 1}]}
    after = {"per_shard": [{"shard": 0, "served": 25}, {"shard": 1, "served": 6},
                           {"shard": 2, "served": 3}]}
    replicas = {"per_replica": [{"shard": 0, "replica": r, "served": 4 * r}
                                for r in range(3)]}
    for b, a in ((before, after), ({}, after), (before, before), ({}, replicas)):
        assert served_skew(b, a) == jload.served_skew(b, a)


def test_run_load_report(fitted_est):
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        trace = make_trace(60, [q(*s) for s in SHAPES], seed=1)
        report = run_load(router, trace, n_clients=3)
        assert report["served"] == 60 and report["rejected"] == 0
        assert report["staleness_violations"] == 0
        assert report["p50_ms"] <= report["p95_ms"] <= report["p99_ms"]
        assert report["throughput_rps"] > 0
        assert sum(p["served"] for p in report["router"]["per_shard"]) == 60


# --------------------------------------------------------------- shutdown
def test_graceful_drain_serves_everything_queued():
    router = ShardRouter(SlowEstimator(delay=0.03), n_shards=1,
                         queue_depth=32, admission="block", batch_max=2,
                         window_s=0.0)
    results = [None] * 8
    threads = _fire(router, 8, results)
    time.sleep(0.02)                      # let the clients enqueue
    router.close(drain=True)
    for t in threads:
        t.join()
    assert all(r is not None and not isinstance(r, Exception)
               for r in results), results
    assert router.pending == 0
    assert not any(sh.thread.is_alive() for sh in router.shards)
    with pytest.raises(RouterClosed):
        router.request(q(1, 1))


def test_close_without_drain_cancels_queued():
    router = ShardRouter(SlowEstimator(delay=0.1), n_shards=1,
                         queue_depth=32, admission="block", batch_max=1,
                         window_s=0.0)
    results = [None] * 6
    threads = _fire(router, 6, results)
    time.sleep(0.02)
    router.close(drain=False)
    for t in threads:
        t.join()
    assert all(r is not None for r in results)
    assert any(isinstance(r, RouterClosed) for r in results) or \
        all(not isinstance(r, Exception) for r in results)


# ---------------------------------------------------------------- stats
def test_stats_schema_matches_reference(fitted_est):
    assert normalize_stats({}) == jstats.normalize_stats({})
    legacy = {"version": 3, "n_workers": 2, "pending": 1, "heartbeat_respawns": 4,
              "n_shards": 2, "per_shard": [{"shard": 0}]}
    assert normalize_stats(legacy) == jstats.normalize_stats(legacy)
    with ShardRouter(fitted_est, n_shards=2, window_s=0.0) as router:
        router.request(q(256, 16))
        raw = router.stats()
    assert raw == jstats.normalize_stats(raw)
    view = StatsView(legacy)
    assert view["version"] == view["model_version"] == 3
    assert view.get("pending") == 1 and "pending" in view
    assert view.to_dict() == jstats.StatsView(legacy).to_dict()


# -------------------------------------------------- the serve-estimator CLI
def test_serve_estimator_demo_on_cpu(capsys):
    report = serve_estimator.main(["--demo", "--device", "cpu",
                                   "--requests", "120", "--window-ms", "0"])
    out = capsys.readouterr().out
    assert report["served"] == report["requests"] == 120
    assert report["rejected"] == report["expired"] == report["errors"] == 0
    assert report["staleness_violations"] == 0
    assert "0 violations" in out and "(host)" in out
    assert report["by_kind"]["cold"]["default_frac"] > 0   # pca abstains


def test_serve_estimator_cli_from_a_store(tmp_path, capsys):
    store = LogStore(tmp_path / "s.jsonl")
    store.append(_fit_records(), source="seed")
    out = tmp_path / "report.json"
    report = serve_estimator.main(["--store", str(tmp_path / "s.jsonl"),
                                   "--device", "cpu", "--requests", "60",
                                   "--clients", "2", "--shards", "2",
                                   "--window-ms", "0", "--json", str(out)])
    assert report["served"] == 60
    assert report["staleness_violations"] == 0
    assert report["router"]["n_shards"] == 2
    assert json.loads(out.read_text())["served"] == 60
    assert "throughput" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--processes"], ["--autoscale"], ["--heartbeat"],
                                  ["--transport", "socket"], ["--replicas", "2"],
                                  ["--workers", "h:1"], ["--registry", "r.jsonl"],
                                  ["--wait-workers", "2"], ["--auth-key", "k"]],
                         ids=lambda f: f[0])
def test_serve_estimator_refuses_fleet_flags(flag):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, the serving fleet and its launchers"):
        serve_estimator.main(["--demo", "--device", "cpu", *flag])


def test_serve_estimator_refuses_the_card_it_does_not_have():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_estimator.main(["--demo"])
