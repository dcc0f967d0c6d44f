"""The port's task-graph runtime against the JAX package's, on the CPU: the
schedulers agree exactly on random DAGs, ``TaskMemoryError`` is raised on
the same tasks when the inputs are tensors, the measurement cache hits as
often as the reference's on the same sweep, fault recovery gives the same
values and the same fault statistics, and the threadpool backend gives
what the inline one gives.  Durations are injected into both packages by
one seeded clock (``tests/_torch_ds.py``), so every schedule compares
exactly."""
import math

import numpy as np
import pytest
import torch

from _torch_ds import inject_clock, n, t
from repro.algorithms import run as jrun
from repro.data import datasets as jds
from repro.data import executor as jex
from repro.data import taskgraph as jtg
from repro.data.distarray import DistArray as JDist
from repro.runtime import fault as jfault
from repro_torch.algorithms import kmeans as tkmeans
from repro_torch.algorithms import run as trun
from repro_torch.core.gridsearch import grid_search as t_grid_search
from repro_torch.data import datasets as tds
from repro_torch.data import executor as tex
from repro_torch.data import taskgraph as ttg
from repro_torch.data.distarray import DistArray as TDist
from repro_torch.runtime import fault as tfault


def _random_dag(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 40))
    durs = [float(d) for d in rng.exponential(1.0, k)]
    deps = [tuple(sorted({int(d) for d in rng.integers(0, i, rng.integers(0, 3))}))
            if i else () for i in range(k)]
    names = [str(rng.choice(["a", "b", "c"])) for _ in range(k)]
    return durs, deps, names, int(rng.integers(1, 7))


# ------------------------------------------------------------- schedulers
@pytest.mark.parametrize("seed", range(8))
def test_schedulers_agree_exactly_on_random_dags(seed):
    durs, deps, names, w = _random_dag(seed)
    assert ttg.lpt_makespan(durs, w) == jtg.lpt_makespan(durs, w)
    assert (ttg.list_schedule_makespan(durs, deps, w)
            == jtg.list_schedule_makespan(durs, deps, w))
    assert (ttg.phase_barrier_makespan(names, durs, deps, w)
            == jtg.phase_barrier_makespan(names, durs, deps, w))


@pytest.mark.parametrize("seed", range(8))
def test_fault_list_schedule_agrees_exactly(seed):
    durs, deps, _, w = _random_dag(seed)
    horizon = jtg.list_schedule_makespan(durs, deps, w)
    retry = [0.1 * (i % 3) for i in range(len(durs))]
    outs = []
    for fault in (jfault, tfault):
        plan = fault.FaultPlan.seeded(
            seed, w, n_tasks=len(durs), horizon_s=horizon, p_loss=0.4,
            straggler=fault.StragglerConfig(warmup=1, patience=1,
                                            threshold=1.5))
        rt = fault.FaultRuntime(plan, w)
        mod = jtg if fault is jfault else ttg
        try:
            res = mod.fault_list_schedule(durs, deps, retry, rt, t0=0.5,
                                          dispatch_s=1e-3)
        except fault.AllWorkersLostError as e:
            res = ("lost", str(e))
        outs.append((res, rt.events, sorted(rt.lost), sorted(rt.quarantined),
                     rt.reexecutions, plan.losses == () or len(plan.losses)))
    assert outs[0] == outs[1]


def test_fault_plans_and_retry_policies_agree():
    for seed in range(5):
        jp = jfault.FaultPlan.seeded(seed, 6, n_tasks=50, horizon_s=2.0)
        tp = tfault.FaultPlan.seeded(seed, 6, n_tasks=50, horizon_s=2.0)
        assert ([(x.worker, x.at) for x in jp.losses]
                == [(x.worker, x.at) for x in tp.losses])
        assert ([(x.worker, x.factor, x.after) for x in jp.slowdowns]
                == [(x.worker, x.factor, x.after) for x in tp.slowdowns])
        assert jp.transient == tp.transient
        assert jp.retry.delays() == tp.retry.delays()
        assert [jp.retry_delay(k) for k in range(4)] \
            == [tp.retry_delay(k) for k in range(4)]
        assert [jp.factor(w, 1.0) for w in range(6)] \
            == [tp.factor(w, 1.0) for w in range(6)]
    with pytest.raises(tfault.RetryExhausted) as ei:
        tfault.FaultPlan(retry=tfault.RetryPolicy(max_retries=2)).retry_delay(5)
    assert ei.value.attempts == 3


# ------------------------------------------------------------ memory model
def _args(rng, lib):
    shapes = [(64, 8), (300, 40), (1000, 20), (4, 4), (2000, 64)]
    out = []
    for i, shp in enumerate(shapes):
        a = rng.normal(size=shp)
        if i % 2:
            a = a.astype(np.float32)
        b = rng.integers(0, 5, shp[0])
        out.append(((a, (b, 1.5), {"c": a[:, :2]}), float(i)))
    if lib == "t":
        out = [(t(x[:2]) + ({"c": t(x[2]["c"])},), e) for x, e in out]
    return out


@pytest.mark.parametrize("limit_mb", [0.05, 0.5, 2.0])
def test_memory_error_on_the_same_tasks(limit_mb):
    raised = {}
    for lib, mod in (("j", jtg), ("t", ttg)):
        g = mod.TaskGraph(mod.Environment(n_workers=2, mem_limit_mb=limit_mb))
        hits = []
        for args, extra in _args(np.random.default_rng(0), lib):
            try:
                g.submit(lambda *a: 0, *args, name="m", extra_mb=extra * 0.01)
                hits.append(False)
            except mod.TaskMemoryError:
                hits.append(True)
        raised[lib] = hits
    assert raised["t"] == raised["j"]
    assert any(raised["t"]) and not all(raised["t"])


def test_tensor_inputs_count_their_bytes():
    x = torch.zeros((1024, 128), dtype=torch.float64)     # 1 MiB
    assert ttg._input_mb((x, (x[:, :64],), {"a": x.to(torch.float32)})) == 2.0
    g = ttg.TaskGraph(ttg.Environment(mem_limit_mb=2.9))   # 3 x 1 MiB > 2.9
    with pytest.raises(ttg.TaskMemoryError):
        g.submit(torch.sum, x, name="s")


def test_tensor_signatures_key_shape_dtype_and_device():
    a = torch.zeros(3, 4, dtype=torch.float64)
    sigs = {ttg._arg_sig(a), ttg._arg_sig(a.T), ttg._arg_sig(a.float()),
            ttg._arg_sig(torch.zeros(4, 4, dtype=torch.float64))}
    assert len(sigs) == 4
    assert ttg._arg_sig(a)[0] == "tensor" and "cpu" in ttg._arg_sig(a)
    assert ttg._shape_sig((a, 1.0)) == ttg._shape_sig((a.clone(), 2.0))
    assert ttg._capture_sig(a) == ttg._arg_sig(a)
    assert ttg._first_device(((1, {"k": a}),)) == torch.device("cpu")
    assert ttg._first_device((1, "x")) is None


def test_bit_identity_of_tensors():
    a = torch.tensor([1.0, float("nan"), -2.0], dtype=torch.float64)
    assert ttg._bit_identical(a, a.clone())
    assert ttg._bit_identical((a, [a]), (a.clone(), [a.clone()]))
    assert not ttg._bit_identical(a, a.float())
    assert not ttg._bit_identical(a, a + 1e-16 * 0 + torch.tensor([0, 0, 1e-12]))
    assert not ttg._bit_identical(a, a.numpy())
    assert ttg._bit_identical(torch.arange(3), torch.arange(3))


# ------------------------------------------------------- measurement cache
ALGO_DATA = {"kmeans": dict(k=3, iters=3), "pca": dict(n_components=3),
             "gmm": dict(k=2, iters=3), "csvm": {}, "rf": dict(n_trees=4)}


@pytest.mark.parametrize("algo", sorted(ALGO_DATA))
def test_measurement_cache_hits_match_reference(algo, monkeypatch):
    inject_clock(monkeypatch, seed=3)
    Xj, yj = jds.gaussian_blobs(240, 12, n_classes=2, seed=4)
    Xt, yt = tds.gaussian_blobs(240, 12, n_classes=2, seed=4, device="cpu")
    got = {}
    for lib in ("j", "t"):
        mod, dist, run = (jex, JDist, jrun) if lib == "j" else (tex, TDist, trun)
        X, y = (Xj, yj) if lib == "j" else (Xt, yt)
        cache = mod.MeasurementCache()
        counts = []
        for pr, pc in ((4, 2), (4, 3), (2, 2), (4, 2)):
            ex = mod.TaskExecutor(mod.Environment(n_workers=4),
                                  measure_cache=cache)
            run(algo, ex, dist.from_array(X, pr, pc), y, **ALGO_DATA[algo])
            counts.append((ex.n_tasks, ex.executed_tasks, ex.replayed_tasks,
                           ex.sim_time))
        got[lib] = (cache.hits, cache.misses, len(cache), counts)
    assert got["t"] == got["j"]
    assert got["t"][0] > 0


# ---------------------------------------------------------- fault recovery
ENV = dict(name="laptop", n_workers=4, n_nodes=1, mem_limit_mb=2048.0,
           dispatch_overhead_s=1e-4, ram_gb=16)


def _chaos_kmeans(lib, plan_kw, monkeypatch, iters=3):
    inject_clock(monkeypatch, seed=11)
    mod, fault = (jex, jfault) if lib == "j" else (tex, tfault)
    if lib == "j":
        X = JDist.from_array(jds.gaussian_blobs(192, 12, seed=2)[0], 2, 2)
        from repro.algorithms import kmeans
    else:
        X = TDist.from_array(tds.gaussian_blobs(192, 12, seed=2, device="cpu")[0], 2, 2)
        kmeans = tkmeans
    plan = fault.FaultPlan(
        losses=tuple(fault.WorkerLoss(*w) for w in plan_kw.get("losses", ())),
        transient=plan_kw.get("transient", {}),
        retry=fault.RetryPolicy(max_retries=3, backoff_s=0.25))
    ex = mod.TaskExecutor(mod.Environment(**ENV), fault_plan=plan)
    out = kmeans.fit(ex, X, k=4, iters=iters, seed=0)
    return ex, out


@pytest.mark.parametrize("plan_kw", [
    {"losses": ((1, 0.004),)}, {"losses": ((1, 0.002), (2, 0.006))},
    {"transient": {0: 2, 5: 1}}, {}],
    ids=["one-loss", "two-losses", "transient", "fault-free"])
def test_fault_recovery_matches_reference(plan_kw, monkeypatch):
    jex_, jout = _chaos_kmeans("j", plan_kw, monkeypatch)
    tex_, tout = _chaos_kmeans("t", plan_kw, monkeypatch)
    assert tex_.fault_stats() == jex_.fault_stats()
    assert tex_.sim_time == jex_.sim_time
    np.testing.assert_allclose(n(tout["centers"]), jout["centers"],
                               rtol=1e-8, atol=1e-8)
    assert all(np.array_equal(n(a), b)
               for a, b in zip(tout["labels"], jout["labels"]))
    if "losses" in plan_kw:
        assert tex_.fault_stats()["reexecuted_tasks"] >= 1
    # the recovered run is bit-identical to the port's fault-free run
    _, free = _chaos_kmeans("t", {}, monkeypatch)
    assert torch.equal(free["centers"], tout["centers"])
    assert free["inertia"] == tout["inertia"]


def test_transient_exhaustion_and_lineage_mismatch():
    plan = tfault.FaultPlan(transient={0: 5},
                            retry=tfault.RetryPolicy(max_retries=2, backoff_s=0.0))
    g = ttg.TaskGraph(ttg.Environment(n_workers=2), fault_plan=plan)
    with pytest.raises(tfault.RetryExhausted) as ei:
        g.submit(torch.neg, torch.ones(3), name="x")
    assert ei.value.attempts == 3

    calls = {"n": 0}

    def impure(x):
        calls["n"] += 1
        return x + calls["n"]

    g = ttg.TaskGraph(ttg.Environment(n_workers=2, mem_limit_mb=2048.0),
                      fault_plan=tfault.FaultPlan(
                          losses=(tfault.WorkerLoss(0, 1e-9),)))
    fs = [g.submit(impure, torch.zeros(2), name="impure") for _ in range(4)]
    with pytest.raises(ttg.LineageMismatchError):
        g.collect(*fs)


def test_center_partial_is_bit_identical_on_reexecution():
    X, _ = tds.gaussian_blobs(500, 9, seed=1, device="cpu")
    lab = torch.from_numpy(np.random.default_rng(0).integers(0, 5, 500))
    a = tkmeans._center_partial(X, (lab, 0.0), 5)
    b = tkmeans._center_partial(X.clone(), (lab.clone(), 0.0), 5)
    assert ttg._bit_identical(a, b)
    sums = np.zeros((5, 9))
    np.add.at(sums, lab.numpy(), X.numpy())
    np.testing.assert_allclose(n(a[0]), sums, rtol=1e-12, atol=1e-12)
    assert np.array_equal(n(a[1]), np.bincount(lab.numpy(), minlength=5))


# ------------------------------------------------------- backends, stats
def test_threadpool_backend_matches_inline():
    X, _ = tds.gaussian_blobs(300, 16, seed=5, device="cpu")
    outs = {}
    for backend in ("inline", "threadpool"):
        g = ttg.TaskGraph(ttg.Environment(n_workers=4), backend=backend)
        outs[backend] = tkmeans.fit(g, TDist.from_array(X, 4, 2), k=3, iters=3)
        g.shutdown()
    assert torch.equal(outs["inline"]["centers"], outs["threadpool"]["centers"])
    assert outs["inline"]["inertia"] == outs["threadpool"]["inertia"]


def test_threadpool_grid_keeps_the_inline_inf_and_pruned_pattern(monkeypatch):
    X, y = tds.gaussian_blobs(128, 16, seed=0, device="cpu")
    env = ttg.Environment(n_workers=4, mem_limit_mb=0.02)
    pats = {}
    for backend in ("inline", "threadpool"):
        real = tex.TaskExecutor

        def make(*a, backend=backend, **k):
            return real(*a, backend=backend, **k)

        monkeypatch.setattr("repro_torch.core.gridsearch.TaskExecutor", make)
        log, grid = t_grid_search(X, y, "kmeans", env, mult=1)
        pats[backend] = [(r.p_r, r.p_c, math.isinf(r.time_s),
                          bool(r.meta.get("pruned")), bool(r.meta.get("oom")))
                         for r in log.records]
    assert pats["inline"] == pats["threadpool"]
    assert any(p[3] for p in pats["inline"]) and any(p[4] for p in pats["inline"])


def test_bodies_are_counted_by_device():
    ttg.reset_body_counts()
    g = ttg.TaskGraph(ttg.Environment(n_workers=2))
    a = g.submit(torch.neg, torch.ones(3), name="a")
    g.submit(torch.add, a, torch.ones(3), name="b")
    g.submit(lambda v: v + 1, 1.0, name="host")
    g.collect()
    assert g.stats()["executed_tasks"] == 3
    assert dict(ttg.BODIES) == {"cpu": 2, "host": 1}
    ttg.reset_body_counts()
    assert not ttg.BODIES


def test_executor_shims_match_reference(monkeypatch):
    inject_clock(monkeypatch, seed=1)
    res = {}
    for lib, mod in (("j", jex), ("t", tex)):
        ex = mod.TaskExecutor(mod.Environment(n_workers=2))
        arr = (lambda v: v) if lib == "j" else t
        s = np.sum if lib == "j" else torch.sum
        outs = ex.map(s, [arr(np.ones(4)), arr(np.ones(5))], name="m")
        red = ex.reduce(lambda a, b: a + b, [1.0, 2.0, 3.0, 4.0], name="r")
        dot = ex.master(np.dot if lib == "j" else torch.dot,
                        arr(np.ones(3)), arr(np.ones(3)), name="mm")
        res[lib] = ([float(o) for o in outs], red, float(dot), ex.n_tasks,
                    len(ex.phases), ex.sim_time)
    assert res["t"] == res["j"]
