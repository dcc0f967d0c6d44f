"""The port's closed loop and paper-§V evaluation harness against the JAX
package's, on the CPU.  One seeded clock per package's task graph (and,
for the elastic runs, per package's ``eval/autorun.py``) makes every
measured duration equal (``tests/_torch_ds.py``), so results, records,
reports and bench payloads compare exactly; kmeans centers within 1e-8."""
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_ds import inject_clock
from repro.core import estimator as jest
from repro.core import gridsearch as jgs
from repro.data import datasets as jds
from repro.data.distarray import DistArray as JDist
from repro.data.executor import Environment as JEnv
from repro.data.logstore import LogStore as JStore
from repro.eval import autorun as jauto
from repro.eval import harness as jh
from repro_torch.core import estimator as t_est
from repro_torch.core import gridsearch as tgs
from repro_torch.data import datasets as tds
from repro_torch.data.distarray import DistArray as TDist
from repro_torch.data.executor import Environment as TEnv
from repro_torch.data.logstore import LogStore as TStore
from repro_torch.eval import autorun as tauto
from repro_torch.eval import harness as th
from repro_torch.launch import evaluate as tlaunch

ROOT = Path(__file__).resolve().parents[1]

J = types.SimpleNamespace(
    est=jest, gs=jgs, Env=JEnv, Store=JStore, auto=jauto, h=jh, Dist=JDist,
    blobs=lambda n, m, seed: jds.gaussian_blobs(n, m, seed=seed))
T = types.SimpleNamespace(
    est=t_est, gs=tgs, Env=TEnv, Store=TStore, auto=tauto, h=th, Dist=TDist,
    blobs=lambda n, m, seed: tds.gaussian_blobs(n, m, seed=seed, device="cpu"))

ENV4 = dict(name="t4", n_workers=4, n_nodes=1, mem_limit_mb=2048.0,
            dispatch_overhead_s=1e-4, ram_gb=16)
ENV8 = dict(name="laptop8", n_workers=8, n_nodes=1, mem_limit_mb=2048.0,
            dispatch_overhead_s=1e-4, ram_gb=16)
ENV2 = dict(name="degraded", n_workers=2, n_nodes=1, mem_limit_mb=2048.0,
            dispatch_overhead_s=1e-4, ram_gb=16)


def _record(r, *, drop_real=True) -> dict:
    """A record as comparable data: ``meta["real_s"]`` is the wall clock
    of the run, the one field the parity does not hold."""
    obj = r.to_obj()
    meta = {k: v for k, v in obj["meta"].items()
            if not (drop_real and k == "real_s")}
    return dict(obj, meta=meta)


def _fields(res) -> dict:
    """Every field of an AutoRunResult / ElasticRunResult but the output,
    with the record as comparable data."""
    out = {f: getattr(res, f) for f in res.__dataclass_fields__
           if f not in ("output", "record")}
    out["record"] = _record(res.record)
    return out


def _stored(store, *, untag=False) -> list:
    """A store's records and sources; ``untag`` strips the port's device tag
    after checking it is the CPU's."""
    out = []
    for r, src in store.iter_records():
        obj = _record(r)
        if untag:
            env = dict(obj["env"])
            assert env.pop("timing") == "wallclock:cpu"
            obj = dict(obj, env=env)
        out.append((obj, src))
    return out


# ------------------------------------------------------------ default blocks
@pytest.mark.parametrize("workers", [1, 2, 3, 4, 8, 16, 48, 64])
def test_default_partitioning_matches_reference(workers):
    for n in (1, 3, 64, 1000, 1024, 7_000_000):
        for m in (1, 2, 27, 784, 1024):
            for s in (2, 4):
                got = tauto.default_partitioning(n, m, TEnv(n_workers=workers), s=s)
                want = jauto.default_partitioning(n, m, JEnv(n_workers=workers), s=s)
                assert got == want, (n, m, workers, s)


# the reference's cases (tests/test_chaos.py): (from grid, to grid, method)
REPARTITIONS = [((2, 2), (4, 2), "refine"), ((4, 2), (4, 2), "keep"),
                ((4, 2), (2, 1), "keep"), ((4, 2), (8, 1), "rebuild"),
                ((3, 1), (6, 4), "refine"), ((2, 2), (3, 3), "rebuild")]


@pytest.mark.parametrize("case", REPARTITIONS, ids=lambda c: f"{c[0]}->{c[1]}")
def test_live_repartition_matches_reference(case):
    (r0, c0), (r1, c1), method = case
    X = np.arange(96, dtype=float).reshape(24, 4)
    jd, jm = jauto.live_repartition(JDist.from_array(X, r0, c0), r1, c1)
    td0 = TDist.from_array(torch.from_numpy(X), r0, c0)
    td, tm = tauto.live_repartition(td0, r1, c1)
    assert tm == jm == method
    assert (td.p_r, td.p_c) == (jd.p_r, jd.p_c)
    assert (td is td0) == (method == "keep")
    for trow, jrow in zip(td.blocks, jd.blocks):
        for tb, jb in zip(trow, jrow):
            assert np.array_equal(tb.numpy(), jb)
    assert np.array_equal(td.to_array().numpy(), X)


# ------------------------------------------------------------ closed loop
def _kmeans_estimator(P):
    X, y = P.blobs(256, 16, 7)
    log, _ = P.gs.grid_search(X, y, "kmeans", P.Env(**ENV4), mult=1,
                              reuse_measurements=True)
    return P.est.BlockSizeEstimator("tree").fit(log)


def _chain(P, path):
    """The reference test's chain: a kmeans-only estimator behind a primed
    service; gmm abstains, runs by default, refits, then runs by model."""
    env = P.Env(**ENV4)
    store = P.Store(path)
    est = _kmeans_estimator(P)
    svc = P.est.EstimatorService(est)
    loop = P.auto.AutoTunedRun(svc, store)
    primed = svc.predict((256, 16, "kmeans", env.features()))
    X, y = P.blobs(192, 12, 8)
    first = loop.run(X, y, "gmm", env)
    second = loop.run(X, y, "gmm", env)
    return {"primed": primed, "first": _fields(first),
            "second": _fields(second), "invalidations": svc.invalidations,
            "version": est.model_version, "abstains": est.abstains("gmm"),
            "store": _stored(store, untag=P is T)}


def test_closed_loop_matches_reference(tmp_path, monkeypatch):
    inject_clock(monkeypatch, seed=5)
    want = _chain(J, tmp_path / "j.jsonl")
    got = _chain(T, tmp_path / "t.jsonl")
    assert got == want
    assert got["first"]["chosen_by"] == "default"
    assert got["second"]["chosen_by"] == "model"
    assert got["first"]["retrained"] and got["invalidations"] == 1
    assert [src for _, src in got["store"]] == ["autorun"]


def test_closed_loop_from_nothing_matches_reference(tmp_path, monkeypatch):
    inject_clock(monkeypatch, seed=9)
    runs = {}
    for name, P in (("j", J), ("t", T)):
        loop = P.auto.AutoTunedRun(P.est.BlockSizeEstimator("tree"),
                                   P.Store(tmp_path / f"{name}.jsonl"))
        X, y = P.blobs(96, 8, 9)
        runs[name] = [_fields(loop.run(X, y, "kmeans", P.Env(**ENV4)))
                      for _ in range(2)]
    assert runs["t"] == runs["j"]
    assert [r["chosen_by"] for r in runs["t"]] == ["default", "model"]


def test_oom_run_logged_as_inf_without_refit_matches_reference(tmp_path,
                                                               monkeypatch):
    inject_clock(monkeypatch, seed=11)
    runs = {}
    for name, P in (("j", J), ("t", T)):
        est = _kmeans_estimator(P)
        v0 = est.model_version
        store = P.Store(tmp_path / f"{name}.jsonl")
        loop = P.auto.AutoTunedRun(P.est.EstimatorService(est), store)
        X, y = P.blobs(128, 16, 11)
        r = loop.run(X, y, "gmm", P.Env(name="tiny", n_workers=4,
                                        mem_limit_mb=1e-6))
        assert r.output is None and est.model_version == v0
        runs[name] = (_fields(r), _stored(store, untag=P is T))
    assert runs["t"] == runs["j"]
    fields = runs["t"][0]
    assert math.isinf(fields["time_s"]) and fields["record"]["meta"]["oom"]
    assert fields["appended"] and not fields["retrained"]


def test_run_result_holds_python_numbers(tmp_path):
    """The report layer serializes only Python numbers: the result's and the
    record's times are floats, its partition ints, whatever the device."""
    loop = tauto.AutoTunedRun(t_est.BlockSizeEstimator("tree"),
                              TStore(tmp_path / "s.jsonl"))
    X, y = T.blobs(96, 8, 9)
    r = loop.run(X, y, "kmeans", TEnv(**ENV4))
    assert type(r.time_s) is float and type(r.record.time_s) is float
    assert all(type(v) is int for v in (r.p_r, r.p_c, *r.shape))
    assert isinstance(r.output["centers"], torch.Tensor)


@pytest.mark.parametrize("sharded", [False, True], ids=["service", "sharded"])
def test_closed_loop_demo_matches_reference(sharded, tmp_path, monkeypatch):
    inject_clock(monkeypatch, seed=3)
    want = jauto.closed_loop_demo(JStore(tmp_path / "j.jsonl"), sharded=sharded)
    got = tauto.closed_loop_demo(TStore(tmp_path / "t.jsonl"), sharded=sharded,
                                 device="cpu")
    assert got == want
    assert got["first_chosen_by"] == "default"
    assert got["second_chosen_by"] == "model"
    assert got["first_retrained"] is True and got["invalidations"] >= 1
    assert got["sharded"] == (2 if sharded else 0)
    # the store's copies carry the device that timed them
    timing = {r.env["timing"] for r, _ in TStore(tmp_path / "t.jsonl").iter_records()}
    assert timing == {"wallclock:cpu"}


# ------------------------------------------------------------ elastic
ELASTIC = {"scale-up": (ENV8, "scale-up", True, "refine"),
           "worker-loss": (ENV2, "worker-loss", False, "keep")}


def _elastic(P, path, new_env, reason, with_store):
    store = P.Store(path) if with_store else None
    loop = P.auto.AutoTunedRun(P.est.BlockSizeEstimator("tree"), store,
                               refit=with_store)
    X, y = P.blobs(256, 16, 5)
    r = loop.run_elastic(X, y, "kmeans", P.Env(**ENV4),
                         P.auto.EnvChange(after_iter=2, env=P.Env(**new_env),
                                          reason=reason), iters=4)
    stored = _stored(store, untag=P is T) if store is not None else None
    return r, stored


@pytest.mark.parametrize("case", sorted(ELASTIC))
def test_run_elastic_matches_reference(case, tmp_path, monkeypatch):
    new_env, reason, with_store, method = ELASTIC[case]
    inject_clock(monkeypatch, seed=13)
    inject_clock(monkeypatch, seed=14, modules=(jauto, tauto))
    jr, jstored = _elastic(J, tmp_path / "j.jsonl", new_env, reason, with_store)
    tr, tstored = _elastic(T, tmp_path / "t.jsonl", new_env, reason, with_store)
    assert _fields(tr) == _fields(jr)
    assert tstored == jstored
    assert tr.repartition == method and tr.results_close
    assert tr.speedup == jr.speedup
    np.testing.assert_allclose(tr.output["centers"].numpy(),
                               jr.output["centers"], rtol=0, atol=1e-8)
    if with_store:
        assert [src for _, src in tstored] == ["recovery"] and tr.retrained


def test_run_elastic_validates_inputs_as_reference():
    X, y = T.blobs(64, 8, 1)
    loop = tauto.AutoTunedRun(t_est.BlockSizeEstimator("tree"), None, refit=False)
    change = tauto.EnvChange(after_iter=1, env=TEnv(**ENV8))
    with pytest.raises(ValueError, match="elastically"):
        loop.run_elastic(X, y, "pca", TEnv(**ENV4), change, iters=4)
    with pytest.raises(ValueError, match="after_iter"):
        loop.run_elastic(X, y, "kmeans", TEnv(**ENV4),
                         tauto.EnvChange(after_iter=4, env=TEnv(**ENV8)), iters=4)


# ------------------------------------------------------------ harness
SHAPES = ((64, 8), (32, 12))


class _Counting:
    """Wraps a harness module's ``BlockSizeEstimator`` to count the records
    each fit was given, in fit order."""

    def __init__(self, cls):
        self.cls, self.fits = cls, []

    def __call__(self, *a, **kw):
        est = self.cls(*a, **kw)
        fit = est.fit

        def counted(records):
            self.fits.append(len(list(records)))
            return fit(records)
        est.fit = counted
        return est


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both packages' ``evaluate`` on SHAPES under the three profiles, the
    port's with a store, and the fits each made."""
    tmp = tmp_path_factory.mktemp("harness")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, P in (("j", J), ("t", T)):
            inject_clock(mp, seed=21)
            mp.setattr(P.h, "SMOKE_SHAPES", SHAPES)
            counter = _Counting(P.h.BlockSizeEstimator)
            mp.setattr(P.h, "BlockSizeEstimator", counter)
            kw = ({"store": TStore(tmp / "t.jsonl"), "device": "cpu"}
                  if P is T else {})
            report = P.h.evaluate(smoke=True, seed=1, **kw)
            out[name] = {"report": report, "fits": counter.fits,
                         "store": kw.get("store")}
    return out


def test_evaluate_matches_reference(reports):
    want, got = reports["j"]["report"], reports["t"]["report"]
    strip = lambda r: {k: v for k, v in r.items() if k != "wall_s"}  # noqa: E731
    assert strip(got) == strip(want)
    assert got["config"]["n_groups"] == 2 * 5 * 3
    assert set(got["holdout_algo"]) == set(th.ALGOS)
    assert set(got["holdout_env"]) == set(th.ENV_PROFILES)
    for e in got["groups"]:
        for k in ("t_pred", "t_default", "t_best"):
            assert type(e[k]) is float, (k, e)


def test_bench_payload_matches_reference(reports):
    got = th.bench_payload(reports["t"]["report"])
    assert got == jh.bench_payload(reports["j"]["report"])
    assert set(got["per_algo"]) == set(th.ALGOS)
    assert got["groups"] == reports["t"]["report"]["config"]["n_groups"]


def test_ground_truth_matches_reference(monkeypatch):
    inject_clock(monkeypatch, seed=2)
    envs = {"laptop": th.ENV_PROFILES["laptop"]}
    jrec, jgroups = jh.build_ground_truth(shapes=SHAPES[:1], envs=envs)
    trec, tgroups = th.build_ground_truth(shapes=SHAPES[:1], envs=envs,
                                          device="cpu")
    assert [r.to_obj() for r in trec] == [r.to_obj() for r in jrec]
    drop = lambda g: {k: v for k, v in g.items() if k != "sweep_wall_s"}  # noqa: E731
    assert [drop(g) for g in tgroups] == [drop(g) for g in jgroups]


def test_write_report_roundtrips(reports, tmp_path):
    report = reports["t"]["report"]
    path = th.write_report(report, tmp_path)
    assert path == tmp_path / "eval_report.json"
    loaded = json.loads(path.read_text())
    assert loaded == json.loads(json.dumps(th._jsonable(report)))
    assert loaded["overall"] == report["overall"]
    ref = json.loads(jh.write_report(reports["j"]["report"], tmp_path / "j").read_text())
    assert {k: v for k, v in loaded.items() if k != "wall_s"} == \
        {k: v for k, v in ref.items() if k != "wall_s"}


def test_env_holdout_drops_exactly_the_profiles_records(reports):
    """Each leave-one-environment-out fit is given every record but the
    held-out profile's, counted; the store's copies carry the device tag
    and so never match a profile, which is why the fits use the untagged
    in-memory records."""
    report, fits = reports["t"]["report"], reports["t"]["fits"]
    n = report["config"]["n_records"]
    per_env = {name: sum(1 for r in reports["t"]["store"].load().records
                         if r.env["n_workers"] == env.n_workers)
               for name, env in th.ENV_PROFILES.items()}
    assert sum(per_env.values()) == n and all(per_env.values())
    env_fits = fits[1 + len(report["holdout_algo"]):]
    assert env_fits == [n - per_env[name] for name in th.ENV_PROFILES]
    assert fits == reports["j"]["fits"]
    store = reports["t"]["store"]
    assert len(store) == n and store.sources() == {"grid_search": n}
    assert {r.env["timing"] for r in store.load().records} == {"wallclock:cpu"}


# ------------------------------------------------------------ launcher
def test_evaluate_launcher_writes_only_under_its_artifacts(tmp_path, monkeypatch,
                                                           capsys):
    bench = ROOT / "BENCH_eval.json"
    before = bench.read_bytes()
    monkeypatch.setattr(th, "SMOKE_SHAPES", SHAPES[:1])
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path / "env_root"))
    report = tlaunch.main(["--smoke", "--device", "cpu",
                           "--artifacts", str(tmp_path / "out")])
    assert "closed loop" in capsys.readouterr().out
    written = sorted(p.relative_to(tmp_path).as_posix()
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written == ["out/BENCH_eval.json", "out/eval_report.json"]
    assert bench.read_bytes() == before
    payload = json.loads((tmp_path / "out" / "BENCH_eval.json").read_text())
    assert payload == json.loads(json.dumps(th.bench_payload(report)))
    assert payload["closed_loop"]["second_chosen_by"] == "model"


def test_evaluate_launcher_defaults_under_the_ports_artifacts(tmp_path, monkeypatch,
                                                              capsys):
    monkeypatch.setattr(th, "SMOKE_SHAPES", SHAPES[:1])
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    tlaunch.main(["--smoke", "--device", "cpu", "--skip-loop"])
    capsys.readouterr()
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
        ["BENCH_eval.json", "eval_report.json"]


def test_evaluate_launcher_refuses_the_card_it_does_not_have(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--smoke", "--artifacts", str(tmp_path)])
    assert not any(tmp_path.iterdir())
