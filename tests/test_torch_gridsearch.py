"""The port's grid search and block-size estimator against the JAX
package's, on the CPU.  One seeded clock injects the same durations into
both packages' task graphs (``tests/_torch_ds.py``), so the grid, its inf
and pruned cells and every ``ExecutionRecord`` compare exactly, with and
without ``reuse_measurements``; the estimator and its service, fitted on
one log written by the reference's sweep and read by both, predict
exactly alike."""
import math

import numpy as np
import pytest
import torch

from _torch_ds import inject_clock
from repro.core import estimator as jest
from repro.core import gridsearch as jgs
from repro.data import datasets as jds
from repro.data.executor import Environment as JEnv
from repro.data.logstore import LogStore as JStore
from repro_torch.core import estimator as t_est
from repro_torch.core import gridsearch as tgs
from repro_torch.data import datasets as tds
from repro_torch.data.executor import Environment as TEnv
from repro_torch.data.executor import MeasurementCache as TCache
from repro_torch.data.logstore import LogStore as TStore

# (workload, rows, cols, Environment kwargs, grid_search kwargs); the
# memory limits bind, so the grids hold measured OOM cells and pruned ones
SWEEPS = [
    ("kmeans", 256, 16, dict(n_workers=4, dispatch_overhead_s=5e-4), {}),
    ("kmeans", 128, 16, dict(n_workers=4, mem_limit_mb=0.02), {}),
    ("pca", 96, 24, dict(n_workers=4, mem_limit_mb=0.01), {}),
    ("gmm", 160, 8, dict(n_workers=2), dict(mult=2)),
    ("rf", 200, 12, dict(n_workers=4, mem_limit_mb=0.02), {}),
    ("csvm", 200, 10, dict(n_workers=2), {}),
    ("kmeans", 64, 8, dict(n_workers=4), dict(row_only=True)),
]


def _sweep(lib, algo, rows, cols, env_kw, kw, **more):
    X, y = (jds.gaussian_blobs(rows, cols, n_classes=2, seed=rows + cols)
            if lib == "j" else
            tds.gaussian_blobs(rows, cols, n_classes=2, seed=rows + cols,
                               device="cpu"))
    gs, env = (jgs, JEnv) if lib == "j" else (tgs, TEnv)
    kw = dict(dict(mult=1), **kw, **more)
    return gs.grid_search(X, y, algo, env(**env_kw), **kw)


@pytest.mark.parametrize("reuse", [False, True], ids=["exhaustive", "reuse"])
@pytest.mark.parametrize("sweep", SWEEPS, ids=lambda s: f"{s[0]}-{s[1]}x{s[2]}")
def test_grid_search_matches_reference_exactly(sweep, reuse, monkeypatch):
    inject_clock(monkeypatch, seed=sweep[1])
    jlog, jgrid = _sweep("j", *sweep, reuse_measurements=reuse)
    inject_clock(monkeypatch, seed=sweep[1])
    tlog, tgrid = _sweep("t", *sweep, reuse_measurements=reuse)
    assert tgrid == jgrid
    assert [r.to_obj() for r in tlog.records] == [r.to_obj() for r in jlog.records]
    assert tgs.grid_stats(tgrid) == jgs.grid_stats(jgrid)
    if reuse and sweep is SWEEPS[0]:
        assert sum(r.meta.get("replayed", 0) for r in tlog.records) > 0


def test_the_sweeps_hold_oom_and_pruned_cells(monkeypatch):
    flags = set()
    for sweep in SWEEPS:
        log, _ = _sweep("t", *sweep)
        flags |= {k for r in log.records for k in ("oom", "pruned")
                  if r.meta.get(k)}
    assert flags == {"oom", "pruned"}


@pytest.mark.parametrize("prune,blocks", [(False, False), (True, False),
                                          (False, True)])
def test_grid_search_options_match_reference(prune, blocks, monkeypatch):
    sweep = SWEEPS[1]
    inject_clock(monkeypatch, seed=7)
    jlog, jgrid = _sweep("j", *sweep, prune_oom=prune, reuse_blocks=blocks)
    inject_clock(monkeypatch, seed=7)
    tlog, tgrid = _sweep("t", *sweep, prune_oom=prune, reuse_blocks=blocks)
    assert tgrid == jgrid
    assert [r.to_obj() for r in tlog.records] == [r.to_obj() for r in jlog.records]


@pytest.mark.parametrize("pr,pc", [(1, 1), (4, 2), (8, 8), (300, 1)])
def test_run_cell_matches_reference(pr, pc, monkeypatch):
    Xj, yj = jds.gaussian_blobs(256, 8, seed=1)
    Xt, yt = tds.gaussian_blobs(256, 8, seed=1, device="cpu")
    inject_clock(monkeypatch, seed=pr + pc)
    j = jgs.run_cell(Xj, yj, "kmeans", JEnv(n_workers=4), pr, pc, repeats=2)
    inject_clock(monkeypatch, seed=pr + pc)
    t = tgs.run_cell(Xt, yt, "kmeans", TEnv(n_workers=4), pr, pc, repeats=2)
    assert t == j


def test_run_cell_copies_strided_views_before_timing(monkeypatch):
    X, y = tds.gaussian_blobs(64, 8, seed=1, device="cpu")
    Xd = tgs._refined_cells(X, [1, 2], [1, 2])[(2, 2)]
    assert not all(b.is_contiguous() for row in Xd.blocks for b in row)
    seen = []
    real = tgs.run_algo

    def spy(algo, ex, Xd, y, **kw):
        seen.extend(b.is_contiguous() for row in Xd.blocks for b in row)
        return real(algo, ex, Xd, y, **kw)

    monkeypatch.setattr(tgs, "run_algo", spy)
    tgs.run_cell(X, y, "kmeans", TEnv(n_workers=2), 2, 2, Xd=Xd,
                 measure_cache=TCache())
    assert seen and all(seen)


def test_grid_powers_match_reference():
    for cores in (1, 4, 27, 48, 64):
        for s in (2, 3):
            for mult in (1, 4):
                assert tgs.grid_powers(cores, s=s, mult=mult) \
                    == jgs.grid_powers(cores, s=s, mult=mult)
    assert tgs.grid_powers(48) == [1, 2, 4, 8, 16, 32, 64, 128]


# --------------------------------------------------------------- estimator
QUERIES = [(1024, 32, "kmeans"), (4096, 8, "kmeans"), (300, 16, "rf"),
           (777, 64, "pca"), (50_000, 27, "kmeans"), (64, 4096, "pca"),
           (2048, 8, "gmm")]


@pytest.fixture(scope="module")
def ref_store(tmp_path_factory):
    """A LogStore written by the reference's sweeps (the tune CLI's four
    plus a pca sweep whose memory limit binds)."""
    path = tmp_path_factory.mktemp("gs") / "store.jsonl"
    store = JStore(path)
    env = JEnv(n_workers=4, mem_limit_mb=64.0)
    for i, (n, m, algo) in enumerate([(512, 32, "kmeans"), (1024, 16, "rf"),
                                      (2048, 8, "kmeans"), (256, 64, "pca")]):
        X, y = jds.gaussian_blobs(n, m, seed=10 + i)
        jgs.grid_search(X, y, algo, env, mult=1, store=store)
    X, y = jds.gaussian_blobs(96, 24, seed=3)
    jgs.grid_search(X, y, "pca", JEnv(n_workers=4, mem_limit_mb=0.01),
                    mult=1, store=store)
    return path


@pytest.mark.parametrize("model", ["tree", "forest"])
def test_estimator_predictions_match_reference(ref_store, model):
    jlog = JStore(ref_store).load()
    tlog = TStore(ref_store).load()
    assert [r.to_obj() for r in tlog.records] == [r.to_obj() for r in jlog.records]
    je = jest.BlockSizeEstimator(model).fit(jlog)
    te = t_est.BlockSizeEstimator(model).fit(tlog)
    envs = [JEnv(n_workers=4, mem_limit_mb=64.0).features(),
            JEnv(n_workers=8).features()]
    qs = [(r, c, a, e) for r, c, a in QUERIES for e in envs]
    assert te.predict_partitions_batch(qs) == je.predict_partitions_batch(qs)
    assert [te.predict_block_size(*q) for q in qs] \
        == [je.predict_block_size(*q) for q in qs]
    assert [te.abstains(a) for a in ("kmeans", "gmm", "csvm")] \
        == [je.abstains(a) for a in ("kmeans", "gmm", "csvm")]


def test_estimator_service_and_refit_match_reference(ref_store):
    jlog, tlog = JStore(ref_store).load(), TStore(ref_store).load()
    je, te = jest.BlockSizeEstimator().fit(jlog), t_est.BlockSizeEstimator().fit(tlog)
    js, ts = jest.EstimatorService(je), t_est.EstimatorService(te)
    env = JEnv(n_workers=4, mem_limit_mb=64.0).features()
    qs = [(r, c, a, env) for r, c, a in QUERIES] * 2
    assert ts.predict_batch(qs) == js.predict_batch(qs)
    assert [ts.predict(q) for q in qs] == [js.predict(q) for q in qs]
    shifted = {lib: [type(r)(r.dataset, r.algo, r.env, 4 if r.p_r == 1 else 1,
                             r.p_c, 1e-9)
                     for r in log.best_per_group() if r.algo == "kmeans"]
               for lib, log in (("j", jlog), ("t", tlog))}
    assert te.refit(shifted["t"]) == je.refit(shifted["j"]) is True
    assert te.model_version == je.model_version
    assert ts.predict_batch(qs) == js.predict_batch(qs)
    assert ts.invalidations == js.invalidations == 1
    assert math.isfinite(tgs.grid_stats({(1, 1): 1.0, (2, 1): float("inf")})["best"])
    assert np.isclose(te.snapshot().predict_partitions(1024, 32, "kmeans", env),
                      je.predict_partitions(1024, 32, "kmeans", env)).all()


def test_grid_search_on_tensors_counts_cells_like_reference():
    X, y = tds.gaussian_blobs(512, 32, seed=10, device="cpu")
    log, grid = tgs.grid_search(X, y, "kmeans", TEnv(n_workers=4, mem_limit_mb=64.0),
                                mult=1)
    assert len(grid) == 9 and all(math.isfinite(v) for v in grid.values())
    assert isinstance(X, torch.Tensor)


def test_grid_search_store_gets_copies_tagged_with_the_timing_device(tmp_path):
    """The store holds each swept record tagged with the device that timed
    it; the returned log keeps the reference's untagged records."""
    X, y = tds.gaussian_blobs(256, 16, seed=10, device="cpu")
    store = TStore(tmp_path / "store.jsonl")
    log, grid = tgs.grid_search(X, y, "kmeans", TEnv(n_workers=4), mult=1,
                                store=store)
    stored = store.load().records
    assert len(stored) == len(log.records) == len(grid)
    assert all("timing" not in r.env for r in log.records)
    assert [r.env for r in stored] \
        == [{**r.env, "timing": "wallclock:cpu"} for r in log.records]
    assert [(r.dataset, r.algo, r.p_r, r.p_c, r.time_s) for r in stored] \
        == [(r.dataset, r.algo, r.p_r, r.p_c, r.time_s) for r in log.records]


def test_diagonal_gram_counts_its_block_twice_in_both_packages():
    """Reference quirk, shared by the port: pca's diagonal Gram task gets one
    block as both ``xa`` and ``xb``, and the memory model sums its inputs
    argument by argument, so that block counts twice.  A limit between three
    and six blocks' bytes then makes the (1, 1) cell a measured OOM although
    its working set is one block and a small Gram matrix; the paper-size
    mnist sweep (60,000 x 784 under 2048 MB) loses its (1, 1) cell so."""
    Xj, yj = jds.gaussian_blobs(96, 24, seed=3)
    Xt, yt = tds.gaussian_blobs(96, 24, seed=3, device="cpu")
    block_mb = Xj.nbytes / 2**20
    from repro.data import taskgraph as jtg
    from repro_torch.data import taskgraph as ttg
    assert jtg._input_mb((Xj, Xj)) == ttg._input_mb((Xt, Xt)) == 2 * block_mb
    env = dict(n_workers=4, mem_limit_mb=4.5 * block_mb)
    for gs, env_cls, X, y in ((jgs, JEnv, Xj, yj), (tgs, TEnv, Xt, yt)):
        t, info = gs.run_cell(X, y, "pca", env_cls(**env), 1, 1)
        assert math.isinf(t) and info["oom"] and "MB > limit" in info["reason"]
        t, _ = gs.run_cell(X, y, "pca", env_cls(**env), 1, 2)
        assert math.isfinite(t)
