"""The port's five dislib workloads, ``DistArray`` and datasets against the
JAX package's, on the CPU, on the same seeded inputs: kmeans centers,
inertia and labels at rtol 1e-8 / atol 1e-8 (the reference's own
partition-invariance tolerance), pca variance at rtol 1e-8 and its
components up to each one's sign, gmm means, variances and weights at rtol
1e-8, csvm and rf predictions exactly equal; each at two partitionings."""
import numpy as np
import pytest
import torch

from _torch_ds import n
from repro.algorithms import gmm as jgmm
from repro.algorithms import kmeans as jkmeans
from repro.algorithms import partition_and_run as j_partition_and_run
from repro.algorithms import pca as jpca
from repro.algorithms import rf as jrf
from repro.algorithms import svm as jsvm
from repro.data import datasets as jds
from repro.data.distarray import DistArray as JDist
from repro.data.executor import Environment as JEnv
from repro.data.executor import TaskExecutor as JEx
from repro_torch.algorithms import gmm as tgmm
from repro_torch.algorithms import kmeans as tkmeans
from repro_torch.algorithms import partition_and_run as t_partition_and_run
from repro_torch.algorithms import pca as tpca
from repro_torch.algorithms import rf as trf
from repro_torch.algorithms import svm as tsvm
from repro_torch.data import datasets as tds
from repro_torch.data.distarray import DistArray as TDist
from repro_torch.data.executor import Environment as TEnv
from repro_torch.data.executor import TaskExecutor as TEx

PARTS = [(1, 1), (4, 3)]


def _both(fn, *args, **kw):
    """``fn`` of the reference's datasets module and of the port's (CPU)."""
    return (getattr(jds, fn)(*args, **kw),
            getattr(tds, fn)(*args, **kw, device="cpu"))


def _fits(jmod, tmod, X, pr, pc, y=None, **kw):
    jX = JDist.from_array(X, pr, pc)
    tX = TDist.from_array(torch.from_numpy(X), pr, pc)
    args_j = (jX,) if y is None else (jX, y)
    args_t = (tX,) if y is None else (tX, torch.from_numpy(y))
    return (jmod.fit(JEx(JEnv(n_workers=4)), *args_j, **kw),
            tmod.fit(TEx(TEnv(n_workers=4)), *args_t, **kw))


# ---------------------------------------------------------------- datasets
@pytest.mark.parametrize("fn,args,kw", [
    ("gaussian_blobs", (300, 17), dict(n_classes=3, seed=5)),
    ("gaussian_blobs", (200, 9), dict(anisotropic=True, seed=6)),
    ("hepmass_like", (), dict(scale=1e-4)),
    ("mnist_like", (), dict(scale=1e-3)),
])
def test_datasets_draw_the_reference_rows(fn, args, kw):
    (Xj, yj), (Xt, yt) = _both(fn, *args, **kw)
    assert Xt.dtype == torch.float64 and yt.dtype == torch.int64
    assert Xt.device.type == "cpu"
    assert np.array_equal(n(Xt), Xj) and np.array_equal(n(yt), yj)


def test_trajectory_and_shape_cases_draw_the_reference_rows():
    Xj, Xt = _both("trajectory_like", 64, 12, seed=3)
    assert np.array_equal(n(Xt), Xj)
    cj, ct = _both("shape_cases", scale=1e-4)
    assert cj.keys() == ct.keys()
    for k in cj:
        assert np.array_equal(n(ct[k][0]), cj[k][0])


def test_datasets_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tds.gaussian_blobs(10, 3)


# --------------------------------------------------------------- distarray
@pytest.mark.parametrize("pr,pc", [(1, 1), (3, 2), (7, 5), (16, 9)])
def test_distarray_blocks_and_refine_match_reference(pr, pc):
    X = np.random.default_rng(pr * 10 + pc).normal(size=(50, 13))
    jd, td = JDist.from_array(X, pr, pc), TDist.from_array(torch.from_numpy(X), pr, pc)
    assert np.array_equal(td.row_edges, jd.row_edges)
    assert np.array_equal(td.col_edges, jd.col_edges)
    assert np.array_equal(n(td.to_array()), X)
    assert td.block_sizes_mb() == jd.block_sizes_mb()
    for fr, fc in ((2, 1), (1, 2), (3, 3)):
        if pr * fr > 50 or pc * fc > 13:
            continue
        jr, tr = jd.refine(fr, fc), td.refine(fr, fc)
        assert [[b.shape for b in r] for r in jr.blocks] \
            == [[tuple(b.shape) for b in r] for r in tr.blocks]
        assert all(np.array_equal(n(b), a) for rj, rt in zip(jr.blocks, tr.blocks)
                   for a, b in zip(rj, rt))
    y = np.arange(50)
    assert [n(s).tolist() for s in td.split_rows(torch.from_numpy(y))] \
        == [s.tolist() for s in jd.split_rows(y)]
    stitched = td.row_stitched(TEx(TEnv()))
    assert all(np.array_equal(n(s), np.concatenate(r, axis=1))
               for s, r in zip(stitched, jd.blocks))


def test_refine_splits_into_views():
    X = torch.arange(60.0, dtype=torch.float64).reshape(10, 6)
    base = TDist.from_array(X, 2, 1)
    fine = base.refine(1, 3)
    assert fine.blocks[0][1].data_ptr() == base.blocks[0][0].data_ptr() + 2 * 8
    assert not fine.blocks[0][1].is_contiguous()


# --------------------------------------------------------------- workloads
@pytest.mark.parametrize("pr,pc", PARTS)
def test_kmeans_matches_reference(pr, pc):
    X, _ = jds.gaussian_blobs(256, 24, n_classes=3, seed=0)
    j, t = _fits(jkmeans, tkmeans, X, pr, pc, k=3, iters=4, seed=7)
    np.testing.assert_allclose(n(t["centers"]), j["centers"], rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(t["inertia"], j["inertia"], rtol=1e-8, atol=1e-8)
    assert len(t["labels"]) == len(j["labels"]) == pr
    assert all(np.array_equal(n(a), b) for a, b in zip(t["labels"], j["labels"]))
    assert np.array_equal(n(tkmeans.predict(t, torch.from_numpy(X))),
                          jkmeans.predict(j, X))


@pytest.mark.parametrize("pr,pc", PARTS)
def test_pca_matches_reference(pr, pc):
    X = jds.trajectory_like(200, 32, seed=2)
    j, t = _fits(jpca, tpca, X, pr, pc, n_components=4)
    np.testing.assert_allclose(n(t["variance"]), j["variance"], rtol=1e-8)
    np.testing.assert_allclose(n(t["mean"]), j["mean"], rtol=1e-8, atol=1e-12)
    tc, jc = n(t["components"]), j["components"]
    signs = np.sign(np.sum(tc * jc, axis=0))          # one sign per component
    np.testing.assert_allclose(tc * signs, jc, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(
        n(tpca.transform(t, torch.from_numpy(X))) * signs,
        jpca.transform(j, X), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("pr,pc", PARTS)
def test_gmm_matches_reference(pr, pc):
    X, _ = jds.gaussian_blobs(400, 6, n_classes=2, noise_frac=0.0,
                              redundant_frac=0.0, seed=4)
    j, t = _fits(jgmm, tgmm, X, pr, pc, k=2, iters=10, seed=1)
    for key in ("mu", "var", "pi"):
        np.testing.assert_allclose(n(t[key]), j[key], rtol=1e-8)
    assert np.array_equal(n(tgmm.predict(t, torch.from_numpy(X))),
                          jgmm.predict(j, X))


@pytest.mark.parametrize("pr,pc", PARTS)
def test_csvm_predictions_match_reference(pr, pc):
    X, y = jds.gaussian_blobs(400, 10, n_classes=2, noise_frac=0.0,
                              redundant_frac=0.0, seed=5)
    j, t = _fits(jsvm, tsvm, X, pr, pc, y=y)
    np.testing.assert_allclose(n(t["w"]), j["w"], rtol=1e-8, atol=1e-10)
    got = tsvm.predict(t, torch.from_numpy(X))
    assert got.dtype == torch.int64
    assert np.array_equal(n(got), jsvm.predict(j, X))
    assert (n(got) == y).mean() > 0.9


@pytest.mark.parametrize("pr,pc", [(1, 1), (3, 2)])
def test_rf_predictions_match_reference(pr, pc):
    X, y = jds.gaussian_blobs(300, 12, n_classes=3, seed=6)
    j, t = _fits(jrf, trf, X, pr, pc, y=y, n_trees=9, max_depth=8)
    assert len(t["trees"]) == len(j["trees"])
    got = trf.predict(t, torch.from_numpy(X))
    assert np.array_equal(n(got), jrf.predict(j, X))
    assert (n(got) == y).mean() > 0.85


def test_partition_invariance_of_the_port():
    X, _ = tds.gaussian_blobs(256, 24, n_classes=3, seed=0, device="cpu")
    cs = [tkmeans.fit(TEx(TEnv(n_workers=4)), TDist.from_array(X, pr, pc),
                      k=3, iters=4, seed=7)["centers"]
          for pr, pc in [(1, 1), (4, 1), (2, 3), (8, 4)]]
    for c in cs[1:]:
        torch.testing.assert_close(c, cs[0], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("algo,kw", [("kmeans", dict(k=3, iters=2)),
                                     ("gmm", dict(k=2, iters=2)),
                                     ("rf", dict(n_trees=3))])
def test_partition_and_run_clamps_like_reference(algo, kw):
    X, y = jds.gaussian_blobs(32, 6, n_classes=2, seed=9)
    _, jd = j_partition_and_run(algo, JEx(JEnv()), X, y, p_r=64, p_c=16, **kw)
    _, td = t_partition_and_run(algo, TEx(TEnv()), torch.from_numpy(X),
                                torch.from_numpy(y), p_r=64, p_c=16, **kw)
    assert (td.p_r, td.p_c) == (jd.p_r, jd.p_c) == (32, 6)
    with pytest.raises(ValueError, match="supervised"):
        t_partition_and_run("csvm", TEx(TEnv()), torch.from_numpy(X), None,
                            p_r=2, p_c=1)
