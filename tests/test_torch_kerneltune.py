"""The port's tile-tuning loop against the JAX package's, on the CPU: the
BLEST-ML core copies give bit-identical predictions, LogStore files cross
between the packages both ways, the simulator and the whole evaluation
table agree under the reference's V5E model and VMEM rule, and the port's
own H100 defaults, wall-clock backend and CLI behave."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import workloads as jwl
from repro.core import chained as jchained
from repro.core import features as jfeat
from repro.core import kerneltune as jkt
from repro.core import trees as jtrees
from repro.core.log import ExecutionLog as JLog
from repro.data.logstore import LogStore as JStore
from repro.eval import harness as jharness
from repro.kernels import timing as jtiming
from repro_torch.configs import workloads as twl
from repro_torch.core import chained as tchained
from repro_torch.core import features as tfeat
from repro_torch.core import kerneltune as tkt
from repro_torch.core import trees as ttrees
from repro_torch.core.log import ExecutionLog as TLog
from repro_torch.core.roofline import H100, V5E
from repro_torch.data.logstore import LogStore as TStore
from repro_torch.eval import harness as tharness
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_blocked as mm
from repro_torch.kernels import ops
from repro_torch.kernels import timing as ttiming
from repro_torch.launch import tune as ttune

ROOT = Path(__file__).resolve().parents[1]
V5E_MODEL = dict(hw=V5E, rule=ttiming.VMEM_RULE)
PRED_SHAPES = [(4096, 4096, 4096), (8192, 1024, 2048), (512, 512, 512),
               (128, 4096, 16384), (32768, 16384, 4096), (1024, 128, 8192),
               (256, 2048, 128, "float32")]


def _tcase(c):
    """The port's KernelCase with the reference case's fields."""
    return ttiming.KernelCase(**dataclasses.asdict(c))


def _yi_cases(with_flash=True):
    return jwl.zoo_cases(["yi-6b"], with_flash=with_flash)


# ------------------------------------------------------------ core copies
def test_featurize_and_vectorize_identical():
    d = jfeat.dataset_features(12345, 67, 4)
    assert tfeat.dataset_features(12345, 67, 4) == d
    env = {"n_workers": 4, "name": "laptop", "mem": 2.5}
    rows = [jfeat.featurize(d, a, env) for a in jfeat.ALGOS]
    assert [tfeat.featurize(d, a, env) for a in tfeat.ALGOS] == rows
    xj, oj = jfeat.vectorize(rows)
    xt, ot = tfeat.vectorize(rows)
    assert oj == ot and np.array_equal(xj, xt)


@pytest.mark.parametrize("model", ["classifier", "regressor", "forest"])
def test_trees_fit_predict_identical(model):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(300, 6))
    X[:, 2] = np.round(X[:, 2])                   # ties in a column
    y = (X[:, 0] + X[:, 2] > 0).astype(int) + (X[:, 1] > 1)
    Xq = rng.normal(size=(80, 6))
    if model == "classifier":
        a = jtrees.DecisionTreeClassifier(max_depth=6).fit(X, y)
        b = ttrees.DecisionTreeClassifier(max_depth=6).fit(X, y)
        assert np.array_equal(a.predict_proba(Xq), b.predict_proba(Xq))
    elif model == "regressor":
        a = jtrees.DecisionTreeRegressor(max_depth=6).fit(X, X[:, 3])
        b = ttrees.DecisionTreeRegressor(max_depth=6).fit(X, X[:, 3])
    else:
        a = jtrees.RandomForestClassifier(n_estimators=7, random_state=3).fit(X, y)
        b = ttrees.RandomForestClassifier(n_estimators=7, random_state=3).fit(X, y)
        assert np.array_equal(a.predict_proba(Xq), b.predict_proba(Xq))
    assert np.array_equal(a.predict(Xq), b.predict(Xq))


@pytest.mark.parametrize("name", ["tree", "forest", "independent", "regression"])
def test_chained_models_identical(name):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(200, 5))
    yr = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
    yc = (X[:, 2] + yr > 0.7).astype(int)
    a = jchained.make_model(name).fit(X, yr, yc)
    b = tchained.make_model(name).fit(X, yr, yc)
    Xq = rng.normal(size=(50, 5))
    assert np.array_equal(a.predict(Xq), b.predict(Xq))


def test_analytic_training_log_and_tuner_identical_under_v5e():
    jlog = jkt.build_training_log(seed=0, n_shapes=12)
    tlog = tkt.build_training_log(seed=0, n_shapes=12, **V5E_MODEL)
    assert [r.to_obj() for r in tlog.records] == [r.to_obj() for r in jlog.records]
    jt = jkt.KernelTuner().fit(jlog)
    tt = tkt.KernelTuner(rule=ttiming.VMEM_RULE).fit(tlog)
    assert tt.predict_batch(PRED_SHAPES) == jt.predict_batch(PRED_SHAPES)
    # the port's default (H100) tuner decodes the same tree on this log (the
    # env key it queries with is constant in training, so never split on)
    # and swaps nothing, not even the tiles the blocked matmul cannot run
    h100 = tkt.KernelTuner().fit(jlog.records)
    assert h100.predict_batch(PRED_SHAPES) == jt.predict_batch(PRED_SHAPES)


def test_flash_tuner_and_service_identical_under_v5e():
    jrecs, _ = jkt.measure_cases(jwl.zoo_cases(), jtiming.SimulatorBackend(seed=2))
    trecs, _ = tkt.measure_cases(twl.zoo_cases(),
                                 ttiming.SimulatorBackend(seed=2, **V5E_MODEL))
    assert [r.to_obj() | {"env": None, "meta": None} for r in trecs] == \
        [r.to_obj() | {"env": None, "meta": None} for r in jrecs]
    for kernel, algo in (("matmul", "matmul_tile"), ("flash", "flash_tile")):
        jt = jkt.KernelTuner(kernel).fit([r for r in jrecs if r.algo == algo])
        tt = tkt.KernelTuner(kernel, rule=ttiming.VMEM_RULE).fit(
            [r for r in trecs if r.algo == algo])
        shapes = [(c.m, c.k, c.n, c.dtype) for c in jwl.zoo_cases()
                  if c.kernel == kernel]
        assert tt.predict_batch(shapes) == jt.predict_batch(shapes)
        queries = [jkt.KernelQuery(m, k, n, dt, algo) for m, k, n, dt in shapes]
        jsvc, tsvc = jkt.KernelTunerService(jt), tkt.KernelTunerService(tt)
        assert tsvc.predict_batch([tkt.KernelQuery(*q) for q in queries]) == \
            jsvc.predict_batch(queries)


def test_execution_log_files_cross_both_ways(tmp_path):
    log = jkt.build_training_log(seed=1, n_shapes=3)
    log.save(tmp_path / "j.jsonl")
    back = TLog.load(tmp_path / "j.jsonl")
    assert [r.to_obj() for r in back.records] == [r.to_obj() for r in log.records]
    back.save(tmp_path / "t.jsonl")
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert [r.to_obj() for r in JLog.load(tmp_path / "t.jsonl").records] == \
        [r.to_obj() for r in log.records]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_logstore_interop(tmp_path, writer):
    """A store one package writes, the other reads: same records, sources,
    and the same measured tuner predictions."""
    path = tmp_path / "store.jsonl"
    cases = _yi_cases()
    if writer == "reference":
        jkt.build_training_log(seed=0, n_shapes=4, store=JStore(path))
        jkt.measure_cases(cases, jtiming.SimulatorBackend(seed=0), JStore(path))
    else:
        tkt.build_training_log(seed=0, n_shapes=4, store=TStore(path), **V5E_MODEL)
        tkt.measure_cases([_tcase(c) for c in cases],
                          ttiming.SimulatorBackend(seed=0, **V5E_MODEL), TStore(path))
    js, ts = JStore(path), TStore(path)
    assert len(js) == len(ts) and js.sources() == ts.sources()
    assert [r.to_obj() for r, _ in ts.iter_records()] == \
        [r.to_obj() for r, _ in js.iter_records()]
    for source in ("kernel_grid", jkt.MEASURED_SOURCE):
        jt = jkt.KernelTuner().fit(js.load(algos="matmul_tile", source=source))
        tt = tkt.KernelTuner(rule=ttiming.VMEM_RULE).fit(
            ts.load(algos="matmul_tile", source=source))
        assert tt.predict_batch(PRED_SHAPES) == jt.predict_batch(PRED_SHAPES)
    # appending from the other package dedups against what is there
    if writer == "reference":
        assert tkt.build_training_log(seed=0, n_shapes=4, store=ts, **V5E_MODEL)
        assert len(ts) == len(js)


# -------------------------------------------------------------- simulator
@pytest.mark.parametrize("kernel", ["matmul", "flash"])
def test_simulator_v5e_seconds_match_reference(kernel):
    jsim = jtiming.SimulatorBackend(seed=3)
    tsim = ttiming.SimulatorBackend(seed=3, **V5E_MODEL)
    assert tsim.name == "sim:v5e"
    n = 0
    for case in jwl.zoo_cases():
        if case.kernel != kernel:
            continue
        bcase = jkt.bucket_case(case)
        tiles = jkt.candidate_tiles(bcase)
        want = jsim.measure(bcase, tiles)
        got = tsim.measure(_tcase(bcase), tiles)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        n += len(tiles)
    assert n > 100


def test_feasible_and_seed_tiles_identical_under_vmem_rule():
    for case in jwl.zoo_cases():
        bcase = jkt.bucket_case(case)
        tcase = _tcase(bcase)
        tiles = jkt.candidate_tiles(bcase)
        assert tkt.candidate_tiles(tcase) == tiles
        assert tkt.feasible_tiles(tcase, tiles, rule=ttiming.VMEM_RULE) == \
            jkt.feasible_tiles(bcase, tiles)
        assert tkt.seed_tiles(tcase, **V5E_MODEL) == jkt.seed_tiles(bcase)
        np.testing.assert_array_equal(
            tkt.prior_times(tcase, tiles, **V5E_MODEL), jkt.prior_times(bcase, tiles))


def test_cost_model_grids_identical_under_v5e():
    bm = np.array([64, 128, 256, 512, 1024])[:, None, None]
    bn = np.array([64, 256, 512, 2048])[None, :, None]
    bk = np.array([128, 512, 3072, 3073])[None, None, :]
    for db in (2, 4):
        np.testing.assert_array_equal(
            tkt.matmul_tile_times(4096, 4096, 4096, bm, bn, bk, dtype_bytes=db,
                                  **V5E_MODEL),
            jkt.matmul_tile_times(4096, 4096, 4096, bm, bn, bk, dtype_bytes=db))
    np.testing.assert_array_equal(
        tkt.flash_tile_times(8192, 128, 8192, bm[:, :, 0], bn[:, :, 0], heads=32,
                             **V5E_MODEL),
        jkt.flash_tile_times(8192, 128, 8192, bm[:, :, 0], bn[:, :, 0], heads=32))


def test_zoo_cases_identical_for_the_whole_zoo():
    for with_flash in (True, False):
        want = [dataclasses.asdict(c) for c in jwl.zoo_cases(with_flash=with_flash)]
        got = [dataclasses.asdict(c) for c in twl.zoo_cases(with_flash=with_flash)]
        assert got == want
    assert twl.EVAL_SHAPES == jwl.EVAL_SHAPES
    assert len(twl.zoo_cases(["yi-6b"], with_flash=False)) == 12


def test_evaluate_kernels_yi6b_identical_under_v5e_simulator():
    """The whole slice: same rows (tiles and times) from both packages."""
    want = jharness.evaluate_kernels(arch_ids=["yi-6b"], seed=0)
    got = tharness.evaluate_kernels(
        backend=ttiming.SimulatorBackend(seed=0, **V5E_MODEL), arch_ids=["yi-6b"])
    keys = ("label", "kernel", "shape", "dtype", "pred", "cost_tile",
            "argmin_tile", "t_pred", "t_cost_model", "t_best", "argmin_hit")
    assert len(got["rows"]) == len(want["rows"]) == 14
    for g, w in zip(got["rows"], want["rows"]):
        assert {k: g[k] for k in keys} == {k: w[k] for k in keys}
    assert got["overall"] == want["overall"]
    assert got["measurement"] == want["measurement"]
    assert tharness.bench_kernel_payload(got) == \
        {**jharness.bench_kernel_payload(want), "backend": "sim:v5e"}


# ---------------------------------------------------- the port's H100 model
def test_h100_defaults_seed_only_tiles_the_kernel_runs():
    sim = ttiming.SimulatorBackend(seed=0)
    assert sim.name == "sim:h100" and sim.hw is H100
    assert H100.peak_flops == 989e12 and H100.hbm_bw == 3.35e12
    for case in twl.zoo_cases(with_flash=False):
        bcase = tkt.bucket_case(case)
        tiles = tkt.seed_tiles(bcase)
        assert tiles
        for bm, bn, bk in tiles:
            sm, sn, depth = mm.plan(bcase.m, bcase.k, bcase.n, block_m=bm, block_n=bn,
                                    block_k=bk, dtype_bytes=bcase.dtype_bytes)
            # a bf16 wgmma tile with a ring of at least two stages
            assert (sm, sn) in mm.INSTANTIATED[2] and mm.stages(sm, sn, depth) >= 2
    # a tile the VMEM rule takes but K1 cannot run is pruned before timing
    case = ttiming.KernelCase("matmul", 4096, 4096, 4096)
    assert tkt.feasible_tiles(case, [(512, 512, 512)], rule=ttiming.VMEM_RULE)
    assert tkt.feasible_tiles(case, [(512, 512, 512)]) == []
    assert math.isinf(tkt.matmul_tile_time(4096, 4096, 4096, 512, 512, 128))


def test_measured_records_name_the_backend_and_rule(tmp_path):
    store = TStore(tmp_path / "s.jsonl")
    case = twl.zoo_cases(["yi-6b"], ["decode_32k"], with_flash=False)[0]
    recs, stats = tkt.measure_case(case, ttiming.SimulatorBackend(seed=0), store)
    assert stats["measured"] > 0
    assert all(r.env == {"smem_kb": 227, "k1": "wgmma-tma", "k2": "wgmma-tma",
                         "kernel": "matmul", "dtype": "bfloat16",
                         "timing": "sim:h100"} for r in recs)
    again, stats = tkt.measure_case(case, ttiming.SimulatorBackend(seed=0), store)
    assert stats["measured"] == 0 and stats["cached"] == len(again)


def test_a_prediction_the_rule_refuses_raises_in_the_wrapper():
    # the TPU's analytic log teaches tiles the blocked matmul cannot run: the
    # tuner returns them as decoded and the wrapper refuses to launch them
    tuner = tkt.KernelTuner().fit(jkt.build_training_log(seed=0, n_shapes=12).records)
    tile = tuner.predict(4096, 4096, 4096)
    assert tile == (512, 512, 512) and not mm.fits(*tile)
    a = torch.zeros((512, 512), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not feasible"):
        ops.matmul(a, a, block_m=tile[0], block_n=tile[1], block_k=tile[2])


@pytest.mark.parametrize("rule,dtype,tile,serial", [
    ("smem", "bfloat16", (128, 256, 64), True),      # the ring fills the budget
    ("smem", "float32", (64, 64, 16), False),
    ("vmem", "bfloat16", (512, 512, 512), False),
    ("vmem", "bfloat16", (2048, 2048, 512), True),
])
def test_simulator_serializes_tiles_over_half_the_budget(rule, dtype, tile, serial):
    """The simulator prices a tile whose working set is over half its
    rule's budget as loads and compute in turn: slower than under a rule
    with room to spare, and equal where the tile is under half."""
    rule = {"smem": ttiming.SMEM_RULE, "vmem": ttiming.VMEM_RULE}[rule]
    roomy = ttiming.TileRule("roomy", rule.budget * 1000, rule.env,
                             rule.matmul_bytes)
    case = ttiming.KernelCase("matmul", 4096, 4096, 4096, dtype=dtype)
    assert bool(rule.tile_bytes(case, *tile) > rule.budget / 2) is serial
    t = ttiming.SimulatorBackend(seed=0, rule=rule).measure(case, [tile])[0]
    t_roomy = ttiming.SimulatorBackend(seed=0, rule=roomy).measure(case, [tile])[0]
    assert t > t_roomy if serial else t == t_roomy


@pytest.mark.parametrize("use", ["tile_bytes", "fits", "cost_model"])
def test_smem_rule_refuses_flash_cases(use):
    """The H100 rule prices flash tiles by K2's real launch: it admits the
    compiled tiles and refuses the rest, on all three of its uses."""
    case = ttiming.KernelCase("flash", 4096, 128, 4096, heads=32)
    admitted = [(64, 64), (64, 128), (128, 64), (128, 128)]
    refused = [(256, 64), (64, 256), (512, 512)]
    if use == "tile_bytes":
        for bq, bk in admitted + refused:
            sq, sk = fa.launch_tile(bq, bk)
            assert ttiming.SMEM_RULE.tile_bytes(case, bq, bk) == \
                fa.smem_bytes(sq, sk, 128) == \
                1024 + sq * 128 * 2 + 2 * 2 * sk * 128 * 2 + 40
    elif use == "fits":
        assert tkt.feasible_tiles(case, admitted + refused) == admitted
    else:
        times = tkt.flash_tile_times(4096, 128, 4096, np.array([64, 128, 256]),
                                     np.array([64, 128, 64]), heads=32)
        assert np.isfinite(times[:2]).all() and np.isinf(times[2])
    # the reference's rule still prices them its own way
    assert ttiming.VMEM_RULE.fits(case, 256, 64)


# ------------------------------------------------------ wall-clock backend
def test_wallclock_cpu_verifies_and_times_a_small_case():
    be = ttiming.WallClockBackend(device="cpu", reps=2)
    assert be.name == "wallclock:cpu"
    case = ttiming.KernelCase("matmul", 96, 80, 64, dtype="float32")
    secs = be.measure(case, [(64, 64, 64), (32, 64, 16)])
    assert all(math.isfinite(s) and s > 0 for s in secs)
    assert (be.measured, be.verified, be.verify_failures) == (2, 2, 0)


def test_wallclock_scores_a_wrong_result_inf(monkeypatch):
    be = ttiming.WallClockBackend(device="cpu")
    real = mm.matmul_blocked_plain
    monkeypatch.setattr(mm, "matmul_blocked_plain",
                        lambda a, b, **kw: real(a, b) + 1.0)
    secs = be.measure(ttiming.KernelCase("matmul", 64, 32, 48), [(64, 64, 32)])
    assert secs == [float("inf")]
    assert (be.measured, be.verify_failures) == (0, 1)


def test_wallclock_raises_on_flash_and_on_an_infeasible_tile():
    """Flash tiles are measured now; an infeasible tile of either kernel
    raises instead of being timed or scored."""
    be = ttiming.WallClockBackend(device="cpu")
    secs = be.measure(ttiming.KernelCase("flash", 128, 64, 128), [(64, 64)])
    assert math.isfinite(secs[0])
    with pytest.raises(ValueError, match="not feasible"):
        be.measure(ttiming.KernelCase("flash", 512, 128, 512), [(256, 64)])
    with pytest.raises(ValueError, match="not feasible"):
        be.measure(ttiming.KernelCase("matmul", 1024, 1024, 1024), [(512, 512, 64)])


@pytest.mark.parametrize("causal", [True, False])
def test_wallclock_cpu_verifies_and_times_a_flash_case(causal):
    be = ttiming.WallClockBackend(device="cpu", reps=2)
    case = ttiming.KernelCase("flash", 96, 32, 128, heads=2, batch=2, causal=causal,
                              dtype="float32")
    secs = be.measure(case, [(64, 64), (32, 128)])
    assert all(math.isfinite(s) and s > 0 for s in secs)
    assert (be.measured, be.verified, be.verify_failures) == (2, 2, 0)
    assert be.measured_by == {"matmul": 0, "flash": 2}


def test_wallclock_scores_a_wrong_flash_result_inf(monkeypatch):
    be = ttiming.WallClockBackend(device="cpu")
    real = fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain",
                        lambda *a, **kw: real(*a, **kw) + 1.0)
    secs = be.measure(ttiming.KernelCase("flash", 64, 32, 64, heads=2), [(64, 64)])
    assert secs == [float("inf")]
    assert (be.measured, be.verify_failures) == (0, 1)


def test_wallclock_cuda_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttiming.WallClockBackend(device="cuda")


def test_get_backend_registry():
    assert ttiming.get_backend("sim", seed=3).seed == 3
    assert isinstance(ttiming.get_backend("wallclock", device="cpu"),
                      ttiming.WallClockBackend)
    with pytest.raises(KeyError):
        ttiming.get_backend("cycle_accurate")


# -------------------------------------------------------------------- CLI
def test_tune_main_with_the_simulator(tmp_path):
    store = tmp_path / "store.jsonl"
    out = ttune.main(["--device", "cpu", "--backend", "sim", "--arch", "yi-6b",
                      "--store", str(store)])
    assert len(out["predicted"]) == 14
    flash = {k: t for k, t in out["predicted"].items() if k.endswith("/flash")}
    assert sorted(flash) == ["yi-6b/prefill_32k/flash", "yi-6b/train_4k/flash"]
    assert all(len(t) == 2 and fa.fits(*t, 128) for t in flash.values())
    assert all(len(t) == 3 and mm.fits(*t) for k, t in out["predicted"].items()
               if k not in flash)
    assert out["backend"]["measured"] > 0 and out["eval"]["config"]["n_rows"] == 14
    report = json.loads((tmp_path / "kernel_eval.json").read_text())
    assert report["config"]["backend"] == "sim:h100"
    again = ttune.main(["--device", "cpu", "--backend", "sim", "--arch", "yi-6b",
                        "--store", str(store)])
    assert again["predicted"] == out["predicted"]
    assert again["eval"]["measurement"]["measured"] == 0      # all memoized


def test_python_m_repro_torch_tune(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "tune", "--device", "cpu",
         "--backend", "sim", "--arch", "yi-6b", "--store",
         str(tmp_path / "store.jsonl")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "yi-6b/decode_32k/ffn_down" in proc.stdout
    assert (tmp_path / "kernel_eval.json").exists()


def test_tune_kernel_with_the_simulator_predicts_the_flash_pairs(tmp_path):
    out = ttune.tune_kernel(TStore(tmp_path / "s.jsonl"),
                            ttiming.SimulatorBackend(seed=0), arch_ids=["yi-6b"],
                            artifacts=tmp_path)
    pred = out["predicted"]
    assert len(pred) == 14
    assert sum(len(t) == 2 for t in pred.values()) == 2
    rows = [r for r in out["eval"]["rows"] if r["kernel"] == "flash"]
    assert [r["label"] for r in rows] == ["yi-6b/train_4k/flash",
                                          "yi-6b/prefill_32k/flash"]
    assert all(fa.fits(*r["argmin_tile"], 128) for r in rows)


def test_evaluate_kernels_skips_a_head_dim_k2_does_not_compile():
    """K2 compiles every head dim of the zoo's attention (phi-3-vision's 96
    and h2o-danube's 120 on d = 128's layout), so no case is skipped: each
    flash case of both archs has a row, and its measured argmin tile is one
    the rule admits at its head dim.  A head dim K2 does not compile (48)
    still has no tile."""
    archs = ["phi-3-vision-4.2b", "h2o-danube-3-4b"]
    report = tharness.evaluate_kernels(backend=ttiming.SimulatorBackend(seed=0),
                                       arch_ids=archs)
    cases = twl.zoo_cases(archs)
    flash = {c.label: c for c in cases if c.kernel == "flash"}
    assert {c.k for c in flash.values()} == {96, 120}
    assert report["config"]["n_cases"] == report["config"]["n_rows"] == len(cases)
    rows = [r for r in report["rows"] if r["kernel"] == "flash"]
    assert sorted(r["label"] for r in rows) == sorted(flash)
    for r in rows:
        assert fa.fits(*r["argmin_tile"], flash[r["label"]].k), r
    assert not fa.fits(64, 64, 48)
