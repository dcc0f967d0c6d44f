"""The port's per-model roofline and mesh tuner against the JAX package's,
on the CPU: every term of ``forward_flops``, ``model_flops``,
``cache_bytes_global`` and ``cell_roofline`` at rtol 1e-12 over the ten
archs, three shapes and three meshes (the same arithmetic, priced on
``V5E`` as the reference prices it), and ``grid_search_cell``,
``MeshTuner.predict`` and ``tune_all`` under ``hw=V5E`` exactly equal.
The port's own default prices on the H100."""
import math

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jcfg
from repro.core import meshtune as jmt
from repro.core import roofline as jrl
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config as tcfg
from repro_torch.core import meshtune as tmt
from repro_torch.core import roofline as trl
from repro_torch.core.roofline import H100, V5E

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = [{"data": 16, "model": 16}, {"data": 64, "model": 1},
          {"pod": 2, "data": 8, "model": 4}]


def _close(got, want):
    if isinstance(want, (bool, str)):
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_flops_and_cache_bytes_match_reference(arch):
    jc, tc = jcfg(arch), tcfg(arch)
    for sn in SHAPE_NAMES:
        s = JSHAPES[sn]
        tokens = float(s.global_batch if s.kind == "decode"
                       else s.global_batch * s.seq_len)
        _close(trl.forward_flops(tc, tokens, s.seq_len, s.kind),
               jrl.forward_flops(jc, tokens, s.seq_len, s.kind))
        _close(trl.model_flops(tc, tokens, s.kind),
               jrl.model_flops(jc, tokens, s.kind))
        _close(trl.cache_bytes_global(tc, s.global_batch, s.seq_len),
               jrl.cache_bytes_global(jc, s.global_batch, s.seq_len))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_roofline_terms_match_reference(arch):
    jc, tc = jcfg(arch), tcfg(arch)
    for sn in SHAPE_NAMES:
        for mesh in MESHES:
            for mb in (None, 4):
                want = jrl.cell_roofline(jc, JSHAPES[sn], mesh, microbatches=mb)
                got = trl.cell_roofline(tc, SHAPES[sn], mesh, microbatches=mb,
                                        hw=V5E)
                assert got.keys() == want.keys()
                for key in want:
                    _close(got[key], want[key])
    over = trl.cell_roofline(tc, SHAPES["train_4k"], MESHES[0], hw=V5E,
                             overlap=0.5)
    _close(over["collective_s"], jrl.cell_roofline(
        jc, JSHAPES["train_4k"], MESHES[0], overlap=0.5)["collective_s"])


def test_cell_roofline_defaults_to_the_h100():
    cfg = tcfg("yi-6b")
    h = trl.cell_roofline(cfg, SHAPES["train_4k"], MESHES[0])
    v = trl.cell_roofline(cfg, SHAPES["train_4k"], MESHES[0], hw=V5E)
    assert h["flops_total"] == v["flops_total"]
    _close(h["compute_s"], v["compute_s"] * V5E.peak_flops / H100.peak_flops)
    _close(h["memory_s"], v["memory_s"] * V5E.hbm_bw / H100.hbm_bw)
    assert h["fits"] == (h["hbm_need_gib"] * 2**30 < H100.hbm_cap)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grid_search_cell_matches_reference(arch):
    for sn in SHAPE_NAMES:
        if sn in jcfg(arch).skip_shapes:
            continue
        jlog, jgrid = jmt.grid_search_cell(jcfg(arch), JSHAPES[sn], chips=64)
        tlog, tgrid = tmt.grid_search_cell(tcfg(arch), SHAPES[sn], chips=64,
                                           hw=V5E)
        assert tgrid == jgrid
        assert [r.to_obj() for r in tlog.records] \
            == [r.to_obj() for r in jlog.records]
    assert tmt.arch_features(tcfg(arch), SHAPES["decode_32k"]) \
        == jmt.arch_features(jcfg(arch), JSHAPES["decode_32k"])
    assert tmt.mesh_grid(64) == jmt.mesh_grid(64)


@pytest.mark.parametrize("chips", [16, 64, 256])
def test_tune_all_and_mesh_tuner_match_reference(chips, tmp_path):
    from repro.data.logstore import LogStore as JStore
    from repro_torch.data.logstore import LogStore as TStore
    archs = ["yi-6b", "mamba2-370m", "mixtral-8x7b", "h2o-danube-3-4b"]
    jstore, tstore = JStore(tmp_path / "j.jsonl"), TStore(tmp_path / "t.jsonl")
    jlog, jgrids = jmt.tune_all(archs, chips=chips, store=jstore)
    tlog, tgrids = tmt.tune_all(archs, chips=chips, store=tstore, hw=V5E)
    assert tgrids == jgrids
    assert (tmp_path / "t.jsonl").read_text().splitlines()[1:] \
        == (tmp_path / "j.jsonl").read_text().splitlines()[1:]
    jt, tt = jmt.MeshTuner(chips).fit(jlog), tmt.MeshTuner(chips, hw=V5E).fit(tlog)
    for arch in ARCH_IDS:
        for sn in SHAPE_NAMES:
            if sn in jcfg(arch).skip_shapes:
                continue
            assert tt.predict(tcfg(arch), SHAPES[sn]) \
                == jt.predict(jcfg(arch), JSHAPES[sn])


def test_mesh_tuner_on_the_h100_predicts_a_feasible_cell():
    log, _ = tmt.tune_all(["yi-6b", "mamba2-370m", "mixtral-8x7b"],
                          shapes=("train_4k",), chips=64)
    dp, tp, mb = tmt.MeshTuner(64).fit(log).predict(tcfg("deepseek-7b"),
                                                    SHAPES["train_4k"])
    assert dp * tp == 64 and SHAPES["train_4k"].global_batch % (dp * mb) == 0
    r = trl.cell_roofline(tcfg("deepseek-7b"), SHAPES["train_4k"],
                          {"data": dp, "model": tp}, microbatches=mb)
    assert r["fits"] and math.isfinite(r["step_s"])
