"""The port's elastic re-mesh against the JAX package's
``repro/runtime/elastic.py``: the elastic cases of ``tests/test_fault.py``
(``plan_mesh`` invariants, its preference, both typed errors,
``adapt_config``), ``plan_mesh`` equal to JAX's over a grid, the ``mesh``
launcher on gloo ranks, and the train launcher on four CPU ranks with
``--inject-failure 6``: after one rank is lost the run re-meshes onto
``plan_mesh(3, 8, prefer_model=3)`` and resumes with the losses of a fresh
3-rank run restored from the same checkpoint (rtol 1e-6); on five ranks,
one idle on the first mesh, the re-plan is from the run's rank count."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.configs import reduced_config as jreduced_config
from repro.runtime import elastic as jel
from repro_torch.configs import reduced_config
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.elastic import (MeshPlan, NoFeasibleMeshError,
                                         adapt_config, plan_mesh)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 360             # seconds, each multi-rank run (a loaded host under -n 6)


@settings(max_examples=50, deadline=None)
@given(n=st.integers(1, 600), gb=st.sampled_from([8, 64, 256]))
def test_plan_mesh_invariants(n, gb):
    plan = plan_mesh(n, gb, prefer_model=16)
    assert plan.size <= n
    data, model = plan.shape
    assert 16 % model == 0                     # tensor shards keep dividing
    assert gb % data == 0                      # batch splits evenly


@pytest.mark.parametrize("gb", [8, 64, 256])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 12, 16, 31, 100, 255, 512, 600])
def test_plan_mesh_grid_matches_jax(n, gb):
    """The invariants over a grid of the property's domain, and the plan
    (shape, axes, microbatches) equal to the JAX function's."""
    for prefer in (16, 4, min(4, n)):
        plan = plan_mesh(n, gb, prefer_model=prefer, microbatches=2)
        assert plan.size <= n
        data, model = plan.shape
        assert prefer % model == 0 and gb % data == 0
        jplan = jel.plan_mesh(n, gb, prefer_model=prefer, microbatches=2)
        assert (plan.shape, plan.axes, plan.microbatches) == \
            (jplan.shape, jplan.axes, jplan.microbatches)


def test_plan_mesh_prefers_larger_usable_mesh():
    plan = plan_mesh(512, 256, prefer_model=16)
    assert plan.size == 512
    plan7 = plan_mesh(7, 256, prefer_model=4)
    assert plan7.size <= 7 and plan7.size >= 4


def test_plan_after_losing_one_of_four_ranks():
    """What the launcher re-meshes onto after a failure at 4 ranks."""
    assert plan_mesh(4, 8, prefer_model=4).shape == (1, 4)
    assert plan_mesh(3, 8, prefer_model=3) == MeshPlan((1, 3), ("data", "model"), 1)


def test_plan_mesh_no_healthy_devices_raises_typed():
    with pytest.raises(NoFeasibleMeshError):
        plan_mesh(0, 64)
    with pytest.raises(NoFeasibleMeshError):
        plan_mesh(-2, 64)


def test_plan_mesh_indivisible_batch_raises_typed():
    with pytest.raises(NoFeasibleMeshError):
        plan_mesh(8, 0)
    assert issubclass(NoFeasibleMeshError, RuntimeError)


@pytest.mark.parametrize("m", [1, 2, 3, 6, 8])
def test_adapt_config_keeps_batch_divisible(m):
    cfg = reduced_config("yi-6b").replace(train_microbatches=m)
    plan = plan_mesh(8, 64, prefer_model=2)
    c2 = adapt_config(cfg, plan, 64)
    data = plan.shape[0]
    assert 64 % c2.train_microbatches == 0
    assert (64 // c2.train_microbatches) % data == 0
    jplan = jel.plan_mesh(8, 64, prefer_model=2)
    jc2 = jel.adapt_config(jreduced_config("yi-6b").replace(train_microbatches=m), jplan, 64)
    assert c2.train_microbatches == jc2.train_microbatches


# ------------------------------------------------------------ the launchers
def _python(tmp_path, code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def test_mesh_launcher_on_four_gloo_ranks(tmp_path):
    out = _python(tmp_path, "from repro_torch.launch import mesh\n"
                  "mesh.main(['--device', 'cpu', '--host-devices', '4'])\n"
                  "mesh.main(['--device', 'cpu', '--host-devices', '4', '--shape', '2,2'])\n")
    assert out.splitlines() == [
        "mesh shape={'data': 1, 'model': 4} devices=4 platform=cpu",
        "mesh shape={'data': 2, 'model': 2} devices=4 platform=cpu"]


def test_mesh_launcher_refuses_more_ranks_than_exist(capsys):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.main(["--device", "cpu", "--shape", "2,2"])
    line = tmesh.main(["--device", "cpu"])
    assert line == "mesh shape={'data': 1, 'model': 1} devices=1 platform=cpu"
    assert capsys.readouterr().out.strip() == line


def test_python_m_repro_torch_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "mesh", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr
    assert "mesh shape={'data': 1, 'model': 1} devices=1 platform=cpu" in proc.stdout


ARGS = ["--device", "cpu", "--quiet", "--global-batch", "8", "--seq", "32",
        "--steps", "8", "--ckpt-every", "4"]


def _train(tmp_path, *argv):
    code = ("import json\nfrom repro_torch.launch import train\n"
            f"print('LOSSES' + json.dumps(train.main({[*ARGS, *argv]!r})))\n")
    out = _python(tmp_path, code)
    return out, json.loads(out.split("LOSSES")[-1])


def test_launcher_remeshes_after_losing_a_rank(tmp_path):
    """Four ranks on (1, 4); at step 6 one is lost: the survivors re-form a
    3-rank group on plan_mesh(3, 8, prefer_model=3) = (1, 3), restore step 4
    and run 5..8.  A fresh 3-rank run restored from that checkpoint gives
    the same losses; before the failure the run matches itself."""
    out, losses = _train(tmp_path, "--host-devices", "4", "--inject-failure", "6",
                         "--ckpt-dir", str(tmp_path / "ck"))
    assert "mesh={'data': 1, 'model': 4} step=sharded" in out
    assert "resumed at step 4 on 3 device(s), mesh={'data': 1, 'model': 3}" in out
    assert len(losses) == 10 and np.all(np.isfinite(losses))   # 1..6, then 5..8
    # the pipeline cursor came back with the weights: steps 5, 6 ran twice
    np.testing.assert_allclose(losses[6:8], losses[4:6], rtol=1e-5)
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    shutil.copytree(tmp_path / "ck" / "step_00000004", fresh / "step_00000004")
    out3, resumed = _train(tmp_path, "--host-devices", "3", "--resume",
                           "--ckpt-dir", str(fresh))
    assert "mesh={'data': 1, 'model': 3}" in out3 and "resumed from step 4" in out3
    np.testing.assert_allclose(resumed, losses[6:], rtol=1e-6)


def test_launcher_replans_from_the_runs_rank_count(tmp_path):
    """Five ranks at global batch 8: the first plan, (1, 4), leaves rank 4
    idle.  At step 5 one of the five is lost, and the plan over the four
    left is (1, 4) again -- the JAX package plans from its device count,
    not from the mesh's -- so the run resumes on four ranks, and steps 5
    and 6 (before and after the restore of step 4) give the same losses."""
    assert jel.plan_mesh(5, 8, prefer_model=4).shape == (1, 4)
    assert jel.plan_mesh(4, 8, prefer_model=4).shape == (1, 4)
    out, losses = _train(tmp_path, "--host-devices", "5", "--steps", "6",
                         "--inject-failure", "5", "--ckpt-dir", str(tmp_path / "ck"))
    assert "mesh={'data': 1, 'model': 4} step=sharded" in out
    assert "resumed at step 4 on 4 device(s), mesh={'data': 1, 'model': 4}" in out
    assert len(losses) == 7 and np.all(np.isfinite(losses))   # 1..5, then 5, 6
    np.testing.assert_allclose(losses[5], losses[4], rtol=1e-6)
