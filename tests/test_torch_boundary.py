"""The port stands alone: importing every ``repro_torch`` module pulls in
neither jax nor any module of the JAX package, and no source names them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tools" / "profile_torch_serve.py",
                                        ROOT / "tools" / "profile_torch_train.py"]

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, check=True)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("launch.serve", "launch.tune", "kernels.flash_attention",
                 "kernels.matmul_blocked", "kernels.timing", "core.kerneltune",
                 "core.tuner", "core.trees", "core.chained", "core.features",
                 "core.log", "core.roofline", "data.logstore", "eval.harness",
                 "configs.workloads", "artifacts", "launch.train",
                 "runtime.optim", "runtime.steps", "runtime.pipeline",
                 "runtime.checkpoint", "runtime.fault", "runtime.tree",
                 "models.moe", "models.ssm", "data.taskgraph", "data.executor",
                 "data.distarray", "data.datasets", "algorithms",
                 "algorithms.kmeans", "algorithms.pca", "algorithms.gmm",
                 "algorithms.svm", "algorithms.rf", "core.gridsearch",
                 "core.estimator", "core.meshtune", "eval.autorun",
                 "launch.evaluate", "launch.serve_estimator", "serve",
                 "serve.router", "serve.refit", "serve.loadgen",
                 "serve.stats"):
        assert f"repro_torch.{name}" in out["imported"], name
    bad = [m for m in out["modules"]
           if m == "jax" or m.startswith(("jax.", "jaxlib"))
           or m == "repro" or m.startswith("repro.")]
    assert not bad, bad


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax_and_no_repro(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    for pattern in ("import repro.", "from repro.", "from repro import"):
        assert pattern not in text, pattern


@pytest.mark.parametrize("path", [p for p in SOURCES if PKG in p.parents],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_attention_and_no_compile(path):
    text = path.read_text()
    assert "scaled_dot_product_attention" not in text
    assert "torch.compile" not in text
