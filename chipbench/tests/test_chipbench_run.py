"""A run of each cell end to end on the CPU at a tiny size (the harness's
look for a card skipped): the result line's shape, a traced run's fields,
and ``correct`` false for each fault the cell can have planted under the
timed path.  On the card (marker ``cuda``): the control at the cell's own
size comes out not correct.

    PYTHONPATH=src python -m pytest -q chipbench/tests
    PYTHONPATH=src python -m pytest -q -m cuda chipbench/tests    # on the card
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from chipbench import common
from chipbench import run as R

ROOT = Path(__file__).resolve().parents[2]
SPEC = common.benchmark()
CELLS = [w["name"] for w in SPEC["workloads"]]
TINY = {"num_hidden_layers": 2, "hidden_size": 128, "num_attention_heads": 4,
        "intermediate_size": 256, "vocab_size": 512}
TRAFFIC = {"train": {"seq": 64, "batch": 4, "microbatches": 2},
           "prefill": {"tokens_per_batch": 64, "lengths": [16, 32]},
           "decode": {"sessions": 4, "context": 16, "room": 8, "keep_within": 4,
                      "keep_steps": 2}}
SEED = 2**31 + 12345


def tiny(cell):
    wl = common.workload(cell)
    cfg = common.config(wl["config"])
    kv = 4 if cfg["num_key_value_heads"] == cfg["num_attention_heads"] else 2
    return {"config": {**TINY, "num_key_value_heads": kv}, "traffic": TRAFFIC[wl["driver"]]}


def execute(cell, **kw):
    return R.execute(cell, SEED, 0.5, kw.pop("trace", False), torch.device("cpu"),
                     shrink=tiny(cell), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    res = execute(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(common.workload(cell)["limits"])
    json.loads(json.dumps(res))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(cell):
    res = execute(cell, trace=True)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["metrics"] == {}                # no device reading from a run on the CPU


def _faults():
    out = []
    for cell in CELLS:
        driver = common.workload(cell)["driver"]
        mod = R._load(common.BENCH / "drivers" / f"{driver}.py", f"chipbench_driver_{driver}")
        out += [(cell, f) for f in mod.FAULTS]
    return out


@pytest.mark.parametrize("cell,fault", _faults())
def test_fault_is_not_correct(cell, fault):
    res = execute(cell, fault=fault)
    assert res["correct"] is False, res["checks"]


def test_no_card_no_result():
    """Without CUDA the harness exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chipbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    """The reference in float8 in the program's place, at the cell's size."""
    out = subprocess.run([sys.executable, "chipbench/run.py", "--workload", cell, "--seed",
                          str(SEED), "--seconds", "2", "--trace", "0", "--control", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False


def test_calibrate_reads_each_fault_and_the_control():
    """The train cell's readings that its limits are set from, at a tiny
    size, as ``--fault`` and ``--control`` runs give them: the faults read
    far above the sound program where they break the step."""
    def checks(**kw):
        return {k: c["value"] for k, c in execute("yi-6b.train", **kw)["checks"].items()}
    sound, control = checks(), checks(control=True)
    unchanged, half = checks(fault="unchanged"), checks(fault="half_batch")
    assert unchanged["grad_gap"] == pytest.approx(1.0)
    assert unchanged["change_gap"] == pytest.approx(1.0)
    assert half["grad_gap"] > 10 * sound["grad_gap"]
    assert control["loss_gap"] > sound["loss_gap"]


def test_idle_gaps_are_named_by_the_innermost_running_host_op():
    from chipbench.window import _gaps
    host = [(0, 100, "outer"), (10, 20, "inner"), (50, 60, "later")]
    busy = [[5, 12], [30, 55], [58, 90]]
    # gaps: [0,5) outer, [12,30) inner (ends 20), [55,58) later, [90,100) outer
    got = dict(_gaps(busy, 0, 100, host))
    assert got == pytest.approx({"outer": 15e-9, "inner": 18e-9, "later": 3e-9})
    assert dict(_gaps([], 0, 10, [])) == pytest.approx({"host outside any op": 10e-9})
