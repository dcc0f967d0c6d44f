"""Every name in BENCHMARK.json resolves to its files, and the file keeps to
the benchmark's contract (keys, names, units, bounds, which cell reports
what)."""
import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in SPEC["end_to_end"]}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["chipbench"]
    assert SPEC["command"][1] == "chipbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and cfg["source"].startswith("https://")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"chipbench/configs/{cfg['name']}.json"
    assert data["reduced"] == cfg["reduced"] == []
    assert data["source"] == cfg["source"]
    for key in ("hidden_size", "intermediate_size", "num_hidden_layers",
                "num_attention_heads", "num_key_value_heads", "vocab_size"):
        assert isinstance(data[key], int)
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    wl = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"] and wl["why"] == cell["why"]
    assert (BENCH / "configs" / f"{wl['config']}.json").exists()
    driver = BENCH / "drivers" / f"{wl['driver']}.py"
    tree = ast.parse(driver.read_text())
    assert {"run", "FAULTS"} <= {getattr(n, "name", None) for n in tree.body} | {
        t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
        if isinstance(t, ast.Name)}
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    reported = {m["name"] for m in SPEC["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell["name"] in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")
    assert metric["moves"] in E2E - {"setup_s"}
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moved["workloads"])
    reader = BENCH / "metrics" / f"{metric['name']}.py"
    assert "read" in {getattr(n, "name", None) for n in ast.parse(reader.read_text()).body}
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"] \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_named_alike():
    """Metrics of one layer give it the same name, letter for letter."""
    by_module = {}
    for m in SPEC["per_layer"]:
        head = m["layer"].split(" (")[0]
        by_module.setdefault(head, set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values()), by_module
