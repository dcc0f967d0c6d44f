"""Run one benchmark cell once on the card and print its result line.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name: ``workloads/<cell>.json`` names its config
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``), and
``BENCHMARK.json`` its metrics, each per-layer metric read by
``metrics/<metric>.py``.  Set-up (loading, weights drawn on the card from
the seed, warming up every shape the cell uses) is timed as ``setup_s``;
then the window runs for ``--seconds``; then the outputs of the window are
compared with the plain reference (``reference/``), and the last line of
standard output is the JSON result.  With ``--trace 1`` the window runs
under the profiler and the line carries the per-layer metrics instead of
the end-to-end ones.

Two more options exist for proving the comparison, never for a measured
run: ``--control 1`` judges the reference computed in float8 in the
program's place, ``--fault <name>`` plants a fault in the program (the
driver's ``FAULTS``).  Either makes the run come out not correct.

It exits non-zero, with no result line, where CUDA is missing or has fewer
cards than the cell asks for, or where JAX or the JAX package is loaded
once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the package by its name only: its folder on the path would shadow modules
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "chipbench"]
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def say(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package
    (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"


def _cell(cell: str, seed: int, device, shrink: dict | None):
    """(workload file, driver module, the driver's context) of ``cell``;
    ``shrink`` overrides config and traffic keys (the CPU tests' tiny
    sizes)."""
    from chipbench import common
    entry = next(w for w in common.benchmark()["workloads"] if w["name"] == cell)
    wl = common.workload(cell)
    if wl["config"] != entry["config"]:
        raise RuntimeError(f"{cell}: workload file names {wl['config']}, "
                           f"BENCHMARK.json {entry['config']}")
    shrink = shrink or {}
    cfg_json = {**common.config(wl["config"]), **shrink.get("config", {})}
    driver = _load(common.BENCH / "drivers" / f"{wl['driver']}.py",
                   f"chipbench_driver_{wl['driver']}")
    ctx = SimpleNamespace(cell=cell, config_name=wl["config"], dims=common.Dims.of(cfg_json),
                          traffic={**wl["traffic"], **shrink.get("traffic", {})},
                          seed=int(seed), device=device, say=say, t_start=T_START,
                          fault=None, control=False, trace=False, seconds=0.0)
    return wl, driver, ctx


def execute(cell: str, seed: int, seconds: float, trace: bool, device, *,
            control: bool = False, fault: str | None = None, shrink: dict | None = None) -> dict:
    """One run of ``cell`` on ``device``: the result dict (the line's keys,
    ``checks`` last)."""
    import torch

    from chipbench import common

    bench = common.benchmark()
    wl, driver, ctx = _cell(cell, seed, device, shrink)
    if fault is not None and fault not in driver.FAULTS:
        raise SystemExit(f"{cell}: no fault {fault!r}; the driver plants {driver.FAULTS}")
    ctx.seconds, ctx.trace, ctx.control, ctx.fault = float(seconds), bool(trace), control, fault
    out = driver.run(ctx)

    if trace:
        metrics = {}                 # device readings: none from a run on the CPU
        for m in bench["per_layer"]:
            if cell not in m.get("workloads", [cell]) or device.type != "cuda":
                continue
            reader = _load(common.BENCH / "metrics" / f"{m['name']}.py",
                           f"chipbench_metric_{m['name'].replace('.', '_')}")
            value = reader.read(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if cell in m.get("workloads", [cell]) and m["name"] in out["e2e"]}

    limits = wl["limits"]
    checks = {name: {"value": v, "limit": limits[name]} for name, v in out["numbers"].items()}
    correct = (out["failed"] == 0 and out["attempted"] > 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        summary = out["run"].trace
        say(f"[trace] busy {summary.busy_s!r} s of {summary.window_s!r} s; "
            f"{summary.linked:.4f} of the operations linked to their launch; ranges "
            f"{summary.ranges}")
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)

    import torch

    from chipbench import common
    stamp = SimpleNamespace(cell=args.workload, say=say, t_start=T_START)
    common.stamp(stamp, "torch imported")
    chips = next(w for w in common.benchmark()["workloads"]
                 if w["name"] == args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"[chipbench] {args.workload} needs {chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)              # the CUDA context, stamped apart
    common.stamp(stamp, "CUDA context made")
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), device,
                     control=bool(args.control), fault=args.fault)
    # after the run, so that nvidia-smi's own start-up stays out of setup_s
    say(f"[chipbench] card: {card_line()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    bad = forbidden_modules()
    if bad:
        say(f"[chipbench] loaded in this process after the window: {bad}; refused")
        return 3
    for name, c in result["checks"].items():
        say(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
