#!/usr/bin/env python3
"""Price dry-run cells in parallel and rank each rank's op list by bytes.

    python3 tools/dryrun_report.py gemma3-27b:prefill_32k gemma3-27b:train_4k \
        [--out artifacts/dryrun] [--summary FILE] [--grep REGEX] [--src DIR]

Each ``arch:shape`` cell runs on ``pod16x16`` as its own ``python -m
repro_torch dryrun --arch A --shape S --save-hlo`` process (all at once;
the dry-run needs no card), writing ``{arch}__{shape}__pod16x16.json`` and
``.ops.txt`` under ``--out``.  Then, for each cell, it prints the record's
per-rank price (``mem_device_bytes``, temp bytes and trace seconds, in GB
of 1e9), the pricing process's peak resident memory on the host, and the
op lines whose outputs are largest, each distinct line once with the
number of times it ran, and writes all of it as JSON to ``--summary``.
``--grep REGEX`` (repeatable) also counts each cell's op lines that match.
``--src DIR`` prices another checkout's port (a parent commit unpacked
beside this one).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MESH = "pod16x16"
TOP = 12                 # op lines listed a cell
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8, "int64": 8,
         "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1}
_TENSOR = re.compile(r"([a-z]+\d*)\[([\d, ]*)\]")


def out_bytes(line: str) -> int:
    """Bytes of the outputs of one op line (``... -> dtype[shape], ...``)."""
    if " -> " not in line:
        return 0
    total = 0
    for dtype, dims in _TENSOR.findall(line.split(" -> ", 1)[1]):
        n = BYTES.get(dtype, 4)
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n
    return total


def rank_ops(text: str, top: int) -> list:
    """The ``top`` distinct op lines of an op list by output bytes."""
    counts = Counter(line.split(" flops=")[0] for line in text.splitlines() if line)
    ranked = sorted(counts.items(), key=lambda kv: out_bytes(kv[0]), reverse=True)
    return [{"op": op, "out_gb": out_bytes(op) / 1e9, "count": n} for op, n in ranked[:top]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="+", help="arch:shape")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--summary", default=None)
    ap.add_argument("--grep", action="append", default=[])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    cells = [c.split(":") for c in args.cells]
    out = Path(args.out).resolve()
    failed, rss = [], {}
    env = dict(os.environ, PYTHONPATH=str(Path(args.src).resolve()))
    procs, t0 = [], time.time()
    for arch, shape in cells:
        cmd = [sys.executable, "-m", "repro_torch", "dryrun", "--arch", arch,
               "--shape", shape, "--save-hlo", "--out", str(out)]
        procs.append(subprocess.Popen(cmd, env=env))
    for (arch, shape), p in zip(cells, procs):
        _, status, usage = os.wait4(p.pid, 0)
        p.returncode = os.waitstatus_to_exitcode(status)
        rss[f"{arch}:{shape}"] = usage.ru_maxrss / 1e6       # kB on Linux
        if p.returncode != 0:
            failed.append(f"{arch}:{shape}")
    print(f"priced {len(cells)} cells in {time.time() - t0:.1f} s", flush=True)
    report = {}
    for arch, shape in cells:
        name = f"{arch}__{shape}__{MESH}"
        if not (out / f"{name}.json").exists():
            continue
        rec = json.loads((out / f"{name}.json").read_text())
        text = (out / f"{name}.ops.txt").read_text()
        ops = rank_ops(text, TOP)
        grep = {g: sum(1 for line in text.splitlines() if re.search(g, line))
                for g in args.grep}
        report[f"{arch}:{shape}"] = {
            "mem_device_gb": rec["mem_device_bytes"] / 1e9,
            "temp_gb": rec["memory"]["temp_size_in_bytes"] / 1e9,
            "argument_gb": rec["memory"]["argument_size_in_bytes"] / 1e9,
            "trace_s": rec["trace_s"], "flops": rec["flops"],
            "host_peak_rss_gb": rss.get(f"{arch}:{shape}"),
            "collectives": {k: v["count"] for k, v in rec["collectives"].items()},
            "n_ops": text.count("\n"), "grep": grep, "top_ops": ops}
        print(f"{arch} {shape} {MESH}: mem_device {rec['mem_device_bytes'] / 1e9:.2f} GB "
              f"(temp {rec['memory']['temp_size_in_bytes'] / 1e9:.2f}) trace {rec['trace_s']} s, "
              f"host peak RSS {rss.get(f'{arch}:{shape}')} GB")
        for g, n in grep.items():
            print(f"    {n:>8} lines match {g!r}")
        for o in ops:
            print(f"    {o['out_gb']:10.3f} GB x{o['count']:<5} {o['op'][:220]}")
    if args.summary:
        Path(args.summary).parent.mkdir(parents=True, exist_ok=True)
        Path(args.summary).write_text(json.dumps({"failed": failed, "cells": report}, indent=1))
    if failed:
        print(f"failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
