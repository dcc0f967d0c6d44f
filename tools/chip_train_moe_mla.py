#!/usr/bin/env python3
"""Phase 36's parts of ``chip_smoke.py`` alone, on one CUDA card.

    python3 tools/chip_train_moe_mla.py

Builds the kernels, then runs in turn, each guarded so that a failure
prints its error and a memory summary and the next part still runs:
phase 11's two K2 bwd rows at gemma3-27b's train shapes; the flash-vs-plain
train check at gemma3-27b's widths (windows (256, 0)); the three
``TRAIN_MOE_MLA`` train runs (mixtral-8x7b, gemma3-27b, deepseek-v3-671b,
global batch ``TRAIN_MOE_MLA_BATCH``; for deepseek-v3 first the size of one
MoE layer); and the MoE and MLA/MTP card-vs-host gradient checks with
their limits widened to 1e-4 / 5e-4 / 1e-3, so that they print their
readings instead of stopping at the first one over the script's limit.
Each part's start is stamped with the seconds since the script began.
"""
import importlib.util
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
T0 = time.time()


def stamp(what):
    print(f"=== {what} at {time.time() - T0:.1f} s", flush=True)


def guarded(what, fn, *a, **k):
    stamp(what)
    try:
        return fn(*a, **k)
    except BaseException as e:
        print(f"!!! {what} failed: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        print(torch.cuda.memory_summary(abbreviated=True)[:3000], flush=True)
        torch.cuda.empty_cache()


def main():
    device, smi = cs.phase_probe()
    cs.phase_build()
    for i, row in enumerate(cs.BWD_TIMING[-2:]):
        guarded(row[0], cs.time_k2_bwd, *row, device, seed=10 + i)
    guarded("gemma3 flash vs plain", cs.train_check, "gemma3-27b",
            dict(windows=(256, 0)), device)
    for key, (arch, layers, replace) in cs.TRAIN_MOE_MLA.items():
        whole, cfg = cs.depth_cut(arch, layers, **replace)
        if cfg.mla is not None:
            print(cs._moe_layer_gb(whole))
        guarded(f"train {key}", cs._train_run, "train-moe-mla", cfg, device, smi,
                key, batch=cs.TRAIN_MOE_MLA_BATCH)
        torch.cuda.empty_cache()
    cs.MOE_CHECK_TOL = dict(loss=1e-4, norm=5e-4, max=1e-3)
    cs.MLA_CHECK_TOL = dict(loss=1e-4, norm=5e-4, max=1e-3)
    guarded("moe check", cs.moe_grad_check, device)
    guarded("mla check", cs.mla_mtp_grad_check, device)
    stamp("done")
    print(smi)


if __name__ == "__main__":
    main()
