#!/usr/bin/env python3
"""Phase 36's deepseek-v3-671b parts of ``chip_smoke.py`` alone, on one CUDA
card, with the MoE check's limits widened so that it prints its readings.

    python3 tools/chip_train_moe_mla.py

Builds the kernels, then runs in turn, each guarded so that a failure
prints its error, a memory summary and the largest live blocks (with the
lines that made them while torch's allocator history records), and the
next part still runs: the flash-vs-plain train check at gemma3-27b's
widths (windows (256, 0)), both sides read against the plain fp32 step;
the MoE card-vs-host check at deepseek-v3's routing over two weight draws
(``MOE_CHECKS``' seed and the next), its limits widened to 1e-4 / 5e-4 /
1e-3; then, with the allocator's history on, the gemma3 check again (on
torch 2.11 the layer's recompute then raised ``SystemError: error return
without exception set``; with the history off it passes) and the deepseek-v3
``TRAIN_MOE_MLA`` run with its one-layer stage's views made before the
layer, as ``_layers`` makes a longer stage's (it runs out of memory: the
layer's three expert gradients wait for its whole backward), and again with
MLA's query chunks saved for the backward instead of recomputed.  Each part's
start is stamped with the seconds since the script began.
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


def live_blocks(n=20):
    """The ``n`` largest live blocks of the allocator's snapshot, each with
    the repository's frames of the stack that allocated it."""
    snap = torch.cuda.memory._snapshot()
    blocks = [b for seg in snap["segments"] for b in seg["blocks"]
              if b["state"] == "active_allocated"]
    blocks.sort(key=lambda b: -b["size"])
    print(f"{len(blocks)} live blocks, {sum(b['size'] for b in blocks) / 1e9:.3f} GB; "
          f"reserved {sum(s['total_size'] for s in snap['segments']) / 1e9:.3f} GB", flush=True)
    for b in blocks[:n]:
        frames = [f"{Path(f['filename']).name}:{f['line']} {f['name']}"
                  for f in b.get("frames", []) if "repro" in f["filename"]
                  or "chip_smoke" in f["filename"]]
        print(f"  {b['size'] / 1e9:.3f} GB  " + " <- ".join(frames[:6]), flush=True)


def guarded(what, fn, *a, **k):
    stamp(what)
    try:
        return fn(*a, **k)
    except BaseException as e:
        print(f"!!! {what} failed: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        print(torch.cuda.memory_summary(abbreviated=True)[:3000], flush=True)
        live_blocks()
        torch.cuda.empty_cache()


def unbind_before_the_layer(tree):
    """A one-layer stage's views made before its layer, as ``_layers`` makes
    a longer stage's (the step before ``transformer._ReadLate``)."""
    return cs.tfm._placed(cs.tfm._layers(tree, 1)[0])


def main():
    device, smi = cs.phase_probe()
    cs.phase_build()
    guarded("gemma3 flash vs plain", cs.train_check, "gemma3-27b",
            dict(windows=(256, 0)), device)
    moe_arch = "deepseek-v3-671b"
    cs.MOE_CHECK_TOL[moe_arch] = dict(loss=1e-4, norm=5e-4, max=1e-3)
    seed, d_ff = cs.MOE_CHECKS[moe_arch]
    for s in (seed, seed + 1):
        cs.MOE_CHECKS[moe_arch] = (s, d_ff)
        guarded(f"moe check {moe_arch} seed {s}", cs.moe_grad_check, device, moe_arch)
    cs.MOE_CHECKS[moe_arch] = (seed, d_ff)
    torch.cuda.memory._record_memory_history(max_entries=200_000, stacks="python")
    guarded("gemma3 flash vs plain, allocator history on", cs.train_check, "gemma3-27b",
            dict(windows=(256, 0)), device)
    arch, layers, replace = cs.TRAIN_MOE_MLA["deepseek_v3"]
    whole, cfg = cs.depth_cut(arch, layers, **replace)
    read_late, cs.tfm._ReadLate = cs.tfm._ReadLate, unbind_before_the_layer
    guarded("train deepseek_v3, the stage's views made before its layer", cs._train_run,
            "train-moe-mla", cfg, device, smi, f"{arch}, unbind before the layer",
            batch=cs.TRAIN_MOE_MLA_BATCH)
    cs.tfm._ReadLate = read_late
    recomputed, cs.attention._recomputed = cs.attention._recomputed, lambda sdpa: sdpa
    guarded("train deepseek_v3, MLA's query chunks saved for the backward", cs._train_run,
            "train-moe-mla", cfg, device, smi, f"{arch}, chunks saved",
            batch=cs.TRAIN_MOE_MLA_BATCH)
    cs.attention._recomputed = recomputed
    torch.cuda.memory._record_memory_history(enabled=None)
    stamp("done")
    print(smi)


if __name__ == "__main__":
    main()
