#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA card.

    python3 tools/profile_torch_train.py [--layers 8] [--seq 4096]
        [--global-batch 8] [--microbatches 8] [--no-flash]

Builds Yi-6B at its published widths with ``--layers`` of its 32 layers
(bf16 params, fp32 AdamW moments and gradient accumulation, per-layer
remat; random weights from a seed), runs one warm-up step and one untraced
step, then traces one train step with ``torch.profiler``.  It prints the
traced step's wall time, the device time summed over all kernels, the
device's idle share (1 - kernel time / wall time; one stream, so kernels
do not overlap), the same share against the untraced step's wall time
(the tracer's host work stretches the traced step once the device is
fast), the device time of the flash-attention kernels (K2 forward, K2
bwd, each kernel of a group on its own line) and of the GEMMs, and the
kernels that take the most device time.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
from profile_torch_serve import _device_us, report  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.pipeline import DataPipeline, PipelineConfig  # noqa: E402

# kernel-name fragments of each group (mangled C++ names; cuBLAS's GEMMs)
GROUPS = {
    "K2 forward (flash_wgmma_kernel)": ("flash_wgmma_kernel", "flash_fwd_kernel"),
    "K2 bwd (delta, dkdv, dq kernels)": ("delta_kernel", "dkdv_kernel", "dq_kernel",
                                         "dkdv_wgmma_kernel", "dq_wgmma_kernel"),
    "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass", "sm90_"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_config("yi-6b").replace(n_layers=args.layers,
                                      train_microbatches=args.microbatches)
    step_fn, specs = train.build(cfg, train.TrainHParams(), use_flash=not args.no_flash)
    params, opt = train.init_state(specs, device, args.seed)
    pipe = DataPipeline(cfg, ShapeConfig("train", "train", args.seq, args.global_batch),
                        PipelineConfig(seed=args.seed), device=device)
    params, opt, _, warm = train.run_step(step_fn, params, opt, next(pipe), 0, device)
    params, opt, _, untraced = train.run_step(step_fn, params, opt, next(pipe), 1, device)
    batch = next(pipe)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics, _ = train.run_step(step_fn, params, opt, batch, 2, device)
        wall = time.perf_counter() - t0
    print(f"[train-step] yi-6b widths, {args.layers} layers, {args.microbatches} x "
          f"{args.global_batch // args.microbatches} x {args.seq} tokens, flash="
          f"{not args.no_flash}: warm-up {warm * 1e3:.1f} ms, loss "
          f"{float(metrics['loss']):.4f}")
    report("train-step", prof, wall, top=12)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events)
    print(f"[train-step] untraced step wall_ms={untraced * 1e3:.3f} idle_share="
          f"{1 - busy / 1e3 / (untraced * 1e3):.4f} (the traced step's device time "
          "against it)")
    for group, fragments in GROUPS.items():
        hit = [e for e in events if any(f in e.key for f in fragments)]
        us = sum(_device_us(e) for e in hit)
        print(f"[train-step] group {group}: {us / 1e3:.3f} ms, {us / busy:.1%} of "
              f"device time, {sum(e.count for e in hit)} launches")
        if group.startswith("K2"):
            for e in sorted(hit, key=_device_us, reverse=True):
                print(f"[train-step]   {_device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
                      f"{e.key[:70]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
