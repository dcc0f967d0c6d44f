#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one CUDA card.

    python3 tools/profile_torch_train.py [--layers 8] [--seq 4096]
        [--global-batch 8] [--microbatches 8] [--no-flash] [--mesh]

Builds Yi-6B at its published widths with ``--layers`` of its 32 layers
(bf16 params, fp32 AdamW moments and gradient accumulation, per-layer
remat; random weights from a seed), runs one warm-up step and one untraced
step, then traces one train step with ``torch.profiler``.  It prints the
traced step's wall time, the device time summed over all kernels, the
device's idle share (1 - kernel time / wall time; one stream, so kernels
do not overlap), the same share against the untraced step's wall time
(the tracer's host work stretches the traced step once the device is
fast), the device time of the flash-attention kernels (K2 forward, K2
bwd, each kernel of a group on its own line), of the GEMMs, of the zero
fills and of the bf16 adds, and the kernels that take the most device
time; then, from the program's spans (``runtime/trace.py``, on for the
traced step), the device and idle time by span path, and the shares of
device time under the optimizer, the gradients' accumulation and remat's
recomputation.

``--mesh`` runs the step as ``chip_smoke.py``'s phase 23 does: through
``make_train_step(shard_ctx=...)`` on a 1x1 ("data", "model") mesh over
one NCCL rank, params, moments and batches DTensors.  Last, one more
untraced step runs under ``cProfile``, and its Python time is printed by
where it is spent (DTensor's dispatch, ``runtime/shardctx.py``,
the rest of the port, the rest of torch's Python, and calls into C: the
ops themselves and their launches).  cProfile slows Python code more than
C calls, so the shares say where the host time goes, not how long it
takes unprofiled.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
from profile_torch_serve import _device_us, holding, print_spans, report  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import mesh as mesh_launch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime.elastic import make_plan_mesh, plan_mesh  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.runtime.pipeline import DataPipeline, PipelineConfig  # noqa: E402

# kernel-name fragments of each group (mangled C++ names; cuBLAS's GEMMs)
GROUPS = {
    "K2 forward (flash_wgmma_kernel)": ("flash_wgmma_kernel", "flash_fwd_kernel"),
    "K2 bwd (delta, dkdv, dq kernels)": ("delta_kernel", "dkdv_kernel", "dq_kernel",
                                         "dkdv_wgmma_kernel", "dq_wgmma_kernel"),
    "GEMMs (cuBLAS)": ("nvjet", "gemm", "xmma", "cutlass", "sm90_"),
    # what a stacked leaf's per-layer ``select`` backward cost: zero fills of
    # the stack and bf16 adds of them
    "fills (FillFunctor)": ("FillFunctor",),
    "bf16 adds": ("CUDAFunctor_add<c10::BFloat16>",),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="the sharded step on a 1x1 mesh over one NCCL rank")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    cfg = get_config("yi-6b").replace(n_layers=args.layers,
                                      train_microbatches=args.microbatches)
    shape = ShapeConfig("train", "train", args.seq, args.global_batch)
    mesh = None
    if args.mesh:
        mesh_launch.init_ranks("cuda", 0, 1)
        mesh = make_plan_mesh(plan_mesh(1, args.global_batch, prefer_model=1))
    try:
        return _profile(args, cfg, shape, mesh, device)
    finally:
        mesh_launch.leave_ranks()


# where a Python frame's time goes: the first fragment its file matches
HOST_GROUPS = (("DTensor dispatch", "torch/distributed/tensor/"),
               ("runtime/shardctx.py", "repro_torch/runtime/shardctx"),
               ("the rest of the port", "repro_torch/"),
               ("the rest of torch's Python", "torch/"))


def host_split(run) -> None:
    """cProfile ``run()`` and print its time by ``HOST_GROUPS``; calls into
    C (the ops, their launches) and other Python as the last two."""
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run()
    prof.disable()
    wall = time.perf_counter() - t0
    groups = dict.fromkeys([g for g, _ in HOST_GROUPS] + ["calls into C", "other Python"],
                           0.0)
    for (path, _, _), (_, _, own, _, _) in pstats.Stats(prof).stats.items():
        if path == "~":
            groups["calls into C"] += own
            continue
        name = next((g for g, frag in HOST_GROUPS if frag in path), "other Python")
        groups[name] += own
    total = sum(groups.values())
    print(f"[train-step] host split under cProfile: step wall {wall * 1e3:.1f} ms, "
          f"profiled {total * 1e3:.1f} ms: " + ", ".join(
              f"{g} {t * 1e3:.1f} ms ({t / total:.1%})" for g, t in groups.items()))


def _profile(args, cfg, shape, mesh, device) -> int:
    step_fn, specs, placements = train.build(cfg, shape, mesh, train.TrainHParams(),
                                             use_flash=not args.no_flash)
    params, opt = train.init_state(specs, device, args.seed, mesh=mesh,
                                   placements=placements)
    pipe = DataPipeline(cfg, shape, PipelineConfig(seed=args.seed), device=device,
                        mesh=mesh, placements=None if placements is None else placements[2])
    params, opt, _, warm = train.run_step(step_fn, params, opt, next(pipe), 0, device)
    params, opt, _, untraced = train.run_step(step_fn, params, opt, next(pipe), 1, device)
    batch = next(pipe)
    torch.cuda.synchronize()
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, metrics, _ = train.run_step(step_fn, params, opt, batch, 2, device)
        wall = time.perf_counter() - t0
    trace.disable()
    print(f"[train-step] yi-6b widths, {args.layers} layers, {args.microbatches} x "
          f"{args.global_batch // args.microbatches} x {args.seq} tokens, flash="
          f"{not args.no_flash}, "
          f"{'1x1 mesh (DTensor)' if mesh is not None else 'plain tensors'}: warm-up "
          f"{warm * 1e3:.1f} ms, loss {float(metrics['loss']):.4f}")
    report("train-step", prof, wall, cfg.ssm.chunk if cfg.ssm else 0, top=12)
    spans, idle, _ = print_spans("train-step", prof)
    busy_s = sum(spans.values())
    print("[train-step] shares of device time: " + ", ".join(
        f"{name} {holding(spans, name) / busy_s:.1%}"
        for name in ("train.optimizer", "train.accumulate", "model.recompute"))
        + f"; idle under train.step {holding(idle, 'train.step') * 1e3:.3f} ms")
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
    batch = next(pipe)
    host_split(lambda: train.run_step(step_fn, params, opt, batch, 3, device))
    pipe.stop()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
