"""Training launcher on one device, with checkpoints and failure injection.

The JAX package's ``repro/launch/train.py`` with its flags and semantics:
a reduced-scale model (``--preset``) trained on the seeded synthetic corpus,
atomic checksummed keep-last-k checkpoints, ``--resume`` from the newest,
straggler detection, and ``--inject-failure N``, which restores from the
newest checkpoint at or before step N and reruns from there.  It runs on the
card unless ``--device cpu`` is given; ``--use-flash`` sends attention and
its gradient through the flash-attention kernels (K2 and K2 bwd), as the
JAX dry-run's switch does for the same step.

On one device a failure restores and resumes on that device: the re-mesh
onto fewer devices (the JAX package's ``runtime/elastic.py``) waits for
ROADMAP.md's "runtime and the remaining launchers".

    PYTHONPATH=src python -m repro_torch train --preset small --device cpu
    PYTHONPATH=src python -m repro_torch train --preset small --use-flash

``build``, ``init_state`` and ``run_step`` are the pieces ``main`` is made
of, so a caller can drive the step at full width without a checkpoint.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, reduced_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.serve import PRESETS, scale_config
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_param_tree
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault import StragglerDetector, simulate_failure
from repro_torch.runtime.optim import opt_state_specs
from repro_torch.runtime.pipeline import DataPipeline, PipelineConfig
from repro_torch.runtime.steps import TrainHParams, make_train_step


def build(cfg, hp: TrainHParams, *, use_flash: bool = False):
    """(train step, (param specs, optimizer-state specs))."""
    pspecs = tfm.param_specs(cfg)
    return make_train_step(cfg, hp, use_flash=use_flash), \
        (pspecs, opt_state_specs(cfg, pspecs))


def init_state(specs, device, seed: int):
    """Random weights by the JAX package's init rule, drawn on ``device``
    from ``seed``, and a zero optimizer state."""
    pspecs, ospecs = specs
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_param_tree(pspecs, gen, device), init_param_tree(ospecs, gen, device)


def run_step(step_fn, params, opt, batch, step: int, device):
    """One synchronised train step: (params, opt, metrics, seconds)."""
    t0 = time.perf_counter()
    params, opt, metrics = step_fn(params, opt, batch, step)
    synchronize(device)
    return params, opt, metrics, time.perf_counter() - t0


def _restore(ckpt, specs, pipe, device, max_step=None):
    tree = {"params": specs[0], "opt": specs[1]}
    restored, manifest = ckpt.restore_latest(tree, device=device, max_step=max_step)
    pipe.restore(manifest["extra"]["pipeline"])
    return restored["params"], restored["opt"], manifest["step"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="artifacts/torch/ckpt_demo")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    ap.add_argument("--use-flash", action="store_true",
                    help="attention and its gradient on the flash kernels")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = scale_config(reduced_config(args.arch), **PRESETS[args.preset])
    cfg = cfg.replace(train_microbatches=args.microbatches)
    shape = ShapeConfig("demo", "train", args.seq, args.global_batch)
    hp = TrainHParams(peak_lr=1e-3, warmup=10, total_steps=args.steps)
    print(f"[train] arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
          f"device={device} microbatches={cfg.train_microbatches} "
          f"flash={args.use_flash}")

    step_fn, specs = build(cfg, hp, use_flash=args.use_flash)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    pipe = DataPipeline(cfg, shape, PipelineConfig(seed=args.seed),
                        device=device).start()

    start_step = 0
    if args.resume and ckpt.all_steps():
        params, opt, start_step = _restore(ckpt, specs, pipe, device)
        print(f"[train] resumed from step {start_step}")
    else:
        params, opt = init_state(specs, device, args.seed)

    detector = StragglerDetector()
    losses = []
    failure_schedule = ({args.inject_failure: ("device_loss", {"lost": 1})}
                        if args.inject_failure >= 0 else {})

    step = start_step
    while step < args.steps:
        ev = simulate_failure(step, failure_schedule)
        if ev is not None:
            print(f"[fault] injected {ev.kind} at step {step}: "
                  "restoring from checkpoint")
            ckpt.wait()
            params, opt, step = _restore(ckpt, specs, pipe, device, max_step=step)
            failure_schedule.pop(ev.step, None)
            print(f"[fault] resumed at step {step} on {device}")
            continue

        batch = next(pipe)
        params, opt, metrics, dt = run_step(step_fn, params, opt, batch, step, device)
        loss = float(metrics["loss"])
        verdict = detector.record(dt)
        losses.append(loss)
        step += 1
        if not args.quiet and (step % 5 == 0 or step == 1):
            print(f"  step {step:4d} loss={loss:.4f} {dt*1e3:7.1f}ms "
                  f"gnorm={float(metrics['gnorm']):.2f} [{verdict}]")
        if step % args.ckpt_every == 0 or step == args.steps:
            ckpt.save(step, {"params": params, "opt": opt},
                      extra={"pipeline": pipe.state()})
    ckpt.wait()
    pipe.stop()

    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses
