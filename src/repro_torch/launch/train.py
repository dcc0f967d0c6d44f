"""End-to-end training launcher on a mesh, with fault tolerance and elastic
re-mesh: the JAX package's ``repro/launch/train.py`` with its flags and
semantics.

A reduced-scale model (``--preset``) trains on the seeded synthetic corpus
with
  * params and optimizer state sharded by the production rules
    (``runtime/sharding.py``) on a (data, model) ``DeviceMesh`` picked by
    ``plan_mesh`` from the rank count,
  * atomic, checksummed, keep-last-k checkpoints (written by rank 0),
  * straggler detection,
  * ``--inject-failure N``: at step N the last rank is lost; the others
    plan the largest feasible mesh over the ``max(1, n - 1)`` ranks left
    of the run's ``n`` (ranks the first plan left idle wait for this
    plan), re-form their process group, rebuild the step, restore the
    newest checkpoint at or before N onto the new placements, and resume.
    With one rank the run re-meshes onto the same one-rank mesh through
    the same code, as the JAX package does with one device.

A one-rank mesh places nothing, so on it the step runs on plain tensors
(``step_mesh``; the run's first line says ``step=plain (one rank)``): the
same math as the sharded step, without DTensor's host work on every op.

It runs on the card unless ``--device cpu`` is given: one rank per visible
card under NCCL, or ``--host-devices K`` gloo ranks on the CPU (spawned
processes; the counterpart of the JAX package's forced host device count).
``--use-flash`` sends attention and its gradient through the flash kernels
(K2 and K2 bwd), each rank on its own shard.

    PYTHONPATH=src python -m repro_torch train --preset small --device cpu
    PYTHONPATH=src python -m repro_torch train --preset small --device cpu \\
        --host-devices 4 --inject-failure 6
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
from repro_torch.launch.mesh import (cpu_rank_threads, init_ranks, leave_ranks,
                                     rank_count, spawn_ranks)
from repro_torch.launch.serve import PRESETS, scale_config
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_leaf, init_param_tree
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import adapt_config, make_plan_mesh, plan_mesh
from repro_torch.runtime.fault import StragglerDetector, simulate_failure
from repro_torch.runtime.optim import opt_state_specs
from repro_torch.runtime.pipeline import DataPipeline, PipelineConfig
from repro_torch.runtime.steps import TrainHParams, input_specs, make_train_step
from repro_torch.runtime.tree import tree_map


def build(cfg, shape, mesh, hp: TrainHParams, *, use_flash: bool = False, **step_kw):
    """(train step, (param specs, optimizer-state specs), (param, optimizer,
    batch) placements) on ``mesh``; with ``mesh=None`` a plain step and no
    placements.  ``step_kw`` (``compress_fn``) goes to ``make_train_step``."""
    pspecs = tfm.param_specs(cfg)
    specs = (pspecs, opt_state_specs(cfg, pspecs))
    if mesh is None:
        return make_train_step(cfg, hp, use_flash=use_flash, **step_kw), specs, None
    rules = shd.make_rules(cfg, mesh, shape)
    placements = (shd.spec_shardings(specs[0], mesh, rules),
                  shd.spec_shardings(specs[1], mesh, rules),
                  shd.spec_shardings(input_specs(cfg, shape), mesh, rules))
    fn = make_train_step(cfg, hp, use_flash=use_flash, shard_ctx=(mesh, rules),
                         **step_kw)
    return fn, specs, placements


def init_state(specs, device, seed: int, *, mesh=None, placements=None):
    """Random weights by the JAX package's init rule, drawn on ``device``
    from ``seed``, and a zero optimizer state; with ``placements`` (what
    ``build`` gives) each rank keeps its shards of them on ``mesh``."""
    pspecs, ospecs = specs
    gen = torch.Generator(device=device).manual_seed(seed)
    if placements is None:
        return init_param_tree(pspecs, gen, device), init_param_tree(ospecs, gen, device)

    def draw(specs, pl):          # leaf by leaf: one full leaf at a time
        return tree_map(lambda s, p: shd.distribute_tree(init_leaf(s, gen, device), mesh, p),
                        specs, pl)
    return draw(pspecs, placements[0]), draw(ospecs, placements[1])


def run_step(step_fn, params, opt, batch, step: int, device):
    """One synchronised train step: (params, opt, metrics, seconds)."""
    t0 = time.perf_counter()
    params, opt, metrics = step_fn(params, opt, batch, step)
    synchronize(device)
    return params, opt, metrics, time.perf_counter() - t0


def _restore(ckpt, specs, placements, mesh, pipe, device, max_step=None):
    tree = {"params": specs[0], "opt": specs[1]}
    pl = None if placements is None else {"params": placements[0], "opt": placements[1]}
    restored, manifest = ckpt.restore_latest(tree, device=device, mesh=mesh,
                                             placements=pl, max_step=max_step)
    pipe.restore(manifest["extra"]["pipeline"])
    return restored["params"], restored["opt"], manifest["step"]


def _plan(n_ranks, args, cfg):
    plan = plan_mesh(n_ranks, args.global_batch, prefer_model=min(4, n_ranks),
                     microbatches=cfg.train_microbatches)
    return plan, adapt_config(cfg, plan, args.global_batch)


def step_mesh(mesh):
    """The mesh the step is sharded on: ``mesh``, or ``None`` (the plain
    step on plain tensors) for a one-rank mesh, which places nothing.  On
    one H100 DTensor's per-op host work made the 1x1 sharded step take
    1.5-2.9x the plain step's time for the same kernels (``PERF.md`` §6)."""
    return mesh if mesh.size() > 1 else None


def _rank_main(rank, n_ranks, store, args):
    """One rank's run; rank 0's losses are the run's."""
    with cpu_rank_threads(args.device_type):
        return _rank_run(rank, n_ranks, store, args)


def _rank_run(rank, n_ranks, store, args):
    import torch.distributed as dist

    device = (torch.device("cuda", rank % torch.cuda.device_count())
              if args.device_type == "cuda" else torch.device("cpu"))
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = scale_config(reduced_config(args.arch), **PRESETS[args.preset])
    cfg = cfg.replace(train_microbatches=args.microbatches)
    shape = ShapeConfig("demo", "train", args.seq, args.global_batch)
    hp = TrainHParams(peak_lr=1e-3, warmup=10, total_steps=args.steps)
    failure_schedule = ({args.inject_failure: ("device_loss", {"lost": 1})}
                        if args.inject_failure >= 0 else {})
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, primary=rank == 0)

    def join(plan, cfg, generation):
        """This rank's place on the plan's mesh: a new process group of
        ``plan.size`` ranks, the mesh and the step built on it."""
        init_ranks(args.device_type, rank, plan.size, store, generation=generation)
        mesh = make_plan_mesh(plan)
        on = step_mesh(mesh)
        step_fn, specs, placements = build(cfg, shape, on, hp, use_flash=args.use_flash)
        return mesh, on, step_fn, specs, placements

    healthy = n_ranks
    plan, cfg = _plan(healthy, args, cfg)
    generation, step, losses, pipe, mesh = 0, 0, [], None, None
    try:
        if rank < plan.size:
            mesh, on, step_fn, specs, placements = join(plan, cfg, generation)
            say(f"[train] arch={cfg.name} params={cfg.n_params()/1e6:.1f}M "
                f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                f"step={'sharded' if on is not None else 'plain (one rank)'} "
                f"microbatches={cfg.train_microbatches} device={device.type} "
                f"flash={args.use_flash}")
            pipe = DataPipeline(cfg, shape, PipelineConfig(seed=args.seed), device=device,
                                mesh=on, placements=placements and placements[2]).start()
            if args.resume and ckpt.all_steps():
                params, opt, step = _restore(ckpt, specs, placements, on, pipe, device)
                say(f"[train] resumed from step {step}")
            else:
                params, opt = init_state(specs, device, args.seed, mesh=on,
                                         placements=placements)
        elif failure_schedule:            # off the first mesh: wait for the re-plan
            step = args.inject_failure
        else:
            return []

        detector = StragglerDetector()
        while step < args.steps:
            ev = simulate_failure(step, failure_schedule)
            if ev is not None:
                if mesh is not None:
                    say(f"[fault] injected {ev.kind} at step {step}: "
                        "restoring from checkpoint onto reduced mesh")
                    ckpt.wait()
                    dist.barrier()        # rank 0's checkpoint is on disk
                    del params, opt
                    leave_ranks()
                # the reference's order: plan from the ranks the run had
                healthy = max(1, healthy - ev.payload["lost"])
                plan, cfg = _plan(healthy, args, cfg)
                failure_schedule.pop(ev.step, None)
                if rank >= plan.size:     # the lost rank, or one left over
                    return losses
                generation += 1
                mesh, on, step_fn, specs, placements = join(plan, cfg, generation)
                if pipe is None:
                    pipe = DataPipeline(cfg, shape, PipelineConfig(seed=args.seed),
                                        device=device).start()
                # restore() below stops the producer and drops what it built
                pipe.cfg, pipe.mesh = cfg, on
                pipe.placements = placements and placements[2]
                params, opt, step = _restore(ckpt, specs, placements, on, pipe, device,
                                             max_step=step)
                say(f"[fault] resumed at step {step} on {plan.size} device(s), "
                    f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
                continue

            batch = next(pipe)
            params, opt, metrics, dt = run_step(step_fn, params, opt, batch, step,
                                                device)
            loss = float(metrics["loss"])
            verdict = detector.record(dt)
            losses.append(loss)
            step += 1
            if not args.quiet and (step % 5 == 0 or step == 1):
                say(f"  step {step:4d} loss={loss:.4f} {dt*1e3:7.1f}ms "
                    f"gnorm={float(metrics['gnorm']):.2f} [{verdict}]")
            if step % args.ckpt_every == 0 or step == args.steps:
                ckpt.save(step, {"params": params, "opt": opt},
                          extra={"pipeline": pipe.state()})
        ckpt.wait()
        if losses:
            first, last = np.mean(losses[:5]), np.mean(losses[-5:])
            say(f"[train] done: loss {first:.4f} -> {last:.4f} "
                f"({'improved' if last < first else 'NOT improved'})")
        return losses
    finally:
        if pipe is not None:
            pipe.stop()
        leave_ranks()


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
    ap.add_argument("--host-devices", type=int, default=0,
                    help="ranks: with --device cpu, K gloo ranks on the CPU "
                         "(default 1); on the card, the first K cards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu; no fallback between them")
    ap.add_argument("--use-flash", action="store_true",
                    help="attention and its gradient on the flash kernels")
    args = ap.parse_args(argv)

    args.device_type = resolve_device(args.device).type
    n_ranks = rank_count(args.device_type, args.host_devices)
    if n_ranks == 1:
        return _rank_main(0, 1, None, args)
    return spawn_ranks(_rank_main, n_ranks, args)
