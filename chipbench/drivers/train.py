"""Training traffic: the program's train step, driven step after step.

Set-up builds the step once (``launch/train.build``, flash attention on)
with the benchmark's weights and a zero optimizer state, and drives it from
the seed through its first ``ref_steps`` steps through the window's own
call (``launch/train.run_step``) and feed (fresh token rows a step, drawn
on the card from the seed); the first compiles and warms everything up.
Their readings are kept: each step's loss, each weight's first gradient
norm worked out from the optimizer's state after one step (Adafactor's
factored second moment at count 1 is the mean of g^2 + 1e-30 over a row),
and the norm of each weight's change after the steps.  The window then runs
whole steps on the same object until ``seconds`` have passed.

After it, the program's state is freed and the reference
(``reference/train.py``) follows the same first steps from the same weights
and tokens in float32; the numbers compared, each over every weight (a
stacked weight layer by layer):

- ``loss_gap``: the largest |program loss - reference loss| over the steps;
- ``grad_gap``: the largest |program norm - reference norm| of a first
  gradient, over the larger of that weight's reference norm and the median
  weight's;
- ``change_gap``: the same of the change after the steps, leaving out
  weights whose reference first gradient is under a thousandth of the
  median's (they move by round-off alone).
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from chipbench import common
from chipbench.reference import model as M
from chipbench.reference import train as R
from chipbench.window import Window

FAULTS = ("unchanged", "half_batch")


def _slot_path(name):
    """Where the program's tree keeps the weight ``name``."""
    if name in ("tok_emb", "final_norm", "head"):
        return (name,)
    if name in ("wq", "wk", "wv", "wo"):
        return ("stages", 0, "u0", "attn", name)
    if name in ("wi", "wg", "w2"):
        return ("stages", 0, "u0", "ffn", "wo" if name == "w2" else name)
    return ("stages", 0, "u0", name)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _stacked(name):
    return name not in ("tok_emb", "final_norm", "head")


def program_grad_norms(opt, shapes) -> dict:
    """Each weight's first gradient norm from Adafactor's state after one
    step: a factored weight's row moment ``vr`` (its shape less the last
    dim) is the mean of g^2 + eps1 over the last dim, a vector's ``v`` is
    g^2 + eps1; a stacked weight's layer by layer."""
    out = {}
    for name, shape in shapes.items():
        slot = _at(opt["slots"], _slot_path(name))
        if "v" in slot:
            rows = [slot["v"].double()]
        else:
            vr = slot["vr"].double() * shape[-1]
            rows = list(vr) if _stacked(name) else [vr]
        per = math.prod(shape[1:]) if _stacked(name) else math.prod(shape)
        out[name] = [math.sqrt(max(float(r.sum()) - R.EPS1 * per, 0.0)) for r in rows]
    return out


def change_norms(current: dict, dims, seed, device) -> dict:
    """The norm of each weight's change from its drawn value (drawn again, one
    weight at a time), a layer a slice for stacked weights."""
    out = {}
    for name, p in current.items():
        p0 = common.draw_weight(dims, seed, name, device)
        if _stacked(name):
            out[name] = [float((a.double() - b.double()).norm()) for a, b in zip(p, p0)]
        else:
            out[name] = [float((p.double() - p0.double()).norm())]
        del p0
    return out


def _gap(got: dict, want: dict, keep=None) -> float:
    """The worst weight's |got - want| over max(want, the median want)."""
    names = [(n, i) for n in want for i in range(len(want[n]))
             if keep is None or keep(n, i)]
    med = statistics.median(want[n][i] for n, i in names)
    return max(abs(got[n][i] - want[n][i]) / max(want[n][i], med, 1e-30) for n, i in names)


class Planted:
    """``with Planted(ctx, fault):`` the program with ``fault`` planted (or
    none): the config it runs and the microbatches it is fed."""

    def __init__(self, ctx, fault):
        self.ctx, self.fault = ctx, fault

    def __enter__(self):
        from repro_torch.runtime import steps as steps_mod
        from repro_torch.runtime.steps import TrainHParams
        tr, dev = self.ctx.traffic, self.ctx.device
        micro = tr["microbatches"]
        self.hp = TrainHParams(peak_lr=tr["lr_peak"], warmup=tr["lr_warmup"],
                               total_steps=tr["lr_total"])
        self.fed = micro // 2 if self.fault == "half_batch" else micro
        self.cfg = common.port_config(self.ctx.config_name, self.ctx.dims,
                                      optimizer="adafactor", opt_dtype="float32",
                                      grad_accum_dtype="float32",
                                      train_microbatches=self.fed, remat=True)
        self.kept = steps_mod.opt_update
        if self.fault == "unchanged":         # the step hands its state back as it was
            steps_mod.opt_update = lambda c, g, s, p, lr: (p, s, torch.zeros((), device=dev))
        return self

    def __exit__(self, *exc):
        from repro_torch.runtime import steps as steps_mod
        steps_mod.opt_update = self.kept
        return False


def _setup(ctx, plant):
    """The step built once, the weights, and its first ``ref_steps`` steps
    driven through the window's call and feed: (step_fn, params, opt,
    weights, feed, readings (losses, first gradient norms, change))."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import train
    from repro_torch.models.layers import init_param_tree

    tr, dims, dev, seed = ctx.traffic, ctx.dims, ctx.device, ctx.seed
    seq, batch, micro, n_ref = tr["seq"], tr["batch"], tr["microbatches"], tr["ref_steps"]
    shape = ShapeConfig("chipbench", "train", seq, batch * plant.fed // micro)
    step_fn, specs, _ = train.build(plant.cfg, shape, None, plant.hp, use_flash=True)
    weights = common.draw_weights(dims, seed, dev)
    params = common.port_params(weights, plant.cfg)
    common.stamp(ctx, "weights drawn")
    opt = init_param_tree(specs[1], None, dev)       # Adafactor's state: zeros

    def feed(step):
        toks = common.draw_tokens(seed, ("train", step), (micro, batch // micro, seq),
                                  dims.vocab, dev)
        return {"tokens": toks[:plant.fed]}

    losses = []
    for step in range(n_ref):
        params, opt, metrics, dt = train.run_step(step_fn, params, opt, feed(step), step, dev)
        losses.append(float(metrics["loss"]))
        ctx.say(f"[train] set-up step {step}: {dt * 1e3:.1f} ms, loss {losses[-1]:.6f}")
        if step == 0:
            gnorms = program_grad_norms(opt, common.weight_shapes(dims))
    change = change_norms(weights, dims, seed, dev)
    return step_fn, params, opt, weights, feed, (losses, gnorms, change)


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _follow(ctx, hp, prec):
    """The reference's (losses, first gradient norms, change) over the first
    ``ref_steps`` steps, in ``prec``."""
    tr, dims, dev, seed = ctx.traffic, ctx.dims, ctx.device, ctx.seed
    micro, batch, seq = tr["microbatches"], tr["batch"], tr["seq"]
    M.no_tf32()
    t0 = time.perf_counter()

    def batches(s):
        return list(common.draw_tokens(seed, ("train", s), (micro, batch // micro, seq),
                                       dims.vocab, dev))
    lr_at = lambda s: R.cosine_lr(s, hp.peak_lr, hp.warmup, hp.total_steps)  # noqa: E731
    losses, gnorms, model = R.follow(lambda: common.draw_weights(dims, seed, dev), batches,
                                     tr["ref_steps"], lr_at, dims.norm_eps, dims.rope_theta,
                                     prec)
    cur = {name: (torch.stack([p.detach() for p in slices]) if stacked
                  else slices[0].detach())
           for name, slices, stacked in model.leaves()}
    del model
    change = change_norms(cur, dims, seed, dev)
    del cur
    _free(dev)
    ctx.say(f"[train] reference{' (float8)' if prec.fp8 else ''}, {tr['ref_steps']} steps: "
            f"{time.perf_counter() - t0:.1f} s, losses {losses}")
    return losses, gnorms, change


def _numbers(judged, ref) -> dict:
    ref_losses, ref_g, ref_ch = ref
    med = statistics.median(x for v in ref_g.values() for x in v)
    keep = lambda n, i: ref_g[n][i] >= 1e-3 * med                       # noqa: E731
    return {"loss_gap": max(abs(a - b) for a, b in zip(judged[0], ref_losses)),
            "grad_gap": _gap(judged[1], ref_g),
            "change_gap": _gap(judged[2], ref_ch, keep),
            "left_out": sum(not keep(n, i) for n in ref_g for i in range(len(ref_g[n])))}


def run(ctx):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    tr, dims, dev = ctx.traffic, ctx.dims, ctx.device
    common.stamp(ctx, "program imported")
    seq, batch, micro, n_ref = tr["seq"], tr["batch"], tr["microbatches"], tr["ref_steps"]
    with Planted(ctx, ctx.fault) as plant:
        step_fn, params, opt, weights, feed, readings = _setup(ctx, plant)
        k2, k2b = fa.launches, fa.bwd_launches
        setup_peak = 0
        if dev.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - ctx.t_start
        n, step = 0, n_ref
        with Window(dev, ctx.trace) as win:
            while win.elapsed() < ctx.seconds:
                params, opt, metrics, _ = train.run_step(step_fn, params, opt, feed(step),
                                                         step, dev)
                step += 1
                n += 1
    k2, k2b = fa.launches - k2, fa.bwd_launches - k2b
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    last_loss = float(metrics["loss"])
    ctx.say(f"[train] window: {n} steps in {win.seconds:.3f} s, last loss {last_loss:.6f}; "
            f"K2 {k2 / max(n, 1):.1f} and K2 bwd {k2b / max(n, 1):.1f} launches a step; "
            f"set-up {setup_s:.3f} s")
    del params, opt, step_fn, weights, metrics
    _free(dev)

    ref = _follow(ctx, plant.hp, M.FP32)
    judged = _follow(ctx, plant.hp, M.Precision(fp8=True)) if ctx.control else readings
    numbers = _numbers(judged, ref)
    ctx.say(f"[train] losses {'control' if ctx.control else 'program'} {judged[0]}; "
            f"{numbers.pop('left_out')} weight slices left out of change_gap")
    run = common.Run(cell=ctx.cell, dims=dims, window_s=win.seconds, trace=win.summary,
                     readings=dict(steps=n, seq=seq, batch=batch, micro_batch=batch // micro,
                                   k2_launches=k2, k2bwd_launches=k2b,
                                   window_peak_bytes=window_peak))
    return dict(attempted=n, failed=0 if all(map(_finite, readings[0] + [last_loss])) else n,
                e2e={"train_tokens_per_s": n * batch * seq / win.seconds,
                     "setup_s": setup_s},
                numbers=numbers, memory_peak_bytes=max(setup_peak, window_peak), run=run)


def _finite(x):
    return x == x and abs(x) != float("inf")
