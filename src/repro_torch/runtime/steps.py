"""The train step (with gradient accumulation), as the JAX package's
``repro/runtime/steps.py::make_train_step`` builds it.

Where JAX scans over the microbatch axis, the port runs a Python loop: each
microbatch's gradient comes from ``torch.autograd.grad`` and is added into
an accumulator in ``cfg.grad_accum_dtype``, so only one microbatch's
activations and one bf16 gradient tree live at a time.  Gradient
compression and the sharded step wait for ROADMAP.md's "runtime and the
remaining launchers".
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.runtime.optim import cosine_schedule, opt_update
from repro_torch.runtime.tree import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000


def make_train_step(cfg: ModelConfig, hp: TrainHParams = TrainHParams(), *,
                    use_flash: bool = False, compress_fn=None, shard_ctx=None):
    """Returns train_step(params, opt_state, batch, step) -> (p, s, metrics).

    ``batch`` leaves carry a leading microbatch axis.  The step updates
    ``params`` and ``opt_state`` in place and returns them; ``metrics`` holds
    ``loss``, ``gnorm`` and ``lr`` (0-d fp32 tensors) and ``step`` (the
    step's number + 1).
    """
    if compress_fn is not None:
        raise NotImplementedError(
            "gradient compression is not ported yet (ROADMAP.md, runtime and "
            "the remaining launchers: compress.py)")
    if shard_ctx is not None:
        raise NotImplementedError(
            "the sharded train step is not ported yet (ROADMAP.md, runtime and "
            "the remaining launchers: sharding.py and shardctx.py)")
    n_micro = cfg.train_microbatches
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def micro_grads(params, flat, mb):
        loss, _ = tf.train_loss(cfg, params, mb, use_flash=use_flash)
        return loss.detach(), torch.autograd.grad(loss, flat)

    def train_step(params, opt_state, batch, step):
        lr = cosine_schedule(step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                             total=hp.total_steps)
        flat = leaves(params)
        for x in flat:
            x.requires_grad_(True)
        try:
            if n_micro == 1:
                loss, grads = micro_grads(params, flat, {k: v[0] for k, v in batch.items()})
            else:
                grads, lsum = None, None
                for m in range(n_micro):
                    loss, g = micro_grads(params, flat, {k: v[m] for k, v in batch.items()})
                    if grads is None:
                        grads, lsum = [x.to(acc_dt, copy=True) for x in g], loss.float()
                    else:
                        for a, x in zip(grads, g):
                            a.add_(x.to(acc_dt))
                        lsum = lsum + loss
                    del g
                loss = lsum / n_micro
                for a in grads:
                    a.div_(n_micro)
        finally:
            for x in flat:
                x.requires_grad_(False)
        params, opt_state, gnorm = opt_update(cfg, unflatten(params, grads),
                                              opt_state, params, lr)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr,
                                   "step": int(step) + 1}

    return train_step
