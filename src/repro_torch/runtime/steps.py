"""Step functions (train / prefill / decode) and their abstract input specs,
as the JAX package's ``repro/runtime/steps.py`` builds them.

``input_specs(cfg, shape)`` gives the ``ParamSpec`` tree a step takes for
one (arch x shape) cell, with no allocation: the dry-run
(``launch/dryrun.py``) makes its inputs from it.

Where JAX scans over the microbatch axis, the port runs a Python loop: each
microbatch's backward hands every leaf's gradient, as soon as autograd has
made it, to a hook that adds it into that leaf's accumulator in
``cfg.grad_accum_dtype`` and drops it, so only one microbatch's activations
and the gradients still being made live at a time, never a whole gradient
tree beside the accumulator (deepseek-v3's MoE layer: 23 GB of bf16
gradients).  Under a mesh each gradient reaches its accumulator in its
leaf's placements, so accumulators are made and added at the shard shape,
as the reference's scan carries a parameter-shaped accumulator that XLA
shards.

With ``shard_ctx=(mesh, rules)`` the step runs under ``shardctx.scope``:
params, optimizer state and batch are DTensors laid out by
``sharding.spec_shardings`` (``launch/train.py::build``), the model's
``constrain`` calls place its intermediates, and each microbatch's gradient
is reduced to its parameter's placements (an all-reduce over the batch axes
for a replicated leaf, a reduce-scatter for a sharded one) before it is
accumulated.
The loss is the global batch's mean and ``gnorm`` the global norm; both
come back as plain tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import ParamSpec
from repro_torch.runtime import shardctx, trace
from repro_torch.runtime.shardctx import constrain
from repro_torch.runtime.optim import cosine_schedule, opt_update
from repro_torch.runtime.tree import leaves, unflatten


def _maybe_scope(ctx):
    if ctx is None:
        return contextlib.nullcontext()
    return shardctx.scope(*ctx)


def _plain(x):
    """A DTensor's full value (the step's scalars), else ``x``."""
    return x.full_tensor() if shardctx.is_dtensor(x) else x


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                microbatches: int | None = None) -> dict:
    """ParamSpec tree of the step inputs for one dry-run cell, the JAX
    package's ``input_specs``: a train batch's leaves carry a leading
    microbatch axis and shard the per-microbatch batch over "batch"; a
    prefill batch holds the prompt (less the image and meta prefixes); a
    decode batch one new token and the cache of capacity ``seq_len``
    (``transformer.cache_specs``)."""
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        m = microbatches if microbatches is not None else cfg.train_microbatches
        if b % m:
            raise ValueError(f"global batch {b} does not split into {m} microbatches")
        mb = b // m
        t_text = t - (cfg.image_tokens if cfg.frontend == "vision" else 0)
        if cfg.n_codebooks > 1:
            toks = ParamSpec((m, mb, cfg.n_codebooks, t_text),
                             (None, "batch", None, None), "int32")
        else:
            toks = ParamSpec((m, mb, t_text), (None, "batch", None), "int32")
        specs = {"tokens": toks}
        if cfg.frontend == "vision":
            specs["image_embeds"] = ParamSpec(
                (m, mb, cfg.image_tokens, cfg.d_model),
                (None, "batch", None, None), cfg.compute_dtype)
        return specs

    if shape.kind == "prefill":
        t_text = t - (cfg.image_tokens if cfg.frontend == "vision" else 0) \
            - cfg.meta_tokens
        if cfg.n_codebooks > 1:
            toks = ParamSpec((b, cfg.n_codebooks, t_text), ("batch", None, None), "int32")
        else:
            toks = ParamSpec((b, t_text), ("batch", None), "int32")
        specs = {"tokens": toks}
        if cfg.frontend == "vision":
            specs["image_embeds"] = ParamSpec((b, cfg.image_tokens, cfg.d_model),
                                              ("batch", None, None), cfg.compute_dtype)
        return specs

    # decode: one new token against a cache of capacity seq_len
    if cfg.n_codebooks > 1:
        toks = ParamSpec((b, cfg.n_codebooks, 1), ("batch", None, None), "int32")
    else:
        toks = ParamSpec((b, 1), ("batch", None), "int32")
    return {"tokens": toks, "cache": tf.cache_specs(cfg, b, t)}


def _accumulate(acc, grads, dtype):
    """``acc`` plus ``grads`` leaf by leaf in ``dtype``, in place; for
    ``acc`` None a copy of ``grads`` in ``dtype``.  A gradient that
    ``dtype`` widens (bf16 into fp32) is added as it is: it widens exactly,
    so the sum is the cast one's, without an fp32 copy of the gradient
    (5.77 GB for Yi-6B's stacked ``ffn/wg``); one that ``dtype`` narrows is
    rounded first, as the reference rounds it."""
    if acc is None:
        return [g.to(dtype, copy=True) for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g if torch.promote_types(g.dtype, dtype) == dtype else g.to(dtype))
    return acc


def make_train_step(cfg: ModelConfig, hp: TrainHParams = TrainHParams(), *,
                    use_flash: bool = False, compress_fn=None, shard_ctx=None):
    """Returns train_step(params, opt_state, batch, step) -> (p, s, metrics).

    ``batch`` leaves carry a leading microbatch axis.  The step updates
    ``params`` and ``opt_state`` in place and returns them; ``metrics`` holds
    ``loss``, ``gnorm`` and ``lr`` (0-d fp32 tensors) and ``step`` (the
    step's number + 1).  ``compress_fn`` optionally transforms the
    accumulated gradient tree (gradient compression, see
    ``runtime/compress.py``) before the optimizer sees it.
    """
    n_micro = cfg.train_microbatches
    acc_dt = getattr(torch, cfg.grad_accum_dtype)

    def accumulate_as_made(flat, acc, added):
        """A hook on each leaf that takes the leaf's gradient as autograd
        has made it (``p.grad``) into ``acc[i]``: with one microbatch the
        gradient itself; else the first microbatch's copy in ``acc_dt``,
        the later ones added into it (``_accumulate``).  ``added[0]``
        counts the leaves taken."""
        def hook_for(i):
            def take(p):
                with trace.span("train.accumulate", i):
                    g, p.grad = p.grad, None
                    if shard_ctx is not None and tuple(g.placements) != tuple(p.placements):
                        # a stacked leaf's gradient comes placed from the layers'
                        # backward (``transformer.stage_forward``), the others
                        # (tok_emb, head, norms) may come as pending sums
                        g = g.redistribute(p.device_mesh, p.placements)
                    if n_micro == 1:
                        acc[i] = g
                    else:
                        acc[i] = _accumulate(None if acc[i] is None else [acc[i]], [g],
                                             acc_dt)[0]
                    added[0] += 1
            return take
        return [p.register_post_accumulate_grad_hook(hook_for(i)) for i, p in enumerate(flat)]

    def micro_backward(params, flat, mb, added, m):
        with trace.span("train.microbatch", m):
            with trace.span("train.forward", m):
                loss, _ = tf.train_loss(cfg, params, mb, use_flash=use_flash)
            added[0] = 0
            with trace.span("train.backward", m):
                torch.autograd.backward(loss, inputs=flat)
        if added[0] != len(flat):
            raise RuntimeError(f"{len(flat) - added[0]} of {len(flat)} parameter leaves "
                               "got no gradient")
        return loss.detach()

    def train_step(params, opt_state, batch, step):
        with _maybe_scope(shard_ctx), trace.span("train.step", step):
            return _step(params, opt_state, batch, step)

    def _step(params, opt_state, batch, step):
        lr = cosine_schedule(step, peak_lr=hp.peak_lr, warmup=hp.warmup,
                             total=hp.total_steps)
        flat = leaves(params)
        grads, added = [None] * len(flat), [0]
        for x in flat:
            x.grad = None
            x.requires_grad_(True)
        hooks = accumulate_as_made(flat, grads, added)
        try:
            if n_micro == 1:
                loss = micro_backward(params, flat, {k: v[0] for k, v in batch.items()},
                                      added, 0)
            else:
                lsum = None
                for m in range(n_micro):
                    loss = micro_backward(params, flat, {k: v[m] for k, v in batch.items()},
                                          added, m)
                    lsum = loss.float() if lsum is None else lsum + loss
                loss = lsum / n_micro
                for a in grads:
                    a.div_(n_micro)
        finally:
            for h in hooks:
                h.remove()
            for x in flat:
                x.requires_grad_(False)
        grads = unflatten(params, grads)
        if compress_fn is not None:
            grads = compress_fn(grads)
        # the span is around the call, so it times whatever this module's
        # ``opt_update`` is when the step runs (a harness may replace it)
        with trace.span("train.optimizer", step):
            params, opt_state, gnorm = opt_update(cfg, grads, opt_state, params, lr)
        return params, opt_state, {"loss": _plain(loss), "gnorm": _plain(gnorm),
                                   "lr": lr, "step": int(step) + 1}

    return train_step


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def _place_cache(cfg: ModelConfig, cache):
    """Under a scope, each cache leaf constrained to its ``cache_specs``
    axes (the JAX package's prefill ``out_shardings``: the sequence axis of
    a returned cache takes "model" under the prefill rules)."""
    specs = tf.cache_specs(cfg, 1, 1)["stages"]
    stages = tuple({u: {k: constrain(x, specs[si][u][k].axes) for k, x in e.items()}
                    for u, e in sc.items()} for si, sc in enumerate(cache["stages"]))
    return {"stages": stages, "pos": cache["pos"]}


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False, shard_ctx=None):
    """Returns prefill_step(params, batch) -> (last logits, cache), the JAX
    package's: ``tf.prefill`` on ``batch["tokens"]`` (and a vision
    config's ``image_embeds``), with no autograd record."""
    def prefill_step(params, batch):
        with torch.no_grad(), _maybe_scope(shard_ctx):
            logits, cache = tf.prefill(cfg, params, batch["tokens"],
                                       batch.get("image_embeds"), use_flash=use_flash)
            if shard_ctx is not None:
                cache = _place_cache(cfg, cache)
            return logits, cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, shard_ctx=None):
    """Returns decode_step(params, batch) -> (logits, cache): one new token
    ``batch["tokens"]`` against ``batch["cache"]``, which it updates in place
    (the JAX package donates it) and returns with ``pos`` advanced."""
    def decode_step(params, batch):
        with torch.no_grad(), _maybe_scope(shard_ctx):
            return tf.decode_step(cfg, params, batch["cache"], batch["tokens"])
    return decode_step


def step_fn_for(cfg: ModelConfig, shape: ShapeConfig, *, use_flash=False,
                microbatches: int | None = None, shard_ctx=None):
    """The (callable, donated argument indices) pair of a dry-run cell, the
    JAX package's: the train step donates params and optimizer state (and
    updates them in place), the decode step its batch (the cache, written
    in place), prefill nothing."""
    if shape.kind == "train":
        c = cfg if microbatches is None else cfg.replace(train_microbatches=microbatches)
        return make_train_step(c, use_flash=use_flash, shard_ctx=shard_ctx), (0, 1)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, use_flash=use_flash, shard_ctx=shard_ctx), ()
    return make_decode_step(cfg, shard_ctx=shard_ctx), (1,)
