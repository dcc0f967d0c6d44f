"""Prefill traffic: a closed loop of prompt batches, one at a time, each
served to its first token by the program's ``launch/serve.generate``
(greedy, ``gen_len`` 1).

Every batch holds ``tokens_per_batch`` prompt tokens as ``tokens_per_batch
// L`` prompts of one length ``L``, drawn uniformly from ``lengths`` batch
by batch.  The lengths' order comes from the workload's ``order_key``, not
from the seed, so every seed serves the same order (the seed draws the
tokens and the weights): the program's speed follows the order of the
lengths, so an order drawn from the seed would make the work differ from
seed to seed.  Set-up serves one batch of each length.  A request's
time to first token runs from its batch's call to the call's return (the
first tokens made and the device synchronised).

After the window the reference (``reference/serve.py``) reruns, in float32,
a sample of the served prompts drawn from the seed (the longest length
among them) and the last batch's ``cache_requests`` prompts, whose cache
the program collected (taken from ``transformer.grow_cache``'s return; the
harness holds the last batch's only, dropped before the next call).  The
numbers compared:

- ``logit_err``: the worst sampled request's ||logits - reference|| /
  ||reference|| at its last position;
- ``token_gap``: the worst sampled request's gap between the reference's
  best logit and its logit of the served first token;
- ``cache_err``: the worst layer's ||k - reference|| / ||reference|| (and
  v's) over the last batch's checked requests.
"""
from __future__ import annotations

import gc
import time
from collections import Counter

import torch

from chipbench import common
from chipbench.reference import model as M
from chipbench.reference import serve as RS
from chipbench.window import Window

FAULTS = ("token", "half_batch")


def run(ctx):
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    grow, sample = tfm.grow_cache, serve.sample
    common.stamp(ctx, "program imported")
    held = {}

    def holding_grow(cfg, cache, capacity):
        held["cache"] = grow(cfg, cache, capacity)
        return held["cache"]
    tfm.grow_cache = holding_grow
    if ctx.fault == "token":                 # a served token altered where it is made
        serve.sample = lambda logits, g, t: (sample(logits, g, t) + 1) % logits.shape[-1]
    try:
        return _run(ctx, serve, held)
    finally:
        tfm.grow_cache, serve.sample = grow, sample


def _run(ctx, serve, held):
    from repro_torch.kernels import flash_attention as fa

    tr, dims, dev, seed = ctx.traffic, ctx.dims, ctx.device, ctx.seed
    shapes = [(tr["tokens_per_batch"] // L, L) for L in tr["lengths"]]
    cfg = common.port_config(ctx.config_name, dims)
    weights = common.draw_weights(dims, seed, dev)
    params = common.port_params(weights, cfg)
    common.stamp(ctx, "weights drawn")
    greedy = torch.Generator(device=dev).manual_seed(0)     # unused at temperature 0

    def prompts(key, b, t):
        return common.draw_tokens(seed, ("prefill", key), (b, t), dims.vocab, dev)

    def call(p):
        return serve.generate(cfg, params, p, gen_len=1, temperature=0.0, generator=greedy)

    for kind, (b, t) in enumerate(shapes):                # every shape the cell uses
        call(prompts(("warm", kind), b, t))
        held.clear()
    k2 = fa.launches
    order = common.rng(tr["order_key"], "order")
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
    alloc0 = _alloc_counts(dev)
    setup_s = time.perf_counter() - ctx.t_start
    served = []
    with Window(dev, ctx.trace) as win:
        i = 0
        while win.elapsed() < ctx.seconds:
            b, t = shapes[int(order.integers(len(shapes)))]
            p = prompts(i, b, t)
            if ctx.fault == "half_batch":     # half the requests never answered
                p = p[:b // 2]
            held.clear()
            t0 = time.perf_counter()
            g = call(p)
            # the last logits are a view of the whole [B, T, V] logits: a copy
            # of the last row frees them
            served.append(dict(i=i, b=b, t=t, ttft=time.perf_counter() - t0,
                               tokens=g.tokens[:, 0], logits=g.logits[0].clone()))
            i += 1
    k2 = fa.launches - k2
    alloc = _alloc_counts(dev, since=alloc0)
    peak = max(setup_peak, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    attempted = sum(s["b"] for s in served)
    answered = sum(s["tokens"].shape[0] for s in served)
    finite = sum(int(torch.isfinite(s["logits"]).all(dim=-1).sum()) for s in served)
    ttfts = [s["ttft"] for s in served for _ in range(s["b"])]
    ctx.say(f"[prefill] window: {len(served)} batches, {attempted} requests in "
            f"{win.seconds:.3f} s; K2 {k2 / max(len(served), 1):.1f} launches a batch; "
            f"set-up {setup_s:.3f} s; batches by length "
            f"{dict(sorted(Counter(s['t'] for s in served).items()))}")
    ctx.say(f"[prefill] allocator in the window: {alloc}")

    # the sample: one of the longest, then others, all drawn from the seed
    rng = common.rng(seed, "sample")
    pool = [(j, r) for j, s in enumerate(served) for r in range(s["tokens"].shape[0])]
    longest = max(s["t"] for s in served)
    first = [x for x in pool if served[x[0]]["t"] == longest]
    pick = [first[int(rng.integers(len(first)))]]
    rest = [x for x in pool if x != pick[0]]
    pick += [rest[int(k)] for k in rng.permutation(len(rest))[:tr["sample_requests"] - 1]]
    last = served[-1]
    cache = held.pop("cache")
    rows = sorted(int(r) for r in
                  rng.permutation(last["tokens"].shape[0])[:tr["cache_requests"]])
    unit = cache["stages"][0]["u0"]
    kv = [(unit["k"][:, r, :last["t"]].clone(), unit["v"][:, r, :last["t"]].clone())
          for r in rows]
    got = [(served[j]["logits"][r], served[j]["tokens"][r]) for j, r in pick]
    batches = [(s["tokens"].shape[0], s["t"]) for s in served]   # the answered
    seqs = [prompts(served[j]["i"], served[j]["b"], served[j]["t"])[r] for j, r in pick]
    seqs += [prompts(last["i"], last["b"], last["t"])[r] for r in rows]
    at = [torch.tensor([x.shape[0] - 1], device=dev) for x in seqs]
    del cache, unit, params, served
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    M.no_tf32()
    precs = [M.FP32] + ([M.Precision(fp8=True)] if ctx.control else [])
    n_pick, cache_errs = len(pick), []

    def on_layer(li, i, kvs):
        if i < n_pick:
            return
        ref_k, ref_v = kvs[0]
        k, v = kvs[1] if ctx.control else (kv[i - n_pick][0][li], kv[i - n_pick][1][li])
        cache_errs.append(max(common.rel_err(k, ref_k), common.rel_err(v, ref_v)))
    t_ref = time.perf_counter()
    out = RS.forward(weights, dims, seqs, at, precs, on_layer)
    ctx.say(f"[prefill] reference over {len(seqs)} prompts: {time.perf_counter() - t_ref:.1f} s")
    ref = [lg[0] for lg in out[0][:n_pick]]
    judged = [(lg[0], lg[0].argmax()) for lg in out[1][:n_pick]] if ctx.control else got
    numbers = {"logit_err": max(common.rel_err(lg.float(), r) for (lg, _), r in zip(judged, ref)),
               "token_gap": max(float(common.token_gap(r, tok))
                                for (_, tok), r in zip(judged, ref)),
               "cache_err": max(cache_errs)}
    run = common.Run(cell=ctx.cell, dims=dims, window_s=win.seconds, trace=win.summary,
                     readings=dict(batches=batches, ttfts=ttfts, k2_launches=k2))
    tokens = sum(b * t for b, t in batches)
    return dict(attempted=attempted, failed=attempted - min(answered, finite),
                e2e={"prefill_tokens_per_s": tokens / win.seconds, "setup_s": setup_s},
                numbers=numbers, memory_peak_bytes=peak, run=run)


_ALLOC = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams")


def _alloc_counts(device, since: dict | None = None) -> dict:
    """The CUDA caching allocator's counters (``torch.cuda.memory_stats``):
    retries after a failed ``cudaMalloc`` (each frees the cached blocks and
    synchronises), ``cudaMalloc`` and ``cudaFree`` calls, and with
    ``since`` their change from that reading; empty off the card."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    now = {k: int(stats.get(k, 0)) for k in _ALLOC}
    if since is None:
        return now
    return {k: now[k] - since.get(k, 0) for k in _ALLOC}
