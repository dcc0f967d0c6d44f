"""Decode traffic: a batch of sessions, each with a long context already in
its cache, generating greedily one token a step through the program's
``models/transformer.decode_step``.

Set-up prefills the ``sessions`` contexts of ``context`` tokens
(``transformer.prefill`` on flash attention, then ``grow_cache`` to room for
``room`` new tokens) and runs two decode steps to warm up.  The window
starts the answers at the context's end and steps until ``seconds`` have
passed; where the room runs out first, the sessions start their answers
again from the context's end.  No copy of the cache is kept for that: a
step writes only the slot of its own position and attends to the slots up
to it, so the contexts' slots are never written and the later ones are
written again before they are read.  A CUDA event
is recorded after each step, with no synchronise but a bound of ``QUEUE``
steps queued ahead of the card; the gaps between successive events are the
gaps between each session's successive tokens.

After the window the reference (``reference/serve.py``) runs, in float32,
over a sample of the sessions drawn from the seed: each context with every
token served before the room first ran out.  A token served after an answer
started again that differs from the one served at its position before
counts as failed.  The numbers compared:

- ``token_gap``: the widest gap between the reference's best logit and its
  logit of a served token, over every served token of the sample;
- ``logit_err``: the worst ||logits - reference|| / ||reference|| of the
  sample's sessions at ``keep_steps`` steps drawn from the seed among the
  first ``keep_within`` (the program's logits of those steps are kept).
"""
from __future__ import annotations

import gc
import time

import torch

from chipbench import common
from chipbench.reference import model as M
from chipbench.reference import serve as RS
from chipbench.window import Window

FAULTS = ("unchanged", "token")
QUEUE = 4                       # decode steps queued ahead of the card at most
RANGE = "gqa_decode"            # the record_function range around the attention


def run(ctx):
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    sample, set_slot, gqa_decode = serve.sample, attn.set_slot_, attn.gqa_decode
    common.stamp(ctx, "program imported")
    if ctx.fault == "token":                 # a served token altered where it is made
        serve.sample = lambda logits, g, t: (sample(logits, g, t) + 1) % logits.shape[-1]
    if ctx.fault == "unchanged":             # the step leaves its cache as it was
        attn.set_slot_ = lambda *a, **k: None
    if ctx.trace:
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(RANGE):
                return gqa_decode(*args, **kwargs)
        attn.gqa_decode = ranged
    try:
        return _run(ctx, serve)
    finally:
        serve.sample, attn.set_slot_, attn.gqa_decode = sample, set_slot, gqa_decode


def _run(ctx, serve):
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.tree import leaves

    tr, dims, dev, seed = ctx.traffic, ctx.dims, ctx.device, ctx.seed
    n_s, ctx_len, room = tr["sessions"], tr["context"], tr["room"]
    cfg = common.port_config(ctx.config_name, dims)
    weights = common.draw_weights(dims, seed, dev)
    params = common.port_params(weights, cfg)
    common.stamp(ctx, "weights drawn")
    greedy = torch.Generator(device=dev).manual_seed(0)     # unused at temperature 0
    prompts = common.draw_tokens(seed, "decode", (n_s, ctx_len), dims.vocab, dev)
    cuda = dev.type == "cuda"

    with torch.inference_mode():
        last, cache = tfm.prefill(cfg, params, prompts, use_flash=True)
        cache = tfm.grow_cache(cfg, cache, ctx_len + room + 1)
        tok0 = serve.sample(last[:, -1], greedy, 0.0)
        del last

        def restart():
            return {"stages": cache["stages"], "pos": ctx_len}

        tok = tok0
        for _ in range(2):
            logits, cache = tfm.decode_step(cfg, params, cache, tok[:, None])
            tok = serve.sample(logits[:, -1], greedy, 0.0)
        cache = restart()
        del logits
    keep = sorted(int(k) for k in common.rng(seed, "keep").permutation(tr["keep_within"])
                  [:tr["keep_steps"]])
    cache_bytes = sum(x.numel() * x.element_size() for x in leaves(cache["stages"]))
    weight_bytes = sum(w.numel() * w.element_size() for w in weights.values())
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - ctx.t_start

    toks, marks, kept, positions = [tok0], [], {}, []
    steps, first_full = 0, None
    with torch.inference_mode(), Window(dev, ctx.trace, ranges=(RANGE,)) as win:
        start = _mark(cuda)
        tok = tok0
        while win.elapsed() < ctx.seconds:
            if cache["pos"] == ctx_len + room + 1:               # no room left
                first_full = steps if first_full is None else first_full
                cache, tok = restart(), tok0
            positions.append(cache["pos"])
            logits, cache = tfm.decode_step(cfg, params, cache, tok[:, None])
            tok = serve.sample(logits[:, -1], greedy, 0.0)
            if steps in keep:
                kept[steps] = logits[:, -1]
            toks.append(tok)
            marks.append(_mark(cuda))
            if cuda and len(marks) > QUEUE:
                marks[-QUEUE - 1].synchronize()
            steps += 1
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    peak = max(setup_peak, window_peak)
    if cuda:
        gaps = [a.elapsed_time(b) for a, b in zip([start] + marks[:-1], marks)]
    else:
        gaps = [(b - a) * 1e3 for a, b in zip([start] + marks[:-1], marks)]
    ctx.say(f"[decode] window: {steps} steps of {n_s} sessions in {win.seconds:.3f} s"
            f"{f', room ran out after {first_full}' if first_full is not None else ''}; "
            f"set-up {setup_s:.3f} s")
    ctx.say(f"[decode] memory: peak {setup_peak / 1e9:.3f} GB in set-up, "
            f"{window_peak / 1e9:.3f} GB in the window; weights {weight_bytes / 1e9:.3f} GB, "
            f"cache {cache_bytes / 1e9:.3f} GB for {ctx_len + room + 1} slots a session, "
            f"{ctx_len + min(steps, room + 1)} of them filled at most")


    n_ok = steps if first_full is None else first_full
    served = torch.stack(toks[:n_ok + 1], dim=1)           # [sessions, n_ok + 1]
    # answers started again serve the first answers' tokens, position by position
    period = room + 1
    again = sum(int((toks[j + 1] != served[:, j % period + 1]).sum())
                for j in range(n_ok, steps))
    picks = [int(s) for s in common.rng(seed, "sessions").permutation(n_s)[:tr["sample_sessions"]]]
    finite = all(bool(torch.isfinite(x).all()) for x in kept.values())
    seqs = [torch.cat([prompts[s], served[s, :n_ok]]) for s in picks]
    at = [torch.arange(ctx_len - 1, ctx_len + n_ok, device=dev) for _ in picks]
    got_kept = {j: lg for j, lg in kept.items() if j < n_ok}
    del cache, params, kept, toks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    M.no_tf32()
    precs = [M.FP32] + ([M.Precision(fp8=True)] if ctx.control else [])
    t_ref = time.perf_counter()
    out = RS.forward(weights, dims, seqs, at, precs)
    ctx.say(f"[decode] reference over {len(seqs)} sessions: {time.perf_counter() - t_ref:.1f} s")
    ref = out[0]
    if ctx.control:
        judged_tok = [lg.argmax(dim=-1) for lg in out[1]]
        judged_lg = {j: torch.stack([out[1][i][j + 1] for i in range(len(picks))])
                     for j in got_kept}
    else:
        judged_tok = [served[s] for s in picks]
        judged_lg = {j: lg[picks].float() for j, lg in got_kept.items()}
    numbers = {"token_gap": max(float(common.token_gap(r, t).max())
                                for r, t in zip(ref, judged_tok)),
               "logit_err": max((common.rel_err(judged_lg[j][i], ref[i][j + 1])
                                 for j in judged_lg for i in range(len(picks))),
                                default=float("nan"))}
    run = common.Run(cell=ctx.cell, dims=dims, window_s=win.seconds, trace=win.summary,
                     readings=dict(sessions=n_s, steps=steps, positions=positions,
                                   gaps_ms=gaps))
    attempted = steps * n_s
    return dict(attempted=attempted, failed=again if finite else attempted,
                e2e={"decode_tokens_per_s": attempted / win.seconds,
                     "itl_p95_ms": common.percentile(gaps, 95), "setup_s": setup_s},
                numbers=numbers, memory_peak_bytes=peak, run=run)


def _mark(cuda: bool):
    if not cuda:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev
