#!/usr/bin/env python3
"""Where the time of the port's serve run goes, on one CUDA card.

    python3 tools/profile_torch_serve.py [--arch yi-6b] [--batch 8]
        [--prompt-len 512] [--decode-steps 8] [--layers N]

Builds the architecture at full width in bf16 (random weights from a seed),
at full depth or at its first ``--layers`` layers (mixtral-8x7b's 93 GB do
not fit one card), warms up once, then traces one ``serve.generate`` call
of one token (the prefill, the cache grown, the first token) and
``--decode-steps`` decode steps with ``torch.profiler``, the program's
spans on (``runtime/trace.py``).  For each phase it prints the wall time,
the device time summed over all kernels, the device's idle share (1 -
kernel time / wall time; one stream, so kernels do not overlap), its split
into GEMMs (cuBLAS), K2 (flash attention) and three blocks, each the
kernels launched under the program's spans of it: attention
(``attention.forward``/``attention.decode``: projections and the plain
softmax attention), the MoE (``moe.apply``: the expert GEMMs, the token
gather and ``index_add_`` scatter, routing) and, for the SSM and hybrid
families, the SSD (``ssd.forward``/``ssd.decode``: its projections and its
plain-torch scan); then the kernels that take the most device time, and
the device and idle time by span path (``span_paths``).  The decode phase
also prints the bytes of repeated k and v a step
(``models/attention.py::kv_repeat_bytes``).  A vision
config's prompts follow ``image_tokens`` image embeddings N(0, 0.02) drawn
from the seed, and an audio config's are ``[batch, K, prompt_len]``
codebook tokens, as ``serve.main`` draws them.
"""
from __future__ import annotations

import argparse
import bisect
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402


def _device_us(evt) -> float:
    # the attribute was renamed from cuda to device in newer torch releases
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


# block: the program's spans it is timed under
BLOCKS = {"attention": ("attention.forward", "attention.decode"),
          "moe": ("moe.apply",),
          "ssd": ("ssd.forward", "ssd.decode")}
OUTSIDE = "outside the program"


def _timeline(spans):
    """One thread's spans [(start, end, name)], nested as a thread opens
    them: ``(times, chains, paths)``, the chain of spans ``(start, name,
    end)`` open from each time in ``times`` on, outermost first, and each
    span's path (its chain's names and its own, joined by ``/``)."""
    times, chains, paths, stack = [], [], [], []

    def mark(t):
        if times and times[-1] == t:
            chains[-1] = tuple(stack)
        else:
            times.append(t)
            chains.append(tuple(stack))
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][2] <= s:
            mark(stack.pop()[2])
        stack.append((s, name, e))
        paths.append("/".join(n for _, n, _ in stack))
        mark(s)
    while stack:
        mark(stack.pop()[2])
    return times, chains, paths


def _open(timeline, t) -> tuple:
    if timeline is None:
        return ()
    i = bisect.bisect_right(timeline[0], t) - 1
    return timeline[1][i] if i >= 0 else ()


def _path(chain) -> str:
    return "/".join(n for _, n, _ in chain) or OUTSIDE


def by_path(spans, ops, caller, lo, hi):
    """Device seconds, idle seconds and span counts by span path.

    ``spans``: ``(start, end, thread, name)`` of every program span (ns);
    ``ops``: ``(start, end, launch)`` of every device operation, ``launch``
    the ``(time, thread)`` of the host call that queued it or None;
    ``caller``: the thread that runs the program.  An operation counts
    under the chain of spans open on its launch's thread when it was
    launched, or where that thread has none open (a backward's launches on
    autograd's device thread), under the caller's chain at that time; one
    not linked to a launch, under ``OUTSIDE``.  Each idle gap of the
    device inside [lo, hi] counts under the spans open on any thread when
    it began, ordered by their starts."""
    per_thread = {}
    for s, e, tid, name in spans:
        per_thread.setdefault(tid, []).append((s, e, name))
    lines = {tid: _timeline(sp) for tid, sp in per_thread.items()}
    count = {}
    for tl in lines.values():
        for p in tl[2]:
            count[p] = count.get(p, 0) + 1
    device, busy = {}, []
    for s, e, launch in ops:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        busy.append([s, e])
        chain = ()
        if launch is not None:
            t, tid = launch
            chain = _open(lines.get(tid), t) or _open(lines.get(caller), t)
        p = _path(chain)
        device[p] = device.get(p, 0.0) + (e - s) / 1e9
    idle = {}
    edges = [lo] + [x for iv in _merge(busy) for x in iv] + [hi]
    for i in range(0, len(edges), 2):
        t, length = edges[i], edges[i + 1] - edges[i]
        if length > 0:
            p = _path(sorted(c for tl in lines.values() for c in _open(tl, t)))
            idle[p] = idle.get(p, 0.0) + length / 1e9
    return device, idle, count


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_paths(prof, lo=None, hi=None):
    """``by_path`` of a finished profile's events: the program's spans (the
    caller the thread of the first one), and each device operation with
    the host call that queued it (of the calls that share its link, the
    latest to start before it; for one linked to none, the call that
    queued the operation before it), over [lo, hi] (ns; by default the
    first to the last event)."""
    spans, ops, calls = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if e.name() in trace.NAMES:
                spans.append((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name()))
            else:
                calls.setdefault(e.correlation_id(), []).append(
                    (e.start_ns(), e.start_thread_id()))
        elif not _annotation(e):
            ops.append((e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    linked, last = [], None
    for s, e, corr in sorted(ops):
        # the device's clock is aligned to the host's only to a few us, so a
        # kernel that starts as soon as it is queued may read as starting
        # before its launch: then the link's first call
        cands = calls.get(corr, ())
        before = [c for c in cands if c[0] <= s]
        launch = max(before) if before else min(cands, default=None)
        # an operation linked to no host call (K2's forward where no
        # autograd Function wraps it) was queued right after the one before
        # it on the card's one stream: it takes that one's launch
        launch = last if launch is None else launch
        linked.append((s, e, launch))
        last = launch
    ends = [x for sp in spans for x in sp[:2]] + [x for op in ops for x in op[:2]]
    caller = min(spans)[2] if spans else None
    lo = min(ends, default=0) if lo is None else lo
    hi = max(ends, default=0) if hi is None else hi
    return by_path(spans, linked, caller, lo, hi)


def _annotation(e) -> bool:
    """A ``record_function`` range's copy on the device's timeline (a span's
    or any other range's): it covers the kernels launched under the range,
    and is no operation of its own."""
    flag = getattr(e, "is_user_annotation", None)
    return (flag is not None and flag()) or e.name() in trace.NAMES


def holding(table: dict, name: str) -> float:
    """The sum of ``table`` over the paths that hold the span ``name``."""
    return sum(v for p, v in table.items() if name in p.split("/"))


def print_spans(tag: str, prof):
    """Print the device and idle time by span path, the most device time
    first; return ``span_paths(prof)``."""
    device, idle, count = span_paths(prof)
    busy = sum(device.values())
    for p in sorted(set(device) | set(idle) | set(count), key=lambda p: -device.get(p, 0)):
        ms = device.get(p, 0.0) * 1e3
        print(f"[{tag}] span {p}: x{count.get(p, 0)} device {ms:.3f} ms "
              f"({ms / 1e3 / max(busy, 1e-12):.1%}), idle {idle.get(p, 0.0) * 1e3:.3f} ms")
    return device, idle, count


def _is_gemm(kernel: str) -> bool:
    return any(tag in kernel.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass"))


def _range_kernels(evt) -> list:
    """(name, us, the launching op's input shapes) of every kernel launched
    under a CPU event, children too."""
    out = [(k.name, k.duration, evt.input_shapes) for k in evt.kernels]
    for child in evt.cpu_children:
        out += _range_kernels(child)
    return out


def _quadratic(shapes, chunk: int) -> bool:
    """Whether an op's inputs span a [.., chunk, chunk] block: the SSD's
    intra-chunk term (its [B, nc, nh, cl, cl] passes and products)."""
    dims = [sh[-2:] for sh in shapes if isinstance(sh, (list, tuple)) and len(sh) >= 2]
    return bool(dims) and max(d[0] for d in dims) == chunk == max(d[1] for d in dims)


def split(prof, busy_ms: float, chunk: int) -> str:
    """Device time of GEMMs, K2 and each block that ran: its GEMMs and the
    rest of it (K2 apart); for the MoE its gather and scatter (``index``
    kernels), for the SSD its ops over [.., chunk, chunk] blocks."""
    # a span's own device-side annotation is not a kernel
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in trace.NAMES]
    names = {k for k, _ in kernels}
    gemm = sum(us for k, us in kernels if _is_gemm(k)) / 1e3
    k2 = sum(us for k, us in kernels if "flash" in k) / 1e3

    def part(ms):
        return f"{ms:.3f} ms ({ms / busy_ms:.1%})"
    out, other = [f"gemm={part(gemm)} k2={part(k2)}"], 0.0
    for rng, spans in BLOCKS.items():
        # a CPU event's list also holds the span's own annotation (named
        # after it), which is not a kernel: keep the entries named like one
        ks = [(k, us, shapes) for e in prof.events()
              if e.device_type == DeviceType.CPU and e.name in spans
              for k, us, shapes in _range_kernels(e) if k in names]
        if not ks:
            continue
        total = sum(us for _, us, _ in ks) / 1e3
        rng_gemm = sum(us for k, us, _ in ks if _is_gemm(k)) / 1e3
        rest = total - rng_gemm - sum(us for k, us, _ in ks if "flash" in k) / 1e3
        other += rest
        detail = [f"gemm {part(rng_gemm)}", f"not GEMM or K2 {part(rest)}"]
        if rng == "moe":
            index = sum(us for k, us, _ in ks if "index" in k.lower()) / 1e3
            detail.append(f"gather and index_add {part(index)}")
        if rng == "ssd":
            quad = [(k, us) for k, us, shapes in ks if _quadratic(shapes, chunk)]
            detail.append(f"ops over [.., {chunk}, {chunk}] blocks "
                          f"{part(sum(us for _, us in quad) / 1e3)}, of which not GEMM "
                          f"{part(sum(us for k, us in quad if not _is_gemm(k)) / 1e3)}")
        out.append(f"{rng}={part(total)} [{'; '.join(detail)}]")
    out.append(f"rest={part(busy_ms - gemm - k2 - other)}")
    return " ".join(out)


def report(name: str, prof, wall_s: float, chunk: int, top: int = 8) -> None:
    # device-side events only: an operator's CPU event also carries the
    # device time of the kernels it launched, which would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0
              and e.key not in trace.NAMES]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    wall_ms = wall_s * 1e3
    print(f"[{name}] wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"idle_share={1 - busy_ms / wall_ms:.4f}")
    print(f"[{name}] split: {split(prof, busy_ms, chunk)}")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        ms = _device_us(e) / 1e3
        print(f"[{name}]   {ms:9.3f} ms  {ms / busy_ms:6.1%}  x{e.count:<5d} "
              f"{e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to the first N layers (0: all)")
    args = ap.parse_args(argv)

    device = resolve_device("cuda")
    trace.enable()
    cfg = get_config(args.arch)
    if args.layers:
        n = args.layers
        cfg = cfg.replace(n_layers=n, windows=cfg.windows[:n],
                          layer_kinds=cfg.layer_kinds[:n], moe_layers=cfg.moe_layers[:n])
    print(f"[profile] {cfg.name}: {cfg.n_layers} layers, {cfg.n_params() / 1e9:.3f} B "
          f"params, batch {args.batch} x {args.prompt_len} prompt"
          f"{f' after {cfg.image_tokens} image positions' if cfg.frontend == 'vision' else ''}"
          f"{f' x {cfg.n_codebooks} codebooks' if cfg.n_codebooks > 1 else ''}", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    prompts, image = serve.draw_inputs(cfg, args.batch, args.prompt_len,
                                       np.random.default_rng(args.seed), device)
    n_image = 0 if image is None else image.shape[1]
    capacity = args.prompt_len + 2 * args.decode_steps + cfg.meta_tokens + n_image + 2
    chunk = cfg.ssm.chunk if cfg.ssm is not None else 0

    def prefill():
        last, cache = tfm.prefill(cfg, params, prompts, image, use_flash=True)
        return last, tfm.grow_cache(cfg, cache, capacity)

    def decode(last, cache, steps):
        tok = last[:, -1].argmax(dim=-1)
        for _ in range(steps):
            logits, cache = tfm.decode_step(cfg, params, cache, tok[..., None])
            tok = logits[:, -1].argmax(dim=-1)
        return cache

    with torch.inference_mode():
        last, cache = prefill()                       # warm-up: build, caches
        decode(last, cache, 2)
        torch.cuda.synchronize()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            serve.generate(cfg, params, prompts, gen_len=1, temperature=0.0,
                           generator=gen, image_embeds=image)
            wall = time.perf_counter() - t0
        report("prefill", prof, wall, chunk)
        print_spans("prefill", prof)

        repeated = attn.kv_repeat_bytes
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            decode(last, cache, args.decode_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        name = f"decode x{args.decode_steps}"
        report(name, prof, wall, chunk)
        print_spans(name, prof)
        print(f"[{name}] repeated k and v: "
              f"{(attn.kv_repeat_bytes - repeated) / args.decode_steps / 1e9:.6f} GB a step")

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
