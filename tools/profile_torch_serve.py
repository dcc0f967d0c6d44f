#!/usr/bin/env python3
"""Where the time of the port's serve run goes, on one CUDA card.

    python3 tools/profile_torch_serve.py [--arch yi-6b] [--batch 8]
        [--prompt-len 512] [--decode-steps 8] [--layers N]

Builds the architecture at full width in bf16 (random weights from a seed),
at full depth or at its first ``--layers`` layers (mixtral-8x7b's 93 GB do
not fit one card), warms up once, then traces one prefill and ``--decode-steps`` decode
steps with ``torch.profiler``.  For each phase it prints the wall time, the
device time summed over all kernels, the device's idle share (1 - kernel
time / wall time; one stream, so kernels do not overlap), its split into
GEMMs (cuBLAS), K2 (flash attention) and three blocks, each timed under a
``record_function`` range the tool puts around its functions: attention
(``gqa_forward``/``gqa_decode``, MLA's ``mla_forward``/``mla_decode``:
projections and the plain softmax attention), the MoE (``moe_apply``: the
expert GEMMs, the token gather and ``index_add_`` scatter, routing) and, for
the SSM and hybrid families, the SSD (its projections and its plain-torch
scan); then the kernels that take the most device time.  A vision
config's prompts follow ``image_tokens`` image embeddings N(0, 0.02) drawn
from the seed, and an audio config's are ``[batch, K, prompt_len]``
codebook tokens, as ``serve.main`` draws them.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402


def _device_us(evt) -> float:
    # the attribute was renamed from cuda to device in newer torch releases
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


# range name: the module and the functions it wraps
RANGES = {"attention": (attn, ("gqa_forward", "gqa_decode", "mla_forward", "mla_decode")),
          "moe": (moe_mod, ("moe_apply",)),
          "ssd": (ssm_mod, ("ssd_forward", "ssd_decode"))}


def _ranged(fn, name: str):
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped


def wrap_ranges() -> None:
    """Put each range around its functions (the model calls them through
    their modules, so the wrappers are what it calls)."""
    for name, (module, fns) in RANGES.items():
        for fn in fns:
            setattr(module, fn, _ranged(getattr(module, fn), name))


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
    """Device time of GEMMs, K2 and each range that ran: its GEMMs and the
    rest of it (K2 apart); for the MoE its gather and scatter (``index``
    kernels), for the SSD its ops over [.., chunk, chunk] blocks."""
    # a range's own device-side annotation is not a kernel
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in RANGES]
    names = {k for k, _ in kernels}
    gemm = sum(us for k, us in kernels if _is_gemm(k)) / 1e3
    k2 = sum(us for k, us in kernels if "flash" in k) / 1e3

    def part(ms):
        return f"{ms:.3f} ms ({ms / busy_ms:.1%})"
    out, other = [f"gemm={part(gemm)} k2={part(k2)}"], 0.0
    for rng in RANGES:
        # a CPU event's list also holds the range's own span (named after
        # it), which is not a kernel: keep the entries named like a kernel
        ks = [(k, us, shapes) for e in prof.events()
              if e.device_type == DeviceType.CPU and e.name == rng
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
              and e.key not in RANGES]
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
    wrap_ranges()
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
            last, cache = prefill()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("prefill", prof, wall, chunk)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            decode(last, cache, args.decode_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"decode x{args.decode_steps}", prof, wall, chunk)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
