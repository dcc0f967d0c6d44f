#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. probe     card name, power limit and capability; TF32 off for fp32 checks
  2. build     nvcc builds both libraries from csrc/, one process per
               source, and prints the build time and each kernel's registers
               and spills (a spill, or a setmaxnreg that ptxas ignores,
               fails); the SASS of every bf16 kernel of K1 and K2 must hold
               HGMMA (wgmma) and UTMALDG (TMA load) instructions, each
               library's compiled tiles must be its rule's, and its shared
               memory per launch must be the rule's
  3. kernel    flash attention (K2) against its plain torch version on the
               card: every compiled bf16 tile on every case (3e-2),
               bit-identical across block_q at a fixed block_k, the fp32
               kernel (2e-5), refused tiles raise, and a window of 1 (one
               nonzero per row of P) reads back each row's own v exactly
  4. timing    K2 at every compiled tile of d = 128, its plain version and
               the SDPA yardstick at the serving shape and at Yi-6B's
               train_4k flash case, with the bound and its share
  5. model     Yi-6B widths, 2 layers, fp32: model_forward flash vs plain
  6. serve     Yi-6B at full width and depth, bf16: 8 x 512-token prompts,
               32 generated tokens, through ``repro_torch.launch.serve.main``
  7. k1        blocked matmul against its plain version on the card: every
               compiled tile of both dtypes at bk 16/64/128/256 on the JAX
               tests' shapes and three ragged ones (bit-identical across the
               tiles of a dtype; refused tiles raise), then Yi-6B's ffn_up
               shape
  8. tune      ``python -m repro_torch tune --arch yi-6b --backend wallclock``
               through its ``main``: every candidate tile of Yi-6B's 14
               cases (12 GEMM on K1, 2 flash on K2) timed on the card, the
               measured tuners fitted, the evaluation table written (store
               in a temporary directory)
  9. k1-timing blocked matmul at (4096, 4096, 11008) bf16 with the default
               tile and the best tile phase 8 measured, beside its plain
               version, torch.matmul and the bound: TFLOP/s and the share
               of the bound
The last three lines are the ``nvidia-smi`` name/power-limit line, the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import zoo_cases  # noqa: E402
from repro_torch.core.kerneltune import bucket_pow2  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul_blocked as mm  # noqa: E402
from repro_torch.launch import serve, tune  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.weights import init_params  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate and dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (name, B, T, S, H, KV, d, window, n_meta, causal); blocks 32 as in the
# JAX package's kernel tests
CASES = [
    ("mha", 2, 128, 128, 4, 4, 64, 0, 0, True),
    ("gqa", 2, 128, 128, 4, 2, 64, 0, 0, True),
    ("gqa+window", 2, 128, 128, 8, 2, 32, 32, 0, True),
    ("window+meta", 2, 96, 96, 4, 2, 32, 32, 8, True),
    ("mqa+window", 2, 64, 64, 2, 1, 128, 16, 0, True),
    ("t<s right-aligned", 2, 64, 192, 4, 2, 64, 0, 0, True),
    ("ragged t=s=100", 2, 100, 100, 4, 2, 64, 0, 0, True),
    ("ragged t=75 s=203", 2, 75, 203, 4, 2, 32, 0, 0, True),
    ("d=128", 2, 256, 256, 8, 2, 128, 0, 0, True),
    ("non-causal", 2, 64, 128, 4, 2, 64, 0, 0, False),
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SLICE = dict(B=8, T=512, H=32, KV=4, d=128)      # Yi-6B prefill in the serve run
TRAIN_4K = dict(B=1, T=4096, H=32, KV=32, d=128)  # Yi-6B's train_4k flash case (MHA)
K2_DEFAULT = (128, 128)                          # the serving call's blocks
# tiles the rule refuses, (block_q, block_k, d)
K2_REFUSED = [(256, 64, 128), (64, 256, 128), (128, 256, 64), (512, 512, 32)]


def check_close(name, got, want, tol):
    """assert_allclose(rtol=tol, atol=tol), as the JAX package's tests hold it."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - (tol + tol * want.abs())).max().item()
    max_err = err.max().item()
    if not (excess <= 0 and torch.isfinite(got).all()):
        raise SystemExit(f"[kernel] {name}: max abs err {max_err:.3e} over tol {tol}")
    return max_err


def rand(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def qkv(gen, b, t, s, h, kv, d, dtype, device):
    return (rand(gen, (b, t, h, d), dtype, device),
            rand(gen, (b, s, kv, d), dtype, device),
            rand(gen, (b, s, kv, d), dtype, device))


def time_ms(fn, iters=50, warmup=5):
    """Mean ms per call, by CUDA events around ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_probe():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[probe] {smi}; capability {torch.cuda.get_device_capability(device)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return device, smi


def _short_name(mangled):
    """'matmul_blocked_kernel<bf16,128,64>' from the mangled template name
    (the wgmma kernels take bf16 only)."""
    ints = re.findall(r"Li(\d+)E", mangled)
    dtype = "bf16" if "bfloat16" in mangled or "wgmma" in mangled else "fp32"
    found = re.search(r"([a-z_]+_kernel)I", mangled)
    base = found.group(1) if found else mangled
    return f"{base}<{','.join([dtype] + ints)}>"


def _cuobjdump():
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(found).exists():
        return found
    import triton
    return str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")


def sass_counts(library, opcodes=("HGMMA", "UTMALDG")):
    """{kernel: {opcode: count}} from ``cuobjdump -sass`` of a built library."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = counts.setdefault(found.group(1), dict.fromkeys(opcodes, 0))
        elif current is not None:
            for op in opcodes:
                current[op] += len(re.findall(rf"\b{op}\b", line))
    return counts


def flash_work(b, t, s, h, kv, d, causal=True, dtype_bytes=2):
    """(flops, bytes) the function needs: each live (query, key) pair costs
    a d-long dot product and a d-long update, 2 flops per multiply-add; q
    and k, v read once, o written once."""
    if causal:
        live = sum(min(s, max(0, r + s - t + 1)) for r in range(t))
    else:
        live = t * s
    return 4 * d * live * b * h, (2 * b * t * h + 2 * b * s * kv) * d * dtype_bytes


def bound(flops, nbytes, dtype=torch.bfloat16):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    return bound_ms, bound_by, t_bytes, t_ops


def phase_build():
    libs = [fa.LIBRARY, mm.LIBRARY]
    t0 = time.perf_counter()
    paths = _build.build_many(libs)
    sources = [src for lib in libs for src in lib.sources]
    print(f"[build] {len(sources)} sources of {len(libs)} libraries in parallel: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    bad = []
    for source in sources:
        log = _build.build_logs.get(source, "")
        if "setmaxnreg ignored" in log:
            bad.append(f"{source}: ptxas ignored setmaxnreg")
        report = _build.ptxas_report(log)
        for name, info in sorted(report.items(), key=lambda kv: _short_name(kv[0])):
            regs = info.get("registers")
            st, ld = info.get("spill_stores", 0), info.get("spill_loads", 0)
            print(f"[build]   {source}: {_short_name(name):<40} "
                  f"registers {regs} spill stores {st} loads {ld}")
            if st or ld:
                bad.append(f"spills in {_short_name(name)}")
    for dtype_bytes, tiles in mm.INSTANTIATED.items():
        if sorted(mm.compiled_tiles(dtype_bytes)) != sorted(tiles):
            bad.append(f"compiled tiles {mm.compiled_tiles(dtype_bytes)} differ from "
                       f"the rule's {tiles}")
    for bm, bn in mm.INSTANTIATED[2]:
        for bk in (64, 128, 256, 448, 512):
            want = int(mm.smem_bytes(bm, bn, bk)) if mm.fits(bm, bn, bk) else -1
            if mm.launch_smem(bm, bn, bk) != want:
                bad.append(f"bf16 {(bm, bn, bk)}: the library asks {mm.launch_smem(bm, bn, bk)} "
                           f"bytes of shared memory, the rule {want}")
    for dtype_bytes, tiles in fa.INSTANTIATED.items():
        if sorted(fa.compiled_tiles(dtype_bytes)) != sorted(tiles):
            bad.append(f"compiled K2 tiles {fa.compiled_tiles(dtype_bytes)} differ "
                       f"from the rule's {tiles}")
        for bq, bk, d in tiles:
            want = int(fa.smem_bytes(bq, bk, d, dtype_bytes))
            if fa.launch_smem(bq, bk, d, dtype_bytes) != want:
                bad.append(f"K2 {(bq, bk, d)} ({dtype_bytes}-byte): the library asks "
                           f"{fa.launch_smem(bq, bk, d, dtype_bytes)} bytes of shared "
                           f"memory, the rule {want}")
    for bq, bk, d in K2_REFUSED:
        if fa.fits(bq, bk, d) or fa.launch_smem(bq, bk, d) != -1:
            bad.append(f"K2 {(bq, bk, d)} is compiled or admitted by the rule")
    for path, kernel, n_tiles in ((paths[1], "matmul_wgmma_kernel", len(mm.INSTANTIATED[2])),
                                  (paths[0], "flash_wgmma_kernel", len(fa.INSTANTIATED[2]))):
        sass = {name: c for name, c in sass_counts(path).items() if kernel in name}
        for name, c in sorted(sass.items(), key=lambda kv: _short_name(kv[0])):
            print(f"[build]   sass {_short_name(name):<40} HGMMA {c['HGMMA']} "
                  f"UTMALDG {c['UTMALDG']}")
            if not (c["HGMMA"] and c["UTMALDG"]):
                bad.append(f"{_short_name(name)} lacks HGMMA or UTMALDG")
        if len(sass) != n_tiles:
            bad.append(f"{len(sass)} {kernel} kernels in the SASS, {n_tiles} compiled tiles")
    if bad:
        raise SystemExit(f"[build] {bad}")
    print(f"[build] matmul_blocked: {len(mm.INSTANTIATED[4])} fp32 tiles on CUDA cores, "
          f"{len(mm.INSTANTIATED[2])} bf16 tiles on wgmma + TMA; flash_attention: "
          f"{len(fa.INSTANTIATED[4])} fp32 kernels on CUDA cores, "
          f"{len(fa.INSTANTIATED[2])} bf16 tiles on wgmma + TMA (HGMMA, UTMALDG in "
          "each bf16 kernel); no spills; tiles and shared memory as the rules say",
          flush=True)


def phase_kernel(device):
    gen = torch.Generator(device=device).manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    n_tiles = worst = 0
    for name, b, t, s, h, kv, d, win, meta, causal in CASES:
        kw = dict(window=win, n_meta=meta, causal=causal)
        q, k, v = qkv(gen, b, t, s, h, kv, d, bf16, device)
        want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **kw)
        by_bk, errs = {}, []
        for bq, bk, dd in fa.INSTANTIATED[2]:
            if dd != d:
                continue
            got = ops.flash_attention(q, k, v, block_q=bq, block_k=bk, **kw)
            errs.append(check_close(f"{name} bf16 tile {(bq, bk)}", got, want, TOL[bf16]))
            # each row's arithmetic does not depend on block_q
            if not torch.equal(got, by_bk.setdefault(bk, got)):
                raise SystemExit(f"[kernel] {name} tile {(bq, bk)} differs from "
                                 f"tile {(64, bk)}")
            n_tiles += 1
        first = next(iter(by_bk.values()))
        across_bk = max(check_close(f"{name} across block_k", o, first, TOL[bf16])
                        for o in by_bk.values())
        q, k, v = (x.to(fp32) for x in (q, k, v))
        got = ops.flash_attention(q, k, v, block_q=32, block_k=32, **kw)
        want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, **kw)
        err32 = check_close(f"{name} fp32", got, want, TOL[fp32])
        worst = max(worst, *errs)
        print(f"[kernel] {name:<18} bf16 {len(errs)} tiles max abs err {max(errs):.3e} "
              f"(tol 3e-2), bit-identical across block_q, {across_bk:.3e} across "
              f"block_k; fp32 {err32:.3e} (tol 2e-5)")
    # P as wgmma's A fragment: with a window of 1 each row of P holds one
    # nonzero (1, at the row's own key), so every row must read back its
    # own v bit for bit at every tile, whatever column its key falls in
    for bq, bk, d in fa.INSTANTIATED[2]:
        q, k, v = qkv(gen, 2, 256, 256, 4, 2, d, bf16, device)
        got = ops.flash_attention(q, k, v, window=1, block_q=bq, block_k=bk)
        if not torch.equal(got, v.repeat_interleave(2, dim=2)):
            raise SystemExit(f"[kernel] one nonzero per row: tile {(bq, bk, d)} does "
                             "not read back each row's own v")
    print(f"[kernel] one nonzero per row of P: all {len(fa.INSTANTIATED[2])} bf16 tiles "
          "read back each row's own v bit for bit")
    for bq, bk, d in K2_REFUSED:
        q, k, v = qkv(gen, 1, 512, 512, 2, 1, d, bf16, device)
        try:
            ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
        except ValueError:
            continue
        raise SystemExit(f"[kernel] refused tile {(bq, bk, d)} did not raise")
    print(f"[kernel] {n_tiles} (case, tile) launches of bf16 within 3e-2 of plain "
          f"(max abs err {worst:.3e}); {len(K2_REFUSED)} refused tiles raised ValueError")
    # the serving shape itself
    dt = torch.bfloat16
    q, k, v = qkv(gen, SLICE["B"], SLICE["T"], SLICE["T"], SLICE["H"],
                  SLICE["KV"], SLICE["d"], dt, device)
    got = ops.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v, scale=SLICE["d"] ** -0.5)
    err = check_close("serving shape", got, want, TOL[dt])
    print(f"[kernel] serving shape q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
          f"default tile {K2_DEFAULT} max abs err {err:.3e} (tol {TOL[dt]})", flush=True)
    print("[kernel] kernels checked against their plain versions: flash_attention_fwd "
          "(bf16 wgmma, fp32 CUDA cores)")
    return q, k, v, max(err, worst)


def time_flash(name, q, k, v, iters, plain_iters):
    """K2 at the default tile and at every compiled tile of the head dim,
    its plain version, SDPA and the bound, at one causal shape."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    tile_ms = {}
    for bq, bk, dd in fa.INSTANTIATED[2]:
        if dd == d:
            tile_ms[(bq, bk)] = time_ms(lambda: ops.flash_attention(
                q, k, v, block_q=bq, block_k=bk), iters=iters)
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=d ** -0.5),
                       iters=plain_iters, warmup=1)
    # the yardstick takes [B,H,T,d]; the copies are made outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=kv != h)
    library_ms = time_ms(sdpa, iters=iters)
    flops, nbytes = flash_work(b, t, s, h, kv, d)
    bound_ms, bound_by, t_bytes, t_ops = bound(flops, nbytes)
    best = min(tile_ms, key=tile_ms.get)
    for tile, ms in tile_ms.items():
        print(f"[timing] {name} tile {tile}: kernel_ms={ms:.4f} "
              f"({flops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.4f} of the bound)"
              f"{' default' if tile == K2_DEFAULT else ''}{' best' if tile == best else ''}")
    print(f"[timing] {name} q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal: "
          f"kernel_ms={tile_ms[K2_DEFAULT]:.4f} at default tile {K2_DEFAULT}, "
          f"{tile_ms[best]:.4f} at best tile {best}; plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (sdpa, {bound_ms / library_ms:.4f} of the bound) "
          f"bound_ms={bound_ms:.5f} by {bound_by} ({nbytes / 1e6:.1f} MB -> "
          f"{t_bytes:.5f} ms, {flops / 1e9:.2f} GFLOP -> {t_ops:.5f} ms)", flush=True)
    return dict(ms=tile_ms[K2_DEFAULT], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, tile=list(K2_DEFAULT),
                best_tile=list(best), best_tile_ms=tile_ms[best],
                share_of_bound=bound_ms / tile_ms[K2_DEFAULT])


def phase_timing(q, k, v, device):
    times = time_flash("serving", q, k, v, iters=50, plain_iters=50)
    gen = torch.Generator(device=device).manual_seed(4)
    c = TRAIN_4K
    q4, k4, v4 = qkv(gen, c["B"], c["T"], c["T"], c["H"], c["KV"], c["d"],
                     torch.bfloat16, device)
    got = ops.flash_attention(q4, k4, v4)
    err = check_close("train_4k", got, fa.flash_attention_plain(
        q4, k4, v4, scale=c["d"] ** -0.5), TOL[torch.bfloat16])
    print(f"[timing] train_4k flash shape max abs err {err:.3e} (tol 3e-2)")
    times["train_4k"] = time_flash("train_4k", q4, k4, v4, iters=20, plain_iters=3)
    return times


def phase_model(device):
    cfg = get_config("yi-6b").replace(n_layers=2, param_dtype="float32",
                                      compute_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(1)
    params = init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (2, 512), generator=gen, device=device)
    with torch.inference_mode():
        a, *_ = tfm.model_forward(cfg, params, tokens, use_flash=False)
        b, *_ = tfm.model_forward(cfg, params, tokens, use_flash=True)
    err = check_close("model flash vs plain", b, a, 2e-3)
    print(f"[model] yi-6b widths, 2 layers, fp32, 2x512 tokens: logits "
          f"{tuple(b.shape)}, max abs err flash vs plain {err:.3e} (tol 2e-3)",
          flush=True)
    del params, a, b
    torch.cuda.empty_cache()


def phase_serve():
    cfg = get_config("yi-6b")
    argv = ["--arch", "yi-6b", "--preset", "full", "--batch", "8",
            "--prompt-len", "512", "--gen-len", "32"]
    torch.cuda.reset_peak_memory_stats()
    report = {}
    fa.launches = 0
    out = serve.main(argv, report=report)
    launches = fa.launches
    # decode never calls the kernel, so every launch of the run is prefill's
    if launches != cfg.n_layers:
        raise SystemExit(f"[serve] {launches} kernel launches, expected {cfg.n_layers}")
    if not (0 <= int(out.min()) and int(out.max()) < cfg.vocab):
        raise SystemExit("[serve] token outside [0, vocab)")
    if not report["logits_finite"]:
        raise SystemExit("[serve] non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] yi-6b full bf16 batch 8 x 512 prompt, 32 new: "
          f"prefill_ms={report['prefill_ms']:.2f} "
          f"decode_ms_per_step={report['decode_ms_per_step']:.3f} "
          f"tokens_per_s={report['tokens_per_s']:.1f} "
          f"peak_mem_gb={peak / 1e9:.3f} flash_launches={launches}", flush=True)
    return launches


# K1 checks: the JAX package's kernel-test shapes (m, k, n) and three ragged
# ones ((100, 60, 36) also misaligns K and N for TMA; at 1200 rows the bf16
# block order ends in a partial group of M tiles), fp32 at its 1e-4 rtol /
# 1e-3 atol and bf16 at 5e-2
K1_SHAPES = [(128, 128, 128), (256, 128, 64), (100, 60, 36), (32, 512, 96),
             (1000, 300, 777), (1200, 72, 136)]
K1_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
K1_BKS = (16, 64, 128, 256)
K1_SLICE = (4096, 4096, 11008)         # Yi-6B ffn_up at train_4k, bf16
DEFAULT_TILE = (128, 128, 128)
# bk 64 is outside the tuner's sweep (128, 256, 512); at 64 the bf16 ring of
# (128, 256) holds 4 stages, at 128 only 2.  Phase 9 times it beside the
# tuned tile, to show what the kernel does with a deeper ring.
SHALLOW_TILE = (128, 256, 64)


def check_close_k1(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
    if not (excess <= 0 and torch.isfinite(got).all()):
        raise SystemExit(f"[k1] {name}: max abs err {err.max().item():.3e} over "
                         f"rtol {rtol} atol {atol}")
    return err.max().item()


def phase_k1(device):
    """Every compiled tile of both dtypes at every bk on every shape: within
    tolerance of plain, and, since every tile sums each output in the same
    k order, bit-identical to the other tiles of its dtype."""
    gen = torch.Generator(device=device).manual_seed(2)
    worst = 0.0
    for dtype, (rtol, atol) in K1_TOL.items():
        size = torch.tensor([], dtype=dtype).element_size()
        for m, k, n in K1_SHAPES:
            a, b = rand(gen, (m, k), dtype, device), rand(gen, (k, n), dtype, device)
            want = mm.matmul_blocked_plain(a, b)
            first, ran, refused, sweep = None, 0, 0, 0.0
            for bm, bn in mm.INSTANTIATED[size]:
                for bk in K1_BKS:
                    # the wrapper clamps each block to its dimension first
                    if not mm.fits(min(bm, m), min(bn, n), min(bk, k), size):
                        try:
                            ops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                        except ValueError:
                            refused += 1
                            continue
                        raise SystemExit(f"[k1] infeasible tile {(bm, bn, bk)} did not raise")
                    got = ops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                    sweep = max(sweep, check_close_k1(f"({m},{k},{n}) tile {(bm, bn, bk)} "
                                                      f"{dtype}", got, want, rtol, atol))
                    if first is None:
                        first = got
                    elif not torch.equal(got, first):
                        raise SystemExit(f"[k1] ({m},{k},{n}) tile {(bm, bn, bk)} {dtype} "
                                         "differs from the first tile's result")
                    ran += 1
            print(f"[k1] ({m},{k},{n}) {str(dtype):<15} {ran} (tile, bk) launches agree "
                  f"with plain and bit for bit with each other; {refused} infeasible "
                  f"ones raised ValueError; max abs err {sweep:.3e} "
                  f"(rtol {rtol} atol {atol})", flush=True)
            worst = max(worst, sweep)
    m, k, n = K1_SLICE
    dt = torch.bfloat16
    a, b = rand(gen, (m, k), dt, device), rand(gen, (k, n), dt, device)
    got = ops.matmul(a, b, block_m=DEFAULT_TILE[0], block_n=DEFAULT_TILE[1],
                     block_k=DEFAULT_TILE[2])
    err = check_close_k1(f"yi-6b ffn_up {K1_SLICE}", got, mm.matmul_blocked_plain(a, b),
                         *K1_TOL[dt])
    print(f"[k1] yi-6b ffn_up (m,k,n)={K1_SLICE} bf16 tile {DEFAULT_TILE} max abs err "
          f"{err:.3e} (rtol/atol 5e-2)", flush=True)
    print("[k1] kernels checked against their plain versions: matmul_blocked "
          "(fp32 CUDA cores, bf16 wgmma)")
    return max(worst, err)


def phase_tune():
    """The tuning loop on the card, through the CLI's ``main``."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "yi-6b", "--backend", "wallclock", "--device", "cuda",
                "--store", str(Path(tmp) / "tune_store.jsonl")]
        mm.launches = fa.launches = 0
        result = tune.main(argv)
        launches = {"matmul": mm.launches, "flash": fa.launches}
    stats, report = result["backend"], result["eval"]
    reps = stats["reps"]
    if stats["verify_failures"] != 0:
        raise SystemExit(f"[tune] {stats['verify_failures']} tiles failed verification")
    for kernel, name in (("matmul", "K1"), ("flash", "K2")):
        measured = stats["measured_by"][kernel]
        if measured == 0 or launches[kernel] < measured * reps:
            raise SystemExit(f"[tune] {launches[kernel]} {name} launches for {measured} "
                             f"measured {kernel} tiles x {reps} reps")
    predicted = result["predicted"]
    flash = {k: t for k, t in predicted.items() if k.endswith("/flash")}
    if (len(predicted) != 14 or len(flash) != 2
            or not all(len(t) == (2 if k in flash else 3) for k, t in predicted.items())):
        raise SystemExit(f"[tune] expected 12 (bm, bn, bk) and 2 (bq, bk) tiles, "
                         f"got {predicted}")
    ov = report["overall"]
    print(f"[tune] eval yi-6b 14 cases (12 GEMM on K1, 2 flash on K2) on the card: "
          f"geomean_speedup_vs_costmodel={ov['geomean_speedup_vs_costmodel']:.4f} "
          f"argmin_hit_rate={ov['argmin_hit_rate']:.4f} "
          f"mean_regret_vs_best={ov['mean_regret_vs_best']:.4f} "
          f"wall_s={result['wall_s']:.1f} measured_tiles={stats['measured']} "
          f"(matmul {stats['measured_by']['matmul']}, flash "
          f"{stats['measured_by']['flash']}) verified={stats['verified']} "
          f"verify_failures={stats['verify_failures']} k1_launches={launches['matmul']} "
          f"k2_launches={launches['flash']}", flush=True)
    cases = {c.label: c for c in zoo_cases(["yi-6b"])}
    for r in report["rows"]:
        m, k, n = (bucket_pow2(x) for x in r["shape"])      # the shape timed
        if r["kernel"] == "flash":
            c = cases[r["label"]]
            m, n = bucket_pow2(c.m), bucket_pow2(c.n)
            flops, nbytes = flash_work(c.batch, m, n, c.heads, c.heads, c.k, c.causal)
            shape = f"(t,d,s)=({m},{k},{n}) heads {c.heads}"
            bound_ms = bound(flops, nbytes)[0]
            extra = f", {bound_ms / (r['t_best'] * 1e3):.4f} of the {bound_ms:.5f} ms bound"
        else:
            flops, shape, extra = 2 * m * k * n, f"(m,k,n)=({m},{k},{n})", ""
        print(f"[tune]   {r['label']:<26} bucket {shape} "
              f"pred={tuple(r['pred'])} {r['t_pred'] * 1e3:.4f} ms, "
              f"cost-model={tuple(r['cost_tile'])} {r['t_cost_model'] * 1e3:.4f} ms, "
              f"best={tuple(r['argmin_tile'])} {r['t_best'] * 1e3:.4f} ms "
              f"({flops / r['t_best'] / 1e12:.2f} TFLOP/s{extra})")
    row = next(r for r in report["rows"] if r["label"] == "yi-6b/train_4k/ffn_up")
    return launches, tuple(row["argmin_tile"])


def phase_k1_timing(device, best_tile):
    m, k, n = K1_SLICE
    gen = torch.Generator(device=device).manual_seed(3)
    a = rand(gen, (m, k), torch.bfloat16, device)
    b = rand(gen, (k, n), torch.bfloat16, device)
    tiles = {"default": DEFAULT_TILE, "best": tuple(best_tile), "shallow": SHALLOW_TILE}
    ms = {}
    for key, (bm, bn, bk) in tiles.items():
        ms[key] = time_ms(lambda: ops.matmul(a, b, block_m=bm, block_n=bn,
                                             block_k=bk), iters=20, warmup=3)
    plain_ms = time_ms(lambda: mm.matmul_blocked_plain(a, b), iters=5, warmup=1)
    library_ms = time_ms(lambda: torch.matmul(a, b), iters=20, warmup=3)
    flops = 2 * m * n * k
    nbytes = (m * k + k * n + m * n) * a.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    tflops = flops / ms["best"] / 1e9
    share = bound_ms / ms["best"]
    print(f"[k1-timing] (m,k,n)={K1_SLICE} bf16: kernel_ms={ms['best']:.4f} at best "
          f"tile {tiles['best']} ({tflops:.2f} TFLOP/s, {share:.4f} of the bound), "
          f"{ms['default']:.4f} at default tile {DEFAULT_TILE} "
          f"({flops / ms['default'] / 1e9:.2f} TFLOP/s), {ms['shallow']:.4f} at "
          f"{SHALLOW_TILE} ({flops / ms['shallow'] / 1e9:.2f} TFLOP/s, "
          f"{bound_ms / ms['shallow']:.4f} of the bound); plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (torch.matmul, {flops / library_ms / 1e9:.2f} "
          f"TFLOP/s, {bound_ms / library_ms:.4f} of the bound) bound_ms={bound_ms:.5f} "
          f"by {bound_by} ({nbytes / 1e6:.1f} MB -> {t_bytes:.5f} ms, "
          f"{flops / 1e9:.1f} GFLOP -> {t_ops:.5f} ms)", flush=True)
    return dict(ms=ms["best"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, tile=list(tiles["best"]),
                default_tile_ms=ms["default"], shallow_tile_ms=ms["shallow"],
                tflops=tflops, share_of_bound=share)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device, smi = phase_probe()
    phase_build()
    q, k, v, err = phase_kernel(device)
    times = phase_timing(q, k, v, device)
    del q, k, v
    torch.cuda.empty_cache()
    phase_model(device)
    launches = phase_serve()
    k1_err = phase_k1(device)
    tune_launches, best_tile = phase_tune()
    k1_times = phase_k1_timing(device, best_tile)
    record = {"kernels": [
        # the times are the bf16 kernel's at the serving shape (train_4k
        # beside them); the fp32 kernel and the C entry point that picks
        # between them are in flash_attention.cu (phase 3).  launches: the
        # serve run's (phase 6); tune_launches: the tune run's (phase 8)
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_wgmma.cuh",
             fp32_source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=launches, tune_launches=tune_launches["flash"],
             max_abs_err=err, **times),
        # the times are the bf16 kernel's; the fp32 kernel and the C entry
        # point that picks between them are in matmul_blocked.cu (phase 7)
        dict(name="matmul_blocked", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_wgmma.cuh",
             fp32_source="src/repro_torch/kernels/csrc/matmul_blocked.cu",
             replaces="src/repro/kernels/matmul_blocked.py:20",
             launches=tune_launches["matmul"], max_abs_err=k1_err, **k1_times)]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
