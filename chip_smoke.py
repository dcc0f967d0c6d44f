#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. probe     card name, power limit and capability; TF32 off for fp32 checks
  2. build     nvcc builds both kernels from csrc/, one process per source,
               and prints each kernel's registers and spills (a spill fails)
  3. kernel    flash attention against its plain torch version on the card
  4. timing    flash kernel, plain version and the SDPA yardstick at the
               serving shape
  5. model     Yi-6B widths, 2 layers, fp32: model_forward flash vs plain
  6. serve     Yi-6B at full width and depth, bf16: 8 x 512-token prompts,
               32 generated tokens, through ``repro_torch.launch.serve.main``
  7. k1        blocked matmul against its plain version on the card: every
               compiled tile at bk 16/64/256, the JAX tests' shapes, a ragged
               shape and Yi-6B's ffn_up shape
  8. tune      ``python -m repro_torch tune --arch yi-6b --backend wallclock``
               through its ``main``: every candidate tile of Yi-6B's 12 GEMM
               cases timed on the card, the measured tuner fitted, the
               evaluation table written (store in a temporary directory)
  9. k1-timing blocked matmul at (4096, 4096, 11008) bf16 with the default
               tile and the best tile phase 8 measured, beside its plain
               version, torch.matmul and the bound
The last three lines are the ``nvidia-smi`` name/power-limit line, the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
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
    """'matmul_blocked_kernel<bf16,128,64>' from the mangled template name."""
    ints = re.findall(r"Li(\d+)E", mangled)
    dtype = "bf16" if "bfloat16" in mangled else "fp32"
    found = re.search(r"([a-z_]+_kernel)I", mangled)
    base = found.group(1) if found else mangled
    return f"{base}<{','.join([dtype] + ints)}>"


def phase_build():
    t0 = time.perf_counter()
    _build.build_many([fa.SOURCE, mm.SOURCE])
    print(f"[build] {fa.SOURCE} and {mm.SOURCE} in parallel: "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    spills = []
    for source in (fa.SOURCE, mm.SOURCE):
        report = _build.ptxas_report(_build.build_logs.get(source, ""))
        for name, info in sorted(report.items(), key=lambda kv: _short_name(kv[0])):
            regs = info.get("registers")
            st, ld = info.get("spill_stores", 0), info.get("spill_loads", 0)
            print(f"[build]   {source}: {_short_name(name):<40} "
                  f"registers {regs} spill stores {st} loads {ld}")
            if st or ld:
                spills.append(_short_name(name))
    if spills:
        raise SystemExit(f"[build] register spills in {spills}")
    tiles = mm.compiled_tiles()
    if sorted(tiles) != sorted(mm.INSTANTIATED):
        raise SystemExit(f"[build] compiled tiles {tiles} differ from the rule's "
                         f"{mm.INSTANTIATED}")
    print(f"[build] {mm.SOURCE}: {len(tiles)} tiles x 2 dtypes compiled, no spills",
          flush=True)


def phase_kernel(device):
    gen = torch.Generator(device=device).manual_seed(0)
    for name, b, t, s, h, kv, d, win, meta, causal in CASES:
        for dtype, tol in TOL.items():
            q, k, v = qkv(gen, b, t, s, h, kv, d, dtype, device)
            got = ops.flash_attention(q, k, v, window=win, n_meta=meta,
                                      causal=causal, block_q=32, block_k=32)
            want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5, window=win,
                                            n_meta=meta, causal=causal)
            err = check_close(f"{name} {dtype}", got, want, tol)
            print(f"[kernel] {name:<18} {str(dtype):<15} max abs err {err:.3e} "
                  f"(tol {tol})")
    # the blocks are a tuning knob and must not change the result
    q, k, v = qkv(gen, 1, 128, 128, 4, 4, 32, torch.float32, device)
    outs = [ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
            for bq, bk in [(32, 32), (64, 32), (32, 64), (128, 128)]]
    for o in outs[1:]:
        err = check_close("block-size invariance", o, outs[0], 1e-5)
    print(f"[kernel] block-size invariance max abs err {err:.3e} (tol 1e-05)")
    # the serving shape itself
    dt = torch.bfloat16
    q, k, v = qkv(gen, SLICE["B"], SLICE["T"], SLICE["T"], SLICE["H"],
                  SLICE["KV"], SLICE["d"], dt, device)
    got = ops.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v, scale=SLICE["d"] ** -0.5)
    err = check_close("serving shape", got, want, TOL[dt])
    print(f"[kernel] serving shape q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
          f"max abs err {err:.3e} (tol {TOL[dt]})", flush=True)
    print("[kernel] kernels checked against their plain versions: flash_attention_fwd")
    return q, k, v, err


def phase_timing(q, k, v):
    b, t, h, d = q.shape
    s = k.shape[1]
    scale = d ** -0.5
    kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, scale=scale))
    # the yardstick takes [B,H,T,d]; the copies are made outside the timing
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    library_ms = time_ms(sdpa)
    lib_err = (sdpa().transpose(1, 2).float()
               - fa.flash_attention_plain(q, k, v, scale=scale).float()).abs().max().item()
    # the work this causal run needs: each live (query, key) pair costs a
    # d-long dot product and a d-long update, 2 flops per multiply-add
    qpos = torch.arange(t, device=q.device)[:, None] + (s - t)
    live = int((torch.arange(s, device=q.device)[None, :] <= qpos).sum())
    flops = 4 * d * live * b * h
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    print(f"[timing] kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (sdpa max abs err vs plain {lib_err:.3e}) "
          f"bound_ms={bound_ms:.5f} by {bound_by} "
          f"({nbytes / 1e6:.1f} MB -> {t_bytes:.5f} ms, "
          f"{flops / 1e9:.2f} GFLOP -> {t_ops:.5f} ms)", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


# K1 checks: the JAX package's kernel-test shapes (m, k, n), a ragged one,
# fp32 at its 1e-4 rtol / 1e-3 atol and bf16 at 5e-2
K1_SHAPES = [(128, 128, 128), (256, 128, 64), (100, 60, 36), (32, 512, 96),
             (1000, 300, 777)]
K1_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (5e-2, 5e-2)}
K1_BKS = (16, 64, 256)
K1_SLICE = (4096, 4096, 11008)         # Yi-6B ffn_up at train_4k, bf16
DEFAULT_TILE = (128, 128, 128)


def check_close_k1(name, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    excess = (err - (atol + rtol * want.abs())).max().item()
    if not (excess <= 0 and torch.isfinite(got).all()):
        raise SystemExit(f"[k1] {name}: max abs err {err.max().item():.3e} over "
                         f"rtol {rtol} atol {atol}")
    return err.max().item()


def phase_k1(device):
    gen = torch.Generator(device=device).manual_seed(2)
    worst = 0.0
    for dtype, (rtol, atol) in K1_TOL.items():
        for m, k, n in K1_SHAPES:
            a, b = rand(gen, (m, k), dtype, device), rand(gen, (k, n), dtype, device)
            want = mm.matmul_blocked_plain(a, b)
            got = ops.matmul(a, b, block_m=64, block_n=64, block_k=64)
            err = check_close_k1(f"({m},{k},{n}) {dtype}", got, want, rtol, atol)
            worst = max(worst, err)
            print(f"[k1] ({m},{k},{n}) {str(dtype):<15} blocks 64 max abs err "
                  f"{err:.3e} (rtol {rtol} atol {atol})")
        # every compiled tile at every bk on the ragged shape; the fp32 sums
        # run in the same k order in every tile, so the results agree exactly
        m, k, n = K1_SHAPES[-1]
        a, b = rand(gen, (m, k), dtype, device), rand(gen, (k, n), dtype, device)
        want = mm.matmul_blocked_plain(a, b)
        first, ran, refused, sweep = None, 0, 0, 0.0
        for bm, bn in mm.INSTANTIATED:
            for bk in K1_BKS:
                if not mm.fits(bm, bn, bk, a.element_size()):
                    try:
                        ops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                    except ValueError:
                        refused += 1
                        continue
                    raise SystemExit(f"[k1] infeasible tile {(bm, bn, bk)} did not raise")
                got = ops.matmul(a, b, block_m=bm, block_n=bn, block_k=bk)
                sweep = max(sweep, check_close_k1(f"tile {(bm, bn, bk)} {dtype}",
                                                  got, want, rtol, atol))
                if first is None:
                    first = got
                elif not torch.equal(got, first):
                    raise SystemExit(f"[k1] tile {(bm, bn, bk)} {dtype} differs from "
                                     "the first tile's result")
                ran += 1
        print(f"[k1] ({m},{k},{n}) {str(dtype):<15} {ran} (tile, bk) launches "
              f"agree with plain and bit for bit with each other; {refused} "
              f"infeasible ones raised ValueError; max abs err {sweep:.3e}", flush=True)
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
    print("[k1] kernels checked against their plain versions: matmul_blocked")
    return max(worst, err)


def phase_tune():
    """The tuning loop on the card, through the CLI's ``main``."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "yi-6b", "--backend", "wallclock", "--device", "cuda",
                "--store", str(Path(tmp) / "tune_store.jsonl")]
        mm.launches = 0
        result = tune.main(argv)
        launches = mm.launches
    stats, report = result["backend"], result["eval"]
    measured, reps = stats["measured"], stats["reps"]
    if stats["verify_failures"] != 0:
        raise SystemExit(f"[tune] {stats['verify_failures']} tiles failed verification")
    if measured == 0 or launches < measured * reps:
        raise SystemExit(f"[tune] {launches} K1 launches for {measured} measured "
                         f"tiles x {reps} reps")
    predicted = result["predicted"]
    if len(predicted) != 12 or not all(len(t) == 3 for t in predicted.values()):
        raise SystemExit(f"[tune] expected a tile for each of 12 cases, got {predicted}")
    ov = report["overall"]
    print(f"[tune] eval yi-6b 12 GEMM cases on the card: "
          f"geomean_speedup_vs_costmodel={ov['geomean_speedup_vs_costmodel']:.4f} "
          f"argmin_hit_rate={ov['argmin_hit_rate']:.4f} "
          f"mean_regret_vs_best={ov['mean_regret_vs_best']:.4f} "
          f"wall_s={result['wall_s']:.1f} measured_tiles={measured} "
          f"verified={stats['verified']} verify_failures={stats['verify_failures']} "
          f"k1_launches={launches}", flush=True)
    for r in report["rows"]:
        m, k, n = (bucket_pow2(x) for x in r["shape"])      # the shape timed
        print(f"[tune]   {r['label']:<26} bucket (m,k,n)=({m},{k},{n}) "
              f"pred={tuple(r['pred'])} {r['t_pred'] * 1e3:.4f} ms, "
              f"cost-model={tuple(r['cost_tile'])} {r['t_cost_model'] * 1e3:.4f} ms, "
              f"best={tuple(r['argmin_tile'])} {r['t_best'] * 1e3:.4f} ms "
              f"({2 * m * k * n / r['t_best'] / 1e12:.2f} TFLOP/s)")
    row = next(r for r in report["rows"] if r["label"] == "yi-6b/train_4k/ffn_up")
    return launches, tuple(row["argmin_tile"])


def phase_k1_timing(device, best_tile):
    m, k, n = K1_SLICE
    gen = torch.Generator(device=device).manual_seed(3)
    a = rand(gen, (m, k), torch.bfloat16, device)
    b = rand(gen, (k, n), torch.bfloat16, device)
    tiles = {"default": DEFAULT_TILE, "best": tuple(best_tile)}
    ms = {}
    for key, (bm, bn, bk) in tiles.items():
        ms[key] = time_ms(lambda: ops.matmul(a, b, block_m=bm, block_n=bn,
                                             block_k=bk), iters=5, warmup=1)
    plain_ms = time_ms(lambda: mm.matmul_blocked_plain(a, b), iters=5, warmup=1)
    library_ms = time_ms(lambda: torch.matmul(a, b), iters=20, warmup=3)
    flops = 2 * m * n * k
    nbytes = (m * k + k * n + m * n) * a.element_size()
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
    print(f"[k1-timing] (m,k,n)={K1_SLICE} bf16: kernel_ms={ms['best']:.4f} at best "
          f"tile {tiles['best']}, {ms['default']:.4f} at default tile {DEFAULT_TILE}; "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (torch.matmul) "
          f"bound_ms={bound_ms:.5f} by {bound_by} ({nbytes / 1e6:.1f} MB -> "
          f"{t_bytes:.5f} ms, {flops / 1e9:.1f} GFLOP -> {t_ops:.5f} ms); "
          f"{flops / ms['best'] / 1e9:.2f} TFLOP/s", flush=True)
    return dict(ms=ms["best"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, tile=list(tiles["best"]),
                default_tile_ms=ms["default"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device, smi = phase_probe()
    phase_build()
    q, k, v, err = phase_kernel(device)
    times = phase_timing(q, k, v)
    del q, k, v
    phase_model(device)
    launches = phase_serve()
    k1_err = phase_k1(device)
    k1_launches, best_tile = phase_tune()
    k1_times = phase_k1_timing(device, best_tile)
    record = {"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=launches, max_abs_err=err, **times),
        dict(name="matmul_blocked", route="cuda",
             source="src/repro_torch/kernels/csrc/matmul_blocked.cu",
             replaces="src/repro/kernels/matmul_blocked.py:20",
             launches=k1_launches, max_abs_err=k1_err, **k1_times)]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
