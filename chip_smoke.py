#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. probe     card name, power limit and capability; TF32 off for fp32 checks
  2. build     nvcc builds the flash-attention kernel from csrc/
  3. kernel    kernel against its plain torch version, both on the card
  4. timing    kernel, plain version and the SDPA yardstick at the serving shape
  5. model     Yi-6B widths, 2 layers, fp32: model_forward flash vs plain
  6. serve     Yi-6B at full width and depth, bf16: 8 x 512-token prompts,
               32 generated tokens, through ``repro_torch.launch.serve.main``
The last three lines are the ``nvidia-smi`` name/power-limit line, the
kernels' JSON record and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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


def phase_build():
    t0 = time.perf_counter()
    _build.build(fa.SOURCE)
    print(f"[build] {fa.SOURCE}: {time.perf_counter() - t0:.1f}s", flush=True)
    for line in _build.build_logs.get(fa.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


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
    record = {"kernels": [dict(
        name="flash_attention_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:32",
        launches=launches, max_abs_err=err, **times)]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
