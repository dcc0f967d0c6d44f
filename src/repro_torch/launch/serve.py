"""Batched serving driver: prefill a prompt batch, decode with KV caches.

Prefill runs every attention layer on the flash-attention kernel; decode
attends each new token against its KV caches (full, or a ring for a
windowed layer) and steps an SSM layer's recurrent state.  ``--preset full`` serves the
architecture at its published widths and depth; the other presets scale the
reduced config, as the JAX package's driver does.

    PYTHONPATH=src python -m repro_torch serve --arch yi-6b --preset full
    PYTHONPATH=src python -m repro_torch serve --arch hymba-1.5b --preset full
    PYTHONPATH=src python -m repro_torch serve --preset small --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import transformer as tfm
from repro_torch.weights import init_params


def scale_config(cfg, *, d_model=256, n_layers=4, vocab=2048, heads=4):
    """Blow a reduced config up/down to a target demo scale."""
    kinds = tuple(cfg.kinds[i % cfg.n_layers] for i in range(n_layers))
    wins = tuple(cfg.layer_windows[i % cfg.n_layers] for i in range(n_layers))
    moes = tuple(cfg.layer_moe[i % cfg.n_layers] for i in range(n_layers))
    return cfg.replace(n_layers=n_layers, d_model=d_model, vocab=vocab,
                       n_heads=heads, n_kv_heads=min(cfg.n_kv_heads, heads),
                       d_head=d_model // heads, d_ff=4 * d_model,
                       dense_d_ff=4 * d_model if cfg.dense_d_ff else 0,
                       layer_kinds=kinds, windows=wins, moe_layers=moes)


PRESETS = {
    "small": dict(d_model=256, n_layers=4, vocab=2048),    # ~5M params
    "100m": dict(d_model=768, n_layers=12, vocab=16384),   # ~110M params
}
FULL = "full"                      # get_config(arch) as published, unscaled


def build_config(arch: str, preset: str):
    if preset == FULL:
        return get_config(arch)
    return scale_config(reduced_config(arch), **PRESETS[preset])


def sample(logits, generator: torch.Generator, temperature: float):
    if temperature <= 0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@dataclass
class Generation:
    tokens: torch.Tensor           # [B, gen_len]
    logits: list                   # per step, the [B, V] logits sampled from
    prefill_s: float
    decode_s: float


@torch.inference_mode()
def generate(cfg, params, prompts, *, gen_len: int, temperature: float,
             generator: torch.Generator) -> Generation:
    """Prefill ``prompts`` [B,T] with flash attention, then decode greedily
    (``temperature`` 0) or by sampling until ``gen_len`` tokens exist."""
    device = prompts.device
    capacity = prompts.shape[1] + gen_len + cfg.meta_tokens + 1

    t0 = time.perf_counter()
    last_logits, cache = tfm.prefill(cfg, params, prompts, use_flash=True)
    cache = tfm.grow_cache(cfg, cache, capacity)
    synchronize(device)
    t_prefill = time.perf_counter() - t0

    step_logits = [last_logits[:, -1]]
    tok = sample(step_logits[-1], generator, temperature)
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, cache = tfm.decode_step(cfg, params, cache, tok[:, None])
        step_logits.append(logits[:, -1])
        tok = sample(step_logits[-1], generator, temperature)
        generated.append(tok)
    synchronize(device)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(generated, dim=1), step_logits,
                      t_prefill, t_decode)


def main(argv=None, report: dict | None = None):
    """Serve one batch and return the generated tokens [batch, gen_len].

    If ``report`` is given, it is filled with the run's prefill_ms,
    decode_ms_per_step, tokens_per_s and whether every step's logits were
    finite (logits_finite).
    """
    ap = argparse.ArgumentParser(prog="python -m repro_torch serve")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="small",
                    choices=sorted([*PRESETS, FULL]))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back on its own")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_config(args.arch, args.preset)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator, device)
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(2, cfg.vocab, (args.batch, args.prompt_len))).to(device)

    gen = generate(cfg, params, prompts, gen_len=args.gen_len,
                   temperature=args.temperature, generator=generator)

    n_new = args.gen_len * args.batch
    decode_ms = gen.decode_s / max(args.gen_len - 1, 1) * 1e3
    tok_s = n_new / max(gen.decode_s, 1e-9)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill={gen.prefill_s*1e3:.1f}ms "
          f"decode={decode_ms:.2f}ms/step "
          f"throughput={tok_s:.1f} tok/s")
    out = gen.tokens
    if out.shape != (args.batch, args.gen_len):
        raise RuntimeError(f"generated shape {tuple(out.shape)}, expected "
                           f"{(args.batch, args.gen_len)}")
    if not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise RuntimeError("generated a token outside [0, vocab)")
    print("[serve] sample row:", out[0, :16].tolist())
    if report is not None:
        report.update(
            prefill_ms=gen.prefill_s * 1e3, decode_ms_per_step=decode_ms,
            tokens_per_s=tok_s,
            logits_finite=all(bool(torch.isfinite(lg).all()) for lg in gen.logits))
    return out


if __name__ == "__main__":
    main()
