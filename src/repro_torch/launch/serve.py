"""Batched serving driver: prefill a prompt batch, decode with KV caches.

Prefill runs every attention layer on the flash-attention kernel; decode
attends each new token against its KV caches (full, or a ring for a
windowed layer) and steps an SSM layer's recurrent state.  A vision
config's prompts carry an image prefix (precomputed patch embeddings drawn
from the seed); an audio config's prompts and new tokens are K codebook
streams.  ``--preset full`` serves the
architecture at its published widths and depth; the other presets scale the
reduced config, as the JAX package's driver does.

    PYTHONPATH=src python -m repro_torch serve --arch yi-6b --preset full
    PYTHONPATH=src python -m repro_torch serve --arch hymba-1.5b --preset full
    PYTHONPATH=src python -m repro_torch serve --arch h2o-danube-3-4b --preset full \
        --prompt-len 6144 --batch 2
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
    """Tokens [B] from logits [B,V], or [B,K] from [B,K,V] (K codebooks,
    drawn as B * K rows, as the JAX package draws them)."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    rows = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(rows, 1, generator=generator)[:, 0].reshape(probs.shape[:-1])


def draw_inputs(cfg, batch: int, prompt_len: int, rng: np.random.Generator, device=None):
    """Prompts [batch, prompt_len] ([batch, K, prompt_len] for K codebooks)
    in [2, vocab) and, for a vision config, image embeddings N(0, 0.02)
    [batch, image_tokens, d_model] in fp32 (else None), as the JAX
    package's ``serve.main`` draws them: numpy arrays, or tensors on
    ``device`` where one is given."""
    shape = ((batch, cfg.n_codebooks, prompt_len) if cfg.n_codebooks > 1
             else (batch, prompt_len))
    prompts = rng.integers(2, cfg.vocab, shape)
    image = None
    if cfg.frontend == "vision":
        image = rng.normal(0, 0.02, (batch, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    if device is None:
        return prompts, image
    return (torch.from_numpy(prompts).to(device),
            None if image is None else torch.from_numpy(image).to(device))


@dataclass
class Generation:
    tokens: torch.Tensor           # [B, gen_len], or [B, K, gen_len] for K codebooks
    logits: list                   # per step, the [B, V] (or [B, K, V]) logits sampled from
    prefill_s: float
    decode_s: float


@torch.inference_mode()
def generate(cfg, params, prompts, *, gen_len: int, temperature: float,
             generator: torch.Generator, image_embeds=None) -> Generation:
    """Prefill ``prompts`` [B,T] ([B,K,T] for K codebooks, after a vision
    config's ``image_embeds`` [B,P,D]) with flash attention, then decode
    greedily (``temperature`` 0) or by sampling until ``gen_len`` tokens
    exist."""
    device = prompts.device
    n_image = image_embeds.shape[1] if image_embeds is not None else 0
    capacity = prompts.shape[-1] + gen_len + cfg.meta_tokens + n_image + 1

    t0 = time.perf_counter()
    last_logits, cache = tfm.prefill(cfg, params, prompts, image_embeds, use_flash=True)
    cache = tfm.grow_cache(cfg, cache, capacity)
    synchronize(device)
    t_prefill = time.perf_counter() - t0

    step_logits = [last_logits[:, -1]]
    tok = sample(step_logits[-1], generator, temperature)
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, cache = tfm.decode_step(cfg, params, cache, tok[..., None])
        step_logits.append(logits[:, -1])
        tok = sample(step_logits[-1], generator, temperature)
        generated.append(tok)
    synchronize(device)
    t_decode = time.perf_counter() - t0
    return Generation(torch.stack(generated, dim=-1), step_logits,
                      t_prefill, t_decode)


def main(argv=None, report: dict | None = None):
    """Serve one batch and return the generated tokens [batch, gen_len]
    (codebook 0's stream for K codebooks, as the JAX package's ``main``).

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
    prompts, image_embeds = draw_inputs(cfg, args.batch, args.prompt_len,
                                        np.random.default_rng(args.seed), device)

    gen = generate(cfg, params, prompts, gen_len=args.gen_len,
                   temperature=args.temperature, generator=generator,
                   image_embeds=image_embeds)

    n_new = args.gen_len * args.batch
    decode_ms = gen.decode_s / max(args.gen_len - 1, 1) * 1e3
    tok_s = n_new / max(gen.decode_s, 1e-9)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill={gen.prefill_s*1e3:.1f}ms "
          f"decode={decode_ms:.2f}ms/step "
          f"throughput={tok_s:.1f} tok/s")
    out = gen.tokens[:, 0] if cfg.n_codebooks > 1 else gen.tokens
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
