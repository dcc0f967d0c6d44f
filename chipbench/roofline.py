"""The benchmark's yardstick: the H100's published peaks, and the operations
and bytes each measured piece of work needs, computed from shapes alone.

A frozen copy of the arithmetic that ``chip_smoke.py`` holds to a hand count
(``model_flops``, ``matmul_params``, ``attention_flops``, ``flash_work``,
``bound``) and of ``live_pairs`` (``kernels/flash_attention.py``), for the
dense decoders the benchmark runs.  The program is never asked: a later
change to it cannot move what a metric divides by.

``cfg`` is a ``chipbench.common.Dims``: layers, widths and vocabulary.
"""
from __future__ import annotations

import numpy as np

# one NVIDIA H100 SXM, dense rates (NVIDIA's data sheet), at 700 W
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations over
    the bf16 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES_PER_S)


def live_pairs(t: int, s: int, *, window: int = 0, n_meta: int = 0,
               causal: bool = True) -> int:
    """(query, key) pairs one (batch, head) attends: under the causal mask
    row r sees the keys up to its own (right-aligned for T < S), a window
    keeps the ``window`` latest of them and the ``n_meta`` first beside
    them; without the mask every pair."""
    if not causal:
        return t * s
    hi = np.maximum(0, np.arange(t, dtype=np.int64) + s - t + 1)
    lo = np.maximum(0, hi - window) if window else np.zeros_like(hi)
    return int((hi - lo + np.minimum(n_meta, lo)).sum())


def layer_matmul_params(cfg) -> int:
    """Parameters of one decoder layer that enter a matrix product at each
    position: the q, k, v and output projections and the gated MLP."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f


def matmul_params(cfg) -> int:
    """``chip_smoke.py``'s count for a dense decoder: every parameter but the
    embedding table (a lookup), so the layers' products, the head, and the
    norms' scales beside them (0.005 % of Yi-6B's)."""
    d = cfg.d_model
    return cfg.n_layers * (layer_matmul_params(cfg) + 2 * d) + d + d * cfg.vocab


def attention_flops(cfg, batch: int, t: int, s: int | None = None) -> float:
    """One layer's forward attention products over the live (query, key)
    pairs of ``batch`` causal sequences of ``t`` queries against ``s`` keys
    (default ``t``): a d-long dot product and a d-long update a pair and
    head, 2 flops a multiply-add."""
    live = live_pairs(t, t if s is None else s)
    return 2 * batch * cfg.n_heads * live * (2 * cfg.head_dim)


def train_step_flops(cfg, seq: int, batch: int) -> float:
    """A train step's model FLOPs at ``batch`` sequences of ``seq``
    positions: 6 x the matmul parameters a position and 3 x the forward's
    attention products in every layer (remat's recomputation not
    counted)."""
    return (6 * matmul_params(cfg) * seq * batch
            + 3 * cfg.n_layers * attention_flops(cfg, batch, seq))


def prefill_flops(cfg, t: int) -> float:
    """The FLOPs a prefill of one ``t``-token prompt needs: 2 x the layers'
    matmul parameters a position, the attention products, and the head at
    the last position only (the first token needs no other logits)."""
    return (2 * cfg.n_layers * layer_matmul_params(cfg) * t
            + cfg.n_layers * attention_flops(cfg, 1, t)
            + 2 * cfg.d_model * cfg.vocab)


def decode_step_work(cfg, batch: int, pos: int) -> tuple[float, float]:
    """(flops, bytes) one decode step of ``batch`` sessions needs, each
    session's new token at position ``pos`` attending ``pos + 1`` keys:
    flops 2 x the matmul parameters a token and the attention products;
    bytes every weight read once (the embedding's ``batch`` rows only),
    the live cache read once and the new keys and values written (bf16)."""
    d, kv, hd, L = cfg.d_model, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    flops = 2 * matmul_params(cfg) * batch + L * 2 * batch * cfg.n_heads * (pos + 1) * 2 * hd
    weights = matmul_params(cfg) * 2 + batch * d * 2
    cache = L * 2 * batch * (pos + 1) * kv * hd * 2    # pos read, the new one written
    return flops, weights + cache


def flash_fwd_work(b: int, t: int, s: int, h: int, kv: int, d: int) -> tuple[float, float]:
    """(flops, bytes) K2's causal forward needs: each live pair a d-long dot
    product and a d-long update, 2 flops a multiply-add; q, k, v read once
    and o written once (bf16)."""
    live = live_pairs(t, s)
    return 4 * d * live * b * h, (2 * b * t * h + 2 * b * s * kv) * d * 2


def flash_bwd_work(b: int, t: int, h: int, kv: int, d: int) -> tuple[float, float]:
    """(flops, bytes) K2 bwd needs at a causal self-attention shape: 2.5 x
    the forward's products (S recomputed, dV, dP, dK, dQ); q, o, dO, k, v
    and the fp32 lse read once, dq, dk, dv written once (bf16)."""
    fwd, _ = flash_fwd_work(b, t, t, h, kv, d)
    nbytes = (2 * (3 * b * t * h * d + 2 * b * t * kv * d)
              + 4 * b * h * t
              + 2 * (b * t * h * d + 2 * b * t * kv * d))
    return 2.5 * fwd, nbytes
