"""Attention: GQA over the full sequence (prefill) and one decode step.

The full-sequence path either calls the flash-attention kernel
(``use_flash=True``) or computes softmax attention in plain torch, as the
JAX package computes it outside any kernel.  Decode attends one new token
against a full KV cache, or a ring cache of capacity ``window`` for a
sliding-window layer, with an optional never-evicted prefix (meta tokens).
MLA is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, apply_rope, causal_window_mask


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def gqa_spec(cfg: ModelConfig, lead: tuple = ()):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    return {
        "wq": ParamSpec(lead + (d, h, hd), la + ("embed", "heads", "head_dim"), dt),
        "wk": ParamSpec(lead + (d, kv, hd), la + ("embed", "kv", "head_dim"), dt),
        "wv": ParamSpec(lead + (d, kv, hd), la + ("embed", "kv", "head_dim"), dt),
        "wo": ParamSpec(lead + (h, hd, d), la + ("heads", "head_dim", "embed_out"), dt),
    }


# ---------------------------------------------------------------------------
# Core softmax attention
# ---------------------------------------------------------------------------

# above this many score elements per (batch, head), full-sequence attention
# walks the queries in chunks so [T,S] probabilities are never whole
_CHUNK_THRESHOLD = 32 * 1024 * 1024
_CHUNK_Q = 1024


def _attend(q, k, v, positions, window, n_meta, scale):
    """Full-sequence attention, chunked over queries when the scores are large."""
    t, s = q.shape[1], k.shape[1]
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    if t * s < _CHUNK_THRESHOLD:
        mask = causal_window_mask(positions, positions, window, n_meta)
        return _sdpa(q, k, v, mask[None], scale)
    outs = []
    for c in range(0, t, _CHUNK_Q):
        mask = causal_window_mask(positions[c:c + _CHUNK_Q], positions,
                                  window, n_meta)
        outs.append(_sdpa(q[:, c:c + _CHUNK_Q], k, v, mask[None], scale))
    return torch.cat(outs, dim=1)


def _sdpa(q, k, v, mask, scale):
    """q:[B,T,H,dh] k,v:[B,S,KV,dh] (KV divides H); mask:[1,T,S] bool."""
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    scores = scores.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


# ---------------------------------------------------------------------------
# GQA: full-sequence path
# ---------------------------------------------------------------------------

def gqa_forward(p, x, positions, *, window: int, theta: float, n_meta: int,
                return_kv: bool = False, use_flash: bool = False):
    """x: [B,T,D]; positions: [T] absolute. Returns y (and optionally (k, v))."""
    dh = p["wq"].shape[-1]
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    q = apply_rope(q, positions, theta)
    k = apply_rope(k, positions, theta)
    if use_flash:
        y = ops.flash_attention(q, k, v, window=window, n_meta=n_meta,
                                scale=dh ** -0.5)
    else:
        y = _attend(q, k, v, positions, window, n_meta, dh ** -0.5)
    out = torch.einsum("bthk,hkd->btd", y, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# GQA: decode path (full or ring cache, optional static prefix)
# ---------------------------------------------------------------------------

def gqa_decode(p, x, cache, pos: int, *, window: int, theta: float, n_meta: int):
    """x: [B,1,D]; cache: {"k","v": [B,S,KV,dh], optional "k_pre","v_pre"};
    ``pos`` the new token's absolute position.

    For windowed layers the cache is a ring buffer of capacity ``window``;
    otherwise capacity is the max sequence length and slot == pos.  The JAX
    version returns an updated copy of the cache.  This one writes the new
    key and value into ``cache`` in place at the slot (no copy of the whole
    cache per step) and returns the same tensors.
    """
    dh = p["wq"].shape[-1]
    positions = torch.arange(pos, pos + 1, device=x.device)   # no host copy
    q = apply_rope(torch.einsum("btd,dhk->bthk", x, p["wq"]), positions, theta)
    k_new = apply_rope(torch.einsum("btd,dhk->bthk", x, p["wk"]), positions, theta)
    v_new = torch.einsum("btd,dhk->bthk", x, p["wv"])

    k, v = cache["k"], cache["v"]
    cap = k.shape[1]
    slot = pos % cap if window > 0 else pos
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]

    n_prefix = cache["k_pre"].shape[1] if "k_pre" in cache else 0
    idx = torch.arange(cap, device=x.device)
    if window > 0:
        age = torch.remainder(slot - idx, cap)       # 0 == just written
        # ring slots are valid iff their absolute position (pos - age) has
        # been written; prefix positions live in k_pre, never in the ring
        valid = age <= pos - n_prefix
    else:
        valid = idx <= pos
    mask = valid[None, None, :]                      # [1,1,S]

    if "k_pre" in cache:                             # never-evicted prefix (meta)
        k_all = torch.cat([cache["k_pre"], k], dim=1)
        v_all = torch.cat([cache["v_pre"], v], dim=1)
        pre = torch.ones((1, 1, n_prefix), dtype=torch.bool, device=x.device)
        mask = torch.cat([pre, mask], dim=-1)
    else:
        k_all, v_all = k, v

    y = _sdpa(q, k_all, v_all, mask, dh ** -0.5)
    out = torch.einsum("bthk,hkd->btd", y, p["wo"])
    return out, cache
