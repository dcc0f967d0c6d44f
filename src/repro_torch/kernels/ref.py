"""Plain-torch oracles for every kernel (the correctness references)."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def flash_attention_ref(q, k, v, *, window: int = 0, n_meta: int = 0,
                        scale: float | None = None, causal: bool = True):
    """q,k,v: [B,T,H,dh] (H == KV heads; repeat kv outside for GQA)."""
    t, s = q.shape[1], k.shape[1]
    qpos = torch.arange(t, device=q.device) + (s - t)      # right-aligned for t < s
    return _attend(q, k, v, qpos, window=window, n_meta=n_meta, scale=scale,
                   causal=causal)


def _attend(q, k, v, qpos, *, window, n_meta, scale, causal):
    """The oracle for query rows at key positions ``qpos``."""
    dh = q.shape[3]
    s = k.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    qpos = qpos[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((len(qpos), s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        in_win = (qpos - kpos) < window
        mask &= in_win | (kpos < n_meta)
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)


def flash_attention_ref_chunked(q, k, v, *, window: int = 0, n_meta: int = 0,
                                scale: float | None = None, causal: bool = True,
                                max_scores: int = 1 << 28):
    """``flash_attention_ref`` over chunks of query rows, so that no chunk's
    fp32 score tensor holds more than ``max_scores`` elements: the whole
    one at Yi-6B's 32k prefill would be 137 GB.  Every row is covered, at
    its own position (rows ``[r0, r1)`` sit at keys ``r0 + S - T`` on).
    Under the causal mask such a chunk sees only keys below ``r1 + S - T``
    and takes only those; a chunk holding a row that sees no key at all
    takes every key, as the whole one does."""
    b, t, h, _ = q.shape
    s = k.shape[1]
    rows = max(1, max_scores // max(1, b * h * s))
    out = []
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        keys = s if not causal or r0 + s - t < 0 else r1 + s - t
        qpos = torch.arange(r0, r1, device=q.device) + (s - t)
        out.append(_attend(q[:, r0:r1], k[:, :keys], v[:, :keys], qpos,
                           window=window, n_meta=n_meta, scale=scale,
                           causal=causal))
    return torch.cat(out, dim=1)
