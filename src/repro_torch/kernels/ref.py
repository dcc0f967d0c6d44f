"""Plain-torch oracles for every kernel (the correctness references)."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() @ b.float()).to(a.dtype)


def flash_attention_ref(q, k, v, *, window: int = 0, n_meta: int = 0,
                        scale: float | None = None, causal: bool = True):
    """q,k,v: [B,T,H,dh] (H == KV heads; repeat kv outside for GQA)."""
    b, t, h, dh = q.shape
    s = k.shape[1]
    scale = dh ** -0.5 if scale is None else scale
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos + (s - t)            # right-aligned for t < s
    if window > 0:
        in_win = (qpos + (s - t) - kpos) < window
        mask &= in_win | (kpos < n_meta)
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
