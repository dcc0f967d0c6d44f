"""Public kernel wrappers, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the kernel's plain version.  There is no other switch and
no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul_blocked as _mm


def matmul(a, b, *, block_m: int = 128, block_n: int = 128,
           block_k: int = 128):
    """a: [M,K] @ b: [K,N] -> [M,N] in a's dtype, fp32 accumulation.

    The blocks keep the JAX wrapper's contract: each is clamped to
    ``min(block, dim)``.  The CUDA kernel then runs the smallest compiled
    tile of the dtype covering the clamped ``(block_m, block_n)``, with
    ``block_k`` as its reduction tile, and masks ragged edges itself; only a
    bf16 K or N that is not a multiple of 8 is zero-padded (TMA's stride
    rule).  A tile the kernel's feasibility rule refuses raises
    ``ValueError`` on either device, so a tile that cannot run on the card
    is never timed or swapped for another.
    """
    m, k = a.shape
    n = b.shape[1]
    if min(m, k, n) > 0:
        _mm.plan(m, k, n, block_m=block_m, block_n=block_n, block_k=block_k,
                 dtype_bytes=a.element_size())
    run = _mm.matmul_blocked_cuda if a.is_cuda else _mm.matmul_blocked_plain
    return run(a, b, block_m=block_m, block_n=block_n, block_k=block_k)


def flash_attention(q, k, v, *, window: int = 0, n_meta: int = 0,
                    scale: float | None = None, causal: bool = True,
                    block_q: int = 128, block_k: int = 128):
    """q: [B,T,H,dh]; k,v: [B,S,KV,dh] with KV | H.

    ``block_q`` / ``block_k`` keep the JAX wrapper's contract: they are
    clamped to ``min(block, T|S)``, and keys that do not fill the last block
    are only allowed under the causal mask.  The CUDA kernel then runs the
    smallest compiled tile of the dtype covering the clamped blocks (bf16;
    fp32 has one tile) and masks ragged edges itself.  A tile the kernel's
    feasibility rule refuses raises ``ValueError`` on either device, so a
    tile that cannot run on the card is never timed or swapped for another.

    When an input needs a gradient, the call goes through the autograd
    Function ``FlashAttention``, whose backward is K2 bwd on the card;
    otherwise (serving, tuning) straight to the forward.
    """
    t, dh, s = q.shape[1], q.shape[3], k.shape[1]
    scale = dh ** -0.5 if scale is None else float(scale)
    if min(t, s) > 0:
        _fa.plan(t, s, dh, block_q=block_q, block_k=block_k, causal=causal,
                 dtype_bytes=q.element_size())
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _fa.FlashAttention.apply(q, k, v, scale, window, n_meta, causal,
                                        block_q, block_k)
    run = _fa.flash_attention_cuda if q.is_cuda else _fa.flash_attention_plain
    return run(q, k, v, scale=scale, window=window, n_meta=n_meta,
               causal=causal, block_q=block_q, block_k=block_k)
