"""Public kernel wrappers, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the kernel's plain version; a meta tensor (the dry-run)
takes flash attention's shape rule, which allocates what a launch does and
computes nothing.  There is no other switch and no fallback.  Under a mesh
(``runtime/shardctx.scope``) flash attention runs on each rank's local
shard: the kernels take raw pointers, which a DTensor has none of.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul_blocked as _mm
from repro_torch.runtime import shardctx


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

    DTensor inputs (a sharded step) run rank by rank, see ``_flash_local``.
    """
    if shardctx.is_dtensor(q):
        return _flash_local(q, k, v, window=window, n_meta=n_meta, scale=scale,
                            causal=causal, block_q=block_q, block_k=block_k)
    t, dh, s = q.shape[1], q.shape[3], k.shape[1]
    scale = dh ** -0.5 if scale is None else float(scale)
    if min(t, s) > 0:
        _fa.plan(t, s, dh, block_q=block_q, block_k=block_k, causal=causal,
                 dtype_bytes=q.element_size())
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _fa.FlashAttention.apply(q, k, v, scale, window, n_meta, causal,
                                        block_q, block_k)
    run = (_fa.flash_attention_cuda if q.is_cuda else
           _fa.flash_attention_shape if q.is_meta else _fa.flash_attention_plain)
    return run(q, k, v, scale=scale, window=window, n_meta=n_meta,
               causal=causal, block_q=block_q, block_k=block_k)


def _flash_local(q, k, v, **kw):
    """Flash attention on DTensors: each rank launches the kernel on its
    local q/k/v and keeps its slice of the output, and the gradient comes
    back through ``FlashAttention`` on the same slices.

    The batch stays on the batch axes.  Heads go on "model" only where the
    kv heads split over the same mesh dims (so each rank's query heads see
    their own kv heads, the group unchanged); otherwise every rank takes
    all heads.  The key axis is never split under one launch: the kernel's
    softmax needs whole rows."""
    from torch.distributed.tensor import Shard

    heads, kv, whole = (("batch", None, "heads", None), ("batch", None, "kv", None),
                        ("batch", None, None, None))
    qp = shardctx.placements(q.shape, heads)
    if qp is None:
        raise RuntimeError("DTensor inputs reached flash_attention outside "
                           "shardctx.scope: no rules to place them by")
    kp = shardctx.placements(k.shape, kv)

    def head_dims(pl):
        return [i for i, p in enumerate(pl) if isinstance(p, Shard) and p.dim == 2]
    if not head_dims(qp) or head_dims(qp) != head_dims(kp):
        heads = kv = whole
    return shardctx.local(lambda q, k, v: flash_attention(q, k, v, **kw),
                          (heads, kv, kv))(q, k, v)
