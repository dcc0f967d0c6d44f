"""Public kernel wrappers, dispatched by the tensor's device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a
CPU tensor takes the kernel's plain version.  There is no other switch and
no fallback.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, window: int = 0, n_meta: int = 0,
                    scale: float | None = None, causal: bool = True,
                    block_q: int = 128, block_k: int = 128):
    """q: [B,T,H,dh]; k,v: [B,S,KV,dh] with KV | H.

    ``block_q`` / ``block_k`` keep the JAX wrapper's contract: they are
    clamped to ``min(block, T|S)``, and keys that do not fill the last block
    are only allowed under the causal mask.  The CUDA kernel's own tile is
    fixed at compile time and masks ragged edges itself, so the blocks do not
    change the result.
    """
    dh, s = q.shape[3], k.shape[1]
    scale = dh ** -0.5 if scale is None else float(scale)
    bk = min(block_k, s)
    if s % bk and not causal:
        raise ValueError("non-causal attention with keys that do not fill the "
                         f"last block (S={s}, block_k={bk}) needs a length mask")
    run = _fa.flash_attention_cuda if q.is_cuda else _fa.flash_attention_plain
    return run(q, k, v, scale=scale, window=window, n_meta=n_meta,
               causal=causal)
