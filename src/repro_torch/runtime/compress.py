"""Gradient compression with error feedback, as the JAX package's
``repro/runtime/compress.py`` writes it.

Two schemes, both with *error feedback* (what is not sent this step is
added to the next step's gradient, so nothing is lost, only delayed):

* ``topk``: keep the largest-|g| fraction of each tensor (Deep Gradient
  Compression style).  ``topk_mask`` keeps ``|g| >=`` the k-th largest
  magnitude, so ties keep more than k.
* ``int8``: symmetric per-tensor int8 with stochastic rounding.

Inside a step the compressed gradient is a masked or quantized dense
tensor.  ``sparse_allreduce`` is the wire-level form of top-k over one mesh
axis: each rank's k values and indices are all-gathered and merged with
``index_add_``.

The rounding noise comes from an explicit ``torch.Generator`` (the JAX
package splits a PRNG key per leaf; here one generator is drawn from leaf
by leaf, in the tree's order), so the rounding matches the reference in
distribution, not bit for bit.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.runtime.tree import leaves, tree_map, unflatten


# ---------------------------------------------------------------------------
# top-k with error feedback
# ---------------------------------------------------------------------------

def _kth_largest_abs(g: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest |g| over the whole (logical) tensor.

    A DTensor's comes from each rank's own k largest: the k largest of the
    whole are among their union, gathered over the mesh dims that split
    ``g`` (a replicated dim holds the same values on every rank)."""
    if not isinstance(g, DTensor):
        return torch.topk(g.reshape(-1).abs(), k, sorted=False).values.min()
    import torch.distributed as dist

    if any(p.is_partial() for p in g.placements):
        raise ValueError("top-k of a partial sum: reduce the gradient first")
    local = g.to_local().reshape(-1).abs()
    cand = torch.topk(local, min(k, local.numel()), sorted=False).values
    for i, p in enumerate(g.placements):
        if p.is_shard():
            group = g.device_mesh.get_group(i)
            parts = [torch.empty_like(cand) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, cand, group=group)
            cand = torch.cat(parts)
    return torch.topk(cand, k, sorted=False).values.min()


def topk_mask(g: torch.Tensor, ratio: float) -> torch.Tensor:
    if g.ndim == 0 or ratio >= 1.0:
        return torch.ones_like(g, dtype=torch.bool)
    k = max(1, int(g.numel() * ratio))
    return g.abs() >= _kth_largest_abs(g, k)


def compress_topk(grads, state, ratio: float):
    """(grads, feedback_state) -> (compressed_grads, new_state)."""
    def one(g, r):
        acc = g.float() + r
        sent = torch.where(topk_mask(acc, ratio), acc, torch.zeros_like(acc))
        return sent.to(g.dtype), acc - sent
    return _split_pairs(grads, [one(g, r) for g, r in zip(leaves(grads), leaves(state))])


def init_feedback(params_like):
    """fp32 zeros like each leaf (a DTensor's with its placements)."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params_like)


def _split_pairs(like, pairs):
    return (unflatten(like, [p[0] for p in pairs]),
            unflatten(like, [p[1] for p in pairs]))


# ---------------------------------------------------------------------------
# int8 with stochastic rounding
# ---------------------------------------------------------------------------

def quantize_int8(g: torch.Tensor, generator: torch.Generator):
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    x = g32 / scale
    noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                       device=g.device) - 0.5
    q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compress_int8(grads, state, generator: torch.Generator):
    """(grads, feedback_state, generator) -> (compressed_grads, new_state);
    the generator lives on the gradients' device."""
    def one(g, r):
        acc = g.float() + r
        deq = dequantize_int8(*quantize_int8(acc, generator))
        return deq.to(g.dtype), acc - deq
    return _split_pairs(grads, [one(g, r) for g, r in zip(leaves(grads), leaves(state))])


# ---------------------------------------------------------------------------
# wire-level sparse all-reduce over one mesh axis
# ---------------------------------------------------------------------------

def sparse_allreduce(g: torch.Tensor, axis_name: str, ratio: float, *, mesh):
    """The sum over ``mesh``'s axis ``axis_name`` of each rank's top-k
    sparsification of its local ``g``: values and indices are all-gathered
    (``2 * k`` words a rank instead of ``|g|``) and scatter-added.

    The DCN-saving primitive for multi-pod data parallelism."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * ratio))
    idx = torch.topk(flat.abs(), k).indices
    vals = flat[idx]
    n = dist.get_world_size(group)
    all_vals = [torch.empty_like(vals) for _ in range(n)]
    all_idx = [torch.empty_like(idx) for _ in range(n)]
    dist.all_gather(all_vals, vals, group=group)
    dist.all_gather(all_idx, idx, group=group)
    merged = torch.zeros_like(flat).index_add_(0, torch.cat(all_idx), torch.cat(all_vals))
    return merged.reshape(g.shape).to(g.dtype)
