"""Attention: GQA and MLA (DeepSeek-V3) over the full sequence (prefill)
and one decode step.

GQA's full-sequence path either calls the flash-attention kernel
(``use_flash=True``) or computes softmax attention in plain torch, as the
JAX package computes it outside any kernel.  Its decode attends one new
token against a full KV cache, or a ring cache of capacity ``window`` for a
sliding-window layer, with an optional never-evicted prefix (meta tokens).

MLA never calls the kernel, as in the JAX package: its full-sequence path
decompresses the latent into per-head keys (qk head dim nope + rope) and
values (v head dim) and attends in plain torch.  Its decode keeps only the
latent cache (``ckv`` and the shared roped key ``krope``) and attends in the
absorbed form: the query is projected into the latent space, scores and
context are taken against ``ckv`` in fp32, and the context is decompressed
per head afterwards.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamSpec, apply_rope, causal_window_mask, rms_norm
from repro_torch.runtime import shardctx, trace
from repro_torch.runtime.shardctx import constrain, local, set_slot_

# bytes of the k and v that ``_repeat_kv`` has made since the last reset (a
# rank's local shards under a mesh); a run reads it by differencing, as
# ``kernels/flash_attention.py``'s ``launches``
kv_repeat_bytes = 0


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


def mla_spec(cfg: ModelConfig, lead: tuple = ()):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    return {
        "wq_a": ParamSpec(lead + (d, m.q_lora_rank), la + ("embed", None), dt),
        "q_norm": ParamSpec(lead + (m.q_lora_rank,), la + (None,), dt, init="zeros"),
        "wq_b": ParamSpec(lead + (m.q_lora_rank, h, m.qk_nope_dim + m.qk_rope_dim),
                          la + (None, "heads", "head_dim"), dt),
        "wkv_a": ParamSpec(lead + (d, m.kv_lora_rank + m.qk_rope_dim),
                           la + ("embed", None), dt),
        "kv_norm": ParamSpec(lead + (m.kv_lora_rank,), la + (None,), dt, init="zeros"),
        "wkv_b": ParamSpec(lead + (m.kv_lora_rank, h, m.qk_nope_dim + m.v_head_dim),
                           la + (None, "heads", "head_dim"), dt),
        "wo": ParamSpec(lead + (h, m.v_head_dim, d),
                        la + ("heads", "head_dim", "embed_out"), dt),
    }


# ---------------------------------------------------------------------------
# Core softmax attention
# ---------------------------------------------------------------------------

# above this many score elements per (batch, head), full-sequence attention
# walks the queries in chunks so [T,S] probabilities are never whole
_CHUNK_THRESHOLD = 32 * 1024 * 1024
_CHUNK_Q = 1024
# while autograd records, full-sequence attention also walks its queries in
# chunks above this many score elements in all [B,H,T,S] (a 2 GiB fp32
# tensor), each chunk recomputed in the backward: deepseek-v3's MLA at T = S
# = 4096 makes [1, 128, 4096, 4096] fp32 scores, 8.6 GB a tensor, and its
# softmax's backward held three of them with the probabilities saved
_TRAIN_CHUNK_SCORES = 1 << 29


_HEADS = ("batch", None, "heads", None)
_SCORES = ("batch", "heads", None, "attn_kv")
_CACHE = ("batch", "kv_seq", "kv", None)


def _attend(q, k, v, positions, window, n_meta, scale):
    """Full-sequence attention, chunked over queries when the scores are large.

    Where the scores split their heads over the mesh, each query chunk runs
    rank by rank on the heads shard (``_sdpa``'s ``by_rank``); where they
    split the key axis instead (hymba's 25 heads on a model axis of 16),
    each chunk runs rank by rank on the key shard (``_sdpa_over_keys``).
    Either way k and v are placed on their shard once, before the chunks."""
    b, t, h = q.shape[:3]
    s = k.shape[1]
    pl = shardctx.placements((b, h, t, s), _SCORES)    # None outside a scope
    by_rank = pl is not None and any(p.is_shard(1) for p in pl)
    by_keys = pl is not None and not by_rank and any(p.is_shard(3) for p in pl)
    if by_keys:
        # the region repeats the kv heads on its key shard
        keys = ("batch", "attn_kv", None, None)
        k, v = constrain(k, keys), constrain(v, keys)
    else:
        k, v = _repeat_kv(k, v, h // k.shape[2])
    if by_rank:
        k, v = constrain(k, _HEADS), constrain(v, _HEADS)

    def sdpa(q, mask):
        if by_keys:
            return _sdpa_over_keys(q, k, v, mask, scale, "attn_kv")
        return _sdpa(q, k, v, mask, scale, by_rank)
    recompute = torch.is_grad_enabled() and b * h * t * s > _TRAIN_CHUNK_SCORES
    if t * s < _CHUNK_THRESHOLD and not recompute:
        return sdpa(q, causal_window_mask(positions, positions, window, n_meta)[None])
    if recompute:
        sdpa = _recomputed(sdpa)
    outs = []
    for c in range(0, t, _CHUNK_Q):
        mask = causal_window_mask(positions[c:c + _CHUNK_Q], positions,
                                  window, n_meta)
        outs.append(sdpa(q[:, c:c + _CHUNK_Q], mask[None]))
    return torch.cat(outs, dim=1)


def _recomputed(sdpa):
    """``sdpa`` saving only its inputs for the backward, which runs it again
    (on autograd's device thread: it takes up the forward's mesh scope), so
    a query chunk's scores and probabilities live only while the chunk
    runs, forward or backward.  Each row's arithmetic is the same."""
    scope = shardctx.current()

    def again(q, mask):
        with shardctx.reenter(scope):
            return sdpa(q, mask)
    return lambda q, mask: checkpoint(again, q, mask, use_reentrant=False,
                                      preserve_rng_state=False)


def _repeat_kv(k, v, g: int):
    """KV heads tiled up to the query heads ("repeat-kv"), so the [B,H,T,S]
    scores stay on the head axis the queries shard over even where the kv
    heads cannot split as the queries do."""
    global kv_repeat_bytes
    if g == 1:
        return k, v
    k = constrain(k.repeat_interleave(g, dim=2), _HEADS)
    v = constrain(v.repeat_interleave(g, dim=2), _HEADS)
    kv_repeat_bytes += _local_bytes(k) + _local_bytes(v)
    return k, v


def _local_bytes(x) -> int:
    if shardctx.is_dtensor(x):
        x = x.to_local()
    return x.numel() * x.element_size()


def _sdpa(q, k, v, mask, scale, by_rank: bool = False):
    """q,k:[B,T|S,H|KV,dh] v:[B,S,KV,dv] (KV divides H; MLA's dv differs
    from dh); mask:[1,T,S] bool.

    ``by_rank`` (full-sequence attention whose scores split the heads; k and
    v already repeated up to H): the score product, the mask, the softmax
    and the value product run rank by rank on q, k and v's heads shard with
    the mask replicated (this function again, on the local shards, where
    ``constrain`` and the repeat do nothing), so each rank makes only its
    heads' [B,H,T,S] scores, forward and backward.  DTensor's own einsums keep the rank's
    heads in the forward but not in the backward (an all-gather of the
    probabilities over heads), and torch 2.11's refuses to flatten a batch
    and a head dim that are both split."""
    if by_rank:
        return local(_sdpa, (_HEADS, _HEADS, _HEADS, (None, None, None), None),
                     out_like=0)(q, k, v, mask, scale)
    k, v = _repeat_kv(k, v, q.shape[2] // k.shape[2])
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    # heads take "model" when they divide it; otherwise the key axis does
    # (hymba's 25 heads): the resolver drops the loser per tensor
    scores = constrain(scores, _SCORES)
    scores = scores.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _sdpa_over_keys(q, k, v, mask, scale, axis: str, k_pre=None, v_pre=None):
    """``_sdpa`` rank by rank on the shard of the key axis: q [B,T,H,dh] with
    its heads whole, k and v [B,S,KV,d] and the mask [1,T,S] split alike on
    their key dim, logical ``axis`` ("attn_kv" for the full sequence,
    "kv_seq" for a decode cache).  Each rank makes the scores of its keys
    only (``_KeyShardAttention``) and returns the whole output.  A decode
    step's never-evicted prefix ``k_pre``/``v_pre`` [B,P,KV,d] (meta tokens)
    joins the first key shard's keys, so it is counted once.  DTensor's own
    einsums gather every key's scores, and torch 2.11's refuse to flatten
    q's split batch and heads."""
    keys, whole = ("batch", axis, None, None), ("batch", None, None, None)
    return local(_key_shard_local, (whole, keys, keys, (None, None, axis), whole, whole,
                                    None, None), out_like=0)(
        q, k, v, mask, k_pre, v_pre, scale, axis)


def _key_shard_local(q, k, v, mask, k_pre, v_pre, scale, axis):
    if k_pre is not None and shardctx.axis_index(axis) == 0:
        k, v = torch.cat([k_pre, k], dim=1), torch.cat([v_pre, v], dim=1)
        pre = torch.ones(mask.shape[:-1] + (k_pre.shape[1],), dtype=torch.bool,
                         device=mask.device)
        mask = torch.cat([pre, mask], dim=-1)
    k, v = _repeat_kv(k, v, q.shape[2] // k.shape[2])
    return _KeyShardAttention.apply(q, k, v, mask, scale, axis)


def _masked_scores(q, k, mask, scale):
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    return scores.masked_fill(~mask[:, None], torch.finfo(torch.float32).min)


class _KeyShardAttention(torch.autograd.Function):
    """Softmax attention from this rank's shard of the keys, as flash-decoding
    splits it: the row max and the sum of exponentials are all-reduced over
    the ranks that hold the other key shards, each rank's probabilities are
    normalised by them and cast to ``v.dtype`` (where ``_sdpa`` casts), and
    the value products are all-reduced, so every rank returns the whole
    output.  A query row that sees no key has the masked fill as every
    score, so each key gets ``1 / S`` of it: the mean of V over all keys, as
    ``_sdpa``'s softmax gives.  The backward recomputes the local
    probabilities from the saved max and sum; dK and dV are exact on the key
    shard, and dQ, a sum over the shards, is all-reduced here (the region
    hands q, replicated over the key axis, a replicated gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, axis):
        e = _masked_scores(q, k, mask, scale)
        m = shardctx.all_reduce_(e.amax(dim=-1), axis, "max")
        e = e.sub_(m[..., None]).exp_()
        se = shardctx.all_reduce_(e.sum(dim=-1), axis)
        out = torch.einsum("bhts,bshd->bthd", e.div_(se[..., None]).to(v.dtype), v)
        ctx.save_for_backward(q, k, v, mask, m, se)
        # the backward runs after the region has ended: it takes it up again
        ctx.scale, ctx.axis, ctx.region = scale, axis, shardctx.region()
        return shardctx.all_reduce_(out, axis)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, m, se = ctx.saved_tensors
        with shardctx.in_region(ctx.region):
            p32 = _masked_scores(q, k, mask, ctx.scale).sub_(m[..., None]).exp_() \
                .div_(se[..., None])
            dv = torch.einsum("bhts,bthd->bshd", p32.to(v.dtype), dout)
            dp = torch.einsum("bthd,bshd->bhts", dout, v).float()
            # the softmax's backward: p * (dp - the sum over every key of p * dp)
            delta = shardctx.all_reduce_((dp * p32).sum(dim=-1), ctx.axis)
            ds = dp.sub_(delta[..., None]).mul_(p32).masked_fill_(~mask[:, None], 0.0)
            ds = ds.mul_(ctx.scale).to(q.dtype)
            dk = torch.einsum("bhts,bthd->bshd", ds, q)
            dq = shardctx.all_reduce_(torch.einsum("bhts,bshd->bthd", ds, k), ctx.axis)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# GQA: full-sequence path
# ---------------------------------------------------------------------------

def _project(x, w, heads: str):
    """x [B,T,D] by w [D,H,dh] -> [B,T,H,dh], placed ("batch", None, heads,
    None).  It runs rank by rank (``_project_local``) where the rules split
    w's D (FSDP: DTensor's einsum contracts the split D and makes pending
    sums of every head over the global batch) or split no H over the mesh
    (mixtral's 8 kv heads on a model axis of 16: DTensor places the
    einsum's flat [B*T, H*dh] product by cost and may split H*dh over a mesh
    dim that H does not divide, which the view back to heads refuses).  A
    TP weight whose heads split is the einsum, placed by ``constrain``."""
    axes = ("batch", None, heads, None)
    shape = x.shape[:2] + w.shape[1:]
    pl = shardctx.placements(shape, axes)          # None outside a scope
    fsdp = pl is not None and any(
        d.is_shard(0) for d in shardctx.placements(w.shape, ("embed", heads, None)))
    if pl is None or (any(d.is_shard(2) for d in pl) and not fsdp):
        return constrain(_einsum_project(x, w), axes)
    return _project_local(x, w, heads)


def _project_local(x, w, heads: str):
    """``_project`` run rank by rank on x's batch shard with whole D and on
    w's heads shard (an FSDP weight's D gathered): each rank makes only its
    heads.  MLA's projections take it where heads split too: under FSDP,
    DTensor's einsum makes every head on every rank."""
    axes = ("batch", None, heads, None)
    return local(_einsum_project, (("batch", None, None), (None, heads, None)),
                 out_like=(x.shape[:2] + w.shape[1:], axes))(x, w)


def _einsum_project(x, w):
    return torch.einsum("btd,dhk->bthk", x, w)


def _out_project(y, wo):
    """y [B,T,H,dv] by wo [H,dv,D] -> [B,T,D], placed ("batch", None, None).
    Under a mesh it runs rank by rank on y's batch and heads shard and on
    wo's heads shard with D gathered (FSDP): each rank's product is its
    term of the sum over the heads shards, a pending sum that ``constrain``
    resolves.  DTensor's own einsum takes the gradient of the output in
    whatever placements the layer's sum hands it (the sequence split where
    a hybrid layer adds the SSD's output) and flattens its split batch and
    sequence dims, which the view back refuses."""
    b, t = y.shape[:2]
    axes = ("batch", None, None)
    out = local(_einsum_out, (("batch", None, "heads", None), ("heads", None, None)),
                out_like=((b, t, wo.shape[-1]), axes), partial=("heads",))(y, wo)
    return constrain(out, axes)


def _einsum_out(y, wo):
    return torch.einsum("bthk,hkd->btd", y, wo)


def gqa_forward(p, x, positions, *, window: int, theta: float, n_meta: int,
                return_kv: bool = False, use_flash: bool = False):
    """x: [B,T,D]; positions: [T] absolute. Returns y (and optionally (k, v))."""
    with trace.span("attention.forward"):
        dh = p["wq"].shape[-1]
        q = _project(x, p["wq"], "heads")
        k = _project(x, p["wk"], "kv")
        v = _project(x, p["wv"], "kv")
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
        if use_flash:
            y = ops.flash_attention(q, k, v, window=window, n_meta=n_meta,
                                    scale=dh ** -0.5)
        else:
            y = _attend(q, k, v, positions, window, n_meta, dh ** -0.5)
        out = _out_project(y, p["wo"])
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
    with trace.span("attention.decode"):
        dh = p["wq"].shape[-1]
        positions = torch.arange(pos, pos + 1, device=x.device)   # no host copy
        q = apply_rope(_project(x, p["wq"], "heads"), positions, theta)
        k_new = apply_rope(_project(x, p["wk"], "kv"), positions, theta)
        v_new = _project(x, p["wv"], "kv")

        k, v = cache["k"], cache["v"]
        cap = k.shape[1]
        slot = pos % cap if window > 0 else pos
        set_slot_(k, 1, slot, k_new[:, 0])
        set_slot_(v, 1, slot, v_new[:, 0])

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

        pl = shardctx.placements(k.shape, _CACHE)        # None outside a scope
        if pl is not None and any(d.is_shard(1) for d in pl):
            # a sequence-split cache (flash-decoding): each rank attends over its
            # shard of the cache, the mask split with it
            y = _sdpa_over_keys(q, k, v, mask, dh ** -0.5, "kv_seq",
                                cache.get("k_pre"), cache.get("v_pre"))
        else:
            if "k_pre" in cache:                         # never-evicted prefix (meta)
                k = torch.cat([cache["k_pre"], k], dim=1)
                v = torch.cat([cache["v_pre"], v], dim=1)
                pre = torch.ones((1, 1, n_prefix), dtype=torch.bool, device=x.device)
                mask = torch.cat([pre, mask], dim=-1)
            y = _sdpa(q, k, v, mask, dh ** -0.5)
        return _out_project(y, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA: full-sequence path
# ---------------------------------------------------------------------------

def mla_forward(cfg: ModelConfig, p, x, positions, *, n_meta: int = 0,
                return_latent: bool = False):
    """x: [B,T,D]; positions: [T].  Returns y, and under ``return_latent``
    the decode cache's latent ``(c [B,T,rank], k_rope [B,T,rope])``."""
    with trace.span("attention.forward"):
        m = cfg.mla
        b, t, _ = x.shape
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5

        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
        q = _project_local(q, p["wq_b"], "heads")
        q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

        c, k_rope = (x @ p["wkv_a"]).split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
        c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
        k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)  # one head

        kvd = _project_local(c, p["wkv_b"], "heads")                  # decompress
        k_nope, v = kvd.split([m.qk_nope_dim, m.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(b, t, cfg.n_heads, m.qk_rope_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        # placed once, as the scores take them: each of _attend's query chunks
        # would otherwise resolve a pending sum of k and v again
        k, v = constrain(k, _HEADS), constrain(v, _HEADS)

        y = _attend(q_full, k, v, positions, 0, n_meta, scale)
        out = torch.einsum("bthk,hkd->btd", y, p["wo"])
        if return_latent:
            return out, (c, k_rope[:, :, 0, :])
        return out


# ---------------------------------------------------------------------------
# MLA: decode path (absorbed, latent cache)
# ---------------------------------------------------------------------------

def mla_decode(cfg: ModelConfig, p, x, cache, pos: int):
    """x: [B,1,D]; cache: {"ckv": [B,S,rank], "krope": [B,S,rope]}.

    The new token's latent is written into ``cache`` in place at ``pos``
    and the same tensors are returned.  The casts are the JAX package's:
    ``q_lat`` in the activation dtype, scores, softmax and ``o_lat`` in
    fp32, ``o_lat`` back in the activation dtype before ``w_uv``.
    """
    with trace.span("attention.decode"):
        m = cfg.mla
        scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
        positions = torch.arange(pos, pos + 1, device=x.device)   # no host copy

        q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
        q = torch.einsum("btr,rhk->bthk", q, p["wq_b"])[:, 0]        # [B,H,nope+rope]
        q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
        q_rope = apply_rope(q_rope[:, None], positions, cfg.rope_theta)[:, 0]

        c_new, kr_new = (x @ p["wkv_a"])[:, 0].split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
        c_new = rms_norm(c_new, p["kv_norm"], cfg.norm_eps)
        kr_new = apply_rope(kr_new[:, None, None, :], positions, cfg.rope_theta)[:, 0, 0]

        ckv, krope = cache["ckv"], cache["krope"]
        set_slot_(ckv, 1, pos, c_new)
        set_slot_(krope, 1, pos, kr_new)

        # absorbed projections
        w_uk, w_uv = p["wkv_b"].split([m.qk_nope_dim, m.v_head_dim], dim=-1)
        q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
        ckv32 = ckv.float()
        s = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv32)
        s = s + torch.einsum("bhn,bsn->bhs", q_rope.float(), krope.float())
        s = s * scale
        valid = torch.arange(ckv.shape[1], device=x.device) <= pos
        s = s.masked_fill(~valid[None, None], torch.finfo(torch.float32).min)
        probs = torch.softmax(s, dim=-1)

        o_lat = torch.einsum("bhs,bsr->bhr", probs, ckv32)
        v = torch.einsum("bhr,rhv->bhv", o_lat.to(x.dtype), w_uv)
        out = torch.einsum("bhv,hvd->bd", v, p["wo"])[:, None]
        return out, cache
