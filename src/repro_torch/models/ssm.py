"""Mamba-2 SSD (state-space duality) block, chunked-scan formulation.

Prefill uses the blocked SSD algorithm from arXiv:2405.21060 §6: a
within-chunk "attention-like" quadratic term plus an inter-chunk linear
state recurrence (a Python loop over chunks, where the JAX package runs a
``lax.scan``).  Decode is the O(1) recurrent step over (conv_state,
ssm_state); it writes the new state into the cache in place.

The scan has no kernel in either package: it is plain torch here, as it is
``jnp.einsum`` and ``lax.scan`` there, and runs in fp32 wherever the JAX
package's does.  Every multi-operand einsum of the reference is written as
pairwise products whose intermediates are no larger than one
``[B, nc, nh, cl, cl]`` tensor, and the ``n_groups`` B/C projections are
broadcast over their heads instead of repeated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, rms_norm
from repro_torch.runtime import shardctx
from repro_torch.runtime.shardctx import constrain, grad_placed, local


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, nh, conv_dim


def ssm_spec(cfg: ModelConfig, lead: tuple = ()):
    s, d_in, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    return {
        "in_proj": ParamSpec(lead + (d, 2 * d_in + 2 * s.n_groups * s.d_state + nh),
                             la + ("embed", "ffn"), dt),
        "conv_w": ParamSpec(lead + (s.d_conv, conv_dim), la + (None, "ffn"), dt),
        "conv_b": ParamSpec(lead + (conv_dim,), la + ("ffn",), dt, init="zeros"),
        "a_log": ParamSpec(lead + (nh,), la + ("heads",), "float32", init="ssm_a"),
        "d_skip": ParamSpec(lead + (nh,), la + ("heads",), "float32", init="ones"),
        "dt_bias": ParamSpec(lead + (nh,), la + ("heads",), "float32", init="ssm_dt"),
        "norm": ParamSpec(lead + (d_in,), la + ("ffn",), dt, init="zeros"),
        "out_proj": ParamSpec(lead + (d_in, d), la + ("ffn", "embed_out"), dt),
    }


def _split_zxbcdt(cfg, zxbcdt):
    """z, xBC, dt along the last axis (``jnp.split`` takes cut indices)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    return torch.tensor_split(zxbcdt, [d_in, d_in + conv_dim], dim=-1)


def _split_xbc(cfg, xbc):
    s, d_in, _, _ = _dims(cfg)
    return torch.tensor_split(xbc, [d_in, d_in + s.n_groups * s.d_state], dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv1d, then SiLU. xbc:[B,T,C], w:[K,C].

    A cross-correlation (not flipped) over ``K - 1`` zeros on the left, one
    filter a channel, as the JAX package's ``conv_general_dilated`` with
    ``feature_group_count = C``.  Under a mesh it runs rank by rank on the
    batch shard with whole channels and filters: DTensor's convolution rule
    splits channels without splitting the groups."""
    return local(_causal_conv_local,
                 (("batch", None, None), (None, None), (None,)))(xbc, w, b)


def _causal_conv_local(xbc, w, b):
    k, c = w.shape
    pad = F.pad(xbc.transpose(1, 2), (k - 1, 0))                 # [B,C,K-1+T]
    out = F.conv1d(pad, w.t()[:, None, :], bias=b, groups=c)     # [B,C,T]
    return F.silu(out.transpose(1, 2))


def _pad_steps(x, pad: int):
    """x [B,T,C] with ``pad`` zero steps on the right, rank by rank on the
    batch shard under a mesh: torch 2.11's DTensor fails to plan the
    redistribution for the pad."""
    if not pad:
        return x
    shape = (x.shape[0], x.shape[1] + pad, x.shape[2])
    return local(lambda x: F.pad(x, (0, 0, 0, pad)), (("batch", None, None),),
                 out_like=(shape, ("batch", None, None)))(x)


def _segsum(x):
    """Stable segment-sum: out[i,j] = sum_{j<k<=i} x[k], -inf for j>i."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((t, t), dtype=torch.bool, device=x.device).triu_(1)
    return out.masked_fill_(upper, float("-inf"))


def _chunk_block(cm, bm, da_h, cum, xdt):
    """Each chunk's own output (the quadratic term within the chunk) and its
    end-state.  cm, bm: [B,nc,cl,G,N]; da_h and its cumulative sum cum:
    [B,nc,nh,cl]; xdt: [B,nc,cl,nh,hd].  Returns y [B,nc,cl,nh,hd] and
    states [B,nc,nh,hd,N].

    The reference's einsum("bchij,bcjh,bcjhd->bcihd", cb * L, dt, x) is
    taken as (C B^T * L), one [B,nc,nh,cl,cl] product (C B^T broadcast over
    each group's heads), times (dt * x) by a batched matmul; each
    [B,nc,nh,cl,cl] block is dropped once used (0.73 GB at hymba's
    prefill).  The end-states are its einsum("bcjhn,bchj,bcjh,bcjhd->bchdn",
    B, decay, dt, x): the decay to the chunk's end folded into (dt * x)
    first, then summed against B."""
    b, nc, cl, g, n = cm.shape
    nh, hd = xdt.shape[3:]
    hpg = nh // g
    lmat = _segsum(da_h).exp_()                                  # [B,nc,nh,cl,cl]
    cb = torch.einsum("bcign,bcjgn->bcgij", cm, bm)              # [B,nc,G,cl,cl]
    m = lmat.reshape(b, nc, g, hpg, cl, cl) * cb[:, :, :, None]
    del lmat
    y = m.reshape(b, nc, nh, cl, cl) @ xdt.permute(0, 1, 3, 2, 4)   # [B,nc,nh,cl,hd]
    del m
    decay_last = torch.exp(cum[..., -1:] - cum).permute(0, 1, 3, 2)   # [B,nc,cl,nh]
    xw = (xdt * decay_last[..., None]).reshape(b, nc, cl, g, hpg, hd)
    states = torch.einsum("bcjgn,bcjgpd->bcgpdn", bm, xw).reshape(b, nc, nh, hd, n)
    return y.permute(0, 1, 3, 2, 4), states


def _inter_chunk(cm, states, cum, carry):
    """The inter-chunk recurrence and its output: the state *before* each
    chunk, from ``carry`` (the state before the first; None: zeros), and C
    against it.  cm: [B,nc,cl,G,N]; states: [B,nc,nh,hd,N]; cum:
    [B,nc,nh,cl].  Returns y_off [B,nc,cl,nh,hd] and the state after the
    last chunk [B,nh,hd,N].  Each sequence's chunks follow one another, so
    under a mesh it runs rank by rank on the batch shard with every chunk."""
    b, nc, cl, g, n = cm.shape
    nh, hd = states.shape[2:4]
    hpg = nh // g
    chunk_decay = torch.exp(cum[..., -1])                        # [B,nc,nh]
    if carry is None:
        carry = states.new_zeros((b, nh, hd, n))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # [B,nc,nh,hd,N]
    # einsum("bcihn,bchdn,bchi->bcihd", C, prev, exp(cum)): C against the
    # state, then the decay from the chunk's start
    y_off = torch.einsum("bcign,bcgpdn->bcigpd", cm,
                         prev_states.reshape(b, nc, g, hpg, hd, n))
    y_off = y_off.reshape(b, nc, cl, nh, hd) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    return y_off, carry


def ssd_forward(cfg: ModelConfig, p, x, *, initial_state=None,
                return_state: bool = False):
    """Full-sequence SSD. x: [B,T,D]; T is padded to whole chunks inside.

    With ``return_state`` it also returns the decode handoff
    ``{"state": [B,nh,hd,N] fp32, "conv": [B,K-1,conv_dim]}``."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b, t0, _ = x.shape
    g, n, hd = s.n_groups, s.d_state, s.head_dim
    cl = min(s.chunk, t0)
    pad = (-t0) % cl
    t = t0 + pad
    nc = t // cl

    # the projection placed as in_proj is: DTensor may otherwise settle a
    # pending sum here by a reduce-scatter that splits the product, and so
    # the heads of dt and x, unevenly (hymba's 50 heads over a model axis of
    # 16), which the chunk reshapes and einsums then refuse
    zxbcdt = constrain(x @ p["in_proj"], ("batch", None, "ffn"))
    z, xbc_raw, dt = _split_zxbcdt(cfg, zxbcdt)
    # padded steps must be identity for the state: xBC = 0 and dt = 0
    # (decay 1, input 0)
    xbc = _pad_steps(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]), pad)
    # torch's softplus is the identity above its threshold of 20, where
    # jax.nn.softplus adds log1p(exp(-x)) < 2.1e-9: below fp32's resolution
    # at 20 (1.9e-6), so the two agree to the last bit that fp32 holds
    dt = _pad_steps(F.softplus(dt.float() + p["dt_bias"]), pad)     # [B,T,nh]
    xs, bm, cm = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, nc, cl, nh, hd).float()
    bm = bm.reshape(b, nc, cl, g, n).float()
    cm = cm.reshape(b, nc, cl, g, n).float()
    dt = dt.reshape(b, nc, cl, nh)
    a = -torch.exp(p["a_log"].float())                           # [nh]
    da_h = (dt * a).permute(0, 1, 3, 2).contiguous()             # [B,nc,nh,cl]
    # on the batch shard: torch 2.11's DTensor has no rule for the flip in
    # a cumsum's backward
    cum = local(torch.cumsum, (("batch", None, None, None), None),
                out_like=0)(da_h, -1)                            # [B,nc,nh,cl]
    xdt = xs * dt[..., None]                                     # [B,nc,cl,nh,hd]

    # the [cl x cl] blocks and the chunk end-states, chunk by chunk: rank by
    # rank on the chunk axis ("ssm_chunks" -> model, as the reference
    # constrains them; SSM head counts, hymba's 50, rarely divide the mesh).
    # Each chunk needs only its own inputs, so the region is exact with no
    # collective; DTensor's batched products flatten the split batch and
    # chunk dims, which torch 2.11 (and 2.13's backward) refuse.  The
    # recurrence over the chunks then runs on the batch shard
    chunks = ("batch", "ssm_chunks", None, None, None)
    y, states = local(_chunk_block, (chunks, chunks, chunks[:4], chunks[:4], chunks),
                      out_like=[((b, nc, cl, nh, hd), chunks),
                                ((b, nc, nh, hd, n), chunks)])(cm, bm, da_h, cum, xdt)
    seqs = ("batch", None, None, None, None)
    y_off, carry = local(_inter_chunk, (seqs, seqs, seqs[:4], seqs[:4]),
                         out_like=[((b, nc, cl, nh, hd), seqs), ((b, nh, hd, n), seqs[:4])])(
        cm, states, cum, None if initial_state is None else initial_state.float())

    # the merges of (nc, cl) and of (nh, hd) keep their own placements for
    # the backward's split (``grad_placed``)
    y = grad_placed((y + y_off).reshape(b, t, nh, hd))
    y = y + p["d_skip"][:, None] * grad_placed(xs.reshape(b, t, nh, hd))
    # the sequence split of the chunks' merge given up for d_in's before the
    # steps are cut and the product flattens the batch and sequence dims
    y = constrain(grad_placed(y.reshape(b, t, d_in)), ("batch", None, "ffn"))
    y = y[:, :t0].to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        # conv tail for the decode handoff: the last K-1 pre-activation,
        # unpadded conv inputs, copied: a view would hold the whole input
        # projection until the prefill stacks every layer's cache (torch
        # 2.11's DTensor slices to a view)
        return out, {"state": carry, "conv": xbc_raw[:, -(s.d_conv - 1):].clone()}
    return out


def _state_step(state, xs, dt, a, bm, cm, hpg: int):
    """The recurrent step of the heads of ``state`` [B,h,hd,N], in place:
    state = state * exp(dt A) + dt x B^T, B broadcast over its group's
    heads; returns C against the new state [B,h,hd].  xs [B,h,hd]; dt [B,h];
    a [h]; bm, cm [B,G,1,N] of every group, ``hpg`` heads a group.  On a
    heads shard (``shardctx.splits("heads")``) it takes the groups of its
    heads."""
    b, h, hd, n = state.shape
    if shardctx.splits("heads"):
        h0 = shardctx.axis_index("heads") * h
        bm, cm = (m[:, h0 // hpg:(h0 + h - 1) // hpg + 1] for m in (bm, cm))
    g = bm.shape[1]
    hpg = h // g
    da = torch.exp(dt * a)                                       # [B,h]
    upd = ((dt[..., None] * xs).reshape(b, g, hpg, hd)[..., None] * bm[..., None, :]
           ).reshape(b, h, hd, n)
    state.mul_(da[..., None, None]).add_(upd)
    return (state.reshape(b, g, hpg, hd, n) @ cm.reshape(b, g, 1, n, 1)).reshape(b, h, hd)


def ssd_decode(cfg: ModelConfig, p, x, cache):
    """One-token recurrent step. x: [B,1,D]; cache: {"state","conv"}.

    The JAX version returns an updated copy of the cache.  This one writes
    the new state and the shifted conv window into ``cache`` in place (so a
    view into a stacked cache is updated) and returns the same tensors."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b = x.shape[0]
    g, n, hd = s.n_groups, s.d_state, s.head_dim
    hpg = nh // g

    z, xbc_new, dt = _split_zxbcdt(cfg, (x @ p["in_proj"])[:, 0])      # [B,...]
    conv_in = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)     # [B,K,C]
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"]) + p["conv_b"])
    cache["conv"].copy_(conv_in[:, 1:])

    xs, bm, cm = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, nh, hd).float()
    bm = bm.reshape(b, g, 1, n).float()
    cm = cm.reshape(b, g, 1, n).float()

    dt = F.softplus(dt.float() + p["dt_bias"])                   # [B,nh]
    a = -torch.exp(p["a_log"].float())
    # rank by rank on the state's batch and heads shard, written in place:
    # DTensor's grouped product flattens the split batch and heads
    heads = ("batch", "heads", None, None)
    y = local(_state_step, (heads, heads[:3], heads[:2], heads[1:2],
                            ("batch", None, None, None), ("batch", None, None, None), None),
              out_like=((b, nh, hd), heads[:3]))(cache["state"], xs, dt, a, bm, cm, hpg)
    y = y + p["d_skip"][:, None] * xs
    y = y.reshape(b, 1, d_in).to(x.dtype)

    y = rms_norm(y * F.silu(z[:, None]), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], cache
