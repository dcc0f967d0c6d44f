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


def _segsum(x):
    """Stable segment-sum: out[i,j] = sum_{j<k<=i} x[k], -inf for j>i."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    upper = torch.ones((t, t), dtype=torch.bool, device=x.device).triu_(1)
    return out.masked_fill_(upper, float("-inf"))


def ssd_forward(cfg: ModelConfig, p, x, *, initial_state=None,
                return_state: bool = False):
    """Full-sequence SSD. x: [B,T,D]; T is padded to whole chunks inside.

    With ``return_state`` it also returns the decode handoff
    ``{"state": [B,nh,hd,N] fp32, "conv": [B,K-1,conv_dim]}``."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b, t0, _ = x.shape
    g, n, hd = s.n_groups, s.d_state, s.head_dim
    hpg = nh // g
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
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    # torch's softplus is the identity above its threshold of 20, where
    # jax.nn.softplus adds log1p(exp(-x)) < 2.1e-9: below fp32's resolution
    # at 20 (1.9e-6), so the two agree to the last bit that fp32 holds
    dt = F.softplus(dt.float() + p["dt_bias"])                   # [B,T0,nh]
    if pad:
        # padded steps must be identity for the state: xBC = 0 and dt = 0
        # (decay 1, input 0)
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    xs, bm, cm = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, nc, cl, nh, hd).float()
    bm = bm.reshape(b, nc, cl, g, n).float()
    cm = cm.reshape(b, nc, cl, g, n).float()
    dt = dt.reshape(b, nc, cl, nh)
    a = -torch.exp(p["a_log"].float())                           # [nh]
    da_h = (dt * a).permute(0, 1, 3, 2).contiguous()             # [B,nc,nh,cl]
    cum = torch.cumsum(da_h, dim=-1)                             # [B,nc,nh,cl]
    xdt = xs * dt[..., None]                                     # [B,nc,cl,nh,hd]

    # ---- intra-chunk (quadratic within the chunk) -------------------------
    # the reference's einsum("bchij,bcjh,bcjhd->bcihd", cb * L, dt, x) is
    # taken as (C B^T * L), one [B,nc,nh,cl,cl] product (C B^T broadcast
    # over each group's heads), times (dt * x) by a batched matmul; each
    # [B,nc,nh,cl,cl] block is dropped once used (0.73 GB at hymba's prefill)
    # the [cl x cl] blocks shard over the chunk axis ("ssm_chunks" ->
    # model): SSM head counts (hymba's 50) rarely divide the mesh
    lmat = constrain(_segsum(da_h).exp_(),
                     ("batch", "ssm_chunks", None, None, None))  # [B,nc,nh,cl,cl]
    cb = constrain(torch.einsum("bcign,bcjgn->bcgij", cm, bm),
                   ("batch", "ssm_chunks", None, None, None))    # [B,nc,G,cl,cl]
    m = lmat.reshape(b, nc, g, hpg, cl, cl) * cb[:, :, :, None]
    del lmat
    y = m.reshape(b, nc, nh, cl, cl) @ xdt.permute(0, 1, 3, 2, 4)   # [B,nc,nh,cl,hd]
    del m
    y = constrain(y.permute(0, 1, 3, 2, 4),
                  ("batch", "ssm_chunks", None, None, None))     # [B,nc,cl,nh,hd]

    # ---- chunk end-states --------------------------------------------------
    # einsum("bcjhn,bchj,bcjh,bcjhd->bchdn", B, decay, dt, x): the decay to
    # the chunk's end folded into (dt * x) first, then summed against B
    decay_last = torch.exp(cum[..., -1:] - cum).permute(0, 1, 3, 2)   # [B,nc,cl,nh]
    xw = (xdt * decay_last[..., None]).reshape(b, nc, cl, g, hpg, hd)
    states = torch.einsum("bcjgn,bcjgpd->bcgpdn", bm, xw).reshape(
        b, nc, nh, hd, n)

    # ---- inter-chunk recurrence: the state *before* each chunk -------------
    chunk_decay = torch.exp(cum[..., -1])                        # [B,nc,nh]
    carry = (x.new_zeros((b, nh, hd, n), dtype=torch.float32)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # [B,nc,nh,hd,N]

    # ---- inter-chunk output contribution -----------------------------------
    # einsum("bcihn,bchdn,bchi->bcihd", C, prev, exp(cum)): C against the
    # state, then the decay from the chunk's start
    y_off = torch.einsum("bcign,bcgpdn->bcigpd", cm,
                         prev_states.reshape(b, nc, g, hpg, hd, n))
    y_off = y_off.reshape(b, nc, cl, nh, hd) \
        * torch.exp(cum).permute(0, 1, 3, 2)[..., None]

    # the merges of (nc, cl) and of (nh, hd) keep their own placements for
    # the backward's split (``grad_placed``)
    y = grad_placed((y + y_off).reshape(b, t, nh, hd))
    y = y + p["d_skip"][:, None] * grad_placed(xs.reshape(b, t, nh, hd))
    y = grad_placed(y.reshape(b, t, d_in))[:, :t0].to(x.dtype)

    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        # conv tail for the decode handoff: the last K-1 pre-activation,
        # unpadded conv inputs
        return out, {"state": carry, "conv": xbc_raw[:, -(s.d_conv - 1):]}
    return out


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
    da = torch.exp(dt * a)                                       # [B,nh]

    # state = state * exp(dt A) + dt x B^T, B broadcast over its group's heads
    upd = ((dt[..., None] * xs).reshape(b, g, hpg, hd)[..., None] * bm[..., None, :]
           ).reshape(b, nh, hd, n)
    state = cache["state"]
    state.mul_(da[..., None, None]).add_(upd)
    y = (state.reshape(b, g, hpg, hd, n) @ cm.reshape(b, g, 1, n, 1)).reshape(b, nh, hd)
    y = y + p["d_skip"][:, None] * xs
    y = y.reshape(b, 1, d_in).to(x.dtype)

    y = rms_norm(y * F.silu(z[:, None]), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], cache
