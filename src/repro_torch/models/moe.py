"""Mixture-of-experts FFN with capacity-based top-k routing.

Dispatch is the per-expert top-C gather formulation of the JAX package:
after top-k routing, each expert independently selects its C
highest-affinity tokens (``torch.topk`` over the token axis), processes them
with a gated MLP, and scatter-adds the weighted results back.  Overflow
tokens are dropped (capacity-factor semantics); shared experts
(DeepSeek-V3) are always-on dense MLPs added to the routed output.

The expert products are ``torch.einsum`` calls, as the JAX package leaves
them to XLA; there is no kernel of the port's own here.  The scatter-add is
``index_add_``, which is not bit-deterministic on CUDA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, activation
from repro_torch.runtime.shardctx import constrain, local, placed_like


def moe_spec(cfg: ModelConfig, lead: tuple = ()):
    mo = cfg.moe
    d = cfg.d_model
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    e_ax = "experts" if mo.shard_mode == "ep" else None
    f_ax = None if mo.shard_mode == "ep" else "ffn"
    spec = {
        "router": ParamSpec(lead + (d, mo.n_experts), la + ("embed", None),
                            "float32"),
        "w_in": ParamSpec(lead + (mo.n_experts, d, mo.d_ff),
                          la + (e_ax, "embed", f_ax), dt),
        "w_gate": ParamSpec(lead + (mo.n_experts, d, mo.d_ff),
                            la + (e_ax, "embed", f_ax), dt),
        "w_out": ParamSpec(lead + (mo.n_experts, mo.d_ff, d),
                           la + (e_ax, f_ax, "embed_out"), dt),
    }
    if mo.n_shared:
        f = mo.n_shared * mo.d_ff
        spec["shared"] = {
            "wi": ParamSpec(lead + (d, f), la + ("embed", "ffn"), dt),
            "wg": ParamSpec(lead + (d, f), la + ("embed", "ffn"), dt),
            "wo": ParamSpec(lead + (f, d), la + ("ffn", "embed_out"), dt),
        }
    return spec


def capacity(n_tokens: int, moe) -> int:
    c = max(8, int(math.ceil(n_tokens * moe.top_k / moe.n_experts
                             * moe.capacity_factor)))
    return min(c, n_tokens)


# dispatch groups are routed independently above this many tokens, each
# with its own capacity, as the JAX package routes them
MAX_DISPATCH_TOKENS = 65536


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, router_mode: str = "softmax"):
    """x: [B,T,D] -> (y, aux_load_balance_loss).

    Above MAX_DISPATCH_TOKENS the token stream is split into groups and
    routed per group (local routing with per-group capacity); the aux loss
    is then the groups' mean.
    """
    b, t, d = x.shape
    nt = b * t
    if nt > MAX_DISPATCH_TOKENS and nt % MAX_DISPATCH_TOKENS == 0:
        xg0 = x.reshape(nt // MAX_DISPATCH_TOKENS, 1, MAX_DISPATCH_TOKENS, d)
        # under a mesh the loop walks an axis no rank splits: each group's
        # tokens split over the batch axes, as its dispatch places them
        # (one all-to-all), and the result goes back to x's layout
        xg = constrain(xg0, (None, None, "moe_tokens", None))
        ys, auxs = zip(*(_moe_dispatch(cfg, p, xc, router_mode) for xc in xg))
        y = placed_like(torch.stack(ys), xg0)
        return y.reshape(b, t, d), torch.stack(auxs).mean()
    return _moe_dispatch(cfg, p, x, router_mode)


def _gather_slots(xf, gidx):
    """xf [N,D] at the slots gidx [E,C] -> [E,C,D]."""
    return xf[gidx.reshape(-1)].reshape(gidx.shape + xf.shape[1:])


def _topk(k: int):
    """The top ``k`` along the last dim, as a (values, indices) tuple."""
    return lambda x: tuple(torch.topk(x, k, dim=-1))


def _combine_slots(ye, gidx, n: int):
    """ye [E,C,D] scatter-added at the slots gidx [E,C] into n zero rows."""
    d = ye.shape[-1]
    return ye.new_zeros(n, d).index_add(0, gidx.reshape(-1), ye.reshape(-1, d))


def _moe_dispatch(cfg: ModelConfig, p, x: torch.Tensor, router_mode: str):
    mo = cfg.moe
    b, t, d = x.shape
    nt = b * t
    xf0 = x.reshape(nt, d)
    xf = constrain(xf0, ("moe_tokens", None))

    # both top-k picks run rank by rank: each rank's own tokens' experts,
    # and each rank's own experts' slots from all the tokens (DTensor in
    # torch 2.11 has no rule for a top-k's backward, which scatters into
    # plain zeros)
    pick = local(_topk(mo.top_k), (("moe_tokens", None),), out_like=[0, 0])
    logits = xf.float() @ p["router"].float()
    if router_mode == "sigmoid":                     # DeepSeek-V3 style
        scores = torch.sigmoid(logits)
        topv, topi = pick(scores)
        weights = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:                                            # mixtral: softmax-then-topk
        probs = torch.softmax(logits, dim=-1)
        topv, topi = pick(probs)
        weights = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # token->expert affinity matrix (nonzero only at routed slots)
    affinity = logits.new_zeros(nt, mo.n_experts).scatter_add(1, topi, weights)

    cap = capacity(nt, mo)
    # per-expert picks; among the many zero affinities topk may take any,
    # and ``keep`` zeroes whatever it takes
    gval, gidx = local(_topk(cap), (("experts", None),),
                       out_like=[0, 0])(affinity.t())     # [E,C]
    keep = (gval > 0.0).to(xf.dtype)

    # dispatch buffers [E,C,D]: experts over "model" (ep) and capacity over
    # the batch axes, the memory-critical layout.  Each rank gathers only its
    # own experts' slots of its capacity shard, from all the tokens: DTensor's
    # own gather would make every expert's slots on every rank first
    xe = local(_gather_slots, ((None, None), ("experts", "moe_cap")),
               out_like=((mo.n_experts, cap, d), ("experts", "moe_cap", None)))(xf, gidx)
    act = activation(cfg.act)
    h = act(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", xe, p["w_in"])
    h = constrain(h, ("experts", "moe_cap", "ffn"))
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"])
    ye = constrain(ye, ("experts", "moe_cap", None))
    ye = ye * (gval.to(xf.dtype) * keep)[..., None]

    # each rank adds its own experts' slots back into every token's row: a
    # pending sum over the ranks that split the slots, resolved once
    out = local(_combine_slots, (("experts", "moe_cap", None), ("experts", "moe_cap"), None),
                out_like=((nt, d), (None, None)), partial=("experts", "moe_cap"))(ye, gidx, nt)
    out = constrain(out, ("moe_tokens", None))

    if mo.n_shared:
        sh = p["shared"]
        hs = act(xf @ sh["wg"]) * (xf @ sh["wi"])
        out = out + hs @ sh["wo"]

    # Switch-style load-balance auxiliary loss
    frac = (affinity > 0).float().mean(dim=0)                      # [E]
    prob_mean = probs.mean(dim=0)                                  # [E]
    aux = mo.n_experts * torch.sum(frac * prob_mean)
    return placed_like(out, xf0).reshape(b, t, d), aux
