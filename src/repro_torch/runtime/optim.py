"""Optimizers: AdamW and Adafactor with spec-level state, as the JAX package
writes them (``repro/runtime/optim.py``), on tensors.

State trees mirror the parameter tree, with first-class specs
(``opt_state_specs``) so the state is drawn on the device like the weights;
moments are in ``cfg.opt_dtype``.  The JAX functions return new trees; these
update the parameters, the state and (inside the update) the gradients in
place, which spares a full-width run copies of its largest trees (Yi-6B at 8
layers: 3.8 GB of bf16 params, 15.3 GB of fp32 moments, 7.6 GB of fp32
gradients), and return the same trees.  Arithmetic follows the reference
term by term in fp32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamSpec, map_specs
from repro_torch.runtime.shardctx import is_dtensor, placed_like
from repro_torch.runtime.tree import leaves, tree_map


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``floor_frac * peak_lr``: a 0-d
    fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by leaf
    in the JAX package's order."""
    total = None
    for g in leaves(tree):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(clipped copy of the tree, its global norm before clipping)."""
    tree = tree_map(torch.clone, tree)
    return tree, _clip_(tree, max_norm)


def _clip_(tree, max_norm: float) -> torch.Tensor:
    """``clip_by_global_norm`` in place; returns the norm before clipping."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in leaves(tree):
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return gn


def _store(dst: torch.Tensor, value: torch.Tensor) -> None:
    """Write an fp32 result into ``dst``, in its dtype (no-op if it is dst)."""
    if value is not dst:
        dst.copy_(value)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0


def adamw_state_specs(pspecs, opt_dtype: str):
    def moment(s):
        return ParamSpec(s.shape, s.axes, opt_dtype, init="zeros")
    return {"mu": map_specs(moment, pspecs), "nu": map_specs(moment, pspecs),
            "count": ParamSpec((), (), "int32", init="zeros")}


# AdamW walks each leaf in slices along its first axis of at most this many
# entries, so that each fp32 temporary of its update is at most 512 MB
# (gemma3-27b's 262,144 x 5376 embedding made 5.6 GB ones whole)
ADAMW_SLICE = 1 << 27


def _first_axis_slices(*xs):
    """Views of ``xs`` (tensors of one shape) in slices along their first
    axis of at most ``ADAMW_SLICE`` entries each, at least one row; the
    tensors whole where they are small or DTensors (whose first axis a mesh
    may split)."""
    x = xs[0]
    if x.numel() <= ADAMW_SLICE or any(map(is_dtensor, xs)):
        yield xs
        return
    rows = max(1, ADAMW_SLICE // (x.numel() // x.shape[0]))
    for i in range(0, x.shape[0], rows):
        yield tuple(t[i:i + rows] for t in xs)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params, lr):
    """One AdamW step with global-norm clipping.  Updates ``params``,
    ``state`` and ``grads`` in place, each leaf slice by slice
    (``_first_axis_slices``: the update is elementwise, so the slices give
    the whole leaf's update bit for bit); returns (params, state, gnorm)."""
    gnorm = _clip_(grads, cfg.clip)
    state["count"].add_(1)
    c = state["count"].float()
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c
    for leaf in zip(leaves(grads), leaves(state["mu"]), leaves(state["nu"]),
                    leaves(params)):
        decay = leaf[3].ndim >= 2                       # decoupled weight decay
        for g, mu, nu, p in _first_axis_slices(*leaf):
            g32 = g.float()
            mu2 = mu.float().mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            nu2 = nu.float().mul_(cfg.b2).add_((1 - cfg.b2) * g32.square())
            step = (mu2 / bc1).div_(torch.sqrt(nu2 / bc2).add_(cfg.eps))
            if decay:
                step.add_(cfg.weight_decay * p.float())
            step.mul_(lr)
            _store(p, p.float().sub_(step) if p.dtype == torch.float32
                   else p.float() - step)
            _store(mu, mu2)
            _store(nu, nu2)
    return params, state, gnorm


# ---------------------------------------------------------------------------
# Adafactor (beta1=0, factored second moment over trailing two dims)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8              # t^-decay second-moment decay exponent
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_rms: float = 1.0
    weight_decay: float = 0.0


def adafactor_state_specs(pspecs, opt_dtype: str):
    def slot(s: ParamSpec):
        if len(s.shape) >= 2:
            return {
                "vr": ParamSpec(s.shape[:-1], s.axes[:-1], opt_dtype, init="zeros"),
                "vc": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                s.axes[:-2] + s.axes[-1:], opt_dtype,
                                init="zeros"),
            }
        return {"v": ParamSpec(s.shape, s.axes, opt_dtype, init="zeros")}

    return {"slots": map_specs(slot, pspecs),
            "count": ParamSpec((), (), "int32", init="zeros")}


# Adafactor walks a factored leaf in slices along its axes before the last
# two (a stacked leaf's layers, an expert leaf's experts) of at most this
# many entries: each slice's vr, vc and denominator are its own rows', so
# its fp32 temporaries are at most 512 MB (deepseek-v3's [1, 256, 7168,
# 2048] expert leaves made 15 GB ones whole)
ADAFACTOR_SLICE = 1 << 27


def _factors(cfg: AdafactorConfig, beta2, g32, vr, vc):
    """The new fp32 factors (vr, vc) of a factored leaf, or of a slice of its
    lead rows, from its fp32 gradient and its old factors."""
    g2 = g32.square().add_(cfg.eps1)
    # each factor in its slot's placements before the outer product, so
    # that vhat is made at g's shard shape: a factor's mean over a split
    # dim is a pending sum, and DTensor would resolve it after the
    # product, on the leaf's whole shape
    return (placed_like(beta2 * vr.float() + (1 - beta2) * g2.mean(dim=-1), vr),
            placed_like(beta2 * vc.float() + (1 - beta2) * g2.mean(dim=-2), vc))


def _factored_update(cfg: AdafactorConfig, g32, vr, vc):
    """The unscaled update ``g32 * rsqrt(vhat)``, vhat made from the factors
    and consumed in place (the head's whole [7168, 129280] leaf makes 3.7 GB
    fp32 temporaries)."""
    denom = vr.mean(dim=-1, keepdim=True)
    vhat = (vr[..., None] / torch.clamp(denom[..., None], min=cfg.eps1)) \
        * vc[..., None, :]
    return vhat.clamp_(min=cfg.eps1).rsqrt_().mul_(g32)


def _apply(cfg: AdafactorConfig, p, upd, rms, pscale, lr):
    """``p`` less its step: the unscaled update ``upd`` (consumed) RMS-clipped
    and scaled by the parameter scale (the Adafactor rule)."""
    upd.div_(torch.clamp(rms / cfg.clip_rms, min=1.0))
    p32 = p.float()
    step = upd.mul_(lr * pscale)
    if cfg.weight_decay and p.ndim >= 2:
        step = step + lr * cfg.weight_decay * p32
    _store(p, p32.sub_(step))


def _lead_rows(x, keep: int, rows: int):
    """Views of ``x`` in slices of at most ``rows`` of its lead rows, the
    axes before its last ``keep`` flattened."""
    x = x.view((-1,) + tuple(x.shape[x.ndim - keep:]))
    return [x[i:i + rows] for i in range(0, x.shape[0], rows)]


def _slice_rows(g) -> int:
    """Lead rows a slice of a factored leaf takes, or 0 to keep it whole: a
    DTensor, a leaf of at most ``ADAFACTOR_SLICE`` entries, one with too few
    lead rows to split, or one whose rows are not a view."""
    if g.ndim < 3 or g.numel() <= ADAFACTOR_SLICE or is_dtensor(g) or not g.is_contiguous():
        return 0
    rows = max(1, ADAFACTOR_SLICE // (g.shape[-2] * g.shape[-1]))
    return rows if rows < g.numel() // (g.shape[-2] * g.shape[-1]) else 0


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads, state, params, lr):
    """One Adafactor step.  Updates ``params`` and ``state`` in place;
    returns (params, state, gnorm).  A factored leaf that ``_slice_rows``
    splits goes slice by slice (``_adafactor_slices``)."""
    state["count"].add_(1)
    c = state["count"].float()
    beta2 = 1.0 - c ** (-cfg.decay)
    total = None                      # the gnorm's sum, leaf by leaf
    for g, slot, p in zip(leaves(grads), _slot_list(state["slots"], params),
                          leaves(params)):
        rows = _slice_rows(g)
        if rows:
            sq = _adafactor_slices(cfg, beta2, g, slot, p, lr, rows)
        else:
            g32 = g.float()
            sq = g32.square().sum()
            if g.ndim >= 2:
                vr, vc = _factors(cfg, beta2, g32, slot["vr"], slot["vc"])
                upd = _factored_update(cfg, g32, vr, vc)
                _store(slot["vr"], vr)
                _store(slot["vc"], vc)
            else:
                v = beta2 * slot["v"].float() + (1 - beta2) * (g32.square() + cfg.eps1)
                upd = g32 * torch.rsqrt(torch.clamp(v, min=cfg.eps1))
                _store(slot["v"], v)
            del g32
            rms = torch.sqrt(upd.square().mean() + 1e-12)
            pscale = torch.clamp(torch.sqrt(p.float().square().mean()), min=cfg.eps2)
            _apply(cfg, p, upd, rms, pscale, lr)
        total = sq if total is None else total + sq
    return params, state, torch.sqrt(total)


def _adafactor_slices(cfg, beta2, g, slot, p, lr, rows):
    """``adafactor_update`` on one factored leaf in slices of ``rows`` lead
    rows, in two passes: first each slice's factors (the whole leaf's bit
    for bit: each row's means are its own) and the fp32 sums of squares of
    the gradient, the unscaled update and the parameter; then each slice's
    update again, RMS-clipped and scaled by the whole leaf's RMS and
    parameter scale (each sum over the slices, divided once by ``numel``,
    so they may differ from the whole leaf's means in the last bits), and
    applied.  Returns the gradient's sum of squares."""
    parts = list(zip(_lead_rows(g, 2, rows), _lead_rows(p, 2, rows),
                     _lead_rows(slot["vr"], 1, rows), _lead_rows(slot["vc"], 1, rows)))
    sums, factors = torch.zeros(3, device=g.device), []
    for gs, ps, vr, vc in parts:
        g32 = gs.float()
        vr, vc = _factors(cfg, beta2, g32, vr, vc)
        factors.append((vr, vc))
        upd = _factored_update(cfg, g32, vr, vc)
        sums += torch.stack([g32.square().sum(), upd.square().sum(),
                             ps.float().square().sum()])
        del g32, upd
    rms = torch.sqrt(sums[1] / g.numel() + 1e-12)
    pscale = torch.clamp(torch.sqrt(sums[2] / g.numel()), min=cfg.eps2)
    for (gs, ps, vr_slot, vc_slot), (vr, vc) in zip(parts, factors):
        _apply(cfg, ps, _factored_update(cfg, gs.float(), vr, vc), rms, pscale, lr)
        _store(vr_slot, vr)
        _store(vc_slot, vc)
    return sums[0]


def _slot_list(slots, params):
    """The per-parameter slot dicts, in the order of ``leaves(params)``."""
    if isinstance(params, dict):
        return [s for k in sorted(params) for s in _slot_list(slots[k], params[k])]
    if isinstance(params, (tuple, list)):
        return [s for i, x in enumerate(params) for s in _slot_list(slots[i], x)]
    return [slots]


# ---------------------------------------------------------------------------
# Uniform facade
# ---------------------------------------------------------------------------

def opt_state_specs(model_cfg: ModelConfig, pspecs):
    if model_cfg.optimizer == "adafactor":
        return adafactor_state_specs(pspecs, model_cfg.opt_dtype)
    return adamw_state_specs(pspecs, model_cfg.opt_dtype)


def opt_update(model_cfg: ModelConfig, grads, state, params, lr):
    if model_cfg.optimizer == "adafactor":
        return adafactor_update(AdafactorConfig(), grads, state, params, lr)
    return adamw_update(AdamWConfig(), grads, state, params, lr)
