"""The plain reference of a train step: the decoder of ``model.py`` in
float32, gradients summed over the microbatches and divided by their count,
then Adafactor as the JAX package writes it (``repro/runtime/optim.py``):
beta1 0, a second moment factored over each weight's trailing two dims
(decay 0.8, eps 1e-30), the update RMS-clipped at 1 over the whole weight
and scaled by the weight's RMS (at least 1e-3), no weight decay; and the
package's cosine schedule for the learning rate.

Each layer's weights are tensors of their own, so autograd sums each one's
gradient where it is made; a stacked weight's optimizer statistics (the
clip's RMS, the parameter scale, and for a [layers, D] norm stack the
factored moments across its layers) are taken over all its layers, as the
JAX package's stacked leaf has them.  Each layer is recomputed in the
backward (``torch.utils.checkpoint``), so one layer's activations live at
a time.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from chipbench.reference import model as M

EPS1, EPS2, DECAY, CLIP = 1e-30, 1e-3, 0.8, 1.0


def cosine_lr(step: int, peak: float, warmup: int, total: int, floor: float = 0.1) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))


class Model:
    """float32 weights: ``top`` (tok_emb, final_norm, head) and ``layers``
    (one dict of ``model.LAYER_KEYS`` a layer), each a leaf of its own."""

    def __init__(self, weights: dict, eps: float, theta: float):
        """``weights``: the benchmark's drawn weights (stacked), any dtype."""
        self.eps, self.theta = eps, theta
        self.top = {k: weights[k].float().clone().requires_grad_(True)
                    for k in ("tok_emb", "final_norm", "head")}
        n = weights["ln1"].shape[0]
        self.layers = [{k: weights[k][i].float().clone().requires_grad_(True)
                        for k in M.LAYER_KEYS} for i in range(n)]

    def leaves(self):
        """(name, slices, stacked): each weight as the program holds it."""
        out = [(k, [self.top[k]], False) for k in ("tok_emb", "final_norm", "head")]
        return out + [(k, [lw[k] for lw in self.layers], True) for k in M.LAYER_KEYS]

    def loss(self, tokens, prec: M.Precision = M.FP32):
        """Cross entropy of one microbatch tokens [B, T]."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.top["tok_emb"][tokens]
        for w in self.layers:
            x = checkpoint(lambda x, *ws: M.layer(x, dict(zip(M.LAYER_KEYS, ws)), positions,
                                                  self.theta, self.eps, prec)[0],
                           x, *(w[k] for k in M.LAYER_KEYS), use_reentrant=False)
        lg = M.logits(x, self.top["final_norm"], self.top["head"], self.eps, prec)
        return M.cross_entropy(lg, tokens)


def _factored(g, vr, vc, beta2):
    """New (vr, vc) and the unscaled update of a weight's gradient ``g``."""
    g2 = g.square() + EPS1
    vr = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
    vc = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
    denom = vr.mean(dim=-1, keepdim=True)
    vhat = (vr[..., None] / denom[..., None].clamp(min=EPS1)) * vc[..., None, :]
    return vr, vc, g * torch.rsqrt(vhat.clamp(min=EPS1))


class Adafactor:
    def __init__(self, model: Model):
        self.model, self.count, self.state = model, 0, {}

    @torch.no_grad()
    def step(self, lr: float):
        self.count += 1
        beta2 = 1.0 - self.count ** (-DECAY)
        for name, slices, stacked in self.model.leaves():
            if stacked and slices[0].ndim == 1:          # a [layers, D] norm stack
                self._whole(name, slices, torch.stack([p.grad for p in slices]),
                            torch.stack([p.detach() for p in slices]), beta2, lr, True)
            elif stacked:
                self._by_layer(name, slices, beta2, lr)
            else:
                self._whole(name, slices, slices[0].grad, slices[0].detach(), beta2, lr,
                            False)

    def _whole(self, name, slices, g, p, beta2, lr, stacked):
        st = self.state.setdefault(name, None)
        if g.ndim >= 2:
            if st is None:
                st = (torch.zeros_like(g.mean(dim=-1)), torch.zeros_like(g.mean(dim=-2)))
            vr, vc, upd = _factored(g, *st, beta2)
            self.state[name] = (vr, vc)
        else:
            v = torch.zeros_like(g) if st is None else st
            v = beta2 * v + (1 - beta2) * (g.square() + EPS1)
            upd = g * torch.rsqrt(v.clamp(min=EPS1))
            self.state[name] = v
        rms = torch.sqrt(upd.square().mean() + 1e-12)
        upd = upd / torch.clamp(rms / CLIP, min=1.0)
        pscale = torch.clamp(torch.sqrt(p.square().mean()), min=EPS2)
        new = p - lr * pscale * upd
        for i, s in enumerate(slices):
            s.copy_(new[i] if stacked else new)

    def _by_layer(self, name, slices, beta2, lr):
        """A stacked weight of per-layer products: the factored moments are
        each layer's own; the RMS and the scale are the stack's (a first pass
        sums them, a second applies the update)."""
        st = self.state.get(name)
        if st is None:
            st = [(torch.zeros_like(p.mean(dim=-1)), torch.zeros_like(p.mean(dim=-2)))
                  for p in slices]
        new_st, upd_sq, p_sq, n = [], 0.0, 0.0, 0
        for p, (vr, vc) in zip(slices, st):
            vr, vc, upd = _factored(p.grad, vr, vc, beta2)
            new_st.append((vr, vc))
            upd_sq = upd_sq + upd.square().sum()
            p_sq = p_sq + p.detach().square().sum()
            n += p.numel()
            del upd
        rms = torch.sqrt(upd_sq / n + 1e-12)
        pscale = torch.clamp(torch.sqrt(p_sq / n), min=EPS2)
        for p, (vr, vc) in zip(slices, new_st):
            denom = vr.mean(dim=-1, keepdim=True)
            vhat = (vr[..., None] / denom[..., None].clamp(min=EPS1)) * vc[..., None, :]
            upd = p.grad * torch.rsqrt(vhat.clamp(min=EPS1))
            upd = upd / torch.clamp(rms / CLIP, min=1.0)
            p.sub_(lr * pscale * upd)
        self.state[name] = new_st


def leaf_norms(model: Model, of: str = "grad") -> dict:
    """{leaf name: the norm of each slice's gradient (``of`` "grad") or
    weight}, a layer a slice for stacked weights, in float64."""
    out = {}
    for name, slices, _ in model.leaves():
        out[name] = [float((p.grad if of == "grad" else p).detach().double().norm())
                     for p in slices]
    return out


def follow(weights, batches, steps: int, lr_at, eps: float, theta: float,
           prec: M.Precision = M.FP32):
    """The reference's first ``steps`` train steps from the weights that
    ``weights()`` draws (dropped once cast), each on ``batches(step)`` (a list
    of microbatches [B, T]).  Returns (losses, first gradients' norms, the
    model after the steps)."""
    model = Model(weights(), eps, theta)
    opt = Adafactor(model)
    losses, gnorms = [], None
    for step in range(steps):
        micro = batches(step)
        total = 0.0
        for mb in micro:
            loss = model.loss(mb, prec)
            loss.backward()
            total += float(loss.detach())
            del loss
        for _, slices, _ in model.leaves():
            for p in slices:
                p.grad.div_(len(micro))
        losses.append(total / len(micro))
        if step == 0:
            gnorms = leaf_norms(model, "grad")
        opt.step(lr_at(step))
        for _, slices, _ in model.leaves():
            for p in slices:
                p.grad = None
    return losses, gnorms, model
