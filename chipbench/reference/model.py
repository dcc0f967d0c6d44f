"""The plain reference: a dense llama-family decoder in float32 torch.

Embedding lookup, then per layer: RMSNorm (``x / rms(x) * (1 + scale)``),
q, k, v projections, split-half rotary embedding on q and k, causal
softmax attention with grouped kv heads (query head ``h`` reads kv head
``h // (H / KV)``), the output projection and a residual; RMSNorm, a
SwiGLU MLP (``silu(x @ wg) * (x @ wi) @ w2``) and a residual.  A final
RMSNorm, an untied head, and for training the mean next-token cross
entropy.  Weights come in the layout of ``chipbench.common.weight_shapes``.

No kernel, no cache, no batching of unequal lengths: attention walks its
queries in blocks so that a block's [heads, block, keys] scores fit, and
the callers run it layer by layer or checkpoint each layer.  It imports
nothing of the program.

``Precision`` says how every matrix product's operands are rounded: not at
all (float32, TF32 off: the reference), or to float8 e4m3 with one scale a
tensor (the control, one precision below the configuration's bfloat16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Q_BLOCK = 1024                       # query rows a block of attention takes
FP8_MAX = 448.0                      # the largest float8 e4m3 value


class Precision:
    """Rounding of a product's operands: ``fp8`` False leaves them float32."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to float8 e4m3 at one scale for the tensor, back in
        float32; the gradient passes through unchanged."""
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (q - x).detach() if x.requires_grad else q

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.round(a), self.round(b))


FP32 = Precision()


def no_tf32():
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, positions, theta: float):
    """Split-half rotary embedding: x [B, T, heads, d], positions [T]."""
    d = x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64),
                          torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = positions.to(torch.float64)[:, None] * inv.to(positions.device)
    cos = torch.cos(ang).to(x.dtype)[:, None, :]
    sin = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Precision = FP32):
    """Causal softmax attention: q [B, T, H, d] at the last T of the S
    positions of k, v [B, S, KV, d]; query blocks of ``Q_BLOCK`` rows."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, t, kv, g, d)
    key_pos = torch.arange(s, device=q.device)
    outs = []
    for c in range(0, t, Q_BLOCK):
        qc = qg[:, c:c + Q_BLOCK]
        q_pos = torch.arange(c, c + qc.shape[1], device=q.device) + (s - t)
        scores = prec.mm("btkgd,bskd->bkgts", qc, k) * d ** -0.5
        scores = scores.masked_fill(key_pos[None, :] > q_pos[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        outs.append(prec.mm("bkgts,bskd->btkgd", probs, v))
    return torch.cat(outs, dim=1).reshape(b, t, h, d)


def layer(x, w: dict, positions, theta: float, eps: float, prec: Precision = FP32):
    """One decoder layer on x [B, T, D]: (x, (k, v)), k after its rotary
    embedding.  ``w`` holds the layer's ln1, wq, wk, wv, wo, ln2, wi, wg, w2."""
    h = rms_norm(x, w["ln1"], eps)
    q = rope(prec.mm("btd,dhk->bthk", h, w["wq"]), positions, theta)
    k = rope(prec.mm("btd,dhk->bthk", h, w["wk"]), positions, theta)
    v = prec.mm("btd,dhk->bthk", h, w["wv"])
    x = x + prec.mm("bthk,hkd->btd", attention(q, k, v, prec), w["wo"])
    h = rms_norm(x, w["ln2"], eps)
    gate = F.silu(prec.mm("btd,df->btf", h, w["wg"])) * prec.mm("btd,df->btf", h, w["wi"])
    return x + prec.mm("btf,fd->btd", gate, w["w2"]), (k, v)


def logits(x, final_norm, head, eps: float, prec: Precision = FP32):
    return prec.mm("btd,dv->btv", rms_norm(x, final_norm, eps), head)


def cross_entropy(lg, tokens):
    """Mean next-token cross entropy of logits [B, T, V] on tokens [B, T]."""
    return F.cross_entropy(lg[:, :-1].reshape(-1, lg.shape[-1]), tokens[:, 1:].reshape(-1))


LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wi", "wg", "w2")
