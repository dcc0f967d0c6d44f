"""Shared model layers: norms, rotary embeddings, MLPs, parameter specs.

Layers are plain functions over nested dicts / tuples of tensors, as in the
JAX package.  Parameter specs (shape + dtype + logical axes) come first so
weights can be drawn straight onto the target device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.runtime import shardctx


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/logical-axes description of one parameter tensor."""
    shape: tuple
    axes: tuple                    # logical axis name (or None) per dim
    dtype: str = "bfloat16"
    init: str = "normal"           # normal | zeros | ones | ssm_a | ssm_dt

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def map_specs(fn, tree):
    """Apply ``fn`` to every ParamSpec leaf of a nested dict / tuple tree."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_specs(fn, v) for v in tree)
    raise TypeError(f"unexpected spec tree node {type(tree).__name__}")


_INIT_CHUNK = 1 << 24             # elements drawn per randn call


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    """One weight by the JAX package's rule, drawn on ``device``."""
    dt = spec.torch_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init in ("ssm_a", "ssm_dt"):          # per-head vectors: small
        u = torch.rand(spec.shape, generator=generator, dtype=torch.float32,
                       device=device)
        if spec.init == "ssm_a":                  # A_log in [log 1, log 16]
            return torch.log(u * 15.0 + 1.0).to(dt)
        u = u * (1e-1 - 1e-3) + 1e-3              # softplus^-1(U[1e-3, 1e-1])
        return (u + torch.log(-torch.expm1(-u))).to(dt)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = 0.02 if fan_in == 0 else min(0.02, (1.0 / fan_in) ** 0.5)
    out = torch.empty(spec.shape, dtype=dt, device=device)
    flat = out.view(-1)
    # draw in fp32 a chunk at a time, so the fp32 copy of a multi-GB stacked
    # weight never exists whole
    for start in range(0, flat.numel(), _INIT_CHUNK):
        n = min(_INIT_CHUNK, flat.numel() - start)
        w = torch.randn(n, generator=generator, dtype=torch.float32, device=device)
        flat[start:start + n] = w.mul_(scale).to(dt)
    return out


def init_param_tree(tree, generator: torch.Generator, device: torch.device):
    """Materialize a ParamSpec tree into weights on ``device``.

    The generator must live on ``device`` too, so full-width weights never
    pass through the host.
    """
    return map_specs(lambda s: init_leaf(s, generator, device), tree)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] in fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / torch.pow(theta, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding.  x: [..., T, H, d]; positions: [..., T]."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)                 # [d/2]
    ang = positions[..., None].float() * inv                    # [..., T, d/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_spec(d_model: int, d_ff: int, dtype: str, stacked: int | None = None):
    lead = () if stacked is None else (stacked,)
    lax = () if stacked is None else ("layers",)
    return {
        "wi": ParamSpec(lead + (d_model, d_ff), lax + ("embed", "ffn"), dtype),
        "wg": ParamSpec(lead + (d_model, d_ff), lax + ("embed", "ffn"), dtype),
        "wo": ParamSpec(lead + (d_ff, d_model), lax + ("ffn", "embed_out"), dtype),
    }


def mlp(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """x [B,T,D].  Where the rules split D of the weights (FSDP), the up and
    gate products run rank by rank on x's batch shard with D whole and on
    the weights' ffn shard with D gathered, and the down product gives this
    rank's term of the sum over the ffn shards, a pending sum for the next
    ``constrain``: DTensor's own product contracts the split D without
    gathering the weight and makes whole-ffn pending sums."""
    wg, wi, wo = params["wg"], params["wi"], params["wo"]
    pl = shardctx.placements(wi.shape, ("embed", "ffn"))   # None outside a scope
    if pl is None or not any(p.is_shard(0) for p in pl):
        return _gate(x, wg, wi, act) @ wo
    b, t, d = x.shape
    h = shardctx.local(_gate, (("batch", None, None), (None, "ffn"), (None, "ffn"), None),
                       out_like=((b, t, wi.shape[1]), ("batch", None, "ffn")))(x, wg, wi, act)
    y = shardctx.local(torch.matmul, (("batch", None, "ffn"), ("ffn", None)),
                       out_like=((b, t, d), ("batch", None, None)), partial=("ffn",))(h, wo)
    return shardctx.constrain(y, ("batch", None, None))


def _gate(x, wg, wi, act):
    return activation(act)(x @ wg) * (x @ wi)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
                       n_always_visible: int = 0) -> torch.Tensor:
    """Boolean [.., Tq, Tk] mask: causal, optionally sliding-window.

    ``window`` 0 means global.  ``n_always_visible`` prefix positions (hymba
    meta tokens) are exempt from the window.
    """
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = diff >= 0
    if window > 0:
        always = k_pos[..., None, :] < n_always_visible
        mask = mask & ((diff < window) | always)
    return mask


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE in fp32; logits [..., V], labels [...] integer.

    Under a mesh the per-token NLL runs rank by rank on the logits' vocab
    slice (``_nll``): DTensor's gather over a vocab-split dim has no exact
    rule."""
    lead = ("batch",) + (None,) * (labels.ndim - 1)
    nll = shardctx.local(_nll, (lead + ("vocab",), lead), out_like=1)(logits, labels)
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _nll(logits, labels):
    """``lse - logit[label]`` per token; on a vocab slice, ``_VocabShardNLL``."""
    if shardctx.splits("vocab"):
        return _VocabShardNLL.apply(logits, labels,
                                    logits.shape[-1] * shardctx.axis_index("vocab"))
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def embedding(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a mesh it runs rank by rank: the table keeps
    its vocab split and gives up any split of D (an FSDP gather), each rank
    looks its tokens up in its slice (``_VocabShardLookup``), and the rows
    come back sharded as the tokens.  (DTensor's own index and embedding
    rules differ across torch versions; one fails to place the backward's
    ``index_put``.)  The rule tables never put the batch and the vocab on
    one mesh axis, so a rank's tokens are looked up in every vocab slice."""
    lead = ("batch",) + (None,) * (tokens.ndim - 1)
    return shardctx.local(_lookup, (("vocab", None), lead), out_like=1)(table, tokens)


def _lookup(table, tokens):
    if shardctx.splits("vocab"):
        return _VocabShardLookup.apply(table, tokens,
                                       table.shape[0] * shardctx.axis_index("vocab"))
    return table[tokens]


class _VocabShardLookup(torch.autograd.Function):
    """Rows of this rank's vocab slice of the table for the tokens that fall
    in it, zeros elsewhere, summed over the ranks that hold the other
    slices: each token's row comes from the one rank that holds it.  The
    gradient of the slice is the scatter-add of the output gradient's rows
    of those tokens, with no collective."""

    @staticmethod
    def forward(ctx, table, tokens, offset):
        local = tokens.long() - offset
        inside = (local >= 0) & (local < table.shape[0])
        local = torch.where(inside, local, torch.zeros_like(local))
        out = shardctx.all_reduce_(table[local] * inside[..., None].to(table.dtype),
                                   "vocab")
        ctx.save_for_backward(local, inside)
        ctx.rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        local, inside = ctx.saved_tensors
        rows = g * inside[..., None].to(g.dtype)
        grad = g.new_zeros((ctx.rows, g.shape[-1]))
        grad.index_add_(0, local.reshape(-1), rows.reshape(-1, g.shape[-1]))
        return grad, None, None


class _VocabShardNLL(torch.autograd.Function):
    """Per-token NLL from this rank's vocab slice of the logits: the max,
    the sum of exponentials and the label's logit are all-reduced over the
    ranks that hold the other slices, so each rank gets the whole row's
    log-sum-exp; the gradient (softmax minus one-hot, on the local slice)
    needs no collective."""

    @staticmethod
    def forward(ctx, logits, labels, offset):
        lf = logits.float()
        vloc = lf.shape[-1]
        m = shardctx.all_reduce_(lf.amax(dim=-1), "vocab", "max")
        se = torch.exp(lf - m[..., None]).sum(dim=-1)
        local = labels.long() - offset
        inside = (local >= 0) & (local < vloc)
        ll = torch.gather(lf, -1, local.clamp(0, vloc - 1)[..., None])[..., 0]
        ll = torch.where(inside, ll, torch.zeros_like(ll))
        shardctx.all_reduce_(se, "vocab")
        shardctx.all_reduce_(ll, "vocab")
        lse = torch.log(se) + m
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        grad = torch.exp(logits.float() - lse[..., None])
        vloc = grad.shape[-1]
        grad.scatter_add_(-1, local.clamp(0, vloc - 1)[..., None],
                          -inside.to(grad.dtype)[..., None])
        return (grad * g[..., None]).to(logits.dtype), None, None
