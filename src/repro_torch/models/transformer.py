"""Generic decoder: the attention families (Yi-6B, deepseek-7b, gemma3-27b,
h2o-danube-3-4b, mixtral-8x7b), MLA with multi-token prediction
(deepseek-v3-671b), the attention-free Mamba-2 (mamba2-370m), the hybrid
heads of hymba-1.5b, and the two modality frontends: the vision prefix of
phi-3-vision-4.2b and the codebooks of musicgen-large.

The layer sequence is decomposed into *stages*, maximal periodic runs of a
repeating unit of layer descriptors, exactly as in the JAX package, so the
stacked per-stage weights keep their leading ``[R, ...]`` axis.  Where JAX
runs a ``lax.scan`` over that axis, this port runs a Python loop over it.

Parameters and caches are nested dicts / tuples of tensors in the JAX
layout: a sliding-window layer's decode cache is a ring of capacity
``window`` (with the meta-token prefix beside it as ``k_pre``/``v_pre``), a
global layer's a full cache, an MLA layer's the latent ``ckv`` and
``krope``, and an SSM or hybrid layer's carries the SSD's fp32 ``state`` and
its ``conv`` window beside them.

The frontends are the JAX package's stubs: a vision config takes
precomputed patch embeddings ``[B, image_tokens, d_model]``, projected by
``img_proj`` and prepended to the text (attended causally, no logits); an
audio config takes ``[B, K, T]`` tokens of K codebooks, sums their K
embeddings and emits K heads (logits ``[B, T, K, V]``).

Where JAX wraps a stage's scan body in ``jax.checkpoint`` (``cfg.remat``),
this port recomputes each layer in the backward with
``torch.utils.checkpoint``, whenever autograd records the forward.  Under
``remat_policy="dots"`` (JAX's ``dots_with_no_batch_dims_saveable``) the
checkpoint is selective: the outputs of the unbatched matrix products are
saved and everything else is recomputed.  ``x @ w`` lowers to ``aten.mm``
(or ``addmm``), and an einsum with no batch dim (``btd,dhk->bthk``) to an
``aten.bmm`` over a batch of one: both are saved.  The score and MoE expert
products are ``bmm`` over real batch dims, and the flash kernel is no aten
op, so they are recomputed, as JAX's policy recomputes batched dots.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (ParamSpec, cross_entropy, embedding, mlp,
                                       mlp_spec, rms_norm)
from repro_torch.runtime import shardctx, trace
from repro_torch.runtime.shardctx import constrain, local


# ---------------------------------------------------------------------------
# Stage decomposition
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LayerDesc:
    kind: str                      # attn | ssm | hybrid
    window: int                    # 0 = global
    moe: bool
    theta: float


@dataclass(frozen=True)
class Stage:
    unit: tuple                    # tuple[LayerDesc]
    repeat: int


def layer_descs(cfg: ModelConfig):
    kinds, wins, moes = cfg.kinds, cfg.layer_windows, cfg.layer_moe
    out = []
    for i in range(cfg.n_layers):
        theta = cfg.rope_theta
        if wins[i] > 0 and cfg.local_rope_theta:
            theta = cfg.local_rope_theta
        out.append(LayerDesc(kinds[i], wins[i], moes[i], theta))
    return out


def build_stages(cfg: ModelConfig, max_unit: int = 8):
    """Greedy periodic decomposition of the layer sequence."""
    descs = layer_descs(cfg)
    n = len(descs)
    stages, i = [], 0
    while i < n:
        best_ul, best_r = 1, 1
        for ul in range(1, min(max_unit, n - i) + 1):
            unit = descs[i:i + ul]
            r = 1
            while descs[i + r * ul: i + (r + 1) * ul] == unit:
                r += 1
            if r >= 2 and ul * r > best_ul * best_r:
                best_ul, best_r = ul, r
        stages.append(Stage(tuple(descs[i:i + best_ul]), best_r))
        i += best_ul * best_r
    return stages


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _layer_spec(cfg: ModelConfig, desc: LayerDesc, lead: tuple):
    d = cfg.d_model
    la = ("layers",) * len(lead)
    dt = cfg.param_dtype
    spec = {"ln1": ParamSpec(lead + (d,), la + (None,), dt, init="zeros")}
    if desc.kind in ("attn", "hybrid"):
        spec["attn"] = (attn.mla_spec(cfg, lead) if cfg.mla is not None
                        else attn.gqa_spec(cfg, lead))
    if desc.kind in ("ssm", "hybrid"):
        spec["ssm"] = ssm_mod.ssm_spec(cfg, lead)
    if desc.kind == "hybrid":
        spec["ln_a"] = ParamSpec(lead + (d,), la + (None,), dt, init="zeros")
        spec["ln_s"] = ParamSpec(lead + (d,), la + (None,), dt, init="zeros")
    if desc.kind == "ssm":                       # mamba block has no extra FFN
        return spec
    spec["ln2"] = ParamSpec(lead + (d,), la + (None,), dt, init="zeros")
    if desc.moe:
        spec["ffn"] = moe_mod.moe_spec(cfg, lead)
    else:
        dff = cfg.dense_d_ff if cfg.moe is not None else cfg.d_ff
        spec["ffn"] = mlp_spec(d, dff, dt, stacked=lead[0] if lead else None)
    return spec


def param_specs(cfg: ModelConfig):
    d, v, k = cfg.d_model, cfg.vocab, cfg.n_codebooks
    dt = cfg.param_dtype
    if k > 1:
        spec = {"tok_emb": ParamSpec((k, v, d), (None, "vocab", "embed"), dt)}
    else:
        spec = {"tok_emb": ParamSpec((v, d), ("vocab", "embed"), dt)}
    if cfg.meta_tokens:
        spec["meta"] = ParamSpec((cfg.meta_tokens, d), (None, "embed"), dt)
    if cfg.frontend == "vision":
        spec["img_proj"] = ParamSpec((d, d), ("embed", "embed_out"), dt)
    spec["stages"] = tuple(
        {f"u{j}": _layer_spec(cfg, desc, (st.repeat,))
         for j, desc in enumerate(st.unit)}
        for st in build_stages(cfg))
    spec["final_norm"] = ParamSpec((d,), (None,), dt, init="zeros")
    if not cfg.tie_embeddings:
        if k > 1:
            spec["head"] = ParamSpec((k, d, v), (None, "embed", "vocab"), dt)
        else:
            spec["head"] = ParamSpec((d, v), ("embed", "vocab"), dt)
    if cfg.mtp_depth:
        blk = _layer_spec(cfg, _mtp_desc(cfg), ())
        blk["ffn"] = mlp_spec(d, cfg.dense_d_ff or cfg.d_ff or 4 * d, dt)  # dense in MoE archs
        spec["mtp"] = {
            "proj": ParamSpec((2 * d, d), (None, "embed_out"), dt),
            "ln_h": ParamSpec((d,), (None,), dt, init="zeros"),
            "ln_e": ParamSpec((d,), (None,), dt, init="zeros"),
            "block": blk,
            "ln_out": ParamSpec((d,), (None,), dt, init="zeros"),
        }
    return spec


def _mtp_desc(cfg: ModelConfig) -> LayerDesc:
    """The multi-token prediction block: a global attention layer, dense."""
    return LayerDesc("attn", 0, False, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _ring_pack(k, window: int, n_meta: int):
    """Pack full-sequence keys/values into a ring cache of capacity window.

    Under a mesh it runs rank by rank on k's batch and kv shard with the
    whole sequence, and the ring is then placed on the cache's axes (a
    slice of each rank's ring): DTensor's ``new_zeros`` would make the
    ring replicated, the whole global batch on every rank."""
    b, t, kv, dh = k.shape
    ring = local(_pack, (("batch", None, "kv", None), None, None),
                 out_like=((b, window, kv, dh), ("batch", None, "kv", None)))(k, window, n_meta)
    return constrain(ring, ("batch", "kv_seq", "kv", None))


def _pack(k, window: int, n_meta: int):
    b, t, kv, dh = k.shape
    w = min(window, max(t - n_meta, 1))
    start = max(n_meta, t - w)
    positions = torch.arange(start, t, device=k.device)
    ring = k.new_zeros((b, window, kv, dh))
    ring[:, positions % window] = k[:, start:]
    return ring


def _ffn(cfg, desc, p, h):
    """The layer's FFN: (y, aux_loss), the aux loss MoE's (0 when dense)."""
    if desc.moe:
        return moe_mod.moe_apply(cfg, p["ffn"], h, cfg.moe.router)
    return mlp(p["ffn"], h, cfg.act), 0.0


def _ssd(cfg, p, h, collect, entry):
    """The layer's SSD over the full sequence; under ``collect`` its decode
    handoff (``state``, ``conv``) goes into ``entry``."""
    if not collect:
        return ssm_mod.ssd_forward(cfg, p["ssm"], h)
    out, st = ssm_mod.ssd_forward(cfg, p["ssm"], h, return_state=True)
    entry.update(st)
    return out


def _attn_forward(cfg, desc, p, h, positions, n_meta, collect, use_flash):
    """The layer's attention over the full sequence, and under ``collect``
    its cache tensors: MLA's latent (MLA takes no flash, as in the JAX
    package) or GQA's k, v."""
    if cfg.mla is not None:
        return attn.mla_forward(cfg, p["attn"], h, positions, n_meta=n_meta,
                                return_latent=collect)
    return attn.gqa_forward(p["attn"], h, positions, window=desc.window,
                            theta=desc.theta, n_meta=n_meta,
                            return_kv=collect, use_flash=use_flash)


def layer_forward(cfg, desc, p, x, positions, n_meta, *, collect=False,
                  use_flash=False):
    """One layer, full sequence.  Returns (x, cache_entry, aux_loss)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    entry = {}
    if desc.kind == "ssm":                       # mamba block: no extra FFN
        return x + _ssd(cfg, p, h, collect, entry), entry, 0.0
    out = _attn_forward(cfg, desc, p, h, positions, n_meta, collect, use_flash)
    if collect and cfg.mla is not None:
        out, (entry["ckv"], entry["krope"]) = out
    elif collect:
        out, (k, v) = out
        if desc.window > 0:
            entry["k"] = _ring_pack(k, desc.window, n_meta)
            entry["v"] = _ring_pack(v, desc.window, n_meta)
            if n_meta:
                # copies, as the conv tail's (``ssm.ssd_forward``)
                entry["k_pre"] = k[:, :n_meta].clone()
                entry["v_pre"] = v[:, :n_meta].clone()
        else:
            entry["k"], entry["v"] = k, v
    if desc.kind == "hybrid":                    # parallel attention + SSM
        s_out = _ssd(cfg, p, h, collect, entry)
        out = 0.5 * (rms_norm(out, p["ln_a"], cfg.norm_eps)
                     + rms_norm(s_out, p["ln_s"], cfg.norm_eps))
    x = x + out
    y, aux = _ffn(cfg, desc, p, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + y, entry, aux


def layer_decode(cfg, desc, p, x, cache, pos: int):
    """One layer, one new token against its cache (updated in place: the
    attention half writes its k/v slot or MLA's latent slot, the SSD half
    its state and conv window, each reading only its own entries of a
    hybrid layer's cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if desc.kind == "ssm":
        out, _ = ssm_mod.ssd_decode(cfg, p["ssm"], h, cache)
        return x + out, cache
    if cfg.mla is not None:
        out, _ = attn.mla_decode(cfg, p["attn"], h, cache, pos)
    else:
        out, _ = attn.gqa_decode(p["attn"], h, cache, pos, window=desc.window,
                                 theta=desc.theta, n_meta=0)
    if desc.kind == "hybrid":
        s_out, _ = ssm_mod.ssd_decode(cfg, p["ssm"], h, cache)
        out = 0.5 * (rms_norm(out, p["ln_a"], cfg.norm_eps)
                     + rms_norm(s_out, p["ln_s"], cfg.norm_eps))
    x = x + out
    y, _ = _ffn(cfg, desc, p, rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + y, cache


# ---------------------------------------------------------------------------
# Stage execution: a loop over the stacked [R, ...] axis
# ---------------------------------------------------------------------------

def _layers(tree, n: int):
    """A stacked dict tree as its ``n`` layers: one ``unbind`` of each leaf,
    each layer a dict of views (no copies).  The backward of ``unbind``
    stacks the layers' gradients once, where a ``v[r]`` per layer would
    allocate a zero gradient the size of the whole stack for each layer and
    add them up; the reference's scan writes each layer's gradient into its
    own slice."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _layers(v, n) if isinstance(v, dict) else v.unbind(0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


class _ReadLate(dict):
    """A stage of one layer as that layer: each read of a leaf gives its
    view without the stacked dim (``squeeze``, whose backward is a view,
    through ``shardctx.grad_placed``), made at the read.  The backward runs
    the nodes made later first, so a view made before the layer (``_layers``'
    ``unbind``) holds each leaf's gradient until the layer's whole backward
    is done; made where the layer reads the leaf, it hands the gradient on
    as soon as it is made, to the train step's accumulator
    (``runtime/steps.py``): deepseek-v3's three [256, 7168, 2048] expert
    gradients are never live together."""

    def __getitem__(self, key):
        v = super().__getitem__(key)
        if isinstance(v, dict):
            return _ReadLate(v)
        return shardctx.grad_placed(v.squeeze(0))


def _placed(tree):
    """A layer's dict of views, each through ``shardctx.grad_placed``."""
    return {k: _placed(v) if isinstance(v, dict) else shardctx.grad_placed(v)
            for k, v in tree.items()}


_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def unbatched_product(op, args) -> bool:
    """Whether an aten call is a matrix product with no batch dim: ``mm``,
    ``addmm``, or a ``bmm`` over a batch of one (how einsum lowers an
    unbatched contraction)."""
    return op in _MM or (op is torch.ops.aten.bmm.default and args[0].shape[0] == 1)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if unbatched_product(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(cfg: ModelConfig, collect: bool):
    """The checkpoint's keyword arguments when each layer is to be
    recomputed in the backward (``cfg.remat``, while autograd records a
    forward that collects no caches), else ``None``.  ``"dots"`` saves the
    unbatched matmuls; any other policy recomputes everything, as in the
    JAX package."""
    if not (cfg.remat and torch.is_grad_enabled() and not collect):
        return None
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = _dots_context
    return kw


def _in_backward() -> bool:
    """Whether autograd is running a backward on this thread (remat's
    re-run of a layer)."""
    return torch._C._current_graph_task_id() != -1


def stage_forward(cfg, stage: Stage, sp, x, positions, n_meta, *,
                  collect=False, use_flash=False):
    entries = {f"u{j}": [] for j in range(len(stage.unit))}
    aux = 0.0
    remat = _remat(cfg, collect)
    mesh_scope = shardctx.current()

    def recomputable(h, lp, d, i):
        # the backward reruns this on autograd's device thread: it takes up
        # the mesh scope of the forward, and its span tells the re-run apart
        with shardctx.reenter(mesh_scope), trace.span(
                "model.recompute" if _in_backward() else "model.layer", i):
            return layer_forward(cfg, d, lp, h, positions, n_meta,
                                 use_flash=use_flash)[::2]
    late = stage.repeat == 1 and torch.is_grad_enabled()
    layers = [[_ReadLate(sp[f"u{j}"])] if late else _layers(sp[f"u{j}"], stage.repeat)
              for j in range(len(stage.unit))]
    for r in range(stage.repeat):
        for j, desc in enumerate(stage.unit):
            # under a mesh each layer's gradient takes its leaf's placements
            # as it is made (DTensor would return it as a pending sum at the
            # global shape); placed here, next to the layer, the backward
            # places it as soon as the layer's backward has made it, where
            # a placement made before the loop would wait for every layer's
            p = layers[j][r] if late else _placed(layers[j][r])
            i = r * len(stage.unit) + j
            if remat is not None:
                # the layer has no randomness: no RNG state to keep; the
                # aux loss comes out with x, as in the JAX package's carry
                x, a = checkpoint(recomputable, x, p, desc, i, **remat)
                e = {}
            else:
                with trace.span("model.layer", i):
                    x, e, a = layer_forward(cfg, desc, p, x, positions, n_meta,
                                            collect=collect, use_flash=use_flash)
            entries[f"u{j}"].append(e)
            aux = aux + a
    caches = {u: {k: torch.stack([e[k] for e in es]) for k in es[0]}
              for u, es in entries.items()}
    return x, caches, aux


def stage_decode(cfg, stage: Stage, sp, x, cache, pos: int):
    units = [(_layers(sp[f"u{j}"], stage.repeat), _layers(cache[f"u{j}"], stage.repeat))
             for j in range(len(stage.unit))]
    for r in range(stage.repeat):
        for j, desc in enumerate(stage.unit):
            x, _ = layer_decode(cfg, desc, units[j][0][r], x, units[j][1][r], pos)
    return x, cache


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens):
    """tokens [B,T], or [B,K,T] for K codebooks (the sum of their K
    embeddings, in the JAX package's order)."""
    if cfg.n_codebooks > 1:
        x = sum(embedding(params["tok_emb"][k], tokens[:, k])
                for k in range(cfg.n_codebooks))
    else:
        x = embedding(params["tok_emb"], tokens)
    if cfg.scale_embeddings:
        # the scale is rounded to the activation dtype first, as the JAX
        # package rounds it (5376 ** 0.5 = 73.32 is 73.5 in bf16)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return x


def lm_head(cfg: ModelConfig, params, x):
    """Logits [B,T,V], or [B,T,K,V] for K codebooks, placed ("batch", None,
    "vocab").  Under a mesh the product runs rank by rank on x's batch
    shard with d whole and on the head's vocab shard with d gathered, so
    each rank makes only its shard of the logits: DTensor's own einsum of
    an FSDP head (d split over "data") makes pending sums of the global
    batch's logits over the whole vocab."""
    b, t = x.shape[:2]
    if cfg.tie_embeddings:
        eq, w, w_axes = "btd,vd->btv", params["tok_emb"], ("vocab", None)
        out = (b, t, w.shape[0]), ("batch", None, "vocab")
    elif cfg.n_codebooks > 1:
        eq, w, w_axes = "btd,kdv->btkv", params["head"], (None, None, "vocab")
        out = (b, t) + w.shape[::2], ("batch", None, None, "vocab")
    else:
        eq, w, w_axes = "btd,dv->btv", params["head"], (None, "vocab")
        out = (b, t, w.shape[1]), ("batch", None, "vocab")
    with trace.span("model.head"):
        return local(lambda x, w: torch.einsum(eq, x, w), (("batch", None, None), w_axes),
                     out_like=out)(x, w)


# ---------------------------------------------------------------------------
# Full forward / prefill / decode
# ---------------------------------------------------------------------------

def model_forward(cfg: ModelConfig, params, tokens, image_embeds=None, *,
                  collect=False, use_flash=False):
    """Returns (logits, hidden, caches, aux, n_prefix).  A vision config's
    ``image_embeds`` [B,P,D] are cast to the activation dtype, projected and
    prepended: the P prefix positions are attended causally (they are not
    window-exempt meta tokens) and get no logits."""
    x = embed_tokens(cfg, params, tokens)
    n_prefix = 0
    if cfg.frontend == "vision" and image_embeds is not None:
        img = image_embeds.to(x.dtype) @ params["img_proj"]
        x = torch.cat([img, x], dim=1)
        n_prefix = img.shape[1]
    if cfg.meta_tokens:
        meta = params["meta"][None].expand((x.shape[0],) + params["meta"].shape)
        x = torch.cat([meta.to(x.dtype), x], dim=1)
        n_prefix = cfg.meta_tokens
    positions = torch.arange(x.shape[1], device=x.device)
    n_meta = cfg.meta_tokens                     # window-exempt prefix length
    caches, aux = [], 0.0
    for si, st in enumerate(build_stages(cfg)):
        x, c, a = stage_forward(cfg, st, params["stages"][si], x, positions,
                                n_meta, collect=collect, use_flash=use_flash)
        caches.append(c)
        aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(cfg, params, x[:, n_prefix:]), x, tuple(caches), aux, n_prefix


def prefill(cfg: ModelConfig, params, tokens, image_embeds=None,
            use_flash=False):
    """Full-sequence forward collecting decode caches.

    Returns (last_logits, cache) where cache = {"stages": ..., "pos": T}.
    """
    logits, _, caches, _, n_prefix = model_forward(
        cfg, params, tokens, image_embeds, collect=True, use_flash=use_flash)
    cache = {"stages": caches, "pos": tokens.shape[-1] + n_prefix}
    return logits[:, -1:], cache


def _mtp_loss(cfg: ModelConfig, params, hidden, tokens, n_prefix: int):
    """DeepSeek-V3's multi-token prediction (depth 1): from the final hidden
    state at t and the embedding of token t + 1, predict token t + 2."""
    mp = params["mtp"]
    h = hidden[:, n_prefix:]                      # [B,T,D] text region
    emb = embed_tokens(cfg, params, tokens)
    h_in = torch.cat([rms_norm(h[:, :-1], mp["ln_h"], cfg.norm_eps),
                      rms_norm(emb[:, 1:], mp["ln_e"], cfg.norm_eps)], dim=-1) @ mp["proj"]
    positions = torch.arange(h_in.shape[1], device=h_in.device)
    # one layer called directly, as the reference calls it: no meta tokens,
    # no remat
    h1, _, _ = layer_forward(cfg, _mtp_desc(cfg), mp["block"], h_in, positions, 0)
    logits = lm_head(cfg, params, rms_norm(h1, mp["ln_out"], cfg.norm_eps))   # [B,T-1,V]
    return cross_entropy(logits[:, :-1], tokens[:, 2:])


def train_loss(cfg: ModelConfig, params, batch, use_flash=False):
    """batch: {"tokens": [B,T] | [B,K,T], "image_embeds"?: [B,P,D]}.
    Returns (loss, metrics): the mean next-token cross entropy over the text
    positions (for K codebooks the mean of the K per-codebook ones), plus
    ``cfg.moe_aux_coef`` times the MoE load-balance loss for an MoE config
    and ``cfg.mtp_loss_weight`` times the multi-token prediction loss where
    ``cfg.mtp_depth`` is set, as the JAX package's ``train_loss``."""
    tokens = batch["tokens"]
    logits, hidden, _, aux, n_prefix = model_forward(cfg, params, tokens,
                                                     batch.get("image_embeds"),
                                                     use_flash=use_flash)
    if cfg.n_codebooks > 1:
        loss = sum(cross_entropy(logits[:, :-1, k], tokens[:, k, 1:])
                   for k in range(cfg.n_codebooks)) / cfg.n_codebooks
    else:
        loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
    metrics = {"ce": loss}
    if cfg.moe is not None:
        loss = loss + cfg.moe_aux_coef * aux
        metrics["aux"] = aux
    if cfg.mtp_depth:
        mtp = _mtp_loss(cfg, params, hidden, tokens, n_prefix)
        loss = loss + cfg.mtp_loss_weight * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def decode_step(cfg: ModelConfig, params, cache, tokens_new):
    """One decode step. tokens_new: [B,1] (or [B,K,1] for K codebooks).

    The caches in ``cache`` are written in place; the returned cache holds
    the same tensors with ``pos`` advanced by one.
    """
    pos = cache["pos"]
    with trace.span("decode.step", pos):
        x = embed_tokens(cfg, params, tokens_new)
        for si, st in enumerate(build_stages(cfg)):
            x, _ = stage_decode(cfg, st, params["stages"][si], x,
                                cache["stages"][si], pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return lm_head(cfg, params, x), {"stages": cache["stages"], "pos": pos + 1}


def grow_cache(cfg: ModelConfig, cache, capacity: int):
    """Pad the full-attention and MLA caches along the sequence axis to
    ``capacity``.

    Ring (windowed) caches, the meta-token prefix and SSM states are already
    fixed-size.  Call after :func:`prefill` to make room for decode steps.
    """
    names = ("ckv", "krope") if cfg.mla is not None else ("k", "v")
    new_stages = []
    for st, sc in zip(build_stages(cfg), cache["stages"]):
        sc = dict(sc)
        for j, desc in enumerate(st.unit):
            if desc.kind == "ssm" or (desc.window > 0 and cfg.mla is None):
                continue
            e = dict(sc[f"u{j}"])
            for name in names:
                arr = e[name]                  # [R,B,S,KV,dh]; MLA's [R,B,S,r]
                if arr.shape[2] < capacity:
                    new = arr.new_zeros(arr.shape[:2] + (capacity,) + arr.shape[3:])
                    new[:, :, :arr.shape[2]] = arr
                    e[name] = new
            sc[f"u{j}"] = e
        new_stages.append(sc)
    return {"stages": tuple(new_stages), "pos": cache["pos"]}


# ---------------------------------------------------------------------------
# Cache specs (for the dry-run's decode cells)
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """ParamSpec tree of prefill()'s cache layout at capacity ``seq_len``, the
    JAX package's leaf for leaf: GQA's k/v (a windowed layer's ring of
    capacity ``min(window, seq_len)``, its meta prefix as ``k_pre``/``v_pre``),
    MLA's ``ckv``/``krope``, the SSD's fp32 ``state`` and its ``conv``
    window.  ``pos`` keeps the reference's int32 scalar spec so the trees
    compare; the port's cache carries it as a Python int (the dry-run binds
    it to a stated position, ``launch/dryrun.py``)."""
    kvd = cfg.head_dim
    dt = cfg.compute_dtype
    out = []
    for st in build_stages(cfg):
        lead = (st.repeat,)
        la = ("layers",)
        sdict = {}
        for j, desc in enumerate(st.unit):
            e = {}
            if desc.kind in ("attn", "hybrid"):
                if cfg.mla is not None:
                    m = cfg.mla
                    e["ckv"] = ParamSpec(lead + (batch, seq_len, m.kv_lora_rank),
                                         la + ("batch", "kv_seq", None), dt)
                    e["krope"] = ParamSpec(lead + (batch, seq_len, m.qk_rope_dim),
                                           la + ("batch", "kv_seq", None), dt)
                else:
                    cap = min(desc.window, seq_len) if desc.window else seq_len
                    shp = lead + (batch, cap, cfg.n_kv_heads, kvd)
                    ax = la + ("batch", "kv_seq", "kv", None)
                    e["k"] = ParamSpec(shp, ax, dt)
                    e["v"] = ParamSpec(shp, ax, dt)
                    if cfg.meta_tokens and desc.window:
                        pshp = lead + (batch, cfg.meta_tokens, cfg.n_kv_heads, kvd)
                        pax = la + ("batch", None, "kv", None)
                        e["k_pre"] = ParamSpec(pshp, pax, dt)
                        e["v_pre"] = ParamSpec(pshp, pax, dt)
            if desc.kind in ("ssm", "hybrid"):
                s, d_in, nh, conv_dim = ssm_mod._dims(cfg)
                e["state"] = ParamSpec(lead + (batch, nh, s.head_dim, s.d_state),
                                       la + ("batch", "heads", None, None), "float32")
                e["conv"] = ParamSpec(lead + (batch, s.d_conv - 1, conv_dim),
                                      la + ("batch", None, "ffn"), dt)
            sdict[f"u{j}"] = e
        out.append(sdict)
    return {"stages": tuple(out), "pos": ParamSpec((), (), "int32", init="zeros")}
