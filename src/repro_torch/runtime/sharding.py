"""Logical-axis sharding rules and DTensor placements on a ``DeviceMesh``.

Every parameter, cache and activation spec carries *logical* axis names
("embed", "heads", "batch", "kv_seq", ...).  A rule table, computed per
(model config, input shape, mesh), maps logical names to mesh axes.  The
resolver drops a mapping whose mesh axis is missing, already used by an
earlier dim of the same tensor, or does not divide the dim (GQA heads
fewer than the model axis fall back to replication, not padded sharding).

``batch_axes``, ``make_rules`` and ``resolve_pspec`` are the JAX package's
(``repro/runtime/sharding.py``) line for line; they read only a mesh's
axis names and shape: a ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``,
or a stand-in's ``axis_names`` and ``shape``.
``resolve_pspec`` returns a plain tuple with a ``PartitionSpec``'s entries:
a mesh axis name, a tuple of names, or ``None``, trailing ``None``s cut.
Where the JAX package builds a ``NamedSharding`` from it, this module
builds DTensor placements: ``Shard(dim)`` on every mesh dim of more than
one rank the spec names for tensor dim ``dim``, ``Replicate()`` on the
others.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _mesh_axes(mesh):
    """A ``DeviceMesh``'s ``mesh_dim_names``, or a stand-in's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    """Size of mesh axis ``name``: a ``DeviceMesh``'s ``shape`` is a tuple in
    ``axis_names`` order, a stand-in's may be a dict."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return shape[name]
    return shape[_mesh_axes(mesh).index(name)]


def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in _mesh_axes(mesh))


def make_rules(cfg: ModelConfig, mesh, shape: ShapeConfig | None = None,
               overrides: dict | None = None) -> dict:
    """Logical axis -> mesh axis (or tuple) mapping for one cell."""
    b_axes = batch_axes(mesh)
    fsdp = cfg.param_sharding == "fsdp"
    rules = {
        "batch": b_axes,
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "ffn": "model",
        "experts": "model",
        "embed": "data" if fsdp else None,
        "embed_out": "data" if fsdp else None,
        "head_dim": None,
        "layers": None,
        "kv_seq": None,
        # MoE dispatch buffers: flattened tokens and per-expert capacity
        # slots shard over the batch axes
        "moe_tokens": b_axes,
        "moe_cap": b_axes,
        # SSD intra-chunk [cl x cl] tensors shard over the chunk axis
        "ssm_chunks": "model",
        # attention-score key axis: takes "model" only when the head axis
        # of the same tensor cannot (per-tensor dedup in resolve_pspec)
        "attn_kv": "model",
    }
    if shape is not None and shape.kind == "prefill":
        # returned caches shard their sequence axis (they are about to be
        # consumed by seq-sharded decode); attention internals unaffected
        rules["kv_seq"] = "model"
    if shape is not None and shape.kind == "decode":
        mesh_batch = 1
        for a in b_axes:
            mesh_batch *= _axis_size(mesh, a)
        if cfg.decode_cache_sharding == "seq":
            # flash-decoding style: cache sequence takes the model axis;
            # per-tensor dedup in resolve_pspec gives kv_seq priority inside
            # cache tensors (their axes list "kv_seq" before "kv")
            if shape.global_batch < mesh_batch:
                # tiny-batch long-context decode: give the cache sequence
                # every axis the batch cannot use
                rules["batch"] = ()
                rules["kv_seq"] = b_axes + ("model",)
            else:
                rules["kv_seq"] = "model"
        # else: "heads" policy -- kv/heads on "model", seq unsharded
    if overrides:
        rules = {**rules, **overrides}
    return rules


def resolve_pspec(spec_axes: tuple, shape: tuple, rules: dict, mesh) -> tuple:
    """Map one tensor's logical axes to a partition spec, with fallbacks."""
    names = _mesh_axes(mesh)
    used: set = set()
    out = []
    for dim, ax in zip(shape, spec_axes):
        target = rules.get(ax) if ax is not None else None
        if target is None:
            out.append(None)
            continue
        axes = (target,) if isinstance(target, str) else tuple(target)
        axes = [a for a in axes if a in names and a not in used]
        size = 1
        for a in axes:
            size *= _axis_size(mesh, a)
        if not axes or size <= 0 or dim % size != 0:
            out.append(None)
            continue
        used.update(axes)
        out.append(tuple(axes) if len(axes) > 1 else axes[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def pspec_placements(pspec: tuple, mesh) -> tuple:
    """A partition spec as DTensor placements, one per mesh dim.

    A tuple of axes on one tensor dim shards it over those mesh dims; DTensor
    splits such a dim over its mesh dims in mesh order, so the spec must
    list them in that order (every rule table does).  A mesh dim of one rank
    stays ``Replicate()``: its one shard is the whole tensor, and DTensor
    (torch 2.13) may otherwise split a size-1 tensor dim over it in an
    einsum's intermediate and then refuse the view back."""
    from torch.distributed.tensor import Replicate, Shard

    names = _mesh_axes(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(pspec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {pspec} lists mesh axes {axes} out of the "
                             f"mesh's order {names}")
        for i, a in zip(idx, axes):
            if _axis_size(mesh, a) > 1:
                out[i] = Shard(dim)
    return tuple(out)


def spec_shardings(tree, mesh, rules: dict):
    """ParamSpec tree -> tree of DTensor placements."""
    # models.layers imports this module (through shardctx): import it late
    from repro_torch.models.layers import map_specs

    def leaf(s):
        return pspec_placements(resolve_pspec(s.axes, s.shape, rules, mesh), mesh)
    return map_specs(leaf, tree)


def batch_shardings(tree_of_specs, mesh, rules: dict):
    return spec_shardings(tree_of_specs, mesh, rules)


def distribute_tree(tree, mesh, placements):
    """Each full tensor of ``tree`` (or ``tree`` itself, one tensor) as a
    DTensor on ``mesh`` with the matching placements: every rank passes the
    same full values and keeps only its shard (``distribute_tensor``
    scatters from rank 0's copy).  A DTensor may share memory with the
    tensor it was made from: clone what is still to be updated apart."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime.tree import tree_map

    return tree_map(lambda x, pl: distribute_tensor(x.detach(), mesh, list(pl)),
                    tree, placements)
