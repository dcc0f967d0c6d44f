"""Sharding-constraint context for the model code.

Model code is mesh-agnostic.  The step builder opens a ``scope(mesh,
rules)`` around the step, and model layers call ``constrain(x,
logical_axes)`` at memory-critical intermediates (MoE dispatch buffers,
attention scores, SSD chunk blocks, logits), as in the JAX package's
``repro/runtime/shardctx.py``.  Outside a scope, and for a tensor that is
not a DTensor, ``constrain`` is a no-op, so plain runs are unaffected.

Inside a scope the step's tensors are DTensors.  Where JAX's
``with_sharding_constraint`` asks the compiler for a layout, ``constrain``
redistributes the DTensor to the placements that ``resolve_pspec`` gives.
Plain tensors made inside the model (positions, masks, rotary tables) meet
DTensors as replicated DTensors: a torch-function mode wraps each plain
operand of an op that has a DTensor operand before the op runs, so what
autograd saves for the backward is a DTensor too.  (DTensor's own
``implicit_replication`` replicates them inside the op only: the backward,
which autograd runs on its device thread for CUDA tensors where no scope
is open, would meet the plain tensor again.)

A scope holds for the thread that opened it.  Model code that autograd
reruns in the backward (a checkpointed layer's recompute) takes up the
scope it was recorded under (``reenter(current())``,
``transformer.stage_forward``).

A region that DTensor has no sharding rule for, or that launches a kernel
on raw pointers, runs on each rank's local shard through ``local``: its
inputs are first constrained to placements under which the region is exact
rank by rank, then handed over as local tensors, and the result comes back
as a DTensor with the placements of the input it names.  Inside such a
region ``axis_index`` and ``all_reduce_`` act over the mesh dims that split
a logical axis (the vocab-split embedding lookup and loss in
``models/layers.py``), as ``lax.axis_index`` and ``lax.psum`` do inside a
JAX ``shard_map``.  ``set_slot_`` writes a decode step's cache slot on
the rank that holds it, and ``placed_like`` and ``grad_placed`` keep the
views around merged dims even in the forward and the backward.  This is
the one module of the model's path that knows the mesh.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.overrides import TorchFunctionMode

from repro_torch.runtime.sharding import pspec_placements, resolve_pspec

_CTX: contextvars.ContextVar = contextvars.ContextVar("shardctx", default=None)
# (mesh, {logical axis: mesh dims that split it}) of the running ``local`` region
_REGION: contextvars.ContextVar = contextvars.ContextVar("shardctx_region", default=None)


class _ReplicatePlain(TorchFunctionMode):
    """Plain tensor operands (more than one element) of an op that also has
    a DTensor operand become replicated DTensors on that DTensor's mesh.
    Operands are looked for at the top level and one list or tuple deep
    (``cat``, indexing), not by flattening every call's arguments: the mode
    sees every torch call of the step, and its host time adds to each."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        mesh = _mesh_of((*args, *kwargs.values()))
        if mesh is None:
            return func(*args, **kwargs)
        rep = [Replicate()] * mesh.ndim

        def wrap(a):
            if _plain(a):
                return DTensor.from_local(a, mesh, rep, run_check=False)
            if type(a) in (list, tuple):
                return type(a)(wrap(b) for b in a)
            return a
        return func(*map(wrap, args), **{k: wrap(v) for k, v in kwargs.items()})


def _mesh_of(operands):
    for a in operands:
        if type(a) is DTensor:
            return a.device_mesh
        if type(a) in (list, tuple):
            for b in a:
                if type(b) is DTensor:
                    return b.device_mesh
    return None


def _plain(x) -> bool:
    return type(x) is torch.Tensor and x.numel() > 1


@contextlib.contextmanager
def scope(mesh, rules):
    tok = _CTX.set((mesh, rules))
    try:
        with _ReplicatePlain():
            yield
    finally:
        _CTX.reset(tok)


def reenter(ctx):
    """``scope(*ctx)``, or nothing for ``ctx`` None: how code run later, or
    on another thread, takes up the scope ``current()`` returned."""
    return contextlib.nullcontext() if ctx is None else scope(*ctx)


def current():
    """``(mesh, rules)`` of the open scope, or ``None``."""
    return _CTX.get()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def placements(shape: tuple, logical_axes: tuple):
    """The placements ``constrain`` would give a tensor of ``shape`` (None
    outside a scope)."""
    ctx = _CTX.get()
    if ctx is None:
        return None
    mesh, rules = ctx
    return pspec_placements(resolve_pspec(logical_axes, tuple(shape), rules, mesh),
                            mesh)


def constrain(x, logical_axes: tuple):
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    want = placements(x.shape, logical_axes)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(ctx[0], want)


def placed_like(x, like):
    """``x`` redistributed to ``like``'s placements where both are DTensors,
    else ``x``.  Put before a view that splits back a dim ``like`` got by
    merging (``[B*T, D] -> [B, T, D]``): ``like``'s own placements came from
    an even merge, where a layout ``constrain`` chose for the merged dim may
    split it finer than the view can cut (tokens over 32 ranks, 16
    sequences).  A pending sum of ``like`` (``Partial``) counts as
    replicated."""
    if not (is_dtensor(x) and is_dtensor(like)):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in like.placements)
    return x if tuple(x.placements) == want else x.redistribute(like.device_mesh, want)


class _GradPlaced(torch.autograd.Function):
    """The identity; its backward redistributes the gradient to the
    placements the forward's tensor had."""

    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, want = ctx.spec
        if is_dtensor(grad) and tuple(grad.placements) != want:
            grad = grad.redistribute(mesh, want)
        return grad


def grad_placed(x):
    """``x``; in the backward, its gradient takes ``x``'s placements before it
    flows further back.  Put after a view that merges dims (``[B, nc, cl,
    ...] -> [B, nc * cl, ...]``): DTensor may hand the gradient a split of
    the merged dim that the backward's view cannot cut evenly (2 chunks
    over a mesh dim of 4), and ``x``'s own placements came from an even
    merge.  ``transformer.stage_forward`` puts each layer's view of a
    stacked leaf through it, so that the layer's gradient is made in the
    leaf's placements rather than as a pending sum at the global shape.
    Outside a scope, or on a plain tensor, it is ``x``."""
    if _CTX.get() is None or not is_dtensor(x):
        return x
    return _GradPlaced.apply(x)


def local(fn, in_axes: tuple, out_like=0, partial: tuple = ()):
    """``fn`` run on each rank's local shards.

    Inside a scope, argument ``i`` is constrained to ``in_axes[i]`` (an
    entry of ``None`` leaves a non-tensor argument alone; a plain tensor is
    first taken as replicated), ``fn`` gets the local tensors, and its
    result (one tensor) comes back as a DTensor with the placements of
    argument ``out_like``, or, for ``out_like = (shape, logical axes)``,
    with the placements ``constrain`` gives a result of that global shape
    and those axes; for an ``fn`` that returns a tuple of tensors,
    ``out_like`` is a list of such entries, one for each.  The caller picks
    axes under which ``fn``
    computes its shard of the result from its shards of the inputs and the
    collectives below.  Both hand-overs are differentiable: the gradient
    flows back into ``fn``'s own backward rank by rank.  An input
    replicated over a mesh dim that splits the result gets only this
    rank's share of its gradient, so that gradient is a partial sum over
    the dim.  With ``partial`` (logical axes of ``in_axes``), ``fn``'s result
    is this rank's term of a sum over the mesh dims that split those axes
    (a scatter-add of this rank's rows): it comes back as a pending sum
    (``Partial``) over them, for the next ``constrain`` to resolve.  Outside
    a scope, or on plain tensors, it is ``fn`` itself.

    While ``fn`` runs, ``axis_index`` and ``all_reduce_`` name a logical
    axis of ``in_axes`` and act over the mesh dims that split it."""
    def run(*args):
        ctx = _CTX.get()
        if ctx is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import Partial

        mesh = ctx[0]
        rep = [Replicate()] * mesh.ndim
        args = [a if ax is None else
                constrain(DTensor.from_local(a, mesh, rep, run_check=False)
                          if _plain(a) else a, ax)
                for a, ax in zip(args, in_axes)]
        split = {}
        for a, axes in zip(args, in_axes):
            for d, name in enumerate(axes or ()):
                if name is not None and is_dtensor(a):
                    split.setdefault(name, tuple(i for i, p in enumerate(a.placements)
                                                 if p.is_shard(d)))
        out_pls = []
        for like in (out_like if isinstance(out_like, list) else [out_like]):
            pl = list(args[like].placements if isinstance(like, int) else placements(*like))
            for name in partial:
                for i in split.get(name, ()):
                    pl[i] = Partial()
            out_pls.append(pl)
        # a mesh dim that splits any result
        out_split = [any(pl[i].is_shard() for pl in out_pls) for i in range(mesh.ndim)]

        def to_local(a):
            if not is_dtensor(a):
                return a
            grad_pl = [Partial() if p.is_replicate() and o else p
                       for p, o in zip(a.placements, out_split)]
            return a.to_local(grad_placements=grad_pl)
        with in_region((mesh, split)):
            out = fn(*(to_local(a) for a in args))
        if isinstance(out_like, list):
            return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                         for o, pl in zip(out, out_pls))
        return DTensor.from_local(out, mesh, out_pls[0], run_check=False)
    return run


def set_slot_(x, dim: int, index: int, value) -> None:
    """``x.select(dim, index).copy_(value)`` in place (a decode step's cache
    write).  On a DTensor split along ``dim`` (a sequence-sharded cache)
    only the rank whose shard holds ``index`` writes, at its local offset,
    as a sharded ``dynamic_update_slice`` does; ``value`` is first placed
    as ``x`` is on its other dims.  (DTensor's own ``select`` of a split dim
    gathers the whole tensor and writes into the copy.)"""
    if not is_dtensor(x):
        x.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Shard

    mesh, mine = x.device_mesh, x.to_local()
    want, shard, coord = [], 0, mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            want.append(Replicate())
            shard = shard * mesh.size(i) + coord[i]
        elif p.is_shard() and p.dim > dim:
            want.append(Shard(p.dim - 1))
        else:
            want.append(p)
    if is_dtensor(value):
        value = value.redistribute(mesh, want).to_local()
    offset = shard * mine.shape[dim]
    if offset <= index < offset + mine.shape[dim]:
        mine.select(dim, index - offset).copy_(value)


def region():
    """The running ``local`` region (``None`` outside one).  An autograd
    Function's forward keeps it for its backward, which runs after the
    region has ended (``in_region``)."""
    return _REGION.get()


@contextlib.contextmanager
def in_region(r):
    """``axis_index`` and ``all_reduce_`` act as in region ``r`` (what
    ``region()`` returned) while the block runs; ``r`` None: no region."""
    tok = _REGION.set(r)
    try:
        yield
    finally:
        _REGION.reset(tok)


def _split(axis: str):
    """(mesh, the mesh dims that split logical ``axis``) in the running
    ``local`` region; no dims outside one."""
    region = _REGION.get()
    if region is None:
        return None, ()
    mesh, split = region
    return mesh, split.get(axis, ())


def axis_index(axis: str) -> int:
    """This rank's index among the shards of logical ``axis`` in the running
    ``local`` region (split in mesh order, each dim within the previous);
    0 where nothing splits it."""
    mesh, dims = _split(axis)
    index = 0
    if dims:
        coord = mesh.get_coordinate()
        for i in dims:
            index = index * mesh.size(i) + coord[i]
    return index


def all_reduce_(x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place (``"sum"`` or ``"max"``) over the ranks that
    hold the other shards of logical ``axis`` in the running ``local``
    region: a no-op where nothing splits it.  Not differentiable: a caller
    inside an autograd Function writes its own backward."""
    import torch.distributed as dist

    mesh, dims = _split(axis)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for i in dims:
        dist.all_reduce(x, red, group=mesh.get_group(i))
    return x


def splits(axis: str) -> bool:
    """Whether the running ``local`` region splits logical ``axis``."""
    return bool(_split(axis)[1])
