"""Nested dict / tuple trees of tensors, walked in the JAX package's order.

The port keeps parameters and optimizer state as the JAX package keeps its
pytrees: nested dicts and tuples.  ``flatten`` visits the leaves as
``jax.tree`` does (dict keys sorted, sequences in order) and names each by
its ``/``-joined key path, the name the checkpoint layout uses.
"""
from __future__ import annotations


def flatten(tree, prefix: tuple = ()) -> list[tuple[str, object]]:
    """``[(path, leaf), ...]`` in the JAX package's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree) for item in flatten(x, prefix + (i,))]
    return [("/".join(str(p) for p in prefix), tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, values):
    """A tree of ``like``'s structure holding ``values`` in ``flatten`` order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):      # filled in sorted order, keys kept in node's
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)
