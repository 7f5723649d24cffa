"""Nested dicts, lists and tuples of tensors (the reference's pytrees).

Leaves come in `jax.tree`'s flatten order: a dict's values by sorted
key, a list's or tuple's in order, depth first.  The optimizer's global
norm sums in that order, and a checkpoint numbers its leaf files by it,
so that either package restores the other's checkpoints.
"""
from __future__ import annotations


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def leaves(tree) -> list:
    """The leaves of `tree`, in flatten order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def unflatten(like, flat) -> object:
    """A tree of `like`'s structure whose leaves are `flat`, in flatten
    order."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}       # the node's own key order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(k) for k in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`,
    trees of the same structure)."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree),
                                                   *(leaves(r) for r in rest))])
