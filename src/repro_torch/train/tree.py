"""Nested containers of tensors ("trees"): the dicts of parameters, gradients
and optimizer state that the training substrate passes around, in place of
JAX's pytrees.

A tree is a dict, list or tuple of trees, ``None``, or a leaf (a tensor or
anything else). Dict keys are visited in sorted order, as JAX flattens dicts,
so two dicts with the same keys flatten alike whatever their insertion order.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "tree_structure", "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure; ``None``
    stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in flattening order; ``None`` counts as a leaf here, so that
    a checkpoint can record where it stood."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_structure(tree: Any) -> Any:
    """A JSON-able description of the structure: dicts and lists as they are,
    ``None`` as null, every other leaf as ``"*"``."""
    if isinstance(tree, dict):
        return {str(k): tree_structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_structure(x) for x in tree]
    return None if tree is None else "*"


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flattening order
    (the inverse of `tree_leaves`, ``None`` leaves included)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the structure holds")
    return out
