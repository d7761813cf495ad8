"""Nested-container helpers in the reference's flatten order.

The JAX package flattens parameter trees with ``jax.tree.flatten``: dict
keys sorted at every level, lists and tuples in order, ``None`` holding
no leaf. Bucket layouts, CHOCO state and payloads depend on that order
(``h_0, h_1, h_10, ...`` — string order, not numeric), so the port
flattens the same way here instead of in ``named_parameters()`` order.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["flatten", "flatten_with_paths", "unflatten", "tree_map", "leaves"]


def flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in flatten order; a path is the tuple of
    dict keys and sequence indices leading to the leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += flatten_with_paths(x, prefix + (i,))
        return out
    return [(prefix, tree)]


def _spec(tree: Any):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _spec(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(_spec(x) for x in tree))
    return "*"


def flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, spec)``; :func:`unflatten` inverts it."""
    return [x for _, x in flatten_with_paths(tree)], _spec(tree)


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def unflatten(spec: Any, leaves_: list) -> Any:
    it = iter(leaves_)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        kind, children = s
        if kind == "dict":
            return {k: build(c) for k, c in children}
        built = [build(c) for c in children]
        return tuple(built) if kind == "tuple" else built

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over trees of one structure."""
    flat, spec = flatten(tree)
    others = [flatten(t) for t in rest]
    for lv, sp in others:
        if sp != spec:
            raise ValueError("tree_map over trees of different structure")
    return unflatten(spec, [fn(x, *(o[0][i] for o in others)) for i, x in enumerate(flat)])
