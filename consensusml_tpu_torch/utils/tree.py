"""Nested-container helpers in the reference's flatten order, and the
worker means of stacked trees.

The JAX package flattens parameter trees with ``jax.tree.flatten``: dict
keys sorted at every level, lists and tuples in order, ``None`` holding
no leaf. Bucket layouts, CHOCO state and payloads depend on that order
(``h_0, h_1, h_10, ...`` — string order, not numeric), so the port
flattens the same way here instead of in ``named_parameters()`` order.

:func:`consensus_mean` is the one definition of "the consensus model"
(the reference's ``consensusml_tpu/utils/tree.py``): the unweighted
worker mean of a stacked tree, reduced in f32 and cast back leaf by
leaf; :func:`masked_worker_mean` restricts it to the alive workers, with
the reference's ``max(sum(alive), 1)`` guard for a round where every
worker is dead.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = [
    "flatten", "flatten_with_paths", "unflatten", "tree_map", "leaves", "named_tensors", "consensus_mean",
    "masked_worker_mean",
]


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


def named_tensors(obj: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor of a train state or any part of
    it: dataclass and NamedTuple fields in declaration order, mappings by
    sorted key, sequences in order, joined by dots (the order of the
    reference's flatten for its NamedTuples and dicts); other values hold
    none."""
    import dataclasses
    from collections.abc import Mapping

    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj) for x in named_tensors(getattr(obj, f.name), f"{prefix}.{f.name}")]
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [x for f in obj._fields for x in named_tensors(getattr(obj, f), f"{prefix}.{f}")]
    if isinstance(obj, Mapping):
        return [x for k in sorted(obj) for x in named_tensors(obj[k], f"{prefix}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [x for i, v in enumerate(obj) for x in named_tensors(v, f"{prefix}.{i}")]
    return []


def masked_worker_mean(x: torch.Tensor, alive, n_alive: torch.Tensor | None = None) -> torch.Tensor:
    """f32 alive-weighted mean of ONE stacked leaf over its leading worker
    axis. ``alive``: ``(world,)`` of 0/1 floats; rows of weight 0 add
    nothing; the divisor is ``max(sum(alive), 1)`` (or ``n_alive``), so a
    round where every worker is dead gives 0, not NaN. Returns f32 at the
    leaf's trailing shape; callers cast back."""
    a = torch.as_tensor(alive, dtype=torch.float32, device=x.device)
    x32 = x.to(torch.float32)
    w = a.reshape((a.shape[0],) + (1,) * (x32.dim() - 1))
    n = torch.clamp(a.sum(), min=1.0) if n_alive is None else n_alive
    return (x32 * w).sum(dim=0) / n


def consensus_mean(tree: Any, alive=None) -> Any:
    """Worker mean over the leading stacked axis of every leaf, in f32 (a
    bf16 sum would lose the low bits exactly where replicas disagree
    least), cast back to each leaf's dtype; with ``alive`` over the alive
    rows only (:func:`masked_worker_mean`)."""
    if alive is None:
        return tree_map(lambda x: x.to(torch.float32).mean(dim=0).to(x.dtype), tree)
    return tree_map(lambda x: masked_worker_mean(x, alive).to(x.dtype), tree)
