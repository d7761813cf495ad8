"""Regex-rule model sharding for gossip-DP x tensor-parallel runs
(counterpart of ``consensusml_tpu/parallel/sharding.py``).

Rules are ``(regex, spec)`` pairs matched against a leaf's ``/``-joined
parameter path (the port's dotted module path with ``/`` for ``.``:
``h_0/qkv/kernel``, ``layer_0/q_proj/base/kernel``, which is the
reference's flax path); ``spec`` names model axes for the TRAILING dims of
the leaf, or with a third element ``"lead"`` for its LEADING dims. The
first matching rule wins; an unmatched leaf is replicated over the model
axes. The same rules shard parameters, optimizer state and gossip state,
whose trees embed the parameter paths.

The reference leaves the rest to GSPMD. Here a rank holds its slice of
each leaf (:func:`shard_plan`) and the models run the collectives
themselves (:mod:`.tensor`): a leaf split on a dim is cut
into ``size`` equal, contiguous pieces along it, piece ``i`` on the
rank of model-axis index ``i``.
"""

from __future__ import annotations

import re
from typing import Sequence

__all__ = [
    "ShardingRules",
    "spec_for_path",
    "tree_path",
    "shard_plan",
    "llama_tp_rules",
    "gpt2_tp_rules",
    "moe_ep_rules",
    "pipeline_pp_rules",
]

ShardingRules = Sequence[tuple]


def spec_for_path(path: str, ndim: int, rules: ShardingRules | None) -> tuple[str | None, ...]:
    """Per-dim spec for one leaf: first matching rule, else replicated.

    A rule's spec applies to the LAST ``len(spec)`` dims ("lead" rules:
    the FIRST); a spec longer than the leaf's rank is an error (catches
    rules written for the wrong tensor)."""
    if rules:
        for rule in rules:
            pattern, spec = rule[0], rule[1]
            if len(rule) > 2 and rule[2] != "lead":
                # a typo'd marker silently becoming a trailing rule would
                # shard the wrong dim
                raise ValueError(f"rule {pattern!r}: third element must be 'lead', got {rule[2]!r}")
            lead = len(rule) > 2
            if re.search(pattern, path):
                if len(spec) > ndim:
                    raise ValueError(
                        f"sharding rule {pattern!r} wants {len(spec)} dims but leaf {path!r} has only {ndim}"
                    )
                pad = (None,) * (ndim - len(spec))
                return tuple(spec) + pad if lead else pad + tuple(spec)
    return (None,) * ndim


def tree_path(name: str) -> str:
    """The ``/``-joined path the rules match, from a port leaf name
    (``h_0.qkv.kernel`` -> ``h_0/qkv/kernel``)."""
    return name.replace(".", "/")


def shard_plan(name: str, shape: tuple, rules: ShardingRules | None, axes: dict[str, int], index: dict[str, int]):
    """The slice of leaf ``name`` (logical ``shape``) that the rank at
    model-axis ``index`` (``{axis: i}``) holds, under ``rules`` over
    ``axes`` (``{axis: size}``): a tuple of one ``slice`` a dim. A dim
    named by the spec is cut into ``axes[name]`` equal pieces (its length
    must divide); the others are whole."""
    spec = spec_for_path(tree_path(name), len(shape), rules)
    out = []
    for dim, (n, axis) in enumerate(zip(shape, spec)):
        if axis is None:
            out.append(slice(0, n))
            continue
        if axis not in axes:
            raise ValueError(f"{name}: rule names axis {axis!r}, not a model axis of {sorted(axes)}")
        size = axes[axis]
        if n % size:
            raise ValueError(f"{name}: dim {dim} of {tuple(shape)} does not split into {size} equal pieces")
        piece = n // size
        out.append(slice(index[axis] * piece, (index[axis] + 1) * piece))
    return tuple(out)


# ---------------------------------------------------------------------------
# stock rule sets (Megatron-style 1-D tensor parallelism), the reference's
# ---------------------------------------------------------------------------


def pipeline_pp_rules(axis: str = "pp", pattern: str = r"stages/") -> ShardingRules:
    """Stage-stacked pipeline params: every leaf under ``pattern`` carries
    its layer/stage dim FIRST, whatever its rank (one "lead" rule)."""
    return [(pattern, (axis,), "lead")]


def llama_tp_rules(axis: str = "tp") -> ShardingRules:
    """Column-parallel q/k/v/gate/up, row-parallel o/down; LoRA adapters
    follow their base projection's split, so the adapter product needs
    no collective of its own."""
    return [
        (r"(q|k|v)_proj/(base/kernel|lora_b)", (None, axis)),
        (r"o_proj/base/kernel", (axis, None)),
        (r"o_proj/lora_a", (axis, None)),
        (r"(gate|up)_proj/kernel", (None, axis)),
        (r"down_proj/kernel", (axis, None)),
        (r"lm_head/kernel", (None, axis)),
        (r"tok_emb/embedding", (None, axis)),
    ]


def moe_ep_rules(axis: str = "ep") -> ShardingRules:
    """Expert parallelism: the stacked expert weights ``wi (E, d, f)`` and
    ``wo (E, f, d)`` split their leading expert dim over ``axis``; the
    router and the dense weights stay replicated. Data only: the MoE model
    is not ported yet."""
    return [
        (r"moe/w[io]", (axis, None, None)),
    ]


def gpt2_tp_rules(axis: str = "tp") -> ShardingRules:
    """Head-parallel attention + column/row-split MLP for the GPT-2 layout
    (qkv kernel ``(hidden, heads, 3*head_dim)``, out kernel ``(heads,
    head_dim, hidden)``: the heads dim is split), the embeddings on
    hidden."""
    return [
        (r"qkv/kernel", (None, axis, None)),
        (r"qkv/bias", (axis, None)),
        (r"/out/kernel", (axis, None, None)),  # '/' so mlp_out doesn't match
        (r"mlp_in/kernel", (None, axis)),
        (r"mlp_in/bias", (axis,)),
        (r"mlp_out/kernel", (axis, None)),
        (r"(wte|wpe)/embedding", (None, axis)),
    ]
