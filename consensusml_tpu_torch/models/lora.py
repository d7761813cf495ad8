"""LoRA fine-tuning: which leaves are adapters (port of
``consensusml_tpu/models/lora.py``).

LoRA is a partition of the parameters by path: the adapter leaves
(``lora_a`` / ``lora_b`` of :class:`.llama.LoRADense`) are trained and
gossiped, every other leaf is the frozen base, the same on every worker.
The optimizer side is :func:`~consensusml_tpu_torch.train.optim.lora_optimizer`;
the gossip side is ``GossipConfig(path_filter=lora_gossip_filter)``.

A path here is the port's: a tuple of keys whose string keys may be
dotted flax paths (``("params", "layer_0.q_proj.lora_a")``, or one
parameter name ``("layer_0.q_proj.lora_a",)``); a key counts if any of
its dot-separated parts is ``lora_a`` or ``lora_b``, as the reference
tests every key of a jax key path.
"""

from __future__ import annotations

from typing import Any

import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = ["is_lora_path", "lora_mask", "lora_gossip_filter", "merge_lora"]

_ADAPTERS = ("lora_a", "lora_b")


def is_lora_path(path: tuple) -> bool:
    """True if a key path belongs to a LoRA adapter parameter."""
    return any(part in _ADAPTERS for key in path if isinstance(key, str) for part in key.split("."))


def lora_mask(params: Any) -> Any:
    """A tree of bools shaped like ``params``: True on adapter leaves."""
    _, spec = T.flatten(params)
    return T.unflatten(spec, [is_lora_path(path) for path, _ in T.flatten_with_paths(params)])


def lora_gossip_filter(path: tuple, _leaf: Any = None) -> bool:
    """Gossip path filter: exchange adapters only
    (``GossipConfig.path_filter``)."""
    return is_lora_path(path)


def merge_lora(params: dict[str, torch.Tensor], alpha_over_rank: float) -> dict[str, torch.Tensor]:
    """Fold the adapters into the base kernels for inference: for every
    module ``p`` holding ``p.base.kernel``, ``p.lora_a`` and ``p.lora_b``,
    ``p.base.kernel += alpha_over_rank * (lora_a @ lora_b)`` (the product
    in f32, cast to the kernel's dtype) and the adapters dropped; every
    other leaf as it is. ``alpha_over_rank`` is the model's ``lora_alpha /
    lora_rank``."""
    out = {}
    for name, leaf in params.items():
        prefix, _, last = name.rpartition(".")
        if last in _ADAPTERS and f"{prefix}.base.kernel" in params:
            continue
        if name.endswith(".base.kernel"):
            mod = name[: -len(".base.kernel")]
            a, b = params.get(f"{mod}.lora_a"), params.get(f"{mod}.lora_b")
            if a is not None and b is not None:
                delta = (a.float() @ b.float()) * alpha_over_rank
                leaf = leaf + delta.to(leaf.dtype)
        out[name] = leaf
    return out
