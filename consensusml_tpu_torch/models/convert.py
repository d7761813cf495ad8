"""Parameter conversion between the JAX package's flax trees and the port,
and numpy-seeded initial parameters.

The port's ``GPT2LM``, ``BertMLM``, ``ResNet`` and ``MLP`` mirror the flax trees one for one
(module path = flax path joined by dots, same shapes and layouts, f32),
so conversion is a flatten: no transposes, no reshapes. The input is the
flax tree with every leaf already a numpy array (``jax.tree.map(
np.asarray, variables)``), so this module needs neither JAX nor flax.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "gpt2_from_flax", "bert_from_flax", "normal_init_params", "resnet_from_flax", "resnet_init_params",
    "mlp_from_flax", "mlp_init_params",
]


def gpt2_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``GPT2LM`` params (numpy leaves) -> a state dict for
    :class:`consensusml_tpu_torch.models.gpt2.GPT2LM` (f32 tensors, keys
    in the reference's flatten order). A leading worker axis, if every
    leaf has one, is kept: the result is then the trainer's stacked
    parameter dict."""
    return {".".join(path): _tensor(leaf) for path, leaf in T.flatten_with_paths(params)}


# ``BertMLM``'s tree flattens as ``GPT2LM``'s: ``layer_0.qkv.kernel`` (768,
# 12, 192), ``mlm_bias``, ... in the reference's flatten order
bert_from_flax = gpt2_from_flax


def normal_init_params(model, seed: int, world_size: int, ranks=None) -> dict[str, np.ndarray]:
    """Stacked ``(W, ...)`` f32 initial parameters of ``model`` (GPT-2's or
    BERT's; only its structure is read, ``meta`` is fine) in flax layout,
    numpy-seeded per worker by ``(seed, rank)``: N(0, 0.02) kernels and
    embeddings, zero biases, unit LayerNorm scales. Keys are flax paths
    joined by dots, in the reference's flatten order (:func:`gpt2_from_flax`'s
    input). ``ranks`` draws only those workers' rows (the same values),
    stacked in that order."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rngs = [np.random.default_rng((seed, r)) for r in (range(world_size) if ranks is None else ranks)]
    world_size = len(rngs)
    out = {}
    for name in sorted(shapes, key=lambda n: tuple(n.split("."))):
        shape = (world_size,) + shapes[name]
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith("scale"):
            out[name] = np.ones(shape, np.float32)
        else:
            arr = np.empty(shape, np.float32)
            for r, rng in enumerate(rngs):
                rng.standard_normal(shapes[name], dtype=np.float32, out=arr[r])
                arr[r] *= np.float32(0.02)
            out[name] = arr
    return out


def resnet_from_flax(variables: Mapping[str, Any]) -> tuple[dict[str, torch.Tensor], dict]:
    """flax ResNet ``variables`` (``{"params": ..., "batch_stats": ...}``,
    numpy leaves, nested or already flat with dotted keys) -> ``(params,
    model_state)`` for the port: ``params`` keyed by dotted flax path,
    ``model_state = {"batch_stats": {path: tensor}}``, f32, in the
    reference's flatten order. A leading worker axis is kept, as
    :func:`gpt2_from_flax` keeps it."""
    params = gpt2_from_flax(variables["params"])
    stats = gpt2_from_flax(variables.get("batch_stats", {}))
    return params, {"batch_stats": stats}


def mlp_from_flax(variables: Mapping[str, Any]) -> tuple[dict[str, torch.Tensor], dict]:
    """flax ``MLP`` variables (``{"params": {"Dense_0": {"kernel", "bias"},
    "Dense_1": ...}}``, numpy leaves) -> ``(params, model_state)`` for the
    port: ``Dense_0.kernel`` (in, hidden), ``Dense_0.bias``,
    ``Dense_1.kernel`` (hidden, classes), ``Dense_1.bias`` as f32 tensors
    (a leading worker axis kept), and ``{}`` (no norm state)."""
    params = gpt2_from_flax(variables["params"])
    want = {f"Dense_{i}.{leaf}" for i in (0, 1) for leaf in ("kernel", "bias")}
    if set(params) != want:
        raise ValueError(f"not a flax MLP tree: {sorted(params)} (expected {sorted(want)})")
    return params, {}


def mlp_init_params(model, seed: int, world_size: int, ranks=None) -> dict[str, dict[str, np.ndarray]]:
    """Stacked ``(W, ...)`` f32 initial variables of the port's ``MLP``
    ``model`` in flax layout, numpy-seeded per worker by ``(seed, rank)``
    with flax's ``nn.Dense`` scheme (lecun-normal kernels, zero biases, as
    :func:`resnet_init_params` draws a ``Dense``): ``{"params": {path:
    array}}`` for :func:`mlp_from_flax`. ``ranks`` as
    :func:`resnet_init_params`'s."""
    return {"params": resnet_init_params(model, seed, world_size, ranks)["params"]}


def resnet_init_params(model, seed: int, world_size: int, ranks=None) -> dict[str, dict[str, np.ndarray]]:
    """Stacked ``(W, ...)`` f32 initial variables of the port's ``ResNet``
    ``model`` (only its structure is read; ``meta`` is fine), numpy-seeded
    per worker by ``(seed, rank)`` with flax's schemes: lecun-normal conv
    and dense kernels (truncated normal on [-2, 2], std ``sqrt(1/fan_in) /
    0.8796``), zero dense bias, BN scales at their ``scale_init`` (ones,
    zeros for the last BN of each block), zero BN bias, running mean 0 and
    var 1. Returns ``{"params": {path: array}, "batch_stats": {path:
    array}}`` for :func:`resnet_from_flax`. ``ranks`` draws only those
    workers' rows (the same values), stacked in that order."""
    from consensusml_tpu_torch.models.fused_bn import FusedBatchNorm
    from consensusml_tpu_torch.models.resnet import BatchNorm, Conv, Dense

    rngs = [np.random.default_rng((seed, r)) for r in (range(world_size) if ranks is None else ranks)]
    world_size = len(rngs)
    params, stats = {}, {}
    for prefix, mod in sorted(model.named_modules(), key=lambda kv: tuple(kv[0].split("."))):
        path = lambda leaf: f"{prefix}.{leaf}" if prefix else leaf  # noqa: E731
        if isinstance(mod, (Conv, Dense)):
            shape = tuple(mod.kernel.shape)
            std = np.float32(np.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978)
            arr = np.empty((world_size,) + shape, np.float32)
            for r, rng in enumerate(rngs):
                arr[r] = _truncated_normal(rng, shape) * std
            params[path("kernel")] = arr
            if isinstance(mod, Dense):
                params[path("bias")] = np.zeros((world_size,) + tuple(mod.bias.shape), np.float32)
        elif isinstance(mod, (BatchNorm, FusedBatchNorm)):
            shape = (world_size,) + tuple(mod.scale.shape)
            params[path("scale")] = np.full(shape, mod.scale_init, np.float32)
            params[path("bias")] = np.zeros(shape, np.float32)
            stats[path("mean")] = np.zeros(shape, np.float32)
            stats[path("var")] = np.ones(shape, np.float32)
    order = lambda d: dict(sorted(d.items(), key=lambda kv: tuple(kv[0].split("."))))  # noqa: E731
    return {"params": order(params), "batch_stats": order(stats)}


def _truncated_normal(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """Standard normal f32 samples in [-2, 2] (redrawn outside)."""
    out = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(out) > 2
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(out) > 2
    return out


def _tensor(leaf) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(leaf, dtype=np.float32))
    if not arr.flags.writeable:  # arrays exported by JAX are read-only
        arr = arr.copy()
    return torch.from_numpy(arr)
