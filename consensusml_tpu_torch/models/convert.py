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
    "mlp_from_flax", "mlp_init_params", "llama_from_flax", "llama_frozen", "llama_adapter_params",
    "llama_base_leaves",
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

# ``LlamaLM``'s likewise: ``layer_0.q_proj.base.kernel`` (4096, 4096),
# ``layer_0.q_proj.lora_a`` (4096, 16), ``tok_emb.embedding``, ...; the
# adapters and the base split by :func:`llama_frozen`
llama_from_flax = gpt2_from_flax


def llama_frozen(params: Mapping[str, torch.Tensor], dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The frozen base of a LoRA run from a port parameter dict (no worker
    axis): every leaf that is not an adapter, the Dense kernels and the
    embedding cast to the compute ``dtype`` once (the reference casts the
    f32 leaf to it before every product: the same numbers), the RMSNorm
    scales kept f32 (used in f32)."""
    from consensusml_tpu_torch.models.lora import is_lora_path

    return {n: (t if n.endswith(".scale") else t.to(dtype)) for n, t in params.items() if not is_lora_path((n,))}


def llama_adapter_params(model, seed: int, world_size: int, ranks=None) -> dict[str, np.ndarray]:
    """Stacked ``(W, ...)`` f32 adapters of the port's ``LlamaLM``
    ``model`` (structure only; ``meta`` is fine) in flax layout,
    numpy-seeded per worker by ``(seed, rank)``: every ``lora_a`` and
    ``lora_b`` drawn N(0, 0.02), as the reference's ``_llama_lora`` init
    redraws every adapter leaf of each worker (``lora_b`` too, which
    ``LoRADense`` alone would start at zero). ``ranks`` draws only those
    workers' rows (the same values), stacked in that order."""
    from consensusml_tpu_torch.models.lora import is_lora_path

    shapes = {n: tuple(p.shape) for n, p in model.named_parameters() if is_lora_path((n,))}
    rngs = [np.random.default_rng((seed, r)) for r in (range(world_size) if ranks is None else ranks)]
    out = {}
    for name in sorted(shapes, key=lambda n: tuple(n.split("."))):
        arr = np.empty((len(rngs),) + shapes[name], np.float32)
        for r, rng in enumerate(rngs):
            rng.standard_normal(shapes[name], dtype=np.float32, out=arr[r])
            arr[r] *= np.float32(0.02)
        out[name] = arr
    return out


# the base's fixed seed: one "pretrained" base for every run, as the
# reference draws it from jax.random.key(42) whatever the run's seed
BASE_SEED = 42


def llama_base_leaves(model, device, dtype: torch.dtype, threads: int = 8):
    """``(name, tensor)`` for every frozen leaf of the port's ``LlamaLM``
    ``model`` (structure only), in flatten order, each drawn on the host
    from numpy seeded by ``(BASE_SEED, leaf index)`` with flax's
    initializers (the Dense kernels lecun-normal: truncated normal on [-2,
    2] with std ``sqrt(1 / fan_in) / 0.8796``; the embedding N(0, 1 /
    hidden); RMSNorm scales 1), then moved to ``device`` and cast as
    :func:`llama_frozen` holds them. Up to ``threads`` leaves are drawn at
    once (numpy fills its arrays outside the GIL) and each is dropped from
    the host once uploaded, so the host never holds the whole base
    (Llama-2-7B: 27 GB in f32)."""
    from concurrent.futures import ThreadPoolExecutor

    from consensusml_tpu_torch.models.lora import is_lora_path

    named = [(n, tuple(p.shape)) for n, p in model.named_parameters() if not is_lora_path((n,))]
    named.sort(key=lambda kv: tuple(kv[0].split(".")))

    def draw(i: int) -> np.ndarray:
        name, shape = named[i]
        if name.endswith(".scale"):
            return np.ones(shape, np.float32)
        rng = np.random.default_rng((BASE_SEED, i))
        if name.endswith(".embedding"):
            out = rng.standard_normal(shape, dtype=np.float32)
            out *= np.float32(1.0 / math.sqrt(shape[-1]))
            return out
        out = _truncated_normal(rng, shape)
        out *= np.float32(math.sqrt(1.0 / shape[0]) / 0.87962566103423978)
        return out

    with ThreadPoolExecutor(max(1, threads)) as pool:
        pending = {}
        for i in range(len(named)):
            pending[i] = pool.submit(draw, i)
            if i >= threads:
                yield _upload(named, i - threads, pending.pop(i - threads).result(), device, dtype)
        for j in sorted(pending):
            yield _upload(named, j, pending.pop(j).result(), device, dtype)


def _upload(named, i, arr, device, dtype):
    name = named[i][0]
    t = torch.from_numpy(arr).to(device)
    return name, (t if name.endswith(".scale") else t.to(dtype))


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
    """Standard normal f32 samples in [-2, 2]: those outside redrawn, and
    only the redrawn ones tested again (one pass over the array: a 7B
    base's leaves hold 45 M values each)."""
    out = rng.standard_normal(shape, dtype=np.float32)
    flat = out.reshape(-1)
    idx = np.flatnonzero(np.abs(flat) > 2)
    while idx.size:
        vals = rng.standard_normal(idx.size, dtype=np.float32)
        flat[idx] = vals
        idx = idx[np.abs(vals) > 2]
    return out


def _tensor(leaf) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(leaf, dtype=np.float32))
    if not arr.flags.writeable:  # arrays exported by JAX are read-only
        arr = arr.copy()
    return torch.from_numpy(arr)
