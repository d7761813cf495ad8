"""Serving artifact: the consensus mean of a training run, and its drafts.

Port of ``consensusml_tpu/serve/export.py``. A decentralized run ends
with W replicas that disagree a little; what is served is their
consensus mean, :func:`consensusml_tpu_torch.utils.tree.consensus_mean`
(the evaluator's mean model). An artifact directory holds:

- ``model.pt``: ``{"params": {path: tensor}, "model_state": {...}}`` with
  the worker axis collapsed, in torch's format (as
  :mod:`consensusml_tpu_torch.utils.checkpoint` stores a checkpoint), the
  parameters under the module paths the port's models take (the flax
  paths joined by dots); a LoRA run's frozen base rides beside its mean
  adapters;
- ``serve_meta.json``: the reference's keys, ``config_name`` and ``scale``
  (enough to rebuild the architecture, :func:`build_serving_model`), the
  ``round`` and ``world_size`` it came from, and ``generation``, the hot
  swap's ordering key (:mod:`.pool.hotswap`): each export to one path
  bumps it, and readers reject a generation that goes backwards. Both
  files are written atomically (a temporary file, then ``os.replace``),
  the meta last, so a reader that sees generation g sees g's model or a
  newer one, never a torn file.

Writers of one directory (a trainer's export, :func:`bump_generation`,
:func:`pin_generation`, :func:`export_draft`) serialize on an ``fcntl``
lock, so no two mint the same generation; readers never take it.

A speculative DRAFT artifact rides in ``<path>/draft/`` (:func:`export_draft`):
a complete artifact of its own with ``"role": "draft"`` and, for a draft
cut to fewer layers than its config, ``"layers"``. It has no ordering of
its own: a watching engine restages target and draft as a pair whenever
the parent's generation advances.

:func:`artifact_from_reference` carries an artifact of the JAX package
across (what its ``load_serving`` returns) into this format.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import json
import os
from typing import Any

import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "export_serving",
    "export_mean",
    "export_draft",
    "load_serving",
    "serving_meta",
    "bump_generation",
    "pin_generation",
    "artifact_from_reference",
    "build_serving_model",
    "META_NAME",
    "DRAFT_SUBDIR",
]

META_NAME = "serve_meta.json"
MODEL_NAME = "model.pt"
DRAFT_SUBDIR = "draft"


def _next_generation(path: str) -> int:
    """One past the generation at ``path`` (1 when there is none yet)."""
    try:
        return int(serving_meta(path).get("generation", 0)) + 1
    except ValueError:
        return 1


@contextlib.contextmanager
def _generation_lock(path: str):
    """Exclusive lock of ``path``'s generation read-modify-write across
    processes: a trainer's export racing a ``bump_generation`` could
    otherwise mint one generation twice, and a watcher that staged the
    first would skip the second."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".generation.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield  # unlocked by close


def _atomic_write(dest: str, write) -> None:
    tmp = dest + ".tmp"
    write(tmp)
    os.replace(tmp, dest)


def _write_meta(path: str, meta: dict[str, Any]) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)

    _atomic_write(os.path.join(path, META_NAME), write)


def _host(tree: Any) -> Any:
    return T.tree_map(lambda t: t.detach().to("cpu").contiguous(), tree)


def _save_model(path: str, params: dict, model_state: dict) -> None:
    tree = {"params": _host(params), "model_state": _host(model_state)}
    _atomic_write(os.path.join(path, MODEL_NAME), lambda tmp: torch.save(tree, tmp))


def export_mean(
    path: str,
    params: dict[str, torch.Tensor],
    *,
    config_name: str,
    scale: str = "smoke",
    round: int,
    world_size: int,
    model_state: dict | None = None,
    generation: int | None = None,
) -> str:
    """Write an artifact of an already collapsed parameter dict (the
    collective backend's ranks average theirs and rank 0 writes this).
    ``generation`` defaults to one past the one on disk. Returns the
    absolute path."""
    path = os.path.abspath(path)
    if generation is not None and generation < 1:
        raise ValueError(f"generation must be >= 1, got {generation}")
    with _generation_lock(path):
        if generation is None:
            generation = _next_generation(path)
        _save_model(path, params, model_state or {})
        _write_meta(path, {
            "config_name": config_name,
            "scale": scale,
            "round": int(round),
            "world_size": int(world_size),
            "generation": int(generation),
        })
    return path


def export_serving(
    path: str,
    state: Any,
    *,
    config_name: str,
    scale: str = "smoke",
    round: int | None = None,
    generation: int | None = None,
) -> str:
    """Collapse a stacked ``TrainState`` to its consensus mean and write the
    artifact at ``path`` (:func:`export_mean`). Safe to repeat on one path:
    the latest wins and each write advances ``generation`` (unless given).
    ``round`` defaults to the state's."""
    mean = T.consensus_mean({"params": state.params, "model_state": state.model_state})
    return export_mean(
        path, {**mean["params"], **state.frozen}, config_name=config_name, scale=scale,
        round=state.step if round is None else round, world_size=len(state.generators),
        model_state=mean["model_state"], generation=generation,
    )


def export_draft(path: str, params: dict[str, torch.Tensor], *, config_name: str, scale: str = "smoke",
                 layers: int | None = None) -> str:
    """Install a speculative draft beside the target at ``path``
    (``<path>/draft/``, a complete artifact :func:`load_serving` reads).
    ``layers`` records a draft cut to its config's first ``layers`` blocks
    (its ``params`` hold those blocks, the embeddings and the final norm).
    Its meta mirrors the parent's generation at write time, for provenance
    only; it is written under the parent's lock, so a concurrent target
    export never sees a torn draft. Returns the draft's directory."""
    path = os.path.abspath(path)
    draft_dir = os.path.join(path, DRAFT_SUBDIR)
    with _generation_lock(path):
        try:
            parent_gen = int(serving_meta(path).get("generation", 0))
        except ValueError:
            parent_gen = 0  # a draft installed before the first export
        os.makedirs(draft_dir, exist_ok=True)
        _save_model(draft_dir, params, {})
        meta = {"config_name": config_name, "scale": scale, "role": "draft", "generation": parent_gen}
        if layers is not None:
            meta["layers"] = int(layers)
        _write_meta(draft_dir, meta)
    return draft_dir


def bump_generation(path: str) -> int:
    """Rewrite an artifact's meta at ``generation + 1``, the model as it
    is; returns the new generation."""
    path = os.path.abspath(path)
    with _generation_lock(path):
        meta = serving_meta(path)  # raises on a directory that is no artifact
        meta["generation"] = int(meta.get("generation", 0)) + 1
        _write_meta(path, meta)
    return meta["generation"]


def pin_generation(path: str, meta: dict[str, Any]) -> int:
    """Re-pin ``path`` to ``meta``'s content at a generation strictly above
    the current one (a rollback is a forward write, since watchers reject
    regressions), stamped ``rolled_back_from``. Returns the generation."""
    path = os.path.abspath(path)
    with _generation_lock(path):
        cur = int(serving_meta(path).get("generation", 0))
        _write_meta(path, {**meta, "generation": cur + 1, "rolled_back_from": cur})
    return cur + 1


def serving_meta(path: str) -> dict[str, Any]:
    """The artifact's meta; raises ``ValueError`` where ``path`` holds none
    (or a torn or foreign one)."""
    meta_path = os.path.join(os.path.abspath(path), META_NAME)
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise ValueError(
            f"{path} is not a serving artifact ({META_NAME} unreadable: {e}); produce one with "
            "python -m consensusml_tpu_torch.train --export-serving or serve.export_serving()"
        ) from None
    if "config_name" not in meta:
        raise ValueError(f"{meta_path} has no config_name field")
    return meta


def load_serving(path: str) -> tuple[dict[str, Any], dict[str, torch.Tensor], dict]:
    """``(meta, params, model_state)`` of an artifact, on the CPU; the
    caller rebuilds the architecture from the meta
    (:func:`build_serving_model`)."""
    meta = serving_meta(path)
    tree = torch.load(os.path.join(os.path.abspath(path), MODEL_NAME), map_location="cpu", weights_only=True)
    return meta, tree["params"], tree.get("model_state", {})


def artifact_from_reference(path: str, meta: dict[str, Any], params: Any, model_state: Any = None) -> str:
    """Write the port's artifact at ``path`` from what the JAX package's
    ``load_serving`` returns (its meta and its parameter tree with numpy
    leaves): the tree flattened to the port's dotted paths in f32, the
    meta's keys kept (the generation too). Returns the absolute path."""
    from consensusml_tpu_torch.models.convert import gpt2_from_flax

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with _generation_lock(path):
        _save_model(path, gpt2_from_flax(params), gpt2_from_flax(model_state or {}))
        _write_meta(path, dict(meta))
    return path


def build_serving_model(meta: dict[str, Any], params: dict[str, torch.Tensor], device=None):
    """The causal LM an artifact names, on ``device`` (``None`` = CUDA;
    raises without a GPU), with ``params`` loaded (f32 masters; the engine
    casts to the compute dtype): ``gpt2_topk``'s ``GPT2LM`` or
    ``llama_lora``'s ``LlamaLM`` (base and adapters) at the meta's scale,
    cut to ``meta["layers"]`` blocks for a truncated draft. Raises for a
    config without a decode path."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.device import resolve_device

    name, scale = meta["config_name"], meta.get("scale", "smoke")
    dev = resolve_device(device)
    if name == "gpt2_topk":
        from consensusml_tpu_torch.models.gpt2 import GPT2LM

        cfg, cls = configs.gpt2_config(scale), GPT2LM
    elif name == "llama_lora":
        from consensusml_tpu_torch.models.llama import LlamaLM

        cfg, cls = configs.llama_config(scale), LlamaLM
    else:
        raise ValueError(f"{name} has no decode path; serving needs a causal LM (gpt2_topk or llama_lora)")
    if "layers" in meta:
        cfg = dataclasses.replace(cfg, layers=int(meta["layers"]))
    model = cls(cfg, device=dev)
    model.load_state_dict(params, strict=True)
    return model.eval()
