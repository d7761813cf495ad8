"""Checkpoint and resume of the trainer's state (port of
``consensusml_tpu/utils/checkpoint.py``), in torch's format.

A checkpoint is a directory (``path/step_N`` with a step) holding one file
a worker, ``worker_00000.pt`` ..., and ``cml_meta.json`` with the world
size and the round, written last and atomically: a directory without it
is not a checkpoint. A worker's file holds its row of every stacked
tensor of the :class:`~consensusml_tpu_torch.train.local_sgd.TrainState`
(parameters, model state, optimizer state with its step and schedule
counts, the gossip state: CHOCO's ``xhat``/``s``, the overlap queue,
push-sum's mass; SlowMo's ``x``/``u``), each under its path, and its
dropout and fault generators' states. The round counter rides in the
meta and in every file.

There is one layout whatever the backend. The simulated backend writes
every worker's file (:func:`save_state`); each rank of the collective
backend writes its own (``save_state(..., rank=r)``), and rank 0 writes
the meta after every rank's file is in place (:func:`write_meta`).
:func:`restore_state` reads either into a stacked state or, with
``rank``, into one rank's, so a run checkpointed on one backend resumes on
the other, bit for bit. A LoRA run's frozen base is not saved: every run
of the config draws the same, and the template's is kept.

The reference's checkpoint holds its typed JAX keys; those cannot become
torch generators, so :func:`state_from_reference` converts everything but
the random streams and the port draws its own (this matters only for
dropout and for injected faults).
"""

from __future__ import annotations

import json
import os
import threading
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "save_state", "restore_state", "write_meta", "checkpoint_world_size", "checkpoint_round", "AsyncSaver",
    "state_from_reference",
]

META = "cml_meta.json"
_FORMAT = 1


def _sections(state) -> list[tuple[str, Any, bool]]:
    """``(name, part, stacked_on_collective)``: every part of the state
    with a worker row. On the collective backend the parameters, model
    state, optimizer and outer state are a stack of one and the gossip
    state is the worker's own, without the axis."""
    return [("params", state.params, True), ("model_state", state.model_state, True),
            ("opt_state", state.opt_state, True), ("gossip", state.gossip, False),
            ("outer", state.outer, True)]


def _rows(state, worker: int, collective: bool) -> list[tuple[str, torch.Tensor]]:
    """Worker ``worker``'s row of every tensor of ``state`` as ``(path,
    view)``: row ``worker`` of a stacked state, or a collective rank's
    tensors (``worker`` ignored)."""
    out = []
    for name, part, one in _sections(state):
        for path, t in T.named_tensors(part, name):
            out.append((path, (t[0] if one else t) if collective else t[worker]))
    return out


def _world(state) -> int:
    return len(state.generators)


def _record(state, worker: int, collective: bool) -> dict:
    """Worker ``worker``'s file: its rows copied to the host, and its
    generators' states."""
    rows = _rows(state, worker, collective)
    g = 0 if collective else worker
    return {
        "format": _FORMAT,
        "round": int(state.step),
        "paths": [p for p, _ in rows],
        "tensors": [t.detach().to("cpu", copy=True) for _, t in rows],
        "generator": state.generators[g].get_state(),
        "fault_generator": state.fault_generators[g].get_state() if state.fault_generators else None,
    }


def _worker_path(path: str, worker: int) -> str:
    return os.path.join(path, f"worker_{worker:05d}.pt")


def _atomic_save(obj: Any, dest: str) -> None:
    tmp = dest + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, dest)


def write_meta(path: str, world_size: int, round_: int) -> None:
    """``cml_meta.json`` (world size and round), atomically: a preemption
    mid-write leaves no meta or a whole one, never a truncated file."""
    meta, tmp = os.path.join(path, META), os.path.join(path, META + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"world_size": int(world_size), "round": int(round_), "format": _FORMAT}, f)
    os.replace(tmp, meta)


def _step_dir(path: str, step: int | None) -> str:
    path = os.path.abspath(path)
    return path if step is None else os.path.join(path, f"step_{step}")


def save_state(path: str, state, step: int | None = None, *, rank: int | None = None) -> str:
    """Write ``state`` at ``path`` (``path/step_N`` with ``step``) and return
    the directory. A stacked state writes every worker's file, then the
    meta. With ``rank`` (a collective rank's state) only that worker's
    file: the caller writes the meta (:func:`write_meta`) once every rank's
    file is in place."""
    path = _step_dir(path, step)
    os.makedirs(path, exist_ok=True)
    if rank is not None:
        _atomic_save(_record(state, rank, True), _worker_path(path, rank))
        return path
    for w in range(_world(state)):
        _atomic_save(_record(state, w, False), _worker_path(path, w))
    write_meta(path, _world(state), state.step)
    return path


def _meta(path: str) -> dict | None:
    try:
        with open(os.path.join(os.path.abspath(path), META)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _meta_int(path: str, key: str) -> int | None:
    meta = _meta(path)
    try:
        return int(meta[key])
    except (TypeError, KeyError, ValueError):
        return None


def checkpoint_world_size(path: str) -> int | None:
    """World size recorded at save time, or None without a readable meta."""
    return _meta_int(path, "world_size")


def checkpoint_round(path: str) -> int | None:
    """Round recorded at save time, or None: lets the CLI size an LR
    schedule across ``--resume`` before restoring anything."""
    return _meta_int(path, "round")


def _load_into(path: str, like, worker: int, collective: bool) -> int:
    rec = torch.load(_worker_path(path, worker), map_location="cpu", weights_only=True)
    rows = _rows(like, worker, collective)
    paths = [p for p, _ in rows]
    if rec["paths"] != paths:
        extra = sorted(set(rec["paths"]) - set(paths))[:3]
        missing = sorted(set(paths) - set(rec["paths"]))[:3]
        raise ValueError(
            f"{_worker_path(path, worker)}: the checkpoint's state has another structure than this run's "
            f"(only in the checkpoint: {extra}; only in this run: {missing}); an LR schedule, "
            "--grad-clip, --slowmo-beta or the gossip flags change it: resume with the flags it was trained with"
        )
    with torch.no_grad():
        for (p, dst), src in zip(rows, rec["tensors"]):
            if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
                raise ValueError(f"{p}: checkpoint has {src.dtype} {tuple(src.shape)}, "
                                 f"this run {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
    g = 0 if collective else worker
    for gen, saved in ((like.generators[g], rec["generator"]),
                       (like.fault_generators[g] if like.fault_generators else None, rec["fault_generator"])):
        if gen is None or saved is None:
            continue
        if gen.get_state().numel() != saved.numel():
            raise ValueError(f"{p}: the checkpoint's random streams were drawn on another device type")
        gen.set_state(saved)
    return rec["round"]


def restore_state(path: str, like, *, rank: int | None = None):
    """Read the checkpoint at ``path`` into ``like`` (a freshly built state
    of the same run: its tensors are overwritten in place, on their own
    device) and return it. ``like`` stacked reads every worker's file;
    with ``rank`` (a collective rank's state) that worker's file alone.
    Raises ``ValueError`` on a world size or structure that differs."""
    path = os.path.abspath(path)
    world = checkpoint_world_size(path)
    if world is None:
        raise ValueError(f"{path}: no {META} (not a checkpoint, or a write that did not finish)")
    want = _world(like) if rank is None else None
    if want is not None and world != want:
        raise ValueError(f"{path}: checkpoint of {world} workers, this run has {want}")
    if rank is not None:
        if not 0 <= rank < world:
            raise ValueError(f"{path}: checkpoint of {world} workers has no rank {rank}")
        rounds = {_load_into(path, like, rank, True)}
    else:
        rounds = {_load_into(path, like, w, False) for w in range(world)}
    if len(rounds) != 1:
        raise ValueError(f"{path}: workers saved at different rounds {sorted(rounds)}")
    like.step = rounds.pop()
    return like


class AsyncSaver:
    """Overlap checkpoint writes with training: ``submit`` copies the state
    to the host (the only part that waits for the device) and hands the
    write to a thread. One write in flight: a new submit waits for the
    previous one. A failed write raises at the next ``submit`` or at
    ``wait``, never silently. The thread is not a daemon, so an exception
    in a later round still lets the write finish."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.last_path: str | None = None

    def submit(self, path: str, state, step: int | None = None) -> None:
        self.wait()
        dest = _step_dir(path, step)
        world, round_ = _world(state), int(state.step)
        records = [_record(state, w, False) for w in range(world)]

        def write():
            try:
                os.makedirs(dest, exist_ok=True)
                for w, rec in enumerate(records):
                    _atomic_save(rec, _worker_path(dest, w))
                write_meta(dest, world, round_)
                self.last_path = dest
            except BaseException as e:  # raised at the next submit or wait
                self._error = e

        self._thread = threading.Thread(target=write, name="checkpoint-writer", daemon=False)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}") from err


def _ref(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _ref_leaves(obj: Any) -> list[np.ndarray]:
    """The array leaves of a reference tree (numpy leaves; NamedTuples,
    mappings, sequences), in the reference's flatten order; empty
    containers (optax's ``EmptyState``, ``MaskedNode``) hold none."""
    if isinstance(obj, (np.ndarray, np.generic)):
        return [np.asarray(obj)]
    if isinstance(obj, Mapping):
        return [x for k in sorted(obj) for x in _ref_leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _ref_leaves(v)]
    if hasattr(obj, "__array__"):
        return [np.asarray(obj)]
    return []


def _ref_named(obj: Any, prefix: tuple = ()) -> dict[str, np.ndarray]:
    """A reference parameter-like tree's leaves by dotted flax path."""
    if isinstance(obj, Mapping):
        out = {}
        for k in sorted(obj):
            out.update(_ref_named(obj[k], prefix + (str(k),)))
        return out
    return {".".join(prefix): np.asarray(obj)}


def _fill(dsts: list[tuple[str, torch.Tensor]], srcs: list[np.ndarray], what: str) -> None:
    if len(dsts) != len(srcs):
        raise ValueError(f"{what}: the reference holds {len(srcs)} arrays, the port's state {len(dsts)}")
    with torch.no_grad():
        for (path, dst), src in zip(dsts, srcs):
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"{path}: reference {tuple(src.shape)}, port {tuple(dst.shape)}")
            dst.copy_(torch.as_tensor(np.array(src)).to(dst.dtype))


def state_from_reference(tree: Any, bundle, *, seed: int = 0, device=None):
    """The port's stacked ``TrainState`` from a reference ``TrainState``
    restored with numpy leaves (``consensusml_tpu.utils.restore_state``
    then ``jax.tree.map(np.asarray, ...)``, the rng left out or kept: it is
    not read). ``bundle`` is the port's run bundle of the same config and
    flags (optimizer, schedule, clip, gossip, SlowMo); the state is built
    from it on ``device`` (the current CUDA device unless the caller asks
    for the CPU) and overwritten with the reference's:

    - parameters and model state (BN statistics) by flax path; a LoRA
      run's frozen base from the reference's (worker 0's rows, cast as the
      port holds it);
    - the optimizer state leaf by leaf in the reference's flatten order,
      which is the port's: Adam's count and moments, SGD's trace, the
      schedule's count; optax's clip holds nothing (the port's reported
      norms start at 0);
    - the gossip state (CHOCO's ``xhat``/``s`` per bucket or per leaf,
      push-sum's mass, the overlap queue) and SlowMo's ``x``/``u`` leaf by
      leaf;
    - the round from ``step``.

    The random streams are not converted (typed JAX keys are not torch
    generators): the port's are drawn from ``seed``, which matters only
    for dropout and injected faults."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.models.convert import llama_frozen
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state

    device = resolve_device(device)
    params, model_state = configs.init_on_device(bundle, seed, device)
    frozen = {}
    ref_params = _ref_named(_ref(tree, "params"))
    if bundle.draw_frozen is not None:
        base = {n: torch.from_numpy(np.ascontiguousarray(a[0])) for n, a in ref_params.items() if n not in params}
        frozen = {n: t.to(device) for n, t in llama_frozen(base, bundle.model.config.dtype).items()}
    state = init_stacked_state(bundle.cfg, params, bundle.world_size, seed=seed, model_state=model_state,
                               frozen=frozen)
    _fill(list(T.named_tensors(state.params, "params")), [ref_params[n] for n in state.params], "params")
    ref_ms = _ref_named(_ref(tree, "model_state"))
    ms = T.named_tensors(state.model_state, "model_state")
    _fill(ms, [ref_ms[p.split(".", 1)[1]] for p, _ in ms], "model_state")
    # optax's clip keeps no state: the port's ClipState.norm (its only
    # "norm" field) has no counterpart and stays 0
    opt = [(p, t) for p, t in T.named_tensors(state.opt_state, "opt_state") if p.rsplit(".", 1)[-1] != "norm"]
    _fill(opt, _ref_leaves(_ref(tree, "opt_state")), "opt_state")
    _fill(T.named_tensors(state.gossip, "gossip"), _ref_leaves(_ref(tree, "gossip")), "gossip")
    _fill(T.named_tensors(state.outer, "outer"), _ref_leaves(_ref(tree, "outer")), "outer")
    state.step = int(np.asarray(_ref(tree, "step")).reshape(-1)[0])
    return state

