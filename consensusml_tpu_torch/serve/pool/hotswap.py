"""Drain-free hot swap: generation-tagged artifact reload.

Port of ``consensusml_tpu/serve/pool/hotswap.py``. The trainer re-exports
the consensus mean at every ``--checkpoint-every`` boundary
(:mod:`..export`: atomic, meta last, a rising ``generation``). A watcher
thread polls the artifact directory and stages any newer generation off
the engine thread: it reads the files, casts each tensor to the dtype of
the live parameter it replaces, and copies them to the card on a side
stream of its own, recording an event (on the CPU the tensors are simply
cast). The engine thread then flips between two steps
(``Engine._maybe_swap``): its stream waits on that event, never on the
disk, and the model's parameters point at the staged tensors. No stream
drops and nothing drains; streams that straddle a swap keep their cache
(prefix under generation g, the rest under g + 1).

Monotonic on the read side: a meta whose generation goes backwards is
rejected and counted once, never served. A read that fails (an export
half written, a transient error) is retried at the next poll. A staged
tree that does not match the live one leaf for leaf is rejected by the
engine, which calls :meth:`GenerationWatcher.reject`: the watcher then
skips that exact artifact (generation and meta mtime) until it is
rewritten. The reference's families count it:
``consensusml_serve_swap_staged_total``, ``..._swap_rejected_total`` and
the ``consensusml_serve_swap_stage_seconds`` histogram.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any

import torch

__all__ = ["StagedSwap", "GenerationWatcher"]


@dataclasses.dataclass(frozen=True)
class StagedSwap:
    """A generation staged on the engine's device, ready to flip.

    ``params``/``draft_params``: name -> tensor in the live dtypes;
    ``spec``/``draft_spec``: name -> (shape, dtype) of what was read, the
    leaf-for-leaf comparison the engine makes; ``event``: recorded after
    the staging copies on the side stream (``None`` on the CPU)."""

    generation: int
    params: dict[str, torch.Tensor]
    spec: dict[str, tuple]
    meta_mtime: float = 0.0
    draft_params: dict[str, torch.Tensor] | None = None
    draft_spec: dict[str, tuple] | None = None
    event: Any = None


def tree_spec(params: dict[str, torch.Tensor]) -> dict[str, tuple]:
    """name -> (shape, dtype): what a staged tree must match."""
    return {n: (tuple(t.shape), t.dtype) for n, t in params.items()}


class GenerationWatcher:
    """Polls an artifact directory and stages new generations.

    ``take()`` (engine thread, between steps) returns the newest staged
    swap and clears it; two generations landing within one poll flip
    straight to the newest. ``like``/``draft_like`` give the live dtypes
    (name -> dtype) the staged tensors are cast to; ``device`` is the
    engine's. The four fields the watcher and the engine thread share
    move under ``_lock``; the slow part (the read and the copies) runs
    outside it.
    """

    def __init__(
        self,
        path: str,
        *,
        device,
        like: dict[str, torch.dtype],
        draft_like: dict[str, torch.dtype] | None = None,
        current_generation: int = 0,
        poll_s: float = 0.25,
    ):
        self.path = path
        self.poll_s = poll_s
        self.device = torch.device(device)
        self._like = like
        self._draft_like = draft_like  # None: not a speculative engine
        self._generation = current_generation  # newest ACCEPTED generation
        self._staged: StagedSwap | None = None
        self._rejected_gen: int | None = None  # the last regression counted
        self._flip_rejected: tuple[int, float] | None = None  # (generation, mtime) the engine refused
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.staged = 0  # generations staged
        self.rejected = 0  # metas rejected: regressions, and trees the engine refused
        self.stage_seconds: list[float] = []  # read + copies of each staged generation
        from consensusml_tpu_torch.obs import get_registry

        reg = get_registry()
        self._m_staged = reg.counter("consensusml_serve_swap_staged_total",
                                     "new artifact generations loaded and staged by the watcher")
        self._m_rejected = reg.counter(
            "consensusml_serve_swap_rejected_total",
            "artifact metas rejected (generation not strictly increasing, or params tree mismatch at flip time)")
        self._m_load = reg.histogram("consensusml_serve_swap_stage_seconds",
                                     "artifact restore + device staging wall time (watcher thread)")
        self._thread = threading.Thread(target=self._run, name="serve-hotswap", daemon=True)
        self._thread.start()

    @property
    def generation(self) -> int:
        """The newest accepted generation (staged or flipped)."""
        with self._lock:
            return self._generation

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:
                # a half-written artifact or a transient read error is not a
                # serving incident: the next poll sees the finished write
                continue

    def _stage(self, params: dict[str, torch.Tensor], like: dict[str, torch.dtype]) -> dict[str, torch.Tensor]:
        """Cast each tensor to its live dtype and copy it to the device (on
        the side stream, from pinned host memory)."""
        cast = {n: t.to(like.get(n, t.dtype)) for n, t in params.items()}
        if self._stream is None:
            return cast
        with torch.cuda.stream(self._stream):
            return {n: t.pin_memory().to(self.device, non_blocking=True) for n, t in cast.items()}

    def poll_once(self) -> bool:
        """One poll: stage the artifact if its generation advanced. Public
        for deterministic tests; True when it staged one."""
        from consensusml_tpu_torch.serve.export import DRAFT_SUBDIR, META_NAME, load_serving, serving_meta

        try:
            meta = serving_meta(self.path)
        except ValueError:
            return False  # no artifact yet, or a torn write
        gen = int(meta.get("generation", 0))
        with self._lock:
            behind = gen <= self._generation
            # count an observed regression once, not once a poll
            regressed = gen < self._generation and gen != self._rejected_gen
            if regressed:
                self._rejected_gen = gen
                self.rejected += 1
        if behind:
            if regressed:
                self._m_rejected.inc()
            return False
        try:
            mtime = os.path.getmtime(os.path.join(self.path, META_NAME))
        except OSError:
            return False  # replaced between the read and the stat
        with self._lock:
            if self._flip_rejected == (gen, mtime):
                return False  # the engine refused this very artifact; await a rewrite
        t0 = time.perf_counter()
        _meta, params, _ms = load_serving(self.path)
        spec, staged = tree_spec(params), self._stage(params, self._like)
        draft_params = draft_spec = None
        draft_dir = os.path.join(self.path, DRAFT_SUBDIR)
        if self._draft_like is not None and os.path.isdir(draft_dir):
            # a torn draft read raises: the pair stages together or not at all
            _dmeta, dparams, _dms = load_serving(draft_dir)
            draft_spec, draft_params = tree_spec(dparams), self._stage(dparams, self._draft_like)
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
            event.synchronize()  # this thread waits for the copies; the engine thread never does
        stage_s = time.perf_counter() - t0
        self._m_load.observe(stage_s)
        with self._lock:
            # the engine may have refused this (generation, mtime) meanwhile
            if self._flip_rejected == (gen, mtime):
                return False
            self._staged = StagedSwap(gen, staged, spec, mtime, draft_params, draft_spec, event)
            self._generation = gen
            self.staged += 1
            self.stage_seconds.append(stage_s)
        self._m_staged.inc()
        return True

    def take(self) -> StagedSwap | None:
        with self._lock:
            staged, self._staged = self._staged, None
        return staged

    def reject(self, staged: StagedSwap) -> None:
        """The engine refused ``staged`` (a tree that does not match): roll
        the accepted generation back, so a corrected artifact rewritten at
        the same generation stages on a later poll, and skip this exact one
        (its generation and meta mtime) until then."""
        self._m_rejected.inc()
        with self._lock:
            self.rejected += 1
            self._flip_rejected = (staged.generation, staged.meta_mtime)
            if self._generation == staged.generation:
                self._generation = staged.generation - 1

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
