"""Tracing and profiling helpers (port of
``consensusml_tpu/utils/profiling.py``).

- :func:`annotate`: name a region so it shows up as a labeled range in a
  ``torch.profiler`` trace (``record_function``), as the reference's
  ``jax.named_scope`` labels its xprof dump.
- :class:`RoundTimer`: wall-clock statistics over training rounds, each
  lap fenced by fetching one element of each leaf of the lap's metrics to
  the host (:func:`fence`), as the reference fences its laps.
- :func:`trace`: ``torch.profiler`` with CPU and CUDA activities around a
  block, written as a Chrome trace into a directory; an exception inside
  the block still stops the profiler and writes the trace.

The train CLI's ``--profile-dir`` traces rounds 2-3 with :func:`trace`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = ["annotate", "RoundTimer", "RoundStats", "trace", "fence"]


def annotate(name: str):
    """Label a region: ``with annotate("gossip"): ...`` makes a named range
    in a ``torch.profiler`` trace."""
    return torch.profiler.record_function(name)


def fence(tree: Any) -> None:
    """Execution barrier: fetch one element of each tensor leaf to the
    host. A device-to-host copy cannot complete before the kernels that
    produced the value have, so this is a fence on every device, and it
    waits for the producers of these leaves only (no
    ``torch.cuda.synchronize``)."""
    for leaf in T.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.numel():
                leaf.reshape(-1)[:1].cpu()
        elif leaf is not None:
            np.asarray(leaf).ravel()[:1]


@dataclasses.dataclass(frozen=True)
class RoundStats:
    """Summary of per-round wall times (seconds)."""

    count: int
    mean_s: float
    p50_s: float
    p95_s: float
    min_s: float
    max_s: float
    total_s: float

    def format(self) -> str:
        return (
            f"rounds={self.count} mean={self.mean_s * 1e3:.1f}ms "
            f"p50={self.p50_s * 1e3:.1f}ms p95={self.p95_s * 1e3:.1f}ms "
            f"min={self.min_s * 1e3:.1f}ms max={self.max_s * 1e3:.1f}ms"
        )


class RoundTimer:
    """Per-round wall times with a fence a lap::

        timer = RoundTimer(warmup=1)
        for batch in batches:
            with timer.lap(metrics_fn=lambda: metrics):
                state, metrics = step(state, batch)
        print(timer.stats().format())

    ``lap`` fences on what ``metrics_fn`` returns after the body ran, so
    the lap covers the step's device work, not just its dispatch. The
    first ``warmup`` laps (kernel builds) are kept apart. ``last_fence_s``
    is how long the last lap's fence blocked (the
    ``consensusml_round_stall_seconds`` gauge)."""

    def __init__(self, warmup: int = 1):
        self._warmup = warmup
        self._laps: list[float] = []
        self._warmup_laps: list[float] = []
        self.last_fence_s: float = 0.0
        self.last_lap_s: float = 0.0

    @contextlib.contextmanager
    def lap(self, metrics_fn=None) -> Iterator[None]:
        t0 = time.time()
        yield
        if metrics_fn is not None:
            t_fence = time.time()
            fence(metrics_fn())
            self.last_fence_s = time.time() - t_fence
        else:
            self.last_fence_s = 0.0
        dt = time.time() - t0
        self.last_lap_s = dt
        if len(self._warmup_laps) < self._warmup:
            self._warmup_laps.append(dt)
        else:
            self._laps.append(dt)

    @property
    def laps(self) -> list[float]:
        return list(self._laps)

    def stats(self) -> RoundStats:
        laps = self._laps or self._warmup_laps
        if not laps:
            return RoundStats(0, math.nan, math.nan, math.nan, math.nan, math.nan, 0.0)
        a = np.asarray(laps)
        return RoundStats(
            count=len(laps),
            mean_s=float(a.mean()),
            p50_s=float(np.percentile(a, 50)),
            p95_s=float(np.percentile(a, 95)),
            min_s=float(a.min()),
            max_s=float(a.max()),
            total_s=float(a.sum()),
        )


# the process's one profiler session (torch.profiler runs one at a time):
# the batch window (:func:`trace`) and the live ``/profile`` capture
# (obs/httpd.py) both hold it; ``PROFILER_SESSION["owner"]`` names the
# holder ("profile-dir", or a /profile capture id), None when free
PROFILER_LOCK = threading.Lock()
PROFILER_SESSION: dict = {"owner": None}


def profiler_activities() -> list:
    """CPU, and CUDA where a card is present."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def claim_profiler(owner: str, wait: bool) -> bool:
    """Take the process's profiler session for ``owner`` (waiting for the
    holder to end when ``wait``); False when it is held and not waited
    for. Release with :func:`release_profiler`."""
    if not PROFILER_LOCK.acquire(blocking=wait):
        return False
    PROFILER_SESSION["owner"] = owner
    return True


def release_profiler() -> None:
    PROFILER_SESSION["owner"] = None
    PROFILER_LOCK.release()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``torch.profiler`` (CPU and, where a card is present, CUDA
    activities) around the block; the Chrome trace lands in ``log_dir`` as
    ``trace-<pid>.json``, also when the block raises. Holds the process's
    profiler session (a live ``/profile`` capture in flight is waited for;
    one requested during the window gets 409)."""
    os.makedirs(log_dir, exist_ok=True)
    claim_profiler("profile-dir", wait=True)
    try:
        prof = torch.profiler.profile(activities=profiler_activities())
        prof.__enter__()
        try:
            yield
        finally:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
    finally:
        release_profiler()
