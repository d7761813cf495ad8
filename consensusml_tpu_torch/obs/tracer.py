"""Span tracer: host-side nested spans + profiler-visible ranges (port of
``consensusml_tpu/obs/tracer.py``).

One ``span("gossip.round")`` does two things at once:

- records a HOST span (begin/end wall-clock, thread, nesting depth) into a
  bounded ring buffer, exportable as Chrome trace-event JSON that Perfetto
  / ``chrome://tracing`` loads directly;
- enters a ``torch.profiler.record_function`` range with the same name
  while a profiler is recording, so a ``--profile-dir`` trace carries the
  span names beside the card's kernels, as the reference's
  ``jax.named_scope`` labels its xprof dump.

The reference's spans inside jitted code fire on the host only while jit
traces (round 0). The port runs eagerly, so its spans fire every round;
round 0's names and nesting are the reference's trace-time nesting
(``train.round`` -> ``gossip.round`` -> ``bucket.pack`` -> ...). Spans
never touch a tensor's value: recording one adds no device
synchronization.

The ring buffer is bounded (``capacity`` spans, oldest dropped) so the
tracer can stay on for a week-long run and still hand the flight recorder
the LAST N rounds of evidence at crash time.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterator

import contextlib

import torch

__all__ = ["SpanTracer", "get_tracer", "span", "null_scope", "trace_program", "tracing_program",
           "as_program"]


def _named_scope(name: str):
    # a profiler range only while a profiler records: outside one,
    # record_function would still cost an op dispatch a span
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def null_scope():
    return contextlib.nullcontext()


# The reference's ``*_traced_total`` counters count while jit traces a
# gossip program: once a compile, so a run ends with one count a distinct
# program. The port runs eagerly; its counters count in the first run of
# each distinct program (plan x topology phase x wire branch), which
# :func:`trace_program` marks for the calls made inside it.
_PROGRAM = threading.local()


@contextlib.contextmanager
def trace_program(seen: set, key) -> Iterator[bool]:
    """Run the body as program ``key``; the body is that program's first
    run (the reference's trace) when ``key`` is not in ``seen`` yet, and
    :func:`tracing_program` then says so. Yields that flag."""
    first = key not in seen
    seen.add(key)
    with as_program(first):
        yield first


@contextlib.contextmanager
def as_program(first: bool) -> Iterator[None]:
    """The body counts as a program's first run iff ``first``: for work a
    program posts in one call and finishes in a later one."""
    prev = getattr(_PROGRAM, "first", False)
    _PROGRAM.first = first
    try:
        yield
    finally:
        _PROGRAM.first = prev


def tracing_program() -> bool:
    """Whether this thread runs the first run of a gossip program (where
    the trace-time counters count)."""
    return getattr(_PROGRAM, "first", False)


class SpanTracer:
    """Bounded ring buffer of completed spans.

    ``enabled=False`` reduces :meth:`span` to the bare profiler range
    (no host recording, no ring append) — the path a run with no trace
    sink configured stays on.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self._events: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._tls = threading.local()
        # RLock: appends and snapshots share it (a snapshot during an
        # append must not see a mutating deque), and the flight
        # recorder's signal-handler dump may interrupt an append on the
        # same thread — reentrancy keeps that from deadlocking
        self._lock = threading.RLock()
        self.enabled = enabled
        # perf_counter gives monotonic span math; the epoch anchor lets a
        # flight-recorder reader correlate spans with log timestamps
        self._anchor_perf = time.perf_counter()
        self._anchor_epoch = time.time()

    # -- recording ---------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        """``with tracer.span("gossip.round", round=3): ...``"""
        if not self.enabled:
            with _named_scope(name):
                yield
            return
        depth = getattr(self._tls, "depth", 0)
        self._tls.depth = depth + 1
        t0 = time.perf_counter()
        try:
            with _named_scope(name):
                yield
        finally:
            dur = time.perf_counter() - t0
            self._tls.depth = depth
            ev = {
                "name": name,
                "ts_us": (t0 - self._anchor_perf) * 1e6,
                "dur_us": dur * 1e6,
                "tid": threading.get_ident(),
                "depth": depth,
            }
            if attrs:
                ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
            with self._lock:
                self._events.append(ev)

    def complete(self, name: str, dur_s: float, **attrs) -> None:
        """Append an externally-timed completed span ending NOW.

        The train loop measures some phases itself (the feed stall is
        clocked inside the prefetcher's queue pop, the fence wait inside
        the round timer) — this records them as first-class spans so the
        per-round phase rows (``round.feed`` / ``round.fence``) ride the
        same ring, digest, and Chrome export as ``with``-recorded spans.
        """
        if not self.enabled:
            return
        dur = max(float(dur_s), 0.0)
        end = time.perf_counter() - self._anchor_perf
        ev = {
            "name": name,
            "ts_us": (end - dur) * 1e6,
            "dur_us": dur * 1e6,
            "tid": threading.get_ident(),
            "depth": getattr(self._tls, "depth", 0),
        }
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker event (watchdog beats, fault rounds)."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ts_us": (time.perf_counter() - self._anchor_perf) * 1e6,
            "dur_us": 0.0,
            "tid": threading.get_ident(),
            "depth": getattr(self._tls, "depth", 0),
            "instant": True,
        }
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        with self._lock:
            self._events.append(ev)

    # -- export ------------------------------------------------------------
    def events(self) -> list[dict[str, Any]]:
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def trace_events(self) -> list[dict[str, Any]]:
        """Chrome trace-event ("X"/"i" phase) dicts for the current ring."""
        pid = os.getpid()
        out: list[dict[str, Any]] = [
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "args": {"name": "consensusml host"},
            }
        ]
        for ev in self.events():
            rec: dict[str, Any] = {
                "name": ev["name"],
                "pid": pid,
                "tid": ev["tid"] % 2**31,  # Perfetto wants small tids
                "ts": round(ev["ts_us"], 3),
            }
            if ev.get("instant"):
                rec["ph"] = "i"
                rec["s"] = "t"
            else:
                rec["ph"] = "X"
                rec["dur"] = round(ev["dur_us"], 3)
            if "args" in ev:
                rec["args"] = ev["args"]
            out.append(rec)
        return out

    def digest(self, max_rounds: int = 64) -> dict[str, Any]:
        """Compact summary of the ring for cluster snapshots.

        Two parts (docs/observability.md "Cross-rank round timeline"):

        - ``spans`` — per-name count/total/max, the whole ring;
        - ``rounds`` — one row per round index found in span attrs
          (``round=`` is stamped by the train loop on ``train.round``
          and the synthetic ``round.feed`` / ``round.fence`` phase
          spans), last ``max_rounds`` rows. The aggregator merges these
          across ranks into the round timeline that attributes a
          straggler round to its phase.

        A few hundred bytes per rank per snapshot — cheap enough to ride
        every :class:`~consensusml_tpu_torch.obs.cluster.ClusterWriter` write.
        """
        names: dict[str, dict[str, float]] = {}
        rounds: dict[int, dict[str, Any]] = {}
        per_round_key = {
            "train.round": "dur_us",
            "round.feed": "feed_us",
            "round.fence": "fence_us",
        }
        for ev in self.events():
            d = names.setdefault(
                ev["name"], {"count": 0, "total_us": 0.0, "max_us": 0.0}
            )
            d["count"] += 1
            d["total_us"] += ev["dur_us"]
            d["max_us"] = max(d["max_us"], ev["dur_us"])
            rnd = (ev.get("args") or {}).get("round")
            key = per_round_key.get(ev["name"])
            if key is not None and isinstance(rnd, (int, float)):
                row = rounds.setdefault(int(rnd), {"round": int(rnd)})
                row[key] = round(ev["dur_us"], 1)
        return {
            "anchor_epoch_s": self._anchor_epoch,
            "spans": {
                k: {
                    "count": int(v["count"]),
                    "total_us": round(v["total_us"], 1),
                    "max_us": round(v["max_us"], 1),
                }
                for k, v in sorted(names.items())
            },
            "rounds": [rounds[r] for r in sorted(rounds)][-max_rounds:],
        }

    def write_chrome_trace(self, path: str) -> str:
        """Dump the ring as a Perfetto-loadable trace-event JSON file."""
        doc = {
            "traceEvents": self.trace_events(),
            "displayTimeUnit": "ms",
            "metadata": {
                "anchor_epoch_s": self._anchor_epoch,
                "source": "consensusml_tpu_torch.obs.tracer",
            },
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        # float() of a device tensor would synchronize: record its shape
        return str(tuple(v.shape))
    try:
        return float(v)
    except Exception:
        return str(v)


_GLOBAL = SpanTracer(enabled=False)


def get_tracer() -> SpanTracer:
    """The process-wide tracer every instrumented module records into.

    Starts DISABLED (profiler ranges only, no host recording) so importing
    instrumented modules costs nothing; the train CLI enables
    it when a trace or flight-recorder sink is configured.
    """
    return _GLOBAL


def span(name: str, **attrs):
    """Module-level shorthand: ``with obs.span("bucket.pack"): ...``"""
    return _GLOBAL.span(name, **attrs)
