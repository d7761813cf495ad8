"""Request-scoped tracing: follow ONE request through the serving path (port of
``consensusml_tpu/obs/requests.py``: host code, as the reference's).

The SLO histograms say *that* TTFT p99 spiked; nothing before this module
said *which request* and *where its time went*. A :class:`TraceContext`
(``trace_id`` minted by the client, ``request_id`` unique per attempt) is
carried from ``tools/loadgen.py`` through the line-JSON protocol,
``ServeServer`` and ``Engine.submit``, and every stage the request
crosses appends one event to its :class:`RequestTrace`:

``submit`` → (``admission.defer`` per budget/blocks-deferred tick) →
``admission`` → ``prefill`` → ``decode`` (first tick; later ticks are
counted, not stored) → ``complete``, plus ``preempt`` on pool-exhaustion
recompute-eviction and ``hotswap`` when a generation flip lands under a
resident stream. The propagation rule (docs/observability.md "Request
tracing"): a client MAY send ``trace_id``/``request_id``; anything
missing is minted server-side, so every request is traceable even from
trace-unaware clients, and client + server observations of one request
join on ``trace_id``.

The registry is BOUNDED both ways — at most ``max_active`` in-flight
traces (oldest force-completed as ``truncated``) and a ``capacity`` ring
of completed ones — so a serving process that lives for weeks holds the
*recent* story only, exactly like the span ring. It exports:

- :meth:`RequestTraceRegistry.snapshot` — JSON-able dict (cluster
  snapshots, ``tools/obs_report.py`` joins, the flight recorder's crash
  dump — in-flight streams included, which is the post-mortem payload);
- :meth:`RequestTraceRegistry.trace_events` — Chrome trace events (one
  ``X`` span per request, one ``i`` instant per stage event) that
  :func:`merged_chrome_trace` interleaves with the ``SpanTracer`` ring,
  so Perfetto shows decode steps and the requests riding them together.

Event appends are one lock + one dict append — cheap enough for every
admission; the per-decode-tick path is an integer increment.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any

from consensusml_tpu_torch.obs._annotations import guarded_by

__all__ = [
    "TraceContext",
    "RequestTrace",
    "RequestTraceRegistry",
    "get_request_registry",
    "merged_chrome_trace",
    "write_merged_chrome_trace",
]

_MINT = itertools.count()

# admission.defer event rows stored per trace; defers past this are
# counted on defer_ticks only (a head-of-line request on an exhausted
# pool is deferred once per engine tick — the trace must stay bounded)
DEFER_EVENTS_KEPT = 16


class TraceContext:
    """The (trace_id, request_id) pair a request carries end to end.

    ``trace_id`` identifies the request across PROCESSES (client and
    server observations join on it); ``request_id`` identifies one
    serving attempt and is what SLO exemplars record. Both are short
    opaque strings; :meth:`mint` makes collision-safe ones, loadgen
    mints deterministic ones so fixtures replay byte-identically.
    """

    __slots__ = ("trace_id", "request_id")

    def __init__(self, trace_id: str, request_id: str | None = None):
        self.trace_id = str(trace_id)
        self.request_id = (
            str(request_id) if request_id else f"{self.trace_id}/0"
        )

    @classmethod
    def mint(cls, prefix: str = "srv") -> "TraceContext":
        tid = f"{prefix}-{uuid.uuid4().hex[:12]}-{next(_MINT):04d}"
        return cls(tid, tid + "/0")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TraceContext({self.trace_id!r}, {self.request_id!r})"


class RequestTrace:
    """One request's event list + rolled-up counters (registry-locked:
    the registry's lock guards every mutation, so a trace never needs
    its own)."""

    __slots__ = (
        "trace_id", "request_id", "prompt_len", "t_start_us",
        "events", "decode_ticks", "defer_ticks", "preemptions",
        "generation", "finish_reason", "t_end_us",
        "spec_proposed", "spec_accepted", "tenant",
    )

    def __init__(self, ctx: TraceContext, prompt_len: int, ts_us: float):
        self.trace_id = ctx.trace_id
        self.request_id = ctx.request_id
        self.prompt_len = int(prompt_len)
        self.t_start_us = ts_us
        self.events: list[dict[str, Any]] = []
        self.decode_ticks = 0
        self.defer_ticks = 0
        self.preemptions = 0
        self.generation = 0
        # speculative-decode accounting (serve/pool/spec.py): per-stream
        # draft tokens offered vs survivors — a stream with a bad
        # acceptance rate shows up in the slowest-request table with its
        # rejected drafts attached, not as unexplained decode ticks
        self.spec_proposed = 0
        self.spec_accepted = 0
        # per-workload attribution label (obs/events.py; the engine's
        # submit() resolves it, "default" for unlabeled clients)
        self.tenant = "default"
        self.finish_reason: str | None = None
        self.t_end_us: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "prompt_len": self.prompt_len,
            "t_start_us": round(self.t_start_us, 3),
            "t_end_us": (
                None if self.t_end_us is None else round(self.t_end_us, 3)
            ),
            "finish_reason": self.finish_reason,
            "decode_ticks": self.decode_ticks,
            "defer_ticks": self.defer_ticks,
            "preemptions": self.preemptions,
            "generation": self.generation,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "tenant": self.tenant,
            # rounding happens at export, never on the hot append path
            "events": [
                dict(e, ts_us=round(e["ts_us"], 3)) for e in self.events
            ],
        }


@guarded_by("_lock", "_active", "_done", "_by_id")
class RequestTraceRegistry:
    """Bounded per-request trace store (engine thread writes, scrapers
    and the flight recorder read concurrently).

    ``capacity`` bounds the completed ring; ``max_active`` bounds the
    in-flight table — a client that opens streams and never finishes
    them (or an engine crash mid-flight) cannot grow the registry
    without bound. The anchor pair mirrors :class:`SpanTracer` so
    request events and host spans share one Chrome-trace clock.
    """

    def __init__(self, capacity: int = 1024, max_active: int = 4096):
        self._active: "OrderedDict[str, RequestTrace]" = OrderedDict()
        self._done: deque[RequestTrace] = deque(maxlen=capacity)
        # request_id -> trace, completed included while the ring holds it
        self._by_id: dict[str, RequestTrace] = {}
        # RLock: the flight recorder's signal-handler dump may land
        # inside an append on the same thread (same reason as the
        # metrics registry's locks)
        self._lock = threading.RLock()
        self.max_active = max_active
        self._anchor_perf = time.perf_counter()
        self._anchor_epoch = time.time()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._anchor_perf) * 1e6

    # -- engine-side recording --------------------------------------------
    def start(self, ctx: TraceContext, prompt_len: int, **attrs) -> RequestTrace:
        """Open a trace and record its ``submit`` event. A ``tenant``
        attr additionally lands as the trace's attribution label (it
        still rides the submit event like any other attr)."""
        ts = self._now_us()
        tr = RequestTrace(ctx, prompt_len, ts)
        if "tenant" in attrs:
            tr.tenant = str(attrs["tenant"])
        ev: dict[str, Any] = {"name": "submit", "ts_us": ts}
        if attrs:
            ev.update(attrs)
        tr.events.append(ev)
        with self._lock:
            old = self._by_id.pop(ctx.request_id, None)
            if old is not None and old.finish_reason is None:
                self._finish_locked(old, "superseded")
            self._active[ctx.request_id] = tr
            self._by_id[ctx.request_id] = tr
            while len(self._active) > self.max_active:
                _rid, stale = self._active.popitem(last=False)
                self._finish_locked(stale, "truncated", evict_only=True)
        return tr

    def event(self, request_id: str | None, name: str, **attrs) -> None:
        """Append one stage event to an in-flight trace (no-op for
        unknown/finished ids, so instrumentation never raises)."""
        if not request_id:
            return
        ts = self._now_us()
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                return
            if name == "admission.defer":
                # a request can be deferred once per engine tick for
                # minutes on an exhausted pool — store the first few
                # rows, COUNT the rest (same stored-vs-counted split as
                # decode ticks; defer_ticks carries the true total)
                tr.defer_ticks += 1
                if tr.defer_ticks > DEFER_EVENTS_KEPT:
                    return
            ev: dict[str, Any] = {"name": name, "ts_us": ts}
            if attrs:
                ev.update(attrs)
            tr.events.append(ev)
            if name == "preempt":
                tr.preemptions += 1
            elif name == "hotswap":
                tr.generation = int(attrs.get("generation", tr.generation))

    def decode_tick(self, request_id: str | None) -> None:
        """Per-decode-tick accounting: the FIRST tick lands a ``decode``
        event, later ticks are one integer increment — a 4096-token
        stream must not store 4096 rows."""
        if not request_id:
            return
        self.decode_ticks((request_id,))

    def decode_ticks(self, request_ids) -> None:
        """Batch form for the engine's step loop: ONE lock round-trip
        covers every resident slot's tick, which is what keeps the
        per-step tracing cost in the microseconds (bench
        ``request_tracing_overhead_pct``)."""
        ts = self._now_us()
        with self._lock:
            for rid in request_ids:
                tr = self._active.get(rid) if rid else None
                if tr is None:
                    continue
                tr.decode_ticks += 1
                if tr.decode_ticks == 1:
                    tr.events.append({"name": "decode", "ts_us": ts})

    def spec_ticks(self, rows) -> None:
        """Speculative-round accounting, batch form like
        :meth:`decode_ticks`: ``rows`` is an iterable of ``(request_id,
        proposed, accepted)`` triples — ONE lock round-trip per verify
        round covers every resident lane."""
        with self._lock:
            for rid, proposed, accepted in rows:
                tr = self._active.get(rid) if rid else None
                if tr is None:
                    continue
                tr.spec_proposed += int(proposed)
                tr.spec_accepted += int(accepted)

    def finish(self, request_id: str | None, reason: str, **attrs) -> None:
        if not request_id:
            return
        ts = self._now_us()
        with self._lock:
            tr = self._active.get(request_id)
            if tr is None:
                return
            # terminal summary rides the complete event (ttft, tokens)
            tr.events.append({"name": "complete", "ts_us": ts, **attrs})
            self._finish_locked(tr, reason)

    def _finish_locked(
        self, tr: RequestTrace, reason: str, evict_only: bool = False
    ) -> None:
        # callers already hold _lock; the RLock makes this re-entry free
        # and keeps the lock-discipline lint's per-method proof local
        with self._lock:
            tr.finish_reason = reason
            tr.t_end_us = self._now_us()
            if not evict_only:
                self._active.pop(tr.request_id, None)
            self._done.append(tr)
            # _by_id keeps completed traces resolvable while the ring
            # holds them; prune ids the ring has dropped
            if len(self._by_id) > len(self._active) + self._done.maxlen:
                live = {t.request_id for t in self._done}
                live.update(self._active)
                self._by_id = {
                    rid: t for rid, t in self._by_id.items() if rid in live
                }

    # -- read side ---------------------------------------------------------
    def get(self, request_id: str) -> RequestTrace | None:
        with self._lock:
            return self._by_id.get(request_id)

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def completed(self) -> list[RequestTrace]:
        with self._lock:
            return list(self._done)

    def snapshot(self) -> dict[str, Any]:
        """JSON-able dump: completed ring + IN-FLIGHT traces (the part a
        crash dump must not lose) + the epoch anchor for log joins."""
        with self._lock:
            return {
                "anchor_epoch_s": self._anchor_epoch,
                "active": [t.to_dict() for t in self._active.values()],
                "completed": [t.to_dict() for t in self._done],
            }

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._done.clear()
            self._by_id.clear()

    # -- Chrome trace export ----------------------------------------------
    def trace_events(self) -> list[dict[str, Any]]:
        """One ``X`` span per request (submit → complete/now) plus one
        ``i`` instant per stage event, lane-per-request so Perfetto
        stacks concurrent streams."""
        pid = os.getpid()
        out: list[dict[str, Any]] = []
        with self._lock:
            traces = list(self._active.values()) + list(self._done)
            now_us = self._now_us()
        for tr in traces:
            tid = 1 + (hash(tr.request_id) % 2**20)
            end = tr.t_end_us if tr.t_end_us is not None else now_us
            out.append(
                {
                    "ph": "X",
                    "name": "request",
                    "cat": "request",
                    "pid": pid,
                    "tid": tid,
                    "ts": round(tr.t_start_us, 3),
                    "dur": round(max(end - tr.t_start_us, 0.0), 3),
                    "args": {
                        "trace_id": tr.trace_id,
                        "request_id": tr.request_id,
                        "prompt_len": tr.prompt_len,
                        "decode_ticks": tr.decode_ticks,
                        "defer_ticks": tr.defer_ticks,
                        "preemptions": tr.preemptions,
                        "finish_reason": tr.finish_reason,
                    },
                }
            )
            for ev in tr.events:
                rec = {
                    "ph": "i",
                    "s": "t",
                    "name": f"req.{ev['name']}",
                    "cat": "request",
                    "pid": pid,
                    "tid": tid,
                    "ts": ev["ts_us"],
                }
                extra = {
                    k: v for k, v in ev.items() if k not in ("name", "ts_us")
                }
                rec["args"] = {"request_id": tr.request_id, **extra}
                out.append(rec)
        return out


def merged_chrome_trace(
    tracer, registry: RequestTraceRegistry | None = None
) -> dict[str, Any]:
    """One Perfetto-loadable document: the span ring's events (decode
    steps, prefill spans) interleaved with the request lanes — the view
    that shows WHICH streams were riding the step that spiked."""
    reg = registry if registry is not None else get_request_registry()
    req_events = reg.trace_events()
    # the two rings were anchored at (slightly) different instants —
    # shift request timestamps onto the tracer's clock so the lanes line
    # up in Perfetto instead of drifting by the import-order gap
    shift_us = (reg._anchor_perf - tracer._anchor_perf) * 1e6
    for ev in req_events:
        ev["ts"] = round(ev["ts"] + shift_us, 3)
    return {
        "traceEvents": tracer.trace_events() + req_events,
        "displayTimeUnit": "ms",
        "metadata": {"source": "consensusml_tpu_torch.obs.requests"},
    }


def write_merged_chrome_trace(
    path: str, tracer, registry: RequestTraceRegistry | None = None
) -> str:
    doc = merged_chrome_trace(tracer, registry)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


_GLOBAL = RequestTraceRegistry()


def get_request_registry() -> RequestTraceRegistry:
    """The process-wide request-trace registry the serving path feeds
    (engine, server, loadgen) and every exporter reads (cluster
    snapshots, /metrics sibling endpoints, the flight recorder)."""
    return _GLOBAL
