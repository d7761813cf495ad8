"""Wide-event request accounting: one structured record per request (port of
``consensusml_tpu/obs/events.py``: host code, as the reference's).

Every other plane answers one question at a time — the SLO histograms
say *that* a percentile spiked (obs/metrics.py), the request registry
says *which request* was slow (obs/requests.py), the cost ledger says
*what each executable costs* (obs/costs.py). Nothing joined them: no
single record answered "what did THIS request consume, and on whose
behalf?". This module is that join (docs/observability.md "Wide events
& tenant accounting").

At every engine-terminal state — complete (``eos``), truncated
(``max_tokens``/``length``), or error-drain (``cancelled``) — the
serving engine emits ONE wide event: the request's trace timings
(submit→admission→prefill→first-decode→complete, ``defer_ticks``,
``decode_ticks``, preemptions, hot-swap generation, speculative
propose/accept counts), its token counts (prompt in, generated out),
the pool block-seconds it held (integrated over hold time by
:class:`~consensusml_tpu.serve.pool.blocks.BlockPool`), the resolved
attention tier, and the LEDGER-DERIVED cost: ``decode_ticks`` × the
``serve.decode`` row's flops/bytes plus one ``serve.prefill.b{bucket}``
row per admission and the ``serve.spec.propose``/``serve.spec.verify``
rows on speculative engines — per-request TFLOPs and HBM bytes are
computed from XLA's own cost analysis, never guessed.

Events carry a ``tenant`` label threaded end to end (line-JSON protocol
→ ``ServeServer`` → ``Engine.submit(tenant=)`` → ``RequestTrace`` /
``GenResult``; default ``"default"``), so :meth:`WideEventLog.rollup`
attributes the fleet's spend per workload — the "tenant A consumed X
TFLOP-s and Y block-seconds" signal a router or autoscaler places
traffic on.

**Retention / memory model.** The log is a bounded ring (``capacity``
events, default 2048, oldest dropped — a weeks-long serving process
keeps the recent story, same policy as the span ring and the request
registry) plus an optional line-JSONL sink for durable offload: with
``jsonl_path`` set every event is appended as one JSON line at emit
time, so the full history lives on disk while memory stays bounded.
Non-finite floats are nulled at emit (events land in strict-JSON
consumers: cluster snapshots, flight dumps, ``/events``).

Singleton rule: producers arm the global log via
:func:`get_wide_event_log`; dump-path consumers (the flight recorder,
``ClusterWriter``) use :func:`peek_wide_event_log` and embed the log
only when something already armed it — a dump must never CREATE a log
as a side effect.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Any

from consensusml_tpu_torch.obs._annotations import guarded_by

__all__ = [
    "WideEventLog",
    "sanitize_tenant",
    "get_wide_event_log",
    "peek_wide_event_log",
    "reset_wide_event_log",
]

DEFAULT_CAPACITY = 2048
# worst-TTFT exemplars retained per tenant in rollup() — matches the
# histogram exemplar cap (obs/metrics.py EXEMPLAR_KEEP)
WORST_TTFT_KEEP = 8

_TENANT_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)


def sanitize_tenant(tenant: Any) -> str:
    """The canonical tenant label: ``None``/empty → ``"default"``,
    otherwise the string with non-``[A-Za-z0-9._-]`` characters replaced
    by ``_`` and capped at 64 chars — tenants arrive from untrusted
    line-JSON clients and become Prometheus label values and rollup
    keys, so the label charset is enforced at the boundary, once."""
    if tenant is None:
        return "default"
    s = str(tenant)[:64]
    if not s:
        return "default"
    return "".join(c if c in _TENANT_OK else "_" for c in s)


def _jsonclean(v: Any) -> Any:
    """Null non-finite floats, recursively — bare NaN/Infinity tokens
    break strict JSON parsers downstream (same rule as alerts.notify)."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {k: _jsonclean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonclean(x) for x in v]
    return v


@guarded_by("_lock", "_events", "_sink", "_emitted")
class WideEventLog:
    """Bounded ring of wide events + optional JSONL sink.

    The engine thread emits; scrapers (``/events``, ``/tenants``), the
    flight recorder, and the cluster writer read concurrently. RLock:
    the flight recorder's signal-handler dump may land inside an emit
    on the same thread (same reason as the metrics registry)."""

    def __init__(
        self,
        capacity: int = DEFAULT_CAPACITY,
        jsonl_path: str | None = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._lock = threading.RLock()
        self._events: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._emitted = 0
        self.jsonl_path = jsonl_path
        self._sink = None  # opened lazily on first emit

    # -- producer side -----------------------------------------------------

    def emit(self, event: dict[str, Any]) -> dict[str, Any]:
        """Record one wide event (the engine's terminal funnel calls
        this once per request). Missing ``time_s``/``tenant`` fields are
        stamped; the stored dict is JSON-safe. Returns the stored
        event."""
        ev = _jsonclean(dict(event))
        ev.setdefault("time_s", time.time())
        ev["tenant"] = sanitize_tenant(ev.get("tenant"))
        with self._lock:
            self._events.append(ev)
            self._emitted += 1
            if self.jsonl_path is not None:
                if self._sink is None:
                    self._sink = open(self.jsonl_path, "a")
                self._sink.write(json.dumps(ev) + "\n")
                self._sink.flush()
        return ev

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    # -- read side ---------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def emitted_total(self) -> int:
        with self._lock:
            return self._emitted

    def events(
        self, n: int | None = None, tenant: str | None = None
    ) -> list[dict[str, Any]]:
        """The newest ``n`` retained events (all when ``None``),
        newest-last, optionally filtered to one tenant."""
        with self._lock:
            evs = list(self._events)
        if tenant is not None:
            evs = [e for e in evs if e.get("tenant") == tenant]
        if n is not None and n >= 0:
            evs = evs[-n:]
        return evs

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted({e.get("tenant", "default") for e in self._events})

    def rollup(self) -> dict[str, dict[str, Any]]:
        """Per-tenant aggregates over the RETAINED ring: request count,
        prompt/generated tokens, ledger-joined TFLOPs and HBM
        gigabytes, pool block-seconds, decode/defer ticks, preemptions,
        and the worst-TTFT exemplars (cap :data:`WORST_TTFT_KEEP`,
        worst first) — the per-workload spend table the ``/tenants``
        endpoint, cluster aggregate, and ``obs_report`` render."""
        with self._lock:
            evs = list(self._events)
        out: dict[str, dict[str, Any]] = {}
        for ev in evs:
            t = ev.get("tenant", "default")
            agg = out.get(t)
            if agg is None:
                agg = out[t] = {
                    "requests": 0,
                    "tokens_in": 0,
                    "tokens_out": 0,
                    "tflops": 0.0,
                    "hbm_gbytes": 0.0,
                    "block_seconds": 0.0,
                    "shared_block_seconds": 0.0,
                    "prefix_hit_blocks": 0,
                    "decode_ticks": 0,
                    "defer_ticks": 0,
                    "preemptions": 0,
                    "worst_ttft": [],
                }
            agg["requests"] += 1
            agg["tokens_in"] += int(ev.get("prompt_len") or 0)
            agg["tokens_out"] += int(ev.get("tokens_out") or 0)
            agg["tflops"] += float(ev.get("tflops") or 0.0)
            agg["hbm_gbytes"] += float(ev.get("hbm_bytes") or 0.0) / 1e9
            agg["block_seconds"] += float(ev.get("block_seconds") or 0.0)
            # prefix-cache attribution: shared holds roll up separately
            # from the charged (exclusive) block-seconds above
            agg["shared_block_seconds"] += float(
                ev.get("shared_block_seconds") or 0.0
            )
            agg["prefix_hit_blocks"] += int(ev.get("prefix_hit_blocks") or 0)
            agg["decode_ticks"] += int(ev.get("decode_ticks") or 0)
            agg["defer_ticks"] += int(ev.get("defer_ticks") or 0)
            agg["preemptions"] += int(ev.get("preemptions") or 0)
            ttft = ev.get("ttft_s")
            if ttft is not None:
                agg["worst_ttft"].append(
                    {
                        "ttft_s": float(ttft),
                        "request_id": ev.get("request_id"),
                        "trace_id": ev.get("trace_id"),
                    }
                )
        for agg in out.values():
            agg["worst_ttft"] = sorted(
                agg["worst_ttft"], key=lambda r: -r["ttft_s"]
            )[:WORST_TTFT_KEEP]
            agg["tflops"] = round(agg["tflops"], 6)
            agg["hbm_gbytes"] = round(agg["hbm_gbytes"], 6)
            agg["block_seconds"] = round(agg["block_seconds"], 6)
            agg["shared_block_seconds"] = round(
                agg["shared_block_seconds"], 6
            )
        return out

    def snapshot(self, last_n: int = 64) -> dict[str, Any]:
        """JSON-able digest for cluster snapshots and flight dumps:
        per-tenant rollup + the last ``last_n`` raw events."""
        with self._lock:
            emitted = self._emitted
            retained = len(self._events)
        return {
            "time_s": time.time(),
            "emitted_total": emitted,
            "retained": retained,
            "tenants": self.rollup(),
            "events_recent": self.events(last_n),
        }


_GLOBAL: WideEventLog | None = None
_GLOBAL_LOCK = threading.Lock()


def get_wide_event_log() -> WideEventLog:
    """The process-wide log, created on first use by whichever producer
    arms it (the serving engine's terminal funnel). An optional JSONL
    sink path is taken from ``CONSENSUSML_WIDE_EVENTS_JSONL`` at
    creation time."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = WideEventLog(
                jsonl_path=os.environ.get("CONSENSUSML_WIDE_EVENTS_JSONL")
            )
        return _GLOBAL


def peek_wide_event_log() -> WideEventLog | None:
    """The global log if armed, else ``None`` — the dump-path accessor
    (flight recorder, cluster writer): a dump must never create a log
    as a side effect."""
    with _GLOBAL_LOCK:
        return _GLOBAL


def reset_wide_event_log() -> None:
    """Drop the global log (tests only — isolates per-test tenants)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
        _GLOBAL = None
