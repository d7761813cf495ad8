"""Crash flight recorder: dump the last N rounds of evidence on failure (port of
``consensusml_tpu/obs/flight.py``: host code, as the reference's).

A hung or dying run's most valuable debugging artifact is what it was
doing JUST BEFORE: the last rounds' spans (which stage the round was in)
and the last metric snapshots (was wire traffic normal? was the loss
finite? was a peer already flagged dead?). The tracer's ring buffer and
the registry's snapshot ring hold exactly that, bounded; the
:class:`FlightRecorder` serializes both to a timestamped JSON file when
one of three triggers fires:

- **watchdog timeout** — ``utils.watchdog.ProgressWatchdog(on_timeout=
  recorder.dump)``: the dump lands before the hard ``os._exit``, so a
  wedged collective still leaves evidence (the exact scenario the
  watchdog exists for);
- **unhandled exception** — a chained ``sys.excepthook``;
- **unhandled THREAD exception** — a chained ``threading.excepthook``:
  the serve-engine loop re-raises device errors on its own thread, so a
  serving crash dumps too, and the dump's ``request_traces`` section
  (the request-trace registry snapshot, in-flight streams included) is
  what makes the dying engine's open requests visible post-mortem;
- **SIGTERM** — a chained signal handler (the launcher's preemption
  path), which re-raises the previous disposition so the process still
  terminates.

``install()`` is idempotent per recorder and restores nothing: the hooks
live for the process, like the crash handlers they are.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any

from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from consensusml_tpu_torch.obs.requests import (
    RequestTraceRegistry,
    get_request_registry,
)
from consensusml_tpu_torch.obs.tracer import SpanTracer, get_tracer

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(
        self,
        out_dir: str,
        tracer: SpanTracer | None = None,
        registry: MetricsRegistry | None = None,
        requests: RequestTraceRegistry | None = None,
        history=None,
        alerts=None,
        events=None,
    ):
        self.out_dir = out_dir
        self.tracer = tracer if tracer is not None else get_tracer()
        self.registry = registry if registry is not None else get_registry()
        self.requests = (
            requests if requests is not None else get_request_registry()
        )
        # history rings / alert engine: explicit wiring wins; a recorder
        # over the GLOBAL registry additionally PEEKS at the process
        # singletons at dump time so an armed alert plane always lands
        # in the post-mortem (never creating one as a side effect) — a
        # custom-registry recorder must not embed the global plane's
        # digests next to a different registry's metrics
        self.history = history
        self.alerts = alerts
        # wide-event log (obs.events): same explicit-or-peek rule — a
        # serving crash's dump carries the last-N terminal wide events
        # and the per-tenant rollup, never creating a log as a dump
        # side effect
        self.events = events
        self._peek_global = registry is None
        self._installed = False
        self._prev_excepthook = None
        self._prev_thread_hook = None
        self._prev_sigterm = None
        self.last_dump_path: str | None = None

    # -- the dump ----------------------------------------------------------
    def dump(self, reason: str, detail: str | None = None) -> str | None:
        """Write ``flightrec-<utc>-<reason>.json``; returns the path.

        Never raises: a failing dump must not mask the original crash.
        """
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            slug = "".join(c if c.isalnum() else "-" for c in reason)[:40]
            path = os.path.join(
                self.out_dir, f"flightrec-{stamp}-{slug}.json"
            )
            doc: dict[str, Any] = {
                "reason": reason,
                "detail": detail,
                "time_s": time.time(),
                "pid": os.getpid(),
                "argv": sys.argv,
                "spans": self.tracer.events(),
                "trace_events": self.tracer.trace_events(),
                "metric_snapshots": self.registry.snapshots(),
                "metrics_final": self.registry.snapshot(
                    {"flight_recorder_reason": reason}
                ),
                # in-flight + recent request traces: the serve-side
                # post-mortem payload (which streams were open, how far
                # each had gotten) — see docs/observability.md
                "request_traces": self.requests.snapshot(),
            }
            alerts = self.alerts
            hist = self.history
            events = self.events
            if self._peek_global:
                from consensusml_tpu_torch.obs.alerts import peek_alert_engine
                from consensusml_tpu_torch.obs.events import peek_wide_event_log
                from consensusml_tpu_torch.obs.history import peek_history

                alerts = alerts or peek_alert_engine()
                hist = hist or peek_history()
                events = events or peek_wide_event_log()
            if alerts is not None:
                # what was already WRONG when the process died
                doc["alerts"] = alerts.snapshot()
            if hist is not None:
                # the last-N trend of every series — whether the breach
                # was a cliff or a slow burn
                doc["history"] = hist.digest()
            if events is not None:
                # who was consuming what when the process died: the
                # last-N terminal wide events + per-tenant rollup
                doc["wide_events"] = events.snapshot()
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            self.last_dump_path = path
            print(f"flight recorder: dumped {path} ({reason})",
                  file=sys.stderr, flush=True)
            return path
        except Exception as e:  # pragma: no cover - last-resort guard
            try:
                print(f"flight recorder: dump failed: {e}",
                      file=sys.stderr, flush=True)
            except Exception:
                pass
            return None

    # -- triggers ----------------------------------------------------------
    def install(self, sigterm: bool = True) -> "FlightRecorder":
        """Chain into sys.excepthook (always) and SIGTERM (when asked and
        possible — signal handlers only install from the main thread)."""
        if self._installed:
            return self
        self._installed = True

        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
                self.dump(
                    "unhandled-exception",
                    detail="".join(
                        traceback.format_exception(exc_type, exc, tb)
                    )[-4000:],
                )
            (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _hook

        # sys.excepthook never sees worker-thread deaths; the serving
        # engine re-raises on its own thread ON PURPOSE (loud death over
        # silent hang), so a serving crash must trigger through here
        self._prev_thread_hook = threading.excepthook

        def _thread_hook(args):
            if args.exc_type is not SystemExit:
                name = getattr(args.thread, "name", "?")
                self.dump(
                    f"thread-exception-{name}",
                    detail="".join(
                        traceback.format_exception(
                            args.exc_type, args.exc_value, args.exc_traceback
                        )
                    )[-4000:],
                )
            prev = self._prev_thread_hook or threading.__excepthook__
            prev(args)

        threading.excepthook = _thread_hook

        if sigterm:
            try:
                self._prev_sigterm = signal.getsignal(signal.SIGTERM)

                def _on_term(signum, frame):
                    self.dump("sigterm")
                    prev = self._prev_sigterm
                    if callable(prev):
                        prev(signum, frame)
                    elif prev != signal.SIG_IGN:
                        # default disposition: re-raise for a clean kill
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

                signal.signal(signal.SIGTERM, _on_term)
            except ValueError:
                # not the main thread — excepthook/watchdog paths still work
                pass
        return self
