"""Live HTTP plane: scrape metrics and traces (port of
``consensusml_tpu/obs/httpd.py``).

The textfile collector is pull-at-cadence — the file is only as fresh as
the last ``--telemetry-every`` rewrite, and a serving process with no
training loop has no natural rewrite cadence at all. This stdlib
``ThreadingHTTPServer`` serves the SAME locked ``expose()`` path the
textfile writer uses, freshly rendered per GET, so a Prometheus scraper
(or a human with curl) sees live values:

- ``GET /metrics``  — Prometheus text exposition (``to_prometheus()``);
- ``GET /traces``   — the merged Chrome trace JSON (span ring + request
  lanes, Perfetto-loadable — the live twin of ``--trace-events``);
- ``GET /requests`` — the request-trace registry snapshot JSON
  (in-flight + recent completed, docs/observability.md "Request
  tracing");
- ``GET /alerts``   — the alert engine's snapshot (firing worst-first,
  recent resolutions, plane events — docs/observability.md "Alerting &
  history");
- ``GET /query?series=NAME[&window=S][&n=N]`` — one history series:
  derived points (rate / p99-per-interval / raw gauge), windowed stats;
- ``GET /healthz``  — the readiness probe a fleet router polls: process
  up, last history-tick age, firing-alert count. Returns **503** when
  this server OWNS the tick cadence (``tick_s > 0``) and ticks stopped
  landing — a wedged serving process stops being routable;
- ``GET /events?n=N&tenant=T`` — the newest wide events from the
  request-accounting log, optionally filtered to one tenant
  (docs/observability.md "Wide events & tenant accounting");
- ``GET /tenants`` — the per-tenant rollup: requests, tokens, joined
  TFLOPs, HBM gigabytes, block-seconds, worst-TTFT exemplars. Both
  PEEK the global log (wired ``events=`` wins): a scrape must never
  create one, so an un-armed process answers with an empty doc;
- ``GET /profile?ms=N`` — an ON-DEMAND ``torch.profiler`` capture of the
  live process for N ms (default 500, at most 30 s): on a card its CUDA
  activity, recorded card-wide (every kernel any thread launches in the
  window: the train loop, a serving engine mid-traffic); on the CPU the
  handler thread's own ops; the Chrome trace lands in
  ``<profile_dir>/cap-<seq>-<time>/trace.json`` and the response carries
  the machine-readable op summary (``consensusml_tpu_torch/tools/
  profile_summary.py``: kernels by name). SINGLE-FLIGHT: one capture at
  a time — a second request gets **409** with the in-flight capture's
  id, and so does a request while the train CLI's ``--profile-dir``
  window holds the process's profiler session (503 when another
  profiler holds it). Capture directories rotate under ``profile_quota``
  (oldest deleted).

Surfaces: ``python -m consensusml_tpu_torch.train --metrics-port N`` and
``ServeServer(metrics_port=N)`` (``0`` picks a free port; read it back
from :attr:`MetricsServer.port`). Render cost is paid by the scraper's
thread — the train/serve hot paths only ever touch the per-metric locks
they already hold for a few µs per update.

History/alert state is OPT-IN wiring (``history=``/``alerts=``): the
train loop drives ``record()``/``evaluate()`` from its own telemetry
tick and passes the engines in for surfacing only; a serving process
has no loop to ride, so ``tick_s > 0`` starts the ``obs-ticker``
daemon thread (docs/threads.md) that drives them at cadence —
``ServeServer(metrics_port=...)`` does exactly that.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from consensusml_tpu_torch.obs._annotations import guarded_by
from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from consensusml_tpu_torch.obs.requests import (
    RequestTraceRegistry,
    get_request_registry,
    merged_chrome_trace,
)
from consensusml_tpu_torch.obs.tracer import SpanTracer, get_tracer

__all__ = ["MetricsServer"]

def _jsonsafe(doc):
    """Non-finite floats -> null: ``json.dumps`` would emit bare
    ``NaN``/``Infinity``, which strict JSON parsers (a Go router polling
    /healthz, jq) reject. Applied to the alert/history endpoint docs,
    whose empty-window stats are NaN by construction."""
    if isinstance(doc, float) and not math.isfinite(doc):
        return None
    if isinstance(doc, dict):
        return {k: _jsonsafe(v) for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [_jsonsafe(v) for v in doc]
    return doc


PROFILE_MAX_MS = 30_000  # one capture may stall a scraper thread this long
PROFILE_DEFAULT_MS = 500


def _profile_summary_json(trace_json: str) -> dict | None:
    """The op summary of a capture (``tools/profile_summary.py``, loaded
    through :func:`~consensusml_tpu_torch.obs.memviz.load_tool`); None when
    the tool is absent or the parse fails."""
    from consensusml_tpu_torch.obs.memviz import load_tool

    try:
        mod = load_tool("profile_summary")
        return None if mod is None else mod.summarize(trace_json, top=500)
    except Exception:
        return None


@guarded_by("_lock", "_profile_inflight", "_profile_seq")
class MetricsServer:
    """Threaded HTTP exporter over the process's observability state.

    ``/profile``'s single-flight state is a flag under a plain ``with``
    lock (the 409 loser reads the winner's capture id under it), and the
    capture itself holds the process's profiler session
    (:func:`~consensusml_tpu_torch.utils.profiling.claim_profiler`), which
    the train CLI's ``--profile-dir`` window holds too."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        registry: MetricsRegistry | None = None,
        tracer: SpanTracer | None = None,
        requests: RequestTraceRegistry | None = None,
        history=None,
        alerts=None,
        tick_s: float = 0.0,
        events=None,
        ready_fn=None,
        profile_dir: str | None = None,
        profile_quota: int = 4,
    ):
        registry = registry if registry is not None else get_registry()
        tracer = tracer if tracer is not None else get_tracer()
        requests = requests if requests is not None else get_request_registry()
        # MetricsHistory / AlertEngine (obs.history / obs.alerts): when
        # wired, /alerts and /query go live and /healthz reports tick
        # freshness; tick_s > 0 additionally makes THIS server drive
        # record()/evaluate() on the obs-ticker thread
        self.history = history
        self.alerts = alerts
        # WideEventLog (obs.events): /events and /tenants surface it;
        # None means peek-at-request-time — the serving engine arms the
        # global log, a scrape never creates one
        self.events = events
        self.tick_s = float(tick_s)
        # readiness hook: a zero-arg callable (e.g. ``lambda:
        # engine.warmed``) consulted by /healthz — False turns the probe
        # 503 so a fleet router places zero new streams here (a replica
        # still paying warmup compiles must not take traffic). None
        # keeps the pre-fleet behavior: tick freshness alone decides.
        self.ready_fn = ready_fn
        server = self
        # /profile: one capture at a time, captures rotating under a quota
        self.profile_dir = profile_dir or os.path.join(tempfile.gettempdir(), f"cml-profiles-{os.getpid()}")
        self.profile_quota = max(1, int(profile_quota))
        self._lock = threading.Lock()
        self._profile_seq = 0
        self._profile_inflight: str | None = None

        self._m_captures = registry.counter(
            "consensusml_profile_captures_total",
            "on-demand /profile captures completed",
        )
        self._m_prof_rejected = registry.counter(
            "consensusml_profile_rejected_total",
            "/profile requests refused (single-flight 409s + profiler "
            "double-start 503s)",
        )

        # the one JSON content type every JSON endpoint sends — /metrics
        # alone stays Prometheus text exposition
        JSON_CTYPE = "application/json; charset=utf-8"

        class Handler(BaseHTTPRequestHandler):
            def _send_json(self, code: int, doc) -> None:
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", JSON_CTYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:  # noqa: N802 - stdlib API name
                url = urlparse(self.path)
                path = url.path
                if path in ("/metrics", "/"):
                    body = registry.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/traces":
                    self._send_json(
                        200, merged_chrome_trace(tracer, requests)
                    )
                elif path == "/requests":
                    self._send_json(200, requests.snapshot())
                elif path == "/alerts":
                    code, doc = server._alerts_doc()
                    self._send_json(code, _jsonsafe(doc))
                elif path == "/query":
                    code, doc = server._query_doc(parse_qs(url.query))
                    self._send_json(code, _jsonsafe(doc))
                elif path == "/healthz":
                    code, doc = server._healthz_doc()
                    self._send_json(code, _jsonsafe(doc))
                elif path == "/events":
                    code, doc = server._events_doc(parse_qs(url.query))
                    self._send_json(code, _jsonsafe(doc))
                elif path == "/tenants":
                    code, doc = server._tenants_doc()
                    self._send_json(code, _jsonsafe(doc))
                elif path == "/profile":
                    self._send_json(*server._profile(parse_qs(url.query)))
                else:
                    self._send_json(
                        404,
                        {
                            "error": "try /metrics, /traces, /requests, "
                                     "/alerts, /query, /healthz, /events, "
                                     "/tenants, /profile"
                        },
                    )

            def log_message(self, *args) -> None:
                pass  # scrapes are not log lines

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.address: tuple[str, int] = self._httpd.server_address[:2]
        self.port: int = self.address[1]
        # /healthz state must exist before the first handler can run
        self._started_s = time.time()
        self._tick_stop = threading.Event()
        self._ticker = None
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-http",
            daemon=True,
        )
        self._thread.start()
        # obs-ticker (docs/threads.md): serving processes have no train
        # loop to ride, so the server itself drives history.record() +
        # alerts.evaluate() at tick_s cadence; the thread only touches
        # the locked history/alert/registry paths
        if self.tick_s > 0 and (
            self.history is not None or self.alerts is not None
        ):
            self._ticker = threading.Thread(
                target=self._tick_loop, name="obs-ticker", daemon=True
            )
            self._ticker.start()

    def _tick_loop(self) -> None:
        while not self._tick_stop.wait(self.tick_s):
            try:
                if self.history is not None:
                    self.history.record()
                if self.alerts is not None:
                    self.alerts.evaluate()
            except Exception:
                # a transient export failure must not kill the cadence;
                # /healthz staleness catches a persistently broken tick
                pass

    # -- /alerts /query /healthz ------------------------------------------

    def _alerts_doc(self) -> tuple[int, dict]:
        if self.alerts is None:
            return 200, {"enabled": False, "firing": [], "firing_total": 0}
        doc = self.alerts.snapshot()
        doc["enabled"] = True
        return 200, doc

    def _query_doc(self, query: dict) -> tuple[int, dict]:
        if self.history is None:
            return 404, {"error": "no metrics history wired on this server"}
        series = (query.get("series") or [None])[0]
        if not series:
            return 400, {
                "error": "series is required: /query?series=NAME"
                         "[&window=SECONDS][&n=POINTS]",
                "series_known": self.history.keys(),
            }
        try:
            window = query.get("window")
            window_s = float(window[0]) if window else None
            n = query.get("n")
            points = int(n[0]) if n else None
        except (TypeError, ValueError):
            return 400, {"error": "window/n must be numeric"}
        doc = self.history.query(series, window_s=window_s, n=points)
        if doc is None:
            return 404, {
                "error": f"unknown series {series!r}",
                "series_known": self.history.keys(),
            }
        return 200, doc

    def _healthz_doc(self) -> tuple[int, dict]:
        """Readiness: 200 while the process (and, when this server owns
        the cadence, its obs tick) is live; 503 when an owned tick went
        stale — the signal a fleet router stops routing on."""
        now = time.time()
        age = None
        if self.history is not None:
            last = self.history.last_record_s
            if last == last:  # not NaN: at least one record landed
                # floor at server start: an OWNED tick cannot be stale
                # before this server has lived a tick interval — an
                # inherited process-global history may carry records
                # from long before this server existed
                age = round(now - max(last, self._started_s), 3)
            else:
                age = round(now - self._started_s, 3)
        firing = len(self.alerts.firing()) if self.alerts is not None else 0
        ok = True
        if self.tick_s > 0 and age is not None:
            ok = age <= max(5.0 * self.tick_s, 10.0)
        # the warmup gate (docs/fleet.md): ready_fn False means the
        # process is alive but must take zero NEW streams — same 503 a
        # stale tick earns, with the reason split out so a fleet
        # router's scrape can tell "warming" from "wedged"
        ready = True
        if self.ready_fn is not None:
            try:
                ready = bool(self.ready_fn())
            except Exception:
                ready = False
        return (200 if ok and ready else 503), {
            "ok": ok and ready,
            "ready": ready,
            "time_s": now,
            "pid": os.getpid(),
            "tick_s": self.tick_s if self.tick_s > 0 else None,
            "last_tick_age_s": age,
            "firing_alerts": firing,
            "history_series": (
                len(self.history) if self.history is not None else 0
            ),
        }

    # -- /events /tenants --------------------------------------------------

    def _event_log(self):
        """Wired log, else the global PEEKED (never created — the
        engine's terminal funnel arms it; a scrape must not)."""
        if self.events is not None:
            return self.events
        from consensusml_tpu_torch.obs.events import peek_wide_event_log

        return peek_wide_event_log()

    def _events_doc(self, query: dict) -> tuple[int, dict]:
        log = self._event_log()
        if log is None:
            return 200, {"enabled": False, "events": [], "emitted_total": 0}
        try:
            n = query.get("n")
            count = int(n[0]) if n else 64
        except (TypeError, ValueError):
            return 400, {"error": "n must be an integer"}
        tenant = (query.get("tenant") or [None])[0]
        return 200, {
            "enabled": True,
            "emitted_total": log.emitted_total,
            "retained": len(log),
            "events": log.events(count, tenant=tenant),
        }

    def _tenants_doc(self) -> tuple[int, dict]:
        log = self._event_log()
        if log is None:
            return 200, {"enabled": False, "tenants": {}}
        return 200, {"enabled": True, "tenants": log.rollup()}

    # -- /profile ---------------------------------------------------------

    def _profile(self, query: dict) -> tuple[int, dict]:
        """One on-demand capture (the reference's ``_profile``). Returns
        ``(http_status, doc)``. Runs on the scraper's handler thread: the
        hot paths never wait on it. The locked check-and-set of
        ``_profile_inflight`` is the single-flight guard; the process's
        profiler session (held by a ``--profile-dir`` window) is the
        second."""
        import torch

        from consensusml_tpu_torch.utils.profiling import (
            PROFILER_SESSION,
            claim_profiler,
            profiler_activities,
            release_profiler,
        )

        try:
            ms = int(query.get("ms", [PROFILE_DEFAULT_MS])[0])
        except (TypeError, ValueError):
            return 400, {"error": "ms must be an integer"}
        ms = min(max(ms, 10), PROFILE_MAX_MS)
        with self._lock:
            inflight = self._profile_inflight
            if inflight is None:
                self._profile_seq += 1
                cap_id = f"cap-{self._profile_seq:05d}-{int(time.time())}"
                self._profile_inflight = cap_id
        if inflight is not None:
            self._m_prof_rejected.inc()
            return 409, {"error": "a profile capture is already in flight", "capture_id": inflight}
        try:
            if not claim_profiler(cap_id, wait=False):
                self._m_prof_rejected.inc()
                return 409, {"error": f"the profiler session is held by {PROFILER_SESSION['owner']!r}",
                             "capture_id": PROFILER_SESSION["owner"]}
            try:
                cap_dir = os.path.join(self.profile_dir, cap_id)
                os.makedirs(cap_dir, exist_ok=True)
                # on a card its activity alone: the CPU side would record
                # only this handler thread's ops, and cost the export time
                acts = [torch.profiler.ProfilerActivity.CUDA] if torch.cuda.is_available() else profiler_activities()
                prof = torch.profiler.profile(activities=acts)
                try:
                    prof.start()
                except RuntimeError as e:
                    # another profiler (not the --profile-dir window) holds the session
                    self._m_prof_rejected.inc()
                    shutil.rmtree(cap_dir, ignore_errors=True)
                    return 503, {"error": f"profiler session unavailable: {e}", "capture_id": None}
                try:
                    time.sleep(ms / 1000.0)
                finally:
                    prof.stop()
                trace_json = os.path.join(cap_dir, "trace.json")
                prof.export_chrome_trace(trace_json)
            finally:
                release_profiler()
            self._rotate_captures()
            self._m_captures.inc()
            return 200, {
                "capture_id": cap_id,
                "dir": cap_dir,
                "ms": ms,
                "trace_json": trace_json,
                "summary": _profile_summary_json(trace_json),
            }
        finally:
            with self._lock:
                self._profile_inflight = None

    def _rotate_captures(self) -> None:
        """Keep the newest ``profile_quota`` capture dirs (ids sort by
        sequence, so lexicographic order is capture order)."""
        try:
            caps = sorted(d for d in os.listdir(self.profile_dir)
                          if d.startswith("cap-") and os.path.isdir(os.path.join(self.profile_dir, d)))
        except OSError:
            return
        for stale in caps[: -self.profile_quota]:
            shutil.rmtree(os.path.join(self.profile_dir, stale), ignore_errors=True)

    def url(self, path: str = "/metrics") -> str:
        return f"http://{self.address[0]}:{self.port}{path}"

    def close(self) -> None:
        self._tick_stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=max(2.0, 2 * self.tick_s))
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
