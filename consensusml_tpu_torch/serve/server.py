"""Threaded socket front-end over :class:`~consensusml_tpu_torch.serve.engine.Engine`.

Port of ``consensusml_tpu/serve/server.py``: line-delimited JSON over
TCP, one request per connection.

request (one line; every field but ``ids`` is optional: sampling fields
default to the engine's ``ServeConfig``; ``trace_id``/``request_id`` are
the client's trace identity, anything missing minted server-side;
``tenant`` labels the request, ``"default"`` when omitted)::

    {"ids": [3, 17, 42], "max_new_tokens": 16,
     "temperature": 0.8, "top_p": 0.95, "seed": 12345, "eos_id": 50256,
     "tenant": "batch-eval",
     "trace_id": "lg0-00042", "request_id": "lg0-00042/0"}

response: one line per token as it is generated, then a terminal record
echoing the resolved sampling triple (resubmitting with the echoed seed
replays the stream), the speculative counts, the resolved tenant and the
trace identity::

    {"token": 7}
    {"token": 19}
    {"done": true, "tokens": [7, 19, ...], "finish_reason": "max_tokens",
     "ttft_ms": 12.3, "latency_ms": 48.9,
     "temperature": 0.8, "top_p": 0.95, "seed": 12345,
     "spec_proposed": 12, "spec_accepted": 9, "tenant": "batch-eval",
     "trace_id": "lg0-00042", "request_id": "lg0-00042/0"}

Errors land as ``{"error": "..."}`` and close the connection.

``metrics_port`` (``None`` = off, ``0`` = a free port, read back from
:attr:`ServeServer.metrics_address`) serves the live observability plane
(:class:`~consensusml_tpu_torch.obs.MetricsServer`): ``/metrics``,
``/traces``, ``/requests``, ``/alerts``, ``/query``, ``/healthz``,
``/events`` and ``/tenants``. A serving process has no train loop to
drive telemetry ticks, so the server's ``obs-ticker`` thread records the
metric history and evaluates the alert rules (the default ruleset unless
``alert_rules`` replaces it) every ``obs_tick_s`` seconds; ``/healthz``
answers 503 until the engine's :meth:`~.engine.Engine.warmup` finishes.
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any

__all__ = ["ServeServer"]


class ServeServer:
    """Accept loop + one thread per connection; ``port=0`` picks a free
    port (read it back from :attr:`address`); ``metrics_port``,
    ``obs_tick_s`` and ``alert_rules`` as the module says."""

    def __init__(self, engine: Any, host: str = "127.0.0.1", port: int = 0, metrics_port: int | None = None,
                 obs_tick_s: float = 2.0, alert_rules: Any | None = None):
        self.engine = engine
        self.metrics = None
        self.metrics_address = None
        # the front-end listener first: a taken port raises before any
        # side server thread exists
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        if metrics_port is not None:
            from consensusml_tpu_torch.obs import MetricsServer, get_alert_engine, get_history

            alerts = get_alert_engine()
            if alert_rules is not None:
                alerts.replace_rules(list(alert_rules))
            try:
                self.metrics = MetricsServer(
                    port=metrics_port, host=host, history=get_history(), alerts=alerts, tick_s=obs_tick_s,
                    # readiness gates on warmup: 503 until the engine is warm
                    ready_fn=lambda: bool(getattr(engine, "warmed", True)),
                )
            except OSError:
                self._sock.close()
                raise
            self.metrics_address = self.metrics.address
        self._sock.settimeout(0.2)  # the accept loop polls the stop flag
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        # the accept loop adds, connection threads discard, shutdown reads
        self._conns_lock = threading.Lock()
        self._conns: set[threading.Thread] = set()
        self._thread = threading.Thread(target=self._accept_loop, name="serve-accept", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us during shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            with self._conns_lock:
                self._conns.add(t)
            t.start()
        self._sock.close()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn, conn.makefile("rwb") as f:
                line = f.readline()
                if not line:
                    return
                try:
                    req = json.loads(line)
                    trace = None
                    if req.get("trace_id") or req.get("request_id"):
                        from consensusml_tpu_torch.obs import TraceContext

                        # what the client did not send is minted
                        trace = TraceContext(req.get("trace_id") or TraceContext.mint("srv").trace_id,
                                             req.get("request_id"))
                    handle = self.engine.submit(
                        req["ids"], req.get("max_new_tokens"), trace=trace,
                        temperature=req.get("temperature"),
                        top_p=req.get("top_p"),
                        seed=req.get("seed"),
                        eos_id=req.get("eos_id"),
                        tenant=req.get("tenant"),
                    )
                except Exception as e:  # bad JSON, validation, draining
                    f.write(json.dumps({"error": str(e)}).encode() + b"\n")
                    f.flush()
                    return
                for tok in handle.tokens():
                    f.write(json.dumps({"token": int(tok)}).encode() + b"\n")
                    f.flush()  # the per-token flush IS the streaming
                r = handle.result()
                f.write(
                    json.dumps(
                        {
                            "done": True,
                            "tokens": r.tokens,
                            "finish_reason": r.finish_reason,
                            "ttft_ms": round(1e3 * r.ttft_s, 3),
                            "latency_ms": round(1e3 * r.latency_s, 3),
                            "temperature": r.temperature,
                            "top_p": r.top_p,
                            "seed": r.seed,
                            "spec_proposed": r.spec_proposed,
                            "spec_accepted": r.spec_accepted,
                            "tenant": r.tenant,
                            "trace_id": r.trace_id,
                            "request_id": r.request_id,
                        }
                    ).encode()
                    + b"\n"
                )
                f.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream; the engine still finishes
        finally:
            with self._conns_lock:
                self._conns.discard(threading.current_thread())

    def shutdown(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop accepting; optionally drain the engine (default) so every
        admitted request completes."""
        self._stop.set()
        self.engine.shutdown(drain=drain, timeout=timeout)
        with self._conns_lock:
            conns = list(self._conns)
        for t in conns:  # let response streams flush
            t.join(timeout=2.0)
        self._thread.join(timeout=2.0)
        if self.metrics is not None:
            self.metrics.close()
