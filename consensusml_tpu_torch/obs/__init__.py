"""Telemetry for the port: spans, metrics, request traces, wide events,
history, alerts, the flight recorder and the live HTTP plane (port of
``consensusml_tpu/obs``; every metric family, label, span name, JSON key
and endpoint path is the reference's, so a dashboard or report written
against the reference reads the port unchanged).

- :mod:`.tracer`: host-side nested spans in a bounded ring, Chrome
  trace-event export; each span is also a ``torch.profiler`` range while
  a profiler records.
- :mod:`.metrics`: counters, gauges and fixed-bucket histograms (with
  exemplars), the Prometheus text exposition and the JSONL snapshot sink.
- :mod:`.requests`: ``TraceContext`` propagation and the bounded
  per-request trace registry, merged into the Chrome trace.
- :mod:`.events`: one wide event per terminal serving request, per-tenant
  rollups.
- :mod:`.history` and :mod:`.alerts`: in-process time-series rings and the
  SLO/alert engine with its default ruleset.
- :mod:`.flight`: the crash flight recorder (watchdog timeout, unhandled
  exception, SIGTERM).
- :mod:`.httpd`: ``/metrics``, ``/traces``, ``/requests``, ``/events``,
  ``/tenants``, ``/alerts``, ``/query``, ``/healthz`` and ``/profile`` (an
  on-demand ``torch.profiler`` capture, single-flight).
- the cost plane: :mod:`.costs` (the per-executable cost ledger, counted
  in one fake pass an executable, ``--cost-ledger`` and
  ``Engine.register_costs``) and :mod:`.memviz` (live device-memory
  gauges and the analytic / counted / live reconciliation).
- the cluster plane: :mod:`.links` (per-edge probes, ``--link-probes``),
  :mod:`.health` (measured consensus decay against the spectral bound,
  always on in the round loop) and :mod:`.cluster` (per-rank snapshots,
  ``--obs-cluster-dir``, and the cross-rank aggregate that
  ``consensusml_tpu_torch.tools.obs_report`` renders).

Hot paths feed the process-wide singletons (``get_tracer()``,
``get_registry()``); the train CLI surfaces the sinks through
``--trace-events``, ``--metrics-prom``, ``--metrics-port``,
``--flight-recorder``, ``--telemetry-every`` and ``--profile-dir``, and
``ServeServer(metrics_port=)`` the live plane of a serving process. With
no sink configured the tracer stays disabled and metric updates are
dict-cheap, so the instrumentation stays on everywhere.
"""

from consensusml_tpu_torch.obs.cluster import (  # noqa: F401
    ClusterWriter,
    aggregate,
    read_snapshots,
)
from consensusml_tpu_torch.obs.alerts import (  # noqa: F401
    Alert,
    AlertEngine,
    AlertRule,
    SloSpec,
    default_ruleset,
    get_alert_engine,
    peek_alert_engine,
)
from consensusml_tpu_torch.obs.events import (  # noqa: F401
    WideEventLog,
    get_wide_event_log,
    peek_wide_event_log,
    sanitize_tenant,
)
from consensusml_tpu_torch.obs.costs import (  # noqa: F401
    CostLedger,
    ExecutableCost,
    get_cost_ledger,
)
from consensusml_tpu_torch.obs.flight import FlightRecorder  # noqa: F401
from consensusml_tpu_torch.obs.memviz import HbmAccountant  # noqa: F401
from consensusml_tpu_torch.obs.history import (  # noqa: F401
    MetricsHistory,
    get_history,
    peek_history,
)
from consensusml_tpu_torch.obs.httpd import MetricsServer  # noqa: F401
from consensusml_tpu_torch.obs.health import (  # noqa: F401
    ConsensusHealthMonitor,
    decay_bound,
)
from consensusml_tpu_torch.obs.links import (  # noqa: F401
    LinkProber,
    link_wire_bytes,
)
from consensusml_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    DEFAULT_LATENCY_BUCKETS,
    DEFAULT_LINK_LATENCY_BUCKETS,
    DEFAULT_ROUND_COUNT_BUCKETS,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    parse_metric_key,
)
from consensusml_tpu_torch.obs.requests import (  # noqa: F401
    RequestTrace,
    RequestTraceRegistry,
    TraceContext,
    get_request_registry,
    merged_chrome_trace,
)
from consensusml_tpu_torch.obs.tracer import (  # noqa: F401
    SpanTracer,
    get_tracer,
    span,
)
