"""Declarative SLO objectives and burn-rate alerting over metric history (port of
``consensusml_tpu/obs/alerts.py``: host code, as the reference's).

The observability plane's signals (metrics, history rings) say what IS;
this module says what is WRONG, with a firing/resolved lifecycle instead
of log lines. An :class:`AlertEngine` evaluates a list of
:class:`AlertRule` objects against a
:class:`~consensusml_tpu_torch.obs.history.MetricsHistory` on every telemetry
tick. Three rule kinds (schema in docs/observability.md
"Alerting & history"):

- ``threshold`` — a scalar series above/below a bound, sustained for
  ``for_s`` seconds. With ``rate_window_s`` set the compared value is
  the counter's windowed per-second rate; against a histogram series
  the compared value is the windowed ``quantile`` (default p99) — "TTFT
  p99 above 500 ms for 30 s" is one rule.
- ``burn_rate`` — the Google-SRE multi-window error-budget burn: an
  :class:`SloSpec` (histogram family + latency threshold + objective)
  defines the error fraction; the rule fires when BOTH the fast and the
  slow window burn the budget faster than ``burn_factor``×. The fast
  window makes it respond in seconds, the slow window stops a single
  bad scrape from paging, and recovery clears it (no traffic = no
  errors, by the history plane's windowed-delta semantics).
- ``stale`` — a unix-timestamp gauge (heartbeats) older than
  ``max_age_s``: the liveness/watchdog rule shape.

Rules match every labeled child of their ``series`` family, so one rule
covers a labeled family fleet of children; alert identity is
``(rule, series key)``. Lifecycle events feed ``consensusml_alert_*``
metrics, tracer instant events, and one loud stderr line per
transition; :meth:`AlertEngine.snapshot` is what ``/alerts``, the
cluster snapshots, and the flight recorder embed.

``default_ruleset()`` is the bundled production posture: serving SLO
burn rates (TTFT, inter-token), queue/pool pressure, consensus health
(the :class:`~consensusml_tpu_torch.obs.health.ConsensusHealthMonitor`'s
sustained-violation gauge — the monitor's episode log routes through
:meth:`AlertEngine.notify` when an engine is attached), hot-swap and
speculative-decode regressions, and heartbeat staleness for both the
train round loop and the serving engine loop. It must fire ZERO alerts
on a healthy run.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

from consensusml_tpu_torch.obs._annotations import guarded_by
from consensusml_tpu_torch.obs.history import MetricsHistory
from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from consensusml_tpu_torch.obs.tracer import SpanTracer, get_tracer

__all__ = [
    "SloSpec",
    "AlertRule",
    "Alert",
    "AlertEngine",
    "SEVERITY_RANK",
    "default_ruleset",
    "get_alert_engine",
    "peek_alert_engine",
    "worst_first_key",
]

# shared with the cluster aggregator's fleet merge — one ordering
SEVERITY_RANK = {"page": 0, "warn": 1, "info": 2}


@dataclass(frozen=True)
class SloSpec:
    """A latency SLO: ``objective`` of observations in ``series`` must
    land at or under ``threshold_s``. ``error_budget`` is what burn
    rates are measured against. Put ``threshold_s`` on a bucket edge of
    the series' histogram for exact accounting."""

    series: str
    threshold_s: float
    objective: float = 0.99

    @property
    def error_budget(self) -> float:
        return max(1.0 - float(self.objective), 1e-9)


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule; unused fields of other kinds are ignored."""

    name: str
    series: str
    kind: str = "threshold"  # threshold | burn_rate | stale
    severity: str = "warn"  # page | warn | info
    summary: str = ""
    # threshold rules
    op: str = "above"  # above | below
    threshold: float = 0.0
    for_s: float = 0.0
    rate_window_s: float | None = None  # compare the windowed rate
    quantile: float = 0.99  # compared when series is a histogram
    # burn-rate rules
    slo: SloSpec | None = None
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_factor: float = 10.0
    # stale rules
    max_age_s: float = 120.0

    def __post_init__(self):
        if self.kind not in ("threshold", "burn_rate", "stale"):
            raise ValueError(f"unknown alert rule kind {self.kind!r}")
        if self.kind == "burn_rate" and self.slo is None:
            raise ValueError(f"burn_rate rule {self.name!r} needs an SloSpec")
        if self.op not in ("above", "below"):
            raise ValueError(f"unknown threshold op {self.op!r}")


class Alert:
    """One firing (or recently resolved) alert instance."""

    __slots__ = (
        "rule", "series", "severity", "summary", "state", "direction",
        "since_s", "fired_s", "resolved_s", "value",
    )

    def __init__(self, rule: AlertRule, series: str, since_s: float):
        self.rule = rule.name
        self.series = series
        self.severity = rule.severity
        self.summary = rule.summary
        self.state = "firing"
        # which way the value is bad — the cluster merge keeps the MIN
        # across ranks for "below" breaches, MAX otherwise
        self.direction = (
            "below"
            if rule.kind == "threshold" and rule.op == "below"
            else "above"
        )
        self.since_s = since_s  # breach start (before for_s elapsed)
        self.fired_s = math.nan
        self.resolved_s: float | None = None
        self.value = math.nan

    def to_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "series": self.series,
            "severity": self.severity,
            "summary": self.summary,
            "state": self.state,
            "direction": self.direction,
            "since_s": self.since_s,
            "fired_s": self.fired_s,
            "resolved_s": self.resolved_s,
            "value": self.value,
        }


class _RuleState:
    __slots__ = ("breach_since", "alert")

    def __init__(self):
        self.breach_since: float | None = None
        self.alert: Alert | None = None


@guarded_by("_lock", "_state", "_resolved", "_events", "_evals")
class AlertEngine:
    """Evaluates rules each tick; owns the alert lifecycle + exports."""

    def __init__(
        self,
        history: MetricsHistory,
        rules: list[AlertRule] | None = None,
        registry: MetricsRegistry | None = None,
        tracer: SpanTracer | None = None,
        *,
        resolved_keep: int = 64,
        events_keep: int = 256,
        quiet: bool = False,
    ):
        self.history = history
        self.rules: list[AlertRule] = (
            list(rules) if rules is not None else default_ruleset()
        )
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        self.quiet = quiet
        self._lock = threading.Lock()
        self._state: dict[tuple[str, str], _RuleState] = {}
        self._resolved: deque[dict[str, Any]] = deque(maxlen=resolved_keep)
        # out-of-band plane events (health-monitor episode lines etc.)
        self._events: deque[dict[str, Any]] = deque(maxlen=events_keep)
        self._evals = 0
        r = self.registry
        self._g_firing = r.gauge(
            "consensusml_alerts_firing", "alerts currently firing"
        )
        self._g_firing.set(0.0)
        self._m_fired = r.counter(
            "consensusml_alert_fired_total", "alert fire transitions"
        )
        self._m_resolved = r.counter(
            "consensusml_alert_resolved_total", "alert resolve transitions"
        )
        self._g_last_eval = r.gauge(
            "consensusml_alert_last_eval_time_seconds",
            "unix time of the latest rule evaluation tick",
        )
        self._rule_gauges: dict[str, Any] = {}
        for rule in self.rules:
            self._rule_gauge(rule.name)

    def _rule_gauge(self, name: str):
        g = self._rule_gauges.get(name)
        if g is None:
            g = self.registry.gauge(
                "consensusml_alert_firing",
                "1 while this rule has a firing alert, else 0 (labeled "
                "per rule)",
                labels={"rule": name},
            )
            g.set(0.0)
            self._rule_gauges[name] = g
        return g

    def replace_rules(self, rules: list[AlertRule]) -> None:
        """Swap the rule set (tests, surface-specific postures); firing
        state of removed rules is dropped, their gauges zeroed."""
        with self._lock:
            self._state.clear()
        for g in self._rule_gauges.values():
            g.set(0.0)
        self.rules = list(rules)
        for rule in self.rules:
            self._rule_gauge(rule.name)

    # -- evaluation --------------------------------------------------------

    def _rule_value(
        self, rule: AlertRule, key: str, now: float
    ) -> tuple[bool, float]:
        """(breached_this_tick, compared_value) for one series key."""
        h = self.history
        if rule.kind == "burn_rate":
            slo = rule.slo
            fast = h.bad_fraction(
                key, slo.threshold_s, rule.fast_window_s, now
            ) / slo.error_budget
            slow = h.bad_fraction(
                key, slo.threshold_s, rule.slow_window_s, now
            ) / slo.error_budget
            return (
                fast > rule.burn_factor and slow > rule.burn_factor,
                fast,
            )
        if rule.kind == "stale":
            latest = h.latest_value(key)
            if latest is None or not math.isfinite(latest[1]):
                return False, math.nan
            age = now - latest[1]
            return age > rule.max_age_s, age
        # threshold
        if rule.rate_window_s is not None:
            v = h.rate(key, rule.rate_window_s, now)
        elif h.kind_of(key) == "histogram":
            v = h.quantile(key, rule.quantile, 300.0, now)
        else:
            latest = h.latest_value(key)
            v = latest[1] if latest is not None else math.nan
        if not math.isfinite(v):
            return False, v
        breach = v > rule.threshold if rule.op == "above" else v < rule.threshold
        return breach, v

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """One tick: evaluate every rule against every matching series,
        advance lifecycles, export, and return the firing alert dicts
        (worst first)."""
        now = time.time() if now is None else float(now)
        transitions: list[tuple[str, Alert]] = []
        firing_per_rule: dict[str, int] = {r.name: 0 for r in self.rules}
        # all window math runs BEFORE the engine lock: history locks
        # never nest under _lock (leaf-lock discipline — a /alerts
        # scrape or a notify() never waits on multi-rule evaluation)
        verdicts: list[tuple[AlertRule, str, bool, float]] = []
        for rule in self.rules:
            for key in self.history.keys_for(rule.series):
                breach, value = self._rule_value(rule, key, now)
                verdicts.append((rule, key, breach, value))
        with self._lock:
            self._evals += 1
            for rule, key, breach, value in verdicts:
                sk = (rule.name, key)
                st = self._state.get(sk)
                if st is None:
                    st = self._state[sk] = _RuleState()
                if breach:
                    if st.breach_since is None:
                        st.breach_since = now
                    if (
                        st.alert is None
                        and now - st.breach_since >= rule.for_s
                    ):
                        st.alert = Alert(rule, key, st.breach_since)
                        st.alert.fired_s = now
                        transitions.append(("fire", st.alert))
                    if st.alert is not None:
                        st.alert.value = value
                else:
                    st.breach_since = None
                    if st.alert is not None:
                        st.alert.state = "resolved"
                        st.alert.resolved_s = now
                        transitions.append(("resolve", st.alert))
                        self._resolved.append(st.alert.to_dict())
                        st.alert = None
                if st.alert is not None:
                    firing_per_rule[rule.name] = (
                        firing_per_rule.get(rule.name, 0) + 1
                    )
            firing = sorted(
                (
                    st.alert.to_dict()
                    for st in self._state.values()
                    if st.alert is not None
                ),
                key=worst_first_key,
            )
        # exports happen OUTSIDE the engine lock (metric locks nest under
        # nothing here; a /alerts scrape never waits on an evaluation)
        for name, n in firing_per_rule.items():
            self._rule_gauge(name).set(1.0 if n else 0.0)
        self._g_firing.set(float(len(firing)))
        self._g_last_eval.set(now)
        for kind, alert in transitions:
            if kind == "fire":
                self._m_fired.inc()
            else:
                self._m_resolved.inc()
            self.tracer.instant(
                f"alert.{kind}",
                rule=alert.rule,
                series=alert.series,
                severity=alert.severity,
                value=alert.value,
            )
            if not self.quiet:
                verb = "FIRING" if kind == "fire" else "resolved"
                print(
                    f"alert {verb} [{alert.severity}] {alert.rule} "
                    f"on {alert.series}: value {alert.value:.4g}"
                    + (f" — {alert.summary}" if alert.summary else ""),
                    file=sys.stderr,
                    flush=True,
                )
        return firing

    # -- views -------------------------------------------------------------

    def firing(self) -> list[dict[str, Any]]:
        with self._lock:
            return sorted(
                (
                    st.alert.to_dict()
                    for st in self._state.values()
                    if st.alert is not None
                ),
                key=worst_first_key,
            )

    def notify(
        self, source: str, message: str, *, severity: str = "warn", **attrs
    ) -> None:
        """Record an out-of-band plane event (e.g. the consensus-health
        monitor's episode log) in the snapshot-visible event ring, as a
        tracer instant, and as one stderr line — subsystems route their
        bespoke "loud" logs through here so every anomaly shows up in
        ``/alerts`` and the cluster report, not just a process's stderr."""
        row = {
            "time_s": time.time(),
            "source": source,
            "severity": severity,
            "message": message,
        }
        if attrs:
            # events land in JSON files (cluster snapshots, flight
            # dumps): bare NaN/Infinity tokens break strict parsers
            row["attrs"] = {
                k: (
                    None
                    if isinstance(v, float) and not math.isfinite(v)
                    else v
                )
                for k, v in attrs.items()
            }
        with self._lock:
            self._events.append(row)
        self.tracer.instant(f"alert.event.{source}", severity=severity)
        if not self.quiet:
            print(
                f"alert-plane event [{severity}] {source}: {message}",
                file=sys.stderr,
                flush=True,
            )

    def snapshot(self) -> dict[str, Any]:
        """JSON-able state for ``/alerts``, cluster snapshots and the
        flight recorder: firing worst-first, recent resolutions, recent
        plane events."""
        with self._lock:
            firing = sorted(
                (
                    st.alert.to_dict()
                    for st in self._state.values()
                    if st.alert is not None
                ),
                key=worst_first_key,
            )
            resolved = list(self._resolved)
            events = list(self._events)
            evals = self._evals
        return {
            "time_s": time.time(),
            "rules": [r.name for r in self.rules],
            "firing": firing,
            "firing_total": len(firing),
            "resolved_recent": resolved[-16:],
            "events_recent": events[-16:],
            "evals_total": evals,
        }


def worst_first_key(a: dict[str, Any]) -> tuple:
    """Worst-first sort key over alert dicts — shared by /alerts and the
    cluster aggregator's fleet merge so both order identically."""
    return (
        SEVERITY_RANK.get(a.get("severity"), 9),
        a.get("fired_s") or 0.0,
        a.get("rule") or "",
        a.get("series") or "",
    )


def default_ruleset(
    *,
    ttft_slo: SloSpec | None = None,
    intertoken_slo: SloSpec | None = None,
    burn_factor: float = 10.0,
    fast_window_s: float = 60.0,
    slow_window_s: float = 300.0,
) -> list[AlertRule]:
    """The bundled serving + consensus posture (see module docstring).

    Thresholds are deliberately loose enough that a HEALTHY run — the
    CPU bench, a steady train loop — fires nothing (bench_diff gates
    this); a real breach (sustained p99 blowout, zero free blocks,
    diverging replica, wedged loop) fires within one fast window.
    """
    ttft = ttft_slo or SloSpec(
        "consensusml_serve_ttft_seconds", threshold_s=1.0, objective=0.99
    )
    intertoken = intertoken_slo or SloSpec(
        "consensusml_serve_intertoken_seconds",
        threshold_s=0.25,
        objective=0.99,
    )
    burn = dict(
        kind="burn_rate",
        fast_window_s=fast_window_s,
        slow_window_s=slow_window_s,
        burn_factor=burn_factor,
    )
    return [
        AlertRule(
            "serve-ttft-burn-rate", ttft.series, severity="page",
            slo=ttft,
            summary=(
                f"TTFT error budget (p{100 * ttft.objective:g} <= "
                f"{ttft.threshold_s:g}s) burning >{burn_factor:g}x in both "
                "windows"
            ),
            **burn,
        ),
        AlertRule(
            "serve-intertoken-burn-rate", intertoken.series, severity="page",
            slo=intertoken,
            summary="inter-token latency error budget burning in both windows",
            **burn,
        ),
        AlertRule(
            "serve-queue-backlog", "consensusml_serve_queue_depth",
            severity="warn", op="above", threshold=128.0, for_s=5.0,
            summary="admission queue sustained above 128 waiting requests",
        ),
        AlertRule(
            "pool-block-exhaustion", "consensusml_pool_blocks_free",
            severity="warn", op="below", threshold=0.5, for_s=2.0,
            summary="paged KV pool out of free blocks (evictions imminent)",
        ),
        AlertRule(
            "consensus-health-violation",
            "consensusml_health_bound_violation",
            severity="page", op="above", threshold=0.5,
            summary=(
                "sustained consensus-decay violation episode "
                "(ConsensusHealthMonitor; a replica is diverging or a "
                "link is biasing the mean)"
            ),
        ),
        AlertRule(
            "swap-rejections", "consensusml_serve_swap_rejected_total",
            severity="warn", op="above", threshold=0.0,
            rate_window_s=slow_window_s,
            summary="hot-swap metas being rejected (generation regression "
                    "or params-tree mismatch)",
        ),
        AlertRule(
            "spec-acceptance-collapse", "consensusml_spec_acceptance_rate",
            severity="warn", op="below", threshold=0.2, for_s=30.0,
            summary="speculative acceptance rate collapsed — draft is "
                    "burning verify work",
        ),
        AlertRule(
            "watchdog-timeouts", "consensusml_watchdog_timeouts_total",
            severity="page", op="above", threshold=0.0,
            rate_window_s=slow_window_s,
            summary="round-progress watchdog fired (wedged collective)",
        ),
        AlertRule(
            "train-heartbeat-stale", "consensusml_heartbeat_time_seconds",
            kind="stale", severity="page", max_age_s=180.0,
            summary="train round loop heartbeat stale",
        ),
        AlertRule(
            "serve-loop-stale", "consensusml_serve_loop_heartbeat_seconds",
            kind="stale", severity="page", max_age_s=30.0,
            summary="serving engine loop heartbeat stale (engine thread "
                    "wedged or dead)",
        ),
    ]


_GLOBAL: AlertEngine | None = None
_GLOBAL_LOCK = threading.Lock()


def get_alert_engine() -> AlertEngine:
    """The process-wide engine (default ruleset over the global history
    and registry), created on first use by whichever surface arms it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            from consensusml_tpu_torch.obs.history import get_history

            _GLOBAL = AlertEngine(get_history())
        return _GLOBAL


def peek_alert_engine() -> AlertEngine | None:
    """The global engine if armed, else None (dump-path fallback)."""
    with _GLOBAL_LOCK:
        return _GLOBAL
