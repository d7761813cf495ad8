"""Consensus-health monitor: measured decay vs the spectral bound, live
(port of ``consensusml_tpu/obs/health.py``: host code, as the reference's;
the bound from the port's spectral gaps, ``topology/topologies.py``).

Gossip theory gives every topology a per-round worst-case contraction of
the disagreement: ``d_{t+1} <= rho * d_t`` with ``rho = 1 - spectral_gap``
(per-PERIOD for time-varying schedules, reported here as the per-round
geometric rate ``rho_period^(1/period)``).
:class:`ConsensusHealthMonitor` checks it ONLINE —
every round's consensus distance feeds ``observe()``, which maintains a
windowed measured decay rate and trips a loud anomaly on sustained
violation.

Two regimes, because training is not pure gossip:

- ``strict=True`` — pure-consensus runs (decay probes, eval harnesses):
  any sustained ``d_t / d_{t-1} > rho + tolerance`` is a bound
  violation. Local SGD would false-positive here (each round injects
  fresh drift), so strict mode is for runs where gossip is the only
  force.
- ``strict=False`` (training default) — the inner loop legitimately
  re-inflates disagreement up to a plateau, so the only certain
  anomaly is sustained GROWTH: ``d_t / d_{t-1} > 1 + tolerance`` for
  ``sustain`` consecutive rounds means a replica is diverging (NaN-adjacent
  params, a poisoned codec, a dead link biasing the mean) — growth always
  violates the bound too, since ``rho < 1``.

Feeds the ``consensusml_health_*`` gauge family (measured decay, bound,
distance, violation flag) and ``consensusml_health_anomalies_total``;
anomalies also land as tracer instant events and a stderr log line that
names the round, the measured rate and the bound — the "loud" part.
With an :class:`~consensusml_tpu_torch.obs.alerts.AlertEngine` attached
(``alerts=``, the train loop wires it when telemetry is on) the episode
log routes through :meth:`AlertEngine.notify` instead of a bespoke
``print``, so the episode shows up in ``/alerts`` and the cluster
report's event stream; the fire/clear LIFECYCLE rides the
``consensusml_health_bound_violation`` gauge via the default ruleset's
``consensus-health-violation`` rule (docs/observability.md
"Alerting & history").
"""

from __future__ import annotations

import math
import sys
from collections import deque
from typing import Any

from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry
from consensusml_tpu_torch.obs.tracer import SpanTracer, get_tracer

__all__ = ["ConsensusHealthMonitor", "decay_bound"]


def decay_bound(topology) -> float:
    """Per-ROUND worst-case consensus contraction rate ``rho`` for a
    topology: ``1 - spectral_gap()``, with time-varying schedules' per-
    period gap folded to the round-wise geometric rate."""
    rho = 1.0 - topology.spectral_gap()
    rho = min(max(rho, 0.0), 1.0)
    period = getattr(topology, "period", 1) if topology.is_time_varying else 1
    if period > 1:
        rho = rho ** (1.0 / period)
    return rho


class ConsensusHealthMonitor:
    """Online measured-vs-bound consensus decay with anomaly detection.

    ``observe(round, distance)`` per round; returns an anomaly record
    dict when a sustained violation starts (and on every following round
    while it persists), else None. ``anomalies`` keeps every record.
    """

    def __init__(
        self,
        topology,
        registry: MetricsRegistry | None = None,
        tracer: SpanTracer | None = None,
        *,
        strict: bool = False,
        tolerance: float = 0.02,
        sustain: int = 3,
        window: int = 16,
        floor: float = 1e-9,
        alerts=None,
    ):
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        self.topology = topology
        self.registry = registry if registry is not None else get_registry()
        self.tracer = tracer if tracer is not None else get_tracer()
        # optional AlertEngine: episode logs route through its event
        # stream instead of a bespoke stderr print (module docstring)
        self.alerts = alerts
        self.strict = strict
        self.tolerance = float(tolerance)
        self.sustain = int(sustain)
        self.floor = float(floor)
        self.bound = decay_bound(topology)
        # the per-round ratio that counts as a violation: the spectral
        # bound itself in strict mode, growth otherwise (see module doc)
        self.threshold = (
            self.bound + self.tolerance
            if strict
            else max(self.bound, 1.0) + self.tolerance
        )
        self._last: float | None = None
        self._ratios: deque[float] = deque(maxlen=window)
        self._streak = 0
        self.anomalies: list[dict[str, Any]] = []
        r = self.registry
        r.gauge(
            "consensusml_health_decay_bound",
            "spectral per-round consensus contraction bound rho = 1 - gap",
        ).set(self.bound)
        self._g_measured = r.gauge(
            "consensusml_health_decay_measured",
            "windowed geometric-mean measured consensus decay per round",
        )
        self._g_distance = r.gauge(
            "consensusml_health_consensus_distance",
            "latest consensus distance the health monitor observed",
        )
        self._g_violation = r.gauge(
            "consensusml_health_bound_violation",
            "1 while consensus decay is in sustained violation "
            "(divergence, or strict-mode bound breach), else 0",
        )
        self._g_violation.set(0.0)
        self._m_anomalies = r.counter(
            "consensusml_health_anomalies_total",
            "sustained consensus-decay anomaly episodes",
        )

    @property
    def measured_decay(self) -> float:
        """Geometric mean of the windowed per-round decay ratios (NaN
        until two observations land)."""
        if not self._ratios:
            return math.nan
        log_sum = sum(math.log(max(x, 1e-300)) for x in self._ratios)
        return math.exp(log_sum / len(self._ratios))

    def observe(self, rnd: int, distance: float) -> dict[str, Any] | None:
        d = float(distance)
        self._g_distance.set(d)
        record = None
        violated_this_round = False
        if not math.isfinite(d):
            # a NaN/Inf distance IS the diverged-replica signature —
            # count it as a violating round directly
            violated_this_round = True
            ratio = math.inf
        elif self._last is not None and self._last > self.floor:
            ratio = d / self._last
            self._ratios.append(ratio)
            self._g_measured.set(self.measured_decay)
            violated_this_round = ratio > self.threshold
        else:
            ratio = math.nan
        if violated_this_round:
            self._streak += 1
        else:
            if self._streak >= self.sustain:
                self._g_violation.set(0.0)  # episode ended
            self._streak = 0
        if self._streak >= self.sustain:
            self._g_violation.set(1.0)
            record = {
                "round": int(rnd),
                "kind": (
                    "divergence"
                    if not math.isfinite(ratio) or ratio > 1.0
                    else "bound-violation"
                ),
                "ratio": float(ratio),
                "measured_decay": float(self.measured_decay),
                "bound": float(self.bound),
                "threshold": float(self.threshold),
                "streak": int(self._streak),
                "distance": d,
            }
            self.anomalies.append(record)
            if self._streak == self.sustain:  # episode start: be loud
                self._m_anomalies.inc()
                msg = (
                    "consensus-health ANOMALY: "
                    f"{record['kind']} at round {rnd} — consensus distance "
                    f"{d:.4g} decayed at {ratio:.4f}/round for "
                    f"{self._streak} rounds (threshold {self.threshold:.4f}"
                    f", spectral bound {self.bound:.4f}, topology "
                    f"{self.topology.name}); a replica is likely diverging "
                    "or a link is biasing the mean "
                    "(consensusml_tpu_torch.obs.health)"
                )
                if self.alerts is not None:
                    self.alerts.notify(
                        "consensus-health", msg, severity="page",
                        round=int(rnd), kind=record["kind"],
                        ratio=record["ratio"], bound=record["bound"],
                    )
                else:
                    print(msg, file=sys.stderr, flush=True)
            self.tracer.instant(
                "health.anomaly",
                round=rnd,
                kind=record["kind"],
                ratio=record["ratio"],
            )
        if math.isfinite(d):
            self._last = d
        return record
