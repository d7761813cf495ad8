"""Metrics registry: counters, gauges, fixed-bucket histograms (port of
``consensusml_tpu/obs/metrics.py``: host code, as the reference's).

The per-round hot path does DICT-CHEAP work only — a counter increment is
one float add under a lock, a histogram observe is a bisect into fixed
buckets. Exporters are pull-style and pay their cost at export time:

- :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  format, written atomically by :meth:`write_prometheus` (the standard
  node-exporter *textfile collector* pattern: point
  ``--collector.textfile.directory`` at the file's directory and the
  metrics scrape like any other target).
- :meth:`MetricsRegistry.snapshot` / :meth:`write_jsonl_snapshot` — one
  JSON object of current values; the registry also retains the last
  ``snapshot_keep`` snapshots in a ring for the flight recorder.

Metric names follow Prometheus conventions (``consensusml_`` prefix,
``_total`` on counters, base units — see docs/observability.md for the
full schema).
"""

from __future__ import annotations

import bisect
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Iterable

from consensusml_tpu_torch.obs._annotations import guarded_by

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "parse_metric_key",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_LINK_LATENCY_BUCKETS",
    "DEFAULT_ROUND_COUNT_BUCKETS",
    "DEFAULT_SLO_BUCKETS",
]

# round latencies span ~1 ms (smoke MLP on CPU) to minutes (first-round
# XLA compile); log-spaced like prometheus defaults but wider
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# link probes resolve ICI/DCN one-hop transfers: microseconds on-chip,
# milliseconds cross-slice, seconds only when something is wrong
DEFAULT_LINK_LATENCY_BUCKETS = (
    1e-6, 2.5e-6, 5e-6, 1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

# serving SLOs (TTFT, inter-token gaps, per-stage serving latencies):
# decode steps run sub-millisecond on real chips, so the request-path
# families need resolution DEFAULT_LATENCY_BUCKETS does not have below
# 1 ms; the top stays low — a 30 s serving latency is already an outage
DEFAULT_SLO_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# small-integer round counts (gossip-bootstrap length, recovery windows):
# the spectral-gap-derived K lands between a handful and a few dozen
DEFAULT_ROUND_COUNT_BUCKETS = (
    1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0, 48.0, 64.0,
)

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_:")


def _labelstr(labels: dict[str, Any] | None) -> str:
    """Canonical Prometheus label rendering: sorted keys, quoted values.
    Empty/None labels render as "" so unlabeled metrics keep their bare
    names everywhere (exposition, snapshots, registry keys)."""
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        if not k or k[0] not in _VALID_FIRST:
            raise ValueError(f"bad label name {k!r}")
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


_LABEL_RE = None  # compiled lazily; module import stays regex-free


def parse_metric_key(key: str) -> tuple[str, dict[str, str]]:
    """Invert :func:`_labelstr`: ``'m{src="0",dst="1"}'`` ->
    ``("m", {"src": "0", "dst": "1"})``. Snapshot consumers (the cluster
    aggregator) use this to merge labeled families across ranks.
    Quote-aware: commas/equals INSIDE a quoted value survive the
    round-trip (a bare split would shred them into garbage labels)."""
    if "{" not in key:
        return key, {}
    global _LABEL_RE
    if _LABEL_RE is None:
        import re

        # name="value" with \" and \\ escapes inside the quotes
        _LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    name, _, rest = key.partition("{")
    labels: dict[str, str] = {}
    for k, v in _LABEL_RE.findall(rest.rstrip("}")):
        labels[k] = v.replace('\\"', '"').replace("\\\\", "\\")
    return name, labels


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        if not name or name[0] not in _VALID_FIRST:
            raise ValueError(f"bad metric name {name!r}")
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        # full identity: family name + canonical label rendering — what
        # exposition lines, snapshot keys, and the registry key on
        self.key = name + _labelstr(self.labels)
        # RLock, not Lock: the flight recorder's SIGTERM handler runs ON
        # the main thread and dumps the registry — with a plain lock a
        # signal landing inside a metric's critical section would
        # deadlock the handler against the very frame it interrupted
        self._lock = threading.RLock()

    def _line_name(self, suffix: str = "", extra: dict | None = None) -> str:
        """Exposition-line name: ``name<suffix>{labels...}`` with ``extra``
        labels (a histogram's ``le``) merged after the metric's own."""
        if extra:
            merged = dict(self.labels)
            merged.update(extra)
            return f"{self.name}{suffix}{_labelstr(merged)}"
        return f"{self.name}{suffix}{_labelstr(self.labels)}"

    def expose(self) -> list[str]:
        raise NotImplementedError

    def value_dict(self) -> Any:
        raise NotImplementedError


@guarded_by("_lock", "_value")
class Counter(_Metric):
    """Monotonically increasing float (Prometheus ``counter``).

    Updated from the train loop, the prefetch/native producer threads
    and the flight recorder's dump path concurrently — every ``_value``
    access (reads included: a torn read exports garbage to a scraper)
    holds the metric lock (the ``__guarded_by__`` contract).
    """

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> list[str]:
        with self._lock:
            return [f"{self._line_name()} {_fmt(self._value)}"]

    def value_dict(self) -> float:
        with self._lock:
            return self._value


@guarded_by("_lock", "_value")
class Gauge(_Metric):
    """Point-in-time float (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        super().__init__(name, help, labels)
        self._value = math.nan

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value = (0.0 if math.isnan(self._value) else self._value) + amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def expose(self) -> list[str]:
        with self._lock:
            return [f"{self._line_name()} {_fmt(self._value)}"]

    def value_dict(self) -> float:
        with self._lock:
            return self._value


EXEMPLAR_KEEP = 8  # worst observations retained per histogram


@guarded_by("_lock", "_counts", "_sum", "_count", "_exemplars")
class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus ``histogram``).

    Buckets are chosen at registration and never reallocated — an
    ``observe`` is a bisect + two adds, cheap enough for every round.
    Exporters snapshot counts/sum/count under the same lock the
    observers hold: an unlocked export could emit a cumulative bucket
    row that disagrees with ``_sum`` (torn between two observes), which
    Prometheus rate math turns into negative latencies.

    ``observe(v, exemplar="req-...")`` makes the histogram
    EXEMPLAR-BEARING: the ``EXEMPLAR_KEEP`` worst (largest) exemplared
    observations are retained with their ids, so a p99 spike in an SLO
    family resolves to the concrete request ids that caused it (the
    ``value_dict``/snapshot side carries them; the Prometheus text
    exposition stays plain-format — exemplars are an OpenMetrics
    extension the textfile collector does not parse). Semantics in
    docs/observability.md "Request tracing".
    """

    kind = "histogram"

    def __init__(
        self, name: str, help: str = "",
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
        labels: dict | None = None,
    ):
        super().__init__(name, help, labels)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = tuple(bs)
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        # (value, exemplar_id, unix_time) sorted worst-first, len<=KEEP
        self._exemplars: list[tuple[float, str, float]] = []

    def observe(self, value: float, exemplar: str | None = None) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar is not None:
                ex = self._exemplars
                if len(ex) < EXEMPLAR_KEEP or v > ex[-1][0]:
                    ex.append((v, str(exemplar), time.time()))
                    ex.sort(key=lambda t: -t[0])
                    del ex[EXEMPLAR_KEEP:]

    def exemplars(self) -> list[dict[str, Any]]:
        """Worst-first retained exemplars (``value``/``id``/``time_s``)."""
        with self._lock:
            ex = list(self._exemplars)
        return [
            {"value": v, "id": rid, "time_s": ts} for v, rid, ts in ex
        ]

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _snapshot(self) -> tuple[list[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def raw(self) -> tuple[tuple[float, ...], tuple[int, ...], float, int]:
        """``(bucket_edges, per-bucket counts incl. the +Inf slot, sum,
        count)`` as one consistent locked read — the numeric form the
        history ring samples (``value_dict`` renders edges as strings
        for JSON; delta math wants floats)."""
        counts, total, n = self._snapshot()
        return self.buckets, tuple(counts), total, n

    def expose(self) -> list[str]:
        counts, total, n = self._snapshot()
        lines = []
        cum = 0
        for le, c in zip(self.buckets, counts):
            cum += c
            lines.append(
                f'{self._line_name("_bucket", {"le": _fmt(le)})} {cum}'
            )
        cum += counts[-1]
        lines.append(f'{self._line_name("_bucket", {"le": "+Inf"})} {cum}')
        lines.append(f'{self._line_name("_sum")} {_fmt(total)}')
        lines.append(f'{self._line_name("_count")} {n}')
        return lines

    def value_dict(self) -> dict[str, Any]:
        counts, total, n = self._snapshot()
        out = {
            "count": n,
            "sum": total,
            "buckets": {
                _fmt(le): c for le, c in zip(self.buckets, counts)
            },
            "inf": counts[-1],
        }
        ex = self.exemplars()
        if ex:
            out["exemplars"] = ex
        return out


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


@guarded_by("_lock", "_metrics", "_snapshots", "_family_kinds")
class MetricsRegistry:
    """Get-or-create metric registry with Prometheus / JSONL exporters.

    Written from the prefetch thread (feed metrics), the train loop
    (round metrics) and the flight recorder's crash-dump path (which
    snapshots mid-signal) — registry structures only move under
    ``_lock``; individual metric values ride each metric's own lock.

    Metrics may carry Prometheus LABELS (``labels={"src": "0", ...}``):
    each label combination is its own child metric (own lock, own
    values), the family name keeps ONE kind across all children, and
    exposition/snapshots key children as ``name{k="v",...}`` (see
    :func:`parse_metric_key` for the inverse — the cluster aggregator's
    merge path).
    """

    def __init__(self, snapshot_keep: int = 64):
        self._metrics: dict[str, _Metric] = {}  # key (name+labels) -> metric
        self._family_kinds: dict[str, str] = {}  # family name -> kind
        # RLock for the same signal-reentrancy reason as _Metric._lock
        self._lock = threading.RLock()
        self._snapshots: deque[dict[str, Any]] = deque(maxlen=snapshot_keep)

    def _get(
        self, cls, name: str, help: str, labels: dict | None = None, **kwargs
    ) -> _Metric:
        key = name + _labelstr(labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                kind = self._family_kinds.get(name)
                if kind is not None and kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {kind}, "
                        f"requested {cls.kind}"
                    )
                m = cls(name, help, labels=labels, **kwargs)
                self._metrics[key] = m
                self._family_kinds[name] = cls.kind
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(
        self, name: str, help: str = "", labels: dict | None = None
    ) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(
        self, name: str, help: str = "", labels: dict | None = None
    ) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "",
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
        labels: dict | None = None,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    # -- Prometheus exporter ----------------------------------------------
    def to_prometheus(self) -> str:
        lines: list[str] = []
        last_family = None
        # sort by (family, labels): one HELP/TYPE header per family, its
        # labeled children grouped under it
        ms = sorted(self.metrics(), key=lambda m: (m.name, m.key))
        helps: dict[str, str] = {}
        for m in ms:  # any child may carry the family help string
            if m.help and m.name not in helps:
                helps[m.name] = m.help
        for m in ms:
            if m.name != last_family:
                if m.name in helps:
                    lines.append(f"# HELP {m.name} {helps[m.name]}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                last_family = m.name
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> str:
        """Atomic textfile write (tmp + rename): a scraper never reads a
        torn file, which is the textfile-collector contract."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)
        return path

    # -- JSONL / snapshot sink --------------------------------------------
    def snapshot(self, extra: dict[str, Any] | None = None) -> dict[str, Any]:
        """Current values as one JSON-able dict; retained in the
        last-K ring the flight recorder dumps."""
        snap: dict[str, Any] = {"time_s": time.time()}
        if extra:
            snap.update(extra)
        snap["metrics"] = {m.key: m.value_dict() for m in self.metrics()}
        with self._lock:
            self._snapshots.append(snap)
        return snap

    def snapshots(self) -> list[dict[str, Any]]:
        # list(deque) while another thread appends raises "deque mutated
        # during iteration" — exactly the flight-recorder-dump-during-
        # telemetry-snapshot race
        with self._lock:
            return list(self._snapshots)

    def write_jsonl_snapshot(
        self, fileobj, extra: dict[str, Any] | None = None
    ) -> dict[str, Any]:
        snap = self.snapshot(extra)
        fileobj.write(json.dumps(snap) + "\n")
        fileobj.flush()
        return snap


_GLOBAL = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry the instrumented hot paths feed."""
    return _GLOBAL
