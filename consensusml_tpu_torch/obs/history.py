"""In-process metrics history: bounded time-series rings over the registry (port of
``consensusml_tpu/obs/history.py``: host code, as the reference's).

Every exported signal in the stack is point-in-time — a scrape sees the
current gauge value, the counter total, the cumulative histogram. Nothing
can answer "what was the TTFT p99 over the last minute" or "is this
counter still moving", which is exactly what SLO evaluation
(:mod:`~consensusml_tpu_torch.obs.alerts`), a fleet router, and a
post-mortem sparkline need. :class:`MetricsHistory` closes that gap
without an external TSDB:

- ``record()`` (called at telemetry cadence — the train loop's
  ``--telemetry-every`` tick, the :class:`~consensusml_tpu_torch.obs.httpd.
  MetricsServer` ticker thread on serving processes, loadgen's sampler)
  appends one ``(timestamp, value)`` sample per registry series into a
  fixed-size per-series ring. Labels are preserved (the series key IS
  the registry key, ``name{k="v"}``); histograms sample their raw
  cumulative ``(count, sum, bucket counts)`` so windowed math can be
  done on DELTAS later.
- memory is bounded (``keep`` samples/series, ``max_series`` series,
  overflow counted — never silent) and accounted: the
  ``consensusml_history_*`` gauges report live series/sample counts and
  the estimated retained bytes.
- query helpers turn the rings into the derived signals alert rules and
  reports consume: :meth:`rate` / :meth:`increase` (counter-reset
  tolerant), :meth:`quantile` and :meth:`bad_fraction`
  (percentiles-from-histogram-deltas over a window), :meth:`spark`
  (per-interval derived points for sparklines), :meth:`last` (last-N
  dumps), and :meth:`query` (the ``/query`` endpoint's document).

Thread-safety: ``record()`` reads each metric under its own lock FIRST
(no nesting of metric locks inside the history lock), then appends under
``_lock``; every query copies under ``_lock``. Writers (telemetry tick)
and scrapers (``/query`` handler threads, the cluster writer) race only
on that lock. Schema and retention model: docs/observability.md
"Alerting & history".
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from collections import deque
from typing import Any, Callable

from consensusml_tpu_torch.obs._annotations import guarded_by
from consensusml_tpu_torch.obs.metrics import (
    MetricsRegistry,
    get_registry,
    parse_metric_key,
)

__all__ = ["MetricsHistory", "get_history", "peek_history"]

# ~1 h of history at the 15 s scrape / serving-ticker cadence, ~40 min
# at train's default --telemetry-every on fast rounds
DEFAULT_KEEP = 240
DEFAULT_MAX_SERIES = 4096


class _Series:
    """One ring: scalar samples are ``(t, value)``; histogram samples
    are ``(t, count, sum, bucket_counts)`` with ``bucket_counts``
    including the +Inf slot (cumulative-by-time, per-bucket raw)."""

    __slots__ = ("key", "kind", "buckets", "samples")

    def __init__(self, key: str, kind: str, keep: int, buckets=None):
        self.key = key
        self.kind = kind
        self.buckets = buckets  # histogram bucket edges, else None
        self.samples: deque = deque(maxlen=keep)

    def est_bytes(self) -> int:
        # honest-order-of-magnitude estimate (tuple + float boxing), the
        # number the memory gauge reports; exactness is not the point —
        # boundedness is, and maxlen already guarantees that
        per = 64 + 16 * (2 if self.buckets is None else 3 + len(self.buckets) + 1)
        return 96 + per * len(self.samples)


@guarded_by("_lock", "_series", "_dropped", "_last_record_s")
class MetricsHistory:
    """Bounded per-series time-series rings over a metrics registry."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        keep: int = DEFAULT_KEEP,
        max_series: int = DEFAULT_MAX_SERIES,
        series_filter: Callable[[str, str], bool] | None = None,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.keep = int(keep)
        self.max_series = int(max_series)
        # optional opt-out: (key, kind) -> False skips the series
        self.series_filter = series_filter
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._dropped = 0
        self._last_record_s = math.nan
        r = self.registry
        self._g_series = r.gauge(
            "consensusml_history_series",
            "metric series retained in the in-process history rings",
        )
        self._g_samples = r.gauge(
            "consensusml_history_samples",
            "total samples across all history rings (bounded by "
            "keep x series)",
        )
        self._g_bytes = r.gauge(
            "consensusml_history_bytes",
            "estimated bytes retained by the history rings",
        )
        self._m_dropped = r.counter(
            "consensusml_history_series_dropped_total",
            "series refused because the max_series cap was reached "
            "(bounded memory, counted — never silent)",
        )

    # -- recording ---------------------------------------------------------

    def record(self, now: float | None = None) -> int:
        """Sample every registry series once; returns series recorded.

        Values are read under each metric's own lock BEFORE the history
        lock is taken (no nested lock order with the hot paths)."""
        now = time.time() if now is None else float(now)
        rows: list[tuple[str, str, Any, Any]] = []
        for m in self.registry.metrics():
            if self.series_filter is not None and not self.series_filter(
                m.key, m.kind
            ):
                continue
            if m.kind == "histogram":
                buckets, counts, total, n = m.raw()
                rows.append((m.key, m.kind, buckets, (now, n, total, counts)))
            else:
                rows.append((m.key, m.kind, None, (now, float(m.value))))
        recorded = 0
        with self._lock:
            for key, kind, buckets, sample in rows:
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.max_series:
                        self._dropped += 1
                        continue
                    s = _Series(key, kind, self.keep, buckets)
                    self._series[key] = s
                s.samples.append(sample)
                recorded += 1
            self._last_record_s = now
            n_series = len(self._series)
            n_samples = sum(len(s.samples) for s in self._series.values())
            est = sum(s.est_bytes() for s in self._series.values())
            dropped = self._dropped
        self._g_series.set(n_series)
        self._g_samples.set(n_samples)
        self._g_bytes.set(est)
        if dropped:
            drop_inc = dropped - self._m_dropped.value
            if drop_inc > 0:
                self._m_dropped.inc(drop_inc)
        return recorded

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    @property
    def last_record_s(self) -> float:
        """Unix time of the latest ``record()`` (NaN before the first) —
        the ``/healthz`` last-tick-age source."""
        with self._lock:
            return self._last_record_s

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def keys_for(self, series: str) -> list[str]:
        """Keys a rule's ``series`` matches: an exact key when it names
        one (carries labels or exists verbatim), else every labeled
        child of the family."""
        with self._lock:
            if series in self._series or "{" in series:
                return [series] if series in self._series else []
            return sorted(
                k
                for k in self._series
                if parse_metric_key(k)[0] == series
            )

    def kind_of(self, key: str) -> str | None:
        """The series' metric kind (``counter``/``gauge``/``histogram``),
        None when unknown."""
        with self._lock:
            s = self._series.get(key)
            return s.kind if s is not None else None

    def _get(self, key: str) -> tuple[str, Any, list] | None:
        """(kind, buckets, samples-copy) — the one locked read every
        query helper builds on."""
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return None
            return s.kind, s.buckets, list(s.samples)

    # -- scalar queries ----------------------------------------------------

    def last(self, key: str, n: int = 1) -> list[tuple]:
        """Last-``n`` raw samples, oldest first (empty when unknown)."""
        got = self._get(key)
        if got is None:
            return []
        return got[2][-max(int(n), 0):]

    def latest_value(self, key: str) -> tuple[float, float] | None:
        """Latest ``(t, value)`` for a scalar series; for a histogram
        the value is its cumulative observation count."""
        got = self._get(key)
        if got is None or not got[2]:
            return None
        s = got[2][-1]
        return (s[0], float(s[1]))

    def _scalar_window(self, key: str, window_s: float, now: float | None):
        got = self._get(key)
        if got is None or len(got[2]) < 2 or got[0] == "histogram":
            return None
        samples = got[2]
        now = samples[-1][0] if now is None else float(now)
        cutoff = now - float(window_s)
        # baseline: the latest sample at/before the cutoff so the delta
        # spans the whole window when history reaches back that far
        base = 0
        for i, (t, _v) in enumerate(samples):
            if t <= cutoff:
                base = i
            else:
                break
        return samples[base:]

    def increase(
        self, key: str, window_s: float, now: float | None = None
    ) -> float:
        """Counter increase over the window: the sum of positive
        sample-to-sample deltas (a process restart resets the counter —
        negative deltas are treated as resets, not decreases). NaN when
        fewer than two samples exist."""
        win = self._scalar_window(key, window_s, now)
        if win is None:
            return math.nan
        total = 0.0
        for (_, a), (_, b) in zip(win, win[1:]):
            if math.isfinite(a) and math.isfinite(b) and b > a:
                total += b - a
        return total

    def rate(
        self, key: str, window_s: float, now: float | None = None
    ) -> float:
        """Per-second :meth:`increase` over the measured sample span."""
        win = self._scalar_window(key, window_s, now)
        if win is None:
            return math.nan
        span = win[-1][0] - win[0][0]
        if span <= 0:
            return math.nan
        total = 0.0
        for (_, a), (_, b) in zip(win, win[1:]):
            if math.isfinite(a) and math.isfinite(b) and b > a:
                total += b - a
        return total / span

    # -- histogram-delta queries -------------------------------------------

    def _hist_delta(
        self, key: str, window_s: float, now: float | None
    ) -> tuple[tuple[float, ...], list[int], float, int] | None:
        """(bucket_edges, delta_counts incl +Inf, delta_sum, delta_count)
        between the window's baseline sample and the latest one."""
        got = self._get(key)
        if got is None or got[0] != "histogram" or len(got[2]) < 2:
            return None
        kind, buckets, samples = got
        now = samples[-1][0] if now is None else float(now)
        cutoff = now - float(window_s)
        base = samples[0]
        for s in samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        latest = samples[-1]
        if latest[0] <= base[0]:
            return None
        d_counts = [
            max(b - a, 0) for a, b in zip(base[3], latest[3])
        ]
        return (
            buckets,
            d_counts,
            max(latest[2] - base[2], 0.0),
            max(latest[1] - base[1], 0),
        )

    def quantile(
        self, key: str, q: float, window_s: float, now: float | None = None
    ) -> float:
        """Windowed percentile from histogram deltas (cumulative-bucket
        linear interpolation, same estimate as the cluster report's
        ``hist_stats``). NaN when the window saw no observations."""
        d = self._hist_delta(key, window_s, now)
        if d is None:
            return math.nan
        buckets, counts, _total, n = d
        if n <= 0:
            return math.nan
        # landing in +Inf reports the last finite edge
        return _delta_quantile(buckets, counts, n, q)

    def bad_fraction(
        self,
        key: str,
        threshold: float,
        window_s: float,
        now: float | None = None,
    ) -> float:
        """Fraction of the window's observations ABOVE ``threshold`` —
        the burn-rate engine's error fraction. Resolved at the smallest
        bucket edge >= threshold (put SLO thresholds on bucket edges for
        exact accounting). 0.0 when the window saw no traffic: no
        observations means no errors, so burn rates decay to zero and
        alerts clear when load stops."""
        d = self._hist_delta(key, window_s, now)
        if d is None:
            return 0.0
        buckets, counts, _total, n = d
        if n <= 0:
            return 0.0
        i = bisect.bisect_left(buckets, float(threshold))
        good = sum(counts[: i + 1]) if i < len(buckets) else n
        return max(0.0, 1.0 - good / n)

    def window_stats(
        self, key: str, window_s: float, now: float | None = None
    ) -> dict[str, float] | None:
        """{count, rate_per_s, mean, p50, p99} over the window's deltas."""
        d = self._hist_delta(key, window_s, now)
        if d is None:
            return None
        _buckets, _counts, total, n = d
        return {
            "count": n,
            "rate_per_s": n / float(window_s) if window_s > 0 else math.nan,
            "mean": total / n if n else math.nan,
            "p50": self.quantile(key, 0.50, window_s, now),
            "p99": self.quantile(key, 0.99, window_s, now),
        }

    # -- derived points / dumps --------------------------------------------

    def spark(self, key: str, points: int | None = None) -> list[list[float]]:
        """Per-sample derived points ``[t, v]`` for sparklines: gauges
        plot raw values, counters plot the per-interval rate, histograms
        the per-interval p99 (None when that interval saw nothing)."""
        got = self._get(key)
        if got is None:
            return []
        kind, buckets, samples = got
        if points is not None:
            samples = samples[-max(int(points) + 1, 2):]
        out: list[list[float]] = []
        if kind == "gauge":
            return [[t, v] for t, v in samples[-(points or len(samples)):]]
        if kind == "histogram" and samples:
            # implicit zero baseline: the first sample's interval covers
            # everything observed before the first record, so a short
            # run (one recorded sample) still yields its p99 point
            first = samples[0]
            samples = [
                (first[0], 0, 0.0, (0,) * len(first[3]))
            ] + samples
        for a, b in zip(samples, samples[1:]):
            dt = b[0] - a[0]
            if kind == "histogram":
                # p99 is dt-independent; only an empty interval yields
                # no point (the zero-baseline first interval qualifies)
                dn = max(b[1] - a[1], 0)
                if dn <= 0:
                    out.append([b[0], None])
                    continue
                d_counts = [max(y - x, 0) for x, y in zip(a[3], b[3])]
                out.append([b[0], _delta_quantile(buckets, d_counts, dn, 0.99)])
            else:  # counter: per-interval rate
                dv = b[1] - a[1]
                out.append(
                    [b[0], max(dv, 0.0) / dt if dt > 0 else None]
                )
        return out

    def query(
        self,
        series: str,
        window_s: float | None = None,
        n: int | None = None,
        now: float | None = None,
    ) -> dict[str, Any] | None:
        """The ``/query`` endpoint's document for one series key (or a
        family name resolving to one unlabeled key). None when the
        series is unknown."""
        keys = self.keys_for(series)
        if not keys:
            return None
        key = series if series in keys else keys[0]
        got = self._get(key)
        if got is None:
            return None
        kind, _buckets, samples = got
        window = float(window_s) if window_s else None
        doc: dict[str, Any] = {
            "series": key,
            "kind": kind,
            "samples_retained": len(samples),
            "keys": keys,
            "points": self.spark(key, points=n),
        }
        if kind == "histogram":
            doc["window_s"] = window or 300.0
            doc["window"] = self.window_stats(key, doc["window_s"], now)
        else:
            last = samples[-1] if samples else None
            doc["last"] = (
                {"time_s": last[0], "value": last[1]} if last else None
            )
            if kind == "counter":
                doc["window_s"] = window or 300.0
                doc["rate_per_s"] = self.rate(key, doc["window_s"], now)
                doc["increase"] = self.increase(key, doc["window_s"], now)
        return doc

    def digest(
        self, points: int = 32, now: float | None = None
    ) -> dict[str, Any]:
        """Compact per-series last-N summary for cluster snapshots and
        flight-recorder dumps (``tools/obs_report.py`` renders the rows
        as sparklines)."""
        rows: list[dict[str, Any]] = []
        for key in self.keys():
            pts = self.spark(key, points=points)
            if not pts:
                continue
            vals = [v for _t, v in pts if v is not None and math.isfinite(v)]
            rows.append(
                {
                    "series": key,
                    "kind": self.kind_of(key) or "?",
                    # non-finite -> null: the digest lands in JSON FILES
                    # (cluster snapshots, flight dumps) where a bare NaN
                    # token breaks strict parsers — a never-set gauge
                    # samples as NaN
                    "points": [
                        [
                            round(t, 3),
                            (
                                _round6(v)
                                if v is not None and math.isfinite(v)
                                else None
                            ),
                        ]
                        for t, v in pts
                    ],
                    "last": _round6(vals[-1]) if vals else None,
                    "min": _round6(min(vals)) if vals else None,
                    "max": _round6(max(vals)) if vals else None,
                }
            )
        with self._lock:
            est = sum(s.est_bytes() for s in self._series.values())
            n_samples = sum(len(s.samples) for s in self._series.values())
        return {
            "keep": self.keep,
            "points": points,
            "series": rows,
            "series_total": len(rows),
            "samples_total": n_samples,
            "memory_bytes_est": est,
        }


def _delta_quantile(buckets, counts, n, q) -> float:
    target = q * n
    cum = 0.0
    lo = 0.0
    for le, c in zip(buckets, counts):
        if cum + c >= target:
            frac = (target - cum) / c if c else 0.0
            return lo + frac * (le - lo)
        cum += c
        lo = le
    return lo


def _round6(v: float) -> float:
    return float(f"{float(v):.6g}")


_GLOBAL: MetricsHistory | None = None
_GLOBAL_LOCK = threading.Lock()


def get_history() -> MetricsHistory:
    """The process-wide history over the global registry (created on
    first use — the surfaces that tick it call this)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsHistory()
        return _GLOBAL


def peek_history() -> MetricsHistory | None:
    """The global history if some surface already armed it, else None —
    the flight recorder / cluster writer fallback that must not CREATE
    one as a side effect of dumping."""
    with _GLOBAL_LOCK:
        return _GLOBAL
