"""Cross-rank aggregation: one cluster view from per-rank snapshots (port
of ``consensusml_tpu/obs/cluster.py``: host code, as the reference's, with
its file names, JSON keys and sections).

Each process's telemetry is its own; a swarm needs the merged picture.
The shared-directory sideband keeps it dependency-free and
multi-controller-correct:

- every rank runs a :class:`ClusterWriter` (``python -m
  consensusml_tpu_torch.train --obs-cluster-dir DIR``): at telemetry
  cadence it rewrites its OWN file ``obs-<role>-<rank>.json`` atomically (tmp + rename, the same
  textfile-collector contract the Prometheus exporter uses) with its
  current registry values, round progress, and a heartbeat timestamp.
  One file per rank, latest wins — no append-log compaction problem,
  no cross-process locking (ranks never touch each other's files). The
  directory can be a shared filesystem mount (multi-host pods) or a
  local dir that a sidecar rsyncs — the aggregator only sees files.
- :func:`aggregate` merges every snapshot in the directory into one
  cluster document: per-rank round/latency skew, merged per-link
  latency histograms with a slowest-link ranking, measured-vs-bound
  consensus health, straggler detection (stale heartbeat or round
  lag), churn counters, and an index of any flight-recorder dumps that
  landed next to the snapshots.
- ``python -m consensusml_tpu_torch.tools.obs_report`` renders that
  document as JSON or text.

Non-rank roles ride the same channel: ``consensusml_tpu_torch.tools.loadgen
--obs-snapshot`` writes an ``obs-loadgen-*.json`` with its
client-observed ``consensusml_loadgen_*`` SLOs, so the serving client
and server sides of an SLO story merge into the same report.
"""

from __future__ import annotations

import glob
import json
import math
import os
import time
from collections import deque
from typing import Any

from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry, parse_metric_key

__all__ = [
    "ClusterWriter",
    "read_snapshots",
    "aggregate",
    "hist_stats",
    "SNAP_PREFIX",
]

SNAP_PREFIX = "obs-"


class ClusterWriter:
    """Atomically (re)writes this process's cluster snapshot file."""

    def __init__(
        self,
        out_dir: str,
        rank: int = 0,
        role: str = "rank",
        registry: MetricsRegistry | None = None,
        world_size: int | None = None,
        tracer=None,
        history=None,
        alerts=None,
        events=None,
    ):
        from consensusml_tpu_torch.obs.tracer import get_tracer

        self.out_dir = out_dir
        self.rank = int(rank)
        self.role = role
        self.world_size = world_size
        self.registry = registry if registry is not None else get_registry()
        # alert/history digest sources: explicit wiring wins; a writer
        # over the GLOBAL registry falls back to peeking the process
        # singletons (so the train loop's armed plane lands in snapshots
        # without threading two more handles through every call site) —
        # a custom registry never picks up the global plane's digests
        self.history = history
        self.alerts = alerts
        # wide-event log (obs.events): same explicit-or-peek rule — a
        # serving rank's snapshot carries its per-tenant rollup so the
        # aggregator can merge fleet-wide tenant spend
        self.events = events
        self._peek_global = registry is None
        # span-ring digest source: per-round phase rows for the merged
        # round timeline (tracer disabled => no digest in the snapshot)
        self.tracer = tracer if tracer is not None else get_tracer()
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(
            out_dir, f"{SNAP_PREFIX}{role}-{self.rank:05d}.json"
        )
        # membership-event timeline (swarm churn): bounded ring, rewritten
        # whole into every snapshot — latest-wins like the rest of the file
        self._events: deque = deque(maxlen=256)

    def record_event(self, event: dict[str, Any]) -> None:
        """Append a membership/churn event row (``{"round": .., "kind":
        "join|drop|rejoin|straggle", "workers": [..], ...}``) to the
        timeline this writer's snapshots carry; the aggregator merges
        every rank's rows into the cluster report's membership timeline."""
        self._events.append(dict(event))

    def write(
        self, round: int | None = None, extra: dict[str, Any] | None = None
    ) -> str:
        doc: dict[str, Any] = {
            "rank": self.rank,
            "role": self.role,
            "pid": os.getpid(),
            "world_size": self.world_size,
            "round": round,
            "heartbeat_s": time.time(),
            "metrics": {
                m.key: m.value_dict() for m in self.registry.metrics()
            },
        }
        if self._events:
            doc["swarm_events"] = list(self._events)
        if self.tracer is not None and self.tracer.enabled:
            digest = self.tracer.digest()
            if digest["spans"]:
                doc["span_digest"] = digest
        alerts = self.alerts
        history = self.history
        events = self.events
        if self._peek_global:
            from consensusml_tpu_torch.obs.alerts import peek_alert_engine
            from consensusml_tpu_torch.obs.events import peek_wide_event_log
            from consensusml_tpu_torch.obs.history import peek_history

            alerts = alerts or peek_alert_engine()
            history = history or peek_history()
            events = events or peek_wide_event_log()
        if alerts is not None:
            doc["alerts"] = alerts.snapshot()
        if history is not None:
            doc["history"] = history.digest(points=32)
        if events is not None:
            # rollup only (events_recent capped small): a snapshot is
            # rewritten at cadence, the full ring stays in-process
            doc["wide_events"] = events.snapshot(last_n=16)
        if extra:
            doc.update(extra)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)
        return self.path


def read_snapshots(cluster_dir: str) -> list[dict[str, Any]]:
    """Every parseable ``obs-*.json`` in the directory, rank-sorted.
    Unparseable files (a writer died mid-rename on a non-POSIX mount)
    are reported in-band under ``_errors``, never raised."""
    out: list[dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(cluster_dir, f"{SNAP_PREFIX}*.json"))):
        try:
            with open(path) as f:
                doc = json.load(f)
            doc["_file"] = os.path.basename(path)
            out.append(doc)
        except (OSError, ValueError) as e:
            out.append(
                {"_file": os.path.basename(path), "_error": f"{type(e).__name__}: {e}"}
            )
    out.sort(key=lambda d: (d.get("role") or "", d.get("rank") or 0))
    return out


def hist_stats(vd: dict[str, Any]) -> dict[str, float]:
    """mean/p50/p99 from a histogram ``value_dict`` (cumulative-bucket
    linear interpolation — the standard textfile-collector estimate)."""
    count = vd.get("count", 0)
    if not count:
        return {"count": 0, "mean": math.nan, "p50": math.nan, "p99": math.nan}
    total = vd.get("sum", 0.0)
    edges = sorted(((float(le), c) for le, c in vd.get("buckets", {}).items()))

    def quantile(q: float) -> float:
        target = q * count
        cum = 0.0
        lo = 0.0
        for le, c in edges:
            if cum + c >= target:
                frac = (target - cum) / c if c else 0.0
                return lo + frac * (le - lo)
            cum += c
            lo = le
        return lo  # landed in the +Inf bucket: report the last edge

    return {
        "count": count,
        "mean": total / count,
        "p50": quantile(0.50),
        "p99": quantile(0.99),
    }


def _merge_hist(a: dict[str, Any] | None, b: dict[str, Any]) -> dict[str, Any]:
    if a is None:
        out = {
            "count": b.get("count", 0),
            "sum": b.get("sum", 0.0),
            "buckets": dict(b.get("buckets", {})),
            "inf": b.get("inf", 0),
        }
        if b.get("exemplars"):
            out["exemplars"] = list(b["exemplars"])
        return out
    out = dict(a)
    out["count"] = a.get("count", 0) + b.get("count", 0)
    out["sum"] = a.get("sum", 0.0) + b.get("sum", 0.0)
    out["inf"] = a.get("inf", 0) + b.get("inf", 0)
    buckets = dict(a.get("buckets", {}))
    for le, c in b.get("buckets", {}).items():
        buckets[le] = buckets.get(le, 0) + c
    out["buckets"] = buckets
    # worst exemplars survive the merge, capped like the per-histogram
    # retention
    ex = list(a.get("exemplars", [])) + list(b.get("exemplars", []))
    if ex:
        from consensusml_tpu_torch.obs.metrics import EXEMPLAR_KEEP

        ex.sort(key=lambda e: -e.get("value", 0.0))
        out["exemplars"] = ex[:EXEMPLAR_KEEP]
    return out


def _metric(doc: dict, name: str, default=None):
    v = (doc.get("metrics") or {}).get(name, default)
    return default if v is None else v


def _age_s(doc: dict, now: float) -> float:
    """Heartbeat age, tolerant of a partial snapshot with the field
    missing or malformed (treated as just-written: age 0)."""
    hb = _finite(doc.get("heartbeat_s"))
    return round(now - (hb if hb is not None else now), 3)


def _finite(v) -> float | None:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


_SLO_SIDES = {
    "consensusml_serve_ttft_seconds": "server",
    "consensusml_serve_prefill_seconds": "server",
    "consensusml_serve_intertoken_seconds": "server",
    "consensusml_loadgen_ttft_seconds": "client",
    "consensusml_loadgen_latency_seconds": "client",
}


def _requests_section(snaps: list[dict[str, Any]], top: int = 8) -> dict[str, Any]:
    """The serving-request view: merge every snapshot's request-trace
    dump into one id index, then resolve the SLO histograms' exemplars
    against it — the "slowest requests" table where a p99 bucket's
    request_id points at a concrete recorded trace (client and server
    observations of one request join on trace_id)."""
    index: dict[str, dict[str, Any]] = {}
    for s in snaps:
        rt = s.get("request_traces") or {}
        for tr in list(rt.get("active", [])) + list(rt.get("completed", [])):
            rid = tr.get("request_id")
            if rid:
                index[rid] = {
                    "trace_id": tr.get("trace_id"),
                    "finish_reason": tr.get("finish_reason"),
                    "decode_ticks": tr.get("decode_ticks", 0),
                    "defer_ticks": tr.get("defer_ticks", 0),
                    "preemptions": tr.get("preemptions", 0),
                    "events": [e.get("name") for e in tr.get("events", [])],
                    "in_flight": tr.get("finish_reason") is None,
                }
    rows: list[dict[str, Any]] = []
    for s in snaps:
        for key, vd in (s.get("metrics") or {}).items():
            name, _labels = parse_metric_key(key)
            side = _SLO_SIDES.get(name)
            if side is None or not isinstance(vd, dict):
                continue
            for ex in vd.get("exemplars", []):
                rid = ex.get("id")
                tr = index.get(rid)
                rows.append(
                    {
                        "metric": name,
                        "side": side,
                        "value_s": ex.get("value"),
                        "request_id": rid,
                        "trace_id": tr["trace_id"] if tr else None,
                        "resolved": tr is not None,
                        "role": s.get("role"),
                        "rank": s.get("rank"),
                        "trace": tr,
                    }
                )
    rows.sort(
        key=lambda r: (
            r["metric"], -(r["value_s"] or 0.0), r["request_id"] or ""
        )
    )
    slowest: list[dict[str, Any]] = []
    per_metric: dict[str, int] = {}
    for r in rows:
        n = per_metric.get(r["metric"], 0)
        if n < top:
            per_metric[r["metric"]] = n + 1
            slowest.append(r)
    return {
        "traces_indexed": len(index),
        "in_flight": sum(1 for t in index.values() if t["in_flight"]),
        "slowest": slowest,
    }


def _round_timeline(ranks: list[dict[str, Any]], max_rounds: int = 64) -> list[dict[str, Any]]:
    """Cross-rank per-round phase rows from the span digests.

    Each rank's ``span_digest.rounds`` carries measured ``train.round``
    duration plus the ``round.feed`` / ``round.fence`` phase spans; the
    merged timeline shows, per round, every rank's split and attributes
    the straggler's EXTRA time (vs the fastest rank) to a phase:
    ``feed`` when the feed-stall delta dominates, else ``gossip`` /
    ``compute`` split by the rank's compile-round span ratio (an
    estimate — the steady-state jitted round is one program; marked
    ``_est`` accordingly)."""
    per_round: dict[int, list[dict[str, Any]]] = {}
    ratios: dict[Any, float] = {}
    for s in ranks:
        digest = s.get("span_digest") or {}
        spans = digest.get("spans") or {}
        gossip_us = (spans.get("gossip.round") or {}).get("total_us", 0.0)
        inner_us = (spans.get("train.inner_loop") or {}).get("total_us", 0.0)
        ratios[s.get("rank")] = (
            gossip_us / (gossip_us + inner_us)
            if gossip_us + inner_us > 0
            else None
        )
        for row in digest.get("rounds", []):
            rnd = row.get("round")
            if rnd is None:
                continue
            per_round.setdefault(int(rnd), []).append(
                {
                    "rank": s.get("rank"),
                    "dur_ms": round(row.get("dur_us", 0.0) / 1e3, 3),
                    "feed_ms": round(row.get("feed_us", 0.0) / 1e3, 3),
                    "fence_ms": round(row.get("fence_us", 0.0) / 1e3, 3),
                }
            )
    timeline: list[dict[str, Any]] = []
    for rnd in sorted(per_round)[-max_rounds:]:
        rows = sorted(per_round[rnd], key=lambda r: (r["rank"] is None, r["rank"]))
        slow = max(rows, key=lambda r: r["dur_ms"])
        fast = min(rows, key=lambda r: r["dur_ms"])
        entry: dict[str, Any] = {"round": rnd, "ranks": rows}
        if len(rows) > 1 and slow["dur_ms"] > fast["dur_ms"]:
            extra = slow["dur_ms"] - fast["dur_ms"]
            feed_delta = max(slow["feed_ms"] - fast["feed_ms"], 0.0)
            feed_delta = min(feed_delta, extra)
            rest = extra - feed_delta
            ratio = ratios.get(slow["rank"])
            gossip_est = rest * ratio if ratio is not None else None
            compute_est = rest - gossip_est if gossip_est is not None else None
            parts = {"feed": feed_delta}
            if gossip_est is not None:
                parts["gossip"] = gossip_est
                parts["compute"] = compute_est
            else:
                parts["step"] = rest  # no compile ratio: unattributed
            entry["straggler"] = {
                "rank": slow["rank"],
                "extra_ms": round(extra, 3),
                "feed_ms": round(feed_delta, 3),
                "gossip_ms_est": (
                    None if gossip_est is None else round(gossip_est, 3)
                ),
                "compute_ms_est": (
                    None if compute_est is None else round(compute_est, 3)
                ),
                "phase": max(parts, key=lambda k: parts[k]),
            }
        timeline.append(entry)
    return timeline


_COST_FAMILIES = {
    # labeled consensusml_cost_*/compile family -> attribution-row field
    "consensusml_cost_flops": "flops",
    "consensusml_cost_bytes_accessed": "bytes_accessed",
    "consensusml_cost_peak_bytes": "peak_bytes",
    "consensusml_compile_seconds": "compile_s",
    "consensusml_cost_expected_seconds": "expected_s",
    "consensusml_cost_measured_seconds": "measured_s",
    "consensusml_cost_floor_ratio": "floor_ratio",
}


def _attribution_section(snaps: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Per-executable cost-ledger rows merged across ranks.

    The ledger's gauges are labeled ``executable=``; every rank lowers
    the same programs, so values merge with max (same convention as the
    replicated swarm counters). Rows come back sorted by expected cost,
    costliest first — the render order of obs_report's attribution
    table. Empty when no rank ran with a cost ledger.
    """
    rows: dict[str, dict[str, Any]] = {}
    for s in snaps:
        for key, vd in (s.get("metrics") or {}).items():
            name, labels = parse_metric_key(key)
            field = _COST_FAMILIES.get(name)
            if field is None or "executable" not in labels:
                continue
            f = _finite(vd)
            if f is None:
                continue
            row = rows.setdefault(
                labels["executable"], {"executable": labels["executable"]}
            )
            row[field] = max(row.get(field, float("-inf")), f)
    out = list(rows.values())
    out.sort(key=lambda r: -(r.get("expected_s") or 0.0))
    return out


def _alerts_section(snaps: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Fleet-wide alert view: every snapshot's firing alerts merged,
    deduplicated by (rule, series-with-labels) — the same breach seen
    from N ranks is ONE row naming all N — ordered worst-first (the
    alert engine's own ordering: severity, then longest-firing). None
    when no snapshot carries an alert plane (partial/old snapshots stay
    renderable)."""
    from consensusml_tpu_torch.obs.alerts import worst_first_key

    rows: dict[tuple[str, str], dict[str, Any]] = {}
    reporting = 0
    events: list[dict[str, Any]] = []
    resolved_total = 0
    for s in snaps:
        al = s.get("alerts")
        if not isinstance(al, dict):
            continue
        reporting += 1
        resolved_total += len(al.get("resolved_recent") or [])
        who = f"{s.get('role') or 'rank'}-{s.get('rank')}"
        for ev in al.get("events_recent") or []:
            events.append(dict(ev, reporter=who))
        for a in al.get("firing") or []:
            key = (a.get("rule") or "", a.get("series") or "")
            row = rows.get(key)
            if row is None:
                row = rows[key] = dict(a, reporters=[])
            else:
                # keep the worst view of the shared breach: earliest
                # fire time, and the value on the bad side of the
                # rule's direction (min for "below" breaches)
                if (a.get("fired_s") or math.inf) < (
                    row.get("fired_s") or math.inf
                ):
                    row["fired_s"] = a.get("fired_s")
                    row["since_s"] = a.get("since_s")
                v, rv = a.get("value"), row.get("value")
                if v is not None and (
                    rv is None
                    or (v < rv if row.get("direction") == "below" else v > rv)
                ):
                    row["value"] = v
            row["reporters"].append(who)
    if not reporting:
        return None
    firing = sorted(rows.values(), key=worst_first_key)
    events.sort(key=lambda e: e.get("time_s") or 0.0)
    return {
        "ranks_reporting": reporting,
        "firing": firing,
        "firing_total": len(firing),
        "resolved_recent_total": resolved_total,
        "events_recent": events[-16:],
    }


def _history_section(snaps: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Per-series sparkline rows from every snapshot's history digest:
    one row per (series, role, rank), carrying the digest's derived
    points (gauge value / counter rate / histogram interval-p99) so the
    report can render client-vs-server trends side by side. None when
    no snapshot carries a digest."""
    rows: list[dict[str, Any]] = []
    reporting = 0
    for s in snaps:
        digest = s.get("history")
        if not isinstance(digest, dict):
            continue
        reporting += 1
        for row in digest.get("series") or []:
            if not isinstance(row, dict) or not row.get("series"):
                continue
            rows.append(
                {
                    "series": row["series"],
                    "kind": row.get("kind"),
                    "role": s.get("role"),
                    "rank": s.get("rank"),
                    "points": row.get("points") or [],
                    "last": row.get("last"),
                    "min": row.get("min"),
                    "max": row.get("max"),
                }
            )
    if not reporting:
        return None
    rows.sort(
        key=lambda r: (
            r["series"], str(r.get("role") or ""), r.get("rank") or 0
        )
    )
    return {
        "ranks_reporting": reporting,
        "series": rows,
        "series_total": len(rows),
    }


def _tenants_section(snaps: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Fleet-wide per-tenant spend: every snapshot's wide-event rollup
    merged by tenant — counters sum across ranks (each rank's events
    are its own requests, disjoint by construction), worst-TTFT
    exemplar lists merge and re-cap. None when no snapshot carries a
    wide-event section (pre-accounting snapshots keep aggregating)."""
    from consensusml_tpu_torch.obs.events import WORST_TTFT_KEEP

    tenants: dict[str, dict[str, Any]] = {}
    reporting = 0
    events_total = 0
    for s in snaps:
        we = s.get("wide_events")
        if not isinstance(we, dict):
            continue
        reporting += 1
        events_total += int(we.get("emitted_total") or 0)
        for t, agg in (we.get("tenants") or {}).items():
            row = tenants.setdefault(t, {"worst_ttft": []})
            for k, v in agg.items():
                if k == "worst_ttft":
                    row["worst_ttft"].extend(v or [])
                elif isinstance(v, (int, float)):
                    row[k] = row.get(k, 0) + v
        for row in tenants.values():
            row["worst_ttft"] = sorted(
                row["worst_ttft"], key=lambda r: -(r.get("ttft_s") or 0.0)
            )[:WORST_TTFT_KEEP]
    if not reporting:
        return None
    return {
        "ranks_reporting": reporting,
        "events_total": events_total,
        "tenants": tenants,
    }


def _fleet_section(snaps: list[dict[str, Any]]) -> dict[str, Any] | None:
    """The fleet plane: router/controller state written as a ``fleet``
    snapshot extra (``tools/fleetctl.py --obs-snapshot``, the fleet
    bench). Routers are disjoint front-ends, so their stream counters
    SUM across snapshots; the per-replica table and canary state merge
    last-writer-wins by replica name. None when no snapshot carries a
    fleet section (non-fleet directories keep aggregating)."""
    routers = 0
    counts: dict[str, float] = {}
    replicas: dict[str, dict[str, Any]] = {}
    canary = None
    events: list[dict] = []
    for s in snaps:
        fl = s.get("fleet")
        if not isinstance(fl, dict):
            continue
        routers += 1
        for k, v in (fl.get("router") or {}).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                counts[k] = counts.get(k, 0) + v
            elif k not in counts:
                counts[k] = v
        for name, row in (fl.get("replicas") or {}).items():
            replicas[name] = row
        if isinstance(fl.get("canary"), dict):
            canary = fl["canary"]
        events.extend(fl.get("events") or [])
    if not routers:
        return None
    return {
        "routers_reporting": routers,
        "router": counts,
        "replicas": replicas,
        "canary": canary,
        "events": sorted(events, key=lambda e: e.get("time_s", 0.0))[-32:],
    }


def _hbm_section(snaps: list[dict[str, Any]]) -> dict[str, Any] | None:
    """The three-way HBM reconciliation gauges (obs/memviz.py), worst
    rank per side — plus per-pair drift. None when no rank reconciled."""
    sides = {
        "analytic_bytes": "consensusml_hbm_analytic_bytes",
        "compiled_bytes": "consensusml_hbm_compiled_bytes",
        "live_peak_bytes": "consensusml_hbm_live_peak_bytes",
        "live_bytes": "consensusml_hbm_live_bytes",
    }
    doc: dict[str, Any] = {}
    drift: dict[str, float] = {}
    for s in snaps:
        for field, fam in sides.items():
            f = _finite(_metric(s, fam))
            if f is not None:
                doc[field] = max(doc.get(field, float("-inf")), f)
        for key, vd in (s.get("metrics") or {}).items():
            name, labels = parse_metric_key(key)
            if name == "consensusml_hbm_drift_pct" and "pair" in labels:
                f = _finite(vd)
                if f is not None:
                    pair = labels["pair"]
                    # keep the worst-magnitude drift across ranks
                    if abs(f) >= abs(drift.get(pair, 0.0)):
                        drift[pair] = f
    if not doc and not drift:
        return None
    doc["drift_pct"] = drift
    return doc


def aggregate(
    cluster_dir: str,
    *,
    now: float | None = None,
    straggler_age_s: float = 120.0,
    straggler_round_lag: int = 3,
    top_links: int = 16,
) -> dict[str, Any]:
    """Merge a cluster directory into one report document.

    ``now`` is injectable so tests (and replays of an old directory)
    get deterministic heartbeat ages. The report is plain JSON-able
    data; ``consensusml_tpu_torch.tools.obs_report`` renders it.
    """
    now = time.time() if now is None else now
    snaps = read_snapshots(cluster_dir)
    errors = [s for s in snaps if "_error" in s]
    ranks = [s for s in snaps if "_error" not in s and s.get("role") == "rank"]
    others = [
        s for s in snaps if "_error" not in s and s.get("role") != "rank"
    ]

    # ---- per-rank rows ---------------------------------------------------
    rank_rows: list[dict[str, Any]] = []
    link_hists: dict[tuple[str, str], dict] = {}
    link_wire: dict[tuple[str, str], float] = {}
    link_traced: dict[tuple[str, str], float] = {}
    for s in ranks:
        lat = _metric(s, "consensusml_round_latency_seconds")
        row = {
            "rank": s.get("rank"),
            "file": s.get("_file"),
            "round": s.get("round"),
            "heartbeat_age_s": _age_s(s, now),
            "rounds_total": _metric(s, "consensusml_rounds_total", 0.0),
            "wire_bytes_total": _metric(s, "consensusml_wire_bytes_total", 0.0),
            "round_latency": (
                hist_stats(lat) if isinstance(lat, dict) else None
            ),
            "consensus_distance": _finite(
                _metric(s, "consensusml_consensus_distance")
            ),
            "alive_frac": _finite(_metric(s, "consensusml_alive_frac")),
            "health": {
                "decay_measured": _finite(
                    _metric(s, "consensusml_health_decay_measured")
                ),
                "decay_bound": _finite(
                    _metric(s, "consensusml_health_decay_bound")
                ),
                "bound_violation": _finite(
                    _metric(s, "consensusml_health_bound_violation")
                ),
                "anomalies_total": _metric(
                    s, "consensusml_health_anomalies_total", 0.0
                ),
            },
        }
        rank_rows.append(row)
        # merge every rank's per-edge families (a rank sees its own
        # probes; in single-controller runs rank 0 sees every edge)
        for key, vd in (s.get("metrics") or {}).items():
            name, labels = parse_metric_key(key)
            if "src" not in labels or "dst" not in labels:
                continue
            edge = (labels["src"], labels["dst"])
            if name == "consensusml_link_latency_seconds" and isinstance(
                vd, dict
            ):
                link_hists[edge] = _merge_hist(link_hists.get(edge), vd)
            elif name in (
                "consensusml_link_wire_bytes_per_round",
                "consensusml_link_wire_bytes_traced_total",
            ):
                f = _finite(vd)
                if f is not None:
                    # max, not sum: every process traces/records the same
                    # full edge set, so summing would multiply by ranks.
                    # The two families stay SEPARATE report fields: the
                    # gauge is the engine's per-round accounting, the
                    # traced counter ACCUMULATES per compile (a retrace
                    # doubles it) and must never masquerade as bytes/round
                    tgt = (
                        link_wire
                        if name == "consensusml_link_wire_bytes_per_round"
                        else link_traced
                    )
                    tgt[edge] = max(tgt.get(edge, 0.0), f)

    # ---- skew ------------------------------------------------------------
    rounds = [r["round"] for r in rank_rows if r["round"] is not None]
    lat_means = [
        r["round_latency"]["mean"]
        for r in rank_rows
        if r["round_latency"] and r["round_latency"]["count"]
    ]
    skew = {
        "ranks": len(rank_rows),
        "round_min": min(rounds) if rounds else None,
        "round_max": max(rounds) if rounds else None,
        "round_lag": (max(rounds) - min(rounds)) if rounds else None,
        "round_latency_mean_min_s": min(lat_means) if lat_means else None,
        "round_latency_mean_max_s": max(lat_means) if lat_means else None,
        "round_latency_skew": (
            max(lat_means) / min(lat_means)
            if lat_means and min(lat_means) > 0
            else None
        ),
    }

    # ---- slowest links ---------------------------------------------------
    links = []

    def link_row(src: str, dst: str, st: dict | None) -> dict[str, Any]:
        return {
            "src": int(src),
            "dst": int(dst),
            "probes": st["count"] if st else 0,
            "mean_latency_s": st["mean"] if st else None,
            "p99_latency_s": st["p99"] if st else None,
            "wire_bytes_per_round": link_wire.get((src, dst)),
            "wire_bytes_traced_total": link_traced.get((src, dst)),
        }

    for (src, dst), vd in link_hists.items():
        links.append(link_row(src, dst, hist_stats(vd)))
    links.sort(key=lambda r: -(r["mean_latency_s"] or 0.0))
    # edges with wire accounting but no probes still belong in the map
    probed = {(r["src"], r["dst"]) for r in links}
    for src, dst in sorted(set(link_wire) | set(link_traced)):
        if (int(src), int(dst)) not in probed:
            links.append(link_row(src, dst, None))

    # ---- stragglers / churn ---------------------------------------------
    max_round = skew["round_max"]
    stragglers = []
    for r in rank_rows:
        reasons = []
        if r["heartbeat_age_s"] > straggler_age_s:
            reasons.append(f"heartbeat stale {r['heartbeat_age_s']:.0f}s")
        if (
            max_round is not None
            and r["round"] is not None
            and max_round - r["round"] >= straggler_round_lag
        ):
            reasons.append(f"{max_round - r['round']} rounds behind")
        if reasons:
            stragglers.append({"rank": r["rank"], "reasons": reasons})
    churn = {
        "elastic_resizes_total": sum(
            _metric(s, "consensusml_elastic_resizes_total", 0.0) for s in ranks
        ),
        "joined_workers_total": sum(
            _metric(s, "consensusml_elastic_joined_workers_total", 0.0)
            for s in ranks
        ),
        "fault_rounds_total": sum(
            _metric(s, "consensusml_fault_rounds_total", 0.0) for s in ranks
        ),
        "worker_drops_total": sum(
            _metric(s, "consensusml_worker_drops_total", 0.0) for s in ranks
        ),
        "watchdog_timeouts_total": sum(
            _metric(s, "consensusml_watchdog_timeouts_total", 0.0)
            for s in ranks
        ),
        # swarm counters are REPLICATED, not per-rank: every rank's
        # controller replays the same schedule (same reason the event
        # timeline below dedups), so merge with max, not sum
        "bootstrapped_joiners_total": max(
            (
                _metric(s, "consensusml_swarm_bootstrapped_joiners_total", 0.0)
                for s in ranks
            ),
            default=0.0,
        ),
        "recovery_rounds_total": max(
            (
                _metric(s, "consensusml_swarm_recovery_rounds_total", 0.0)
                for s in ranks
            ),
            default=0.0,
        ),
    }

    # ---- membership (swarm) ---------------------------------------------
    # per-kind event counters (labeled family) + the merged event timeline
    # the ClusterWriter snapshots carry — what obs_report renders as the
    # join/drop/straggler-vs-round view
    event_counts: dict[str, float] = {}
    timeline: list[dict[str, Any]] = []
    seen_events = set()
    swarm_epoch = None
    swarm_members = None
    for s in ranks:
        for key, vd in (s.get("metrics") or {}).items():
            name, labels = parse_metric_key(key)
            if name == "consensusml_swarm_events_total" and "kind" in labels:
                f = _finite(vd)
                if f is not None:
                    # replicated across ranks (same schedule) — max, like
                    # the timeline dedup below, not a rank-count inflation
                    k = labels["kind"]
                    event_counts[k] = max(event_counts.get(k, 0.0), f)
        e = _finite(_metric(s, "consensusml_swarm_epoch"))
        if e is not None:
            swarm_epoch = max(swarm_epoch or 0, e)
        m = _finite(_metric(s, "consensusml_swarm_members"))
        if m is not None:
            swarm_members = m if swarm_members is None else max(swarm_members, m)
        for row in s.get("swarm_events", []):
            key = (
                row.get("round"), row.get("kind"),
                tuple(row.get("workers") or ()),
            )
            if key in seen_events:  # every rank replays the same schedule
                continue
            seen_events.add(key)
            timeline.append(dict(row, rank=s.get("rank")))
    timeline.sort(key=lambda r: (r.get("round") or 0, r.get("kind") or ""))
    membership = {
        "epoch": swarm_epoch,
        "active_members": swarm_members,
        "event_counts": event_counts,
        "timeline": timeline,
    }

    # ---- cluster-level health -------------------------------------------
    measured = [
        r["health"]["decay_measured"]
        for r in rank_rows
        if r["health"]["decay_measured"] is not None
    ]
    bounds = [
        r["health"]["decay_bound"]
        for r in rank_rows
        if r["health"]["decay_bound"] is not None
    ]
    health = {
        "decay_bound": bounds[0] if bounds else None,
        "decay_measured_worst": max(measured) if measured else None,
        "ranks_in_violation": sum(
            1 for r in rank_rows if (r["health"]["bound_violation"] or 0) > 0
        ),
        "anomalies_total": sum(
            r["health"]["anomalies_total"] or 0 for r in rank_rows
        ),
    }

    # ---- flight-recorder index ------------------------------------------
    flightrecs = []
    for path in sorted(
        glob.glob(os.path.join(cluster_dir, "**", "flightrec-*.json"),
                  recursive=True)
    ):
        st = os.stat(path)
        flightrecs.append(
            {
                "file": os.path.relpath(path, cluster_dir),
                "bytes": st.st_size,
                "mtime_s": st.st_mtime,
            }
        )

    # ---- non-rank roles (loadgen etc.) ----------------------------------
    other_rows = []
    for s in others:
        row = {
            "role": s.get("role"),
            "rank": s.get("rank"),
            "file": s.get("_file"),
            "heartbeat_age_s": _age_s(s, now),
            "metrics": {},
        }
        for key, vd in (s.get("metrics") or {}).items():
            if isinstance(vd, dict):
                row["metrics"][key] = hist_stats(vd)
            else:
                f = _finite(vd)
                if f is not None:
                    row["metrics"][key] = f
        other_rows.append(row)

    return {
        "time_s": now,
        "cluster_dir": os.path.abspath(cluster_dir),
        "skew": skew,
        "ranks": rank_rows,
        "links": links[: max(top_links, 0)] if top_links else links,
        "links_total": len(links),
        "health": health,
        "stragglers": stragglers,
        "churn": churn,
        "membership": membership,
        # the request plane: slowest-request exemplar table resolved
        # against the merged trace index (docs/observability.md
        # "Request tracing")
        "requests": _requests_section(ranks + others),
        # cross-rank per-round phase rows from the span digests
        "round_timeline": _round_timeline(ranks),
        # the cost plane: per-executable compiled cost/attribution rows
        # + the three-way HBM reconciliation (docs/observability.md
        # "Cost attribution"; empty/None without --cost-ledger)
        "attribution": _attribution_section(ranks + others),
        "hbm": _hbm_section(ranks + others),
        # the alert plane: fleet-wide firing alerts deduped by
        # (rule, series), worst-first, with per-series history
        # sparkline rows (docs/observability.md "Alerting & history");
        # None when no snapshot carries the sections — partial or
        # pre-alert-plane snapshots keep aggregating
        "alerts": _alerts_section(ranks + others),
        "history": _history_section(ranks + others),
        # the wide-event plane: fleet-wide per-tenant spend merged from
        # each snapshot's rollup (docs/observability.md "Wide events &
        # tenant accounting"); None when no snapshot carries one
        "tenants": _tenants_section(ranks + others),
        # the fleet plane: router stream accounting + replica table +
        # canary state from fleetctl/bench snapshots (docs/fleet.md);
        # None when no snapshot carries a fleet extra
        "fleet": _fleet_section(ranks + others),
        "flight_recorders": flightrecs,
        "clients": other_rows,
        "errors": errors,
    }
