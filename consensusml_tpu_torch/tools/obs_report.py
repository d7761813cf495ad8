"""Render a cluster observability report from an --obs-cluster-dir (port
of ``tools/obs_report.py``: the same text and ``--json`` document from the
same snapshots).

Merges every rank's ``obs-*.json`` snapshot (and any loadgen/client
snapshots and flight-recorder dumps living in the same directory) into
one report: per-rank round/latency skew, slowest-link ranking with the
bytes each edge carries, measured-vs-bound consensus health, straggler
detection, churn counters, the swarm membership timeline
(join/drop/straggler events vs round, with each join's gossip-bootstrap
cost and epsilon), the SLOWEST-REQUEST table (SLO histogram exemplars
resolved against the merged request-trace index — client and server
sides of one request join on trace_id), the cross-rank ROUND
TIMELINE attributing straggler rounds to phase (feed vs gossip vs
compute), the fleet-wide ALERTS table (firing alerts deduped by
rule+series, worst-first, from each snapshot's alert-plane state), and
per-series history SPARKLINES (client and server TTFT side by side).
Partial snapshots degrade gracefully: a rank file missing an optional
section renders with that block marked absent, never a crash. See
docs/observability.md "Cluster view" / "Request tracing" /
"Alerting & history" and docs/elasticity.md.

    python -m consensusml_tpu_torch.tools.obs_report /shared/obs            # text report
    python -m consensusml_tpu_torch.tools.obs_report /shared/obs --json     # full JSON doc
    python -m consensusml_tpu_torch.tools.obs_report /shared/obs --top 8    # top-8 links only
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys



def _fmt_s(v) -> str:
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-"
    if v >= 1.0:
        return f"{v:.3f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def _int_or_dash(v) -> str:
    return "-" if v is None else f"{v:.0f}"


def _fmt_b(v) -> str:
    if v is None:
        return "-"
    for unit, scale in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if v >= scale:
            return f"{v / scale:.2f}{unit}"
    return f"{v:.0f}B"


def _fmt_count(v) -> str:
    """Compact count (FLOPs): 2.5G, 57M, 1.6K."""
    if v is None or (isinstance(v, float) and not math.isfinite(v)):
        return "-"
    for unit, scale in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= scale:
            return f"{v / scale:.1f}{unit}"
    return f"{v:.0f}"


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _spark(points) -> str:
    """Unicode sparkline over history-digest points ([t, v] rows; None
    values — an interval that saw nothing — render as '.')."""
    vals = [
        v
        for _t, v in points
        if isinstance(v, (int, float)) and math.isfinite(v)
    ]
    if not vals:
        return "." * min(len(points), 8)
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    out = []
    for _t, v in points:
        if not isinstance(v, (int, float)) or not math.isfinite(v):
            out.append(".")
            continue
        i = int((v - lo) / span * (len(_SPARK_GLYPHS) - 1))
        out.append(_SPARK_GLYPHS[max(0, min(i, len(_SPARK_GLYPHS) - 1))])
    return "".join(out)


# history series surfaced first in the sparkline block: the client/
# server SLO joins and the pressure signals the alert rules watch
_SPARK_PRIORITY = (
    "consensusml_serve_ttft_seconds",
    "consensusml_loadgen_ttft_seconds",
    "consensusml_serve_intertoken_seconds",
    "consensusml_loadgen_latency_seconds",
    "consensusml_serve_queue_depth",
    "consensusml_pool_blocks_free",
    "consensusml_round_latency_seconds",
    "consensusml_consensus_distance",
    "consensusml_health_decay_measured",
)


def _render_alerts(doc: dict, add) -> None:
    """The Alerts table: fleet-wide firing alerts (deduped by
    rule+series, worst-first) and recent plane events; marked absent
    when no snapshot exported the alert plane."""
    al = doc.get("alerts")
    if not al:
        add("alerts: absent (no snapshot carries an alert plane)")
        return
    if not al.get("firing"):
        add(
            f"alerts: none firing ({al.get('ranks_reporting', 0)} "
            f"snapshot(s) reporting, "
            f"{al.get('resolved_recent_total', 0)} recently resolved)"
        )
    else:
        add(
            f"alerts: {al.get('firing_total', 0)} FIRING "
            f"({al.get('ranks_reporting', 0)} snapshot(s) reporting):"
        )
        add("  sev   rule                        value      for      reporters  series")
        now = doc.get("time_s")
        for a in al["firing"]:
            dur = (
                f"{now - a['fired_s']:.0f}s"
                if now and a.get("fired_s")
                else "-"
            )
            v = a.get("value")
            add(
                f"  {str(a.get('severity')):<5} {str(a.get('rule')):<27} "
                f"{'-' if v is None else format(v, '.4g'):>9}  {dur:>7}  "
                f"{','.join(a.get('reporters') or []):<9}  "
                f"{a.get('series')}"
            )
    for ev in (al.get("events_recent") or [])[-4:]:
        add(
            f"  event [{ev.get('severity')}] {ev.get('source')} "
            f"({ev.get('reporter')}): {ev.get('message')}"
        )


def _render_history(doc: dict, add, top: int = 16) -> None:
    """Per-series sparkline summaries from the merged history digests;
    SLO/pressure families first so client-vs-server TTFT reads as two
    adjacent rows."""
    hist = doc.get("history")
    if not hist:
        add("history: absent (no snapshot carries history rings)")
        return
    rows = hist.get("series") or []
    prio = {name: i for i, name in enumerate(_SPARK_PRIORITY)}

    def fam(row):
        return str(row.get("series", "")).partition("{")[0]

    def rank_of(row):
        f = fam(row)
        if f in prio:
            return prio[f]
        # the plane's own meta-families last — real signals first
        if f.startswith(("consensusml_history_", "consensusml_alert")):
            return len(prio) + 1
        return len(prio)

    rows = sorted(
        rows,
        key=lambda r: (
            rank_of(r),
            str(r.get("series")),
            str(r.get("role") or ""),
            r.get("rank") or 0,
        ),
    )
    shown = rows[:top] if top else rows
    add(
        f"history ({hist.get('series_total', len(rows))} series from "
        f"{hist.get('ranks_reporting', 0)} snapshot(s)"
        + (f", top {len(shown)}" if len(shown) < len(rows) else "")
        + "; gauges raw, counters rate/s, histograms interval-p99):"
    )
    for r in shown:
        who = f"{r.get('role') or 'rank'}-{r.get('rank')}"
        add(
            f"  {str(r.get('series'))[:46]:<46} {who:<10} "
            f"{_spark(r.get('points') or []):<32} "
            f"last={'-' if r.get('last') is None else format(r['last'], '.4g')}"
        )


def _render_tenants(doc: dict, add) -> None:
    """The tenant cost table: fleet-wide per-tenant spend merged from
    the snapshots' wide-event rollups (tokens, ledger-joined TFLOPs and
    HBM gigabytes, pool block-seconds, worst TTFT); marked absent for
    pre-wide-event snapshots — an old directory keeps rendering."""
    tn = doc.get("tenants")
    if not tn:
        add("tenants: absent (no snapshot carries wide-event accounting)")
        return
    rows = tn.get("tenants") or {}
    add(
        f"tenant accounting ({len(rows)} tenant(s), "
        f"{tn.get('events_total', 0)} events from "
        f"{tn.get('ranks_reporting', 0)} snapshot(s)):"
    )
    add("  tenant            req   tok_in  tok_out   tflops     hbm        blk-s     worst ttft")
    for name in sorted(rows):
        r = rows[name]
        worst = (r.get("worst_ttft") or [{}])[0]
        wt = worst.get("ttft_s")
        add(
            f"  {name:<15} {r.get('requests', 0):>5}  "
            f"{r.get('tokens_in', 0):>7}  {r.get('tokens_out', 0):>7}  "
            f"{'-' if r.get('tflops') is None else format(r['tflops'], '.4g'):>7}  "
            f"{_fmt_b((r.get('hbm_gbytes') or 0.0) * 1e9):>9}  "
            f"{'-' if r.get('block_seconds') is None else format(r['block_seconds'], '.3f'):>8}  "
            f"{_fmt_s(wt)}"
            + (f" ({worst.get('request_id')})" if wt is not None else "")
        )


def _render_fleet(doc: dict, add) -> None:
    """The fleet plane: router stream accounting (accepted vs completed
    vs rejected — lost must be 0), per-replica table, canary state
    (docs/fleet.md). Rendered only when a snapshot carried a fleet
    extra, so non-fleet directories stay unchanged."""
    fl = doc.get("fleet")
    if not fl:
        return
    r = fl.get("router") or {}
    add(
        f"fleet ({fl.get('routers_reporting', 0)} router(s), "
        f"policy={r.get('policy', '?')}): "
        f"accepted={r.get('accepted', 0):g} completed={r.get('completed', 0):g} "
        f"rejected={r.get('rejected', 0):g} client_gone={r.get('client_gone', 0):g} "
        f"lost={r.get('lost_streams', 0):g} redispatches={r.get('redispatches', 0):g} "
        f"affinity_hits={r.get('affinity_hits', 0):g}"
    )
    reps = fl.get("replicas") or {}
    if reps:
        add("  replica           ready  queue  gen   hbm free")
        for name in sorted(reps):
            row = reps[name]
            add(
                f"  {name:<16} {str(bool(row.get('ready'))):>6}  "
                f"{_int_or_dash(row.get('queue_depth')):>5}  "
                f"{_int_or_dash(row.get('generation')):>3}  "
                f"{_fmt_b(row.get('hbm_free_bytes')):>9}"
            )
    canary = fl.get("canary")
    if canary:
        add(
            f"  canary: state={canary.get('state')} "
            f"replica={canary.get('replica', '-')} "
            f"target_gen={canary.get('target_generation', '-')}"
            + (
                f" reason={','.join(canary.get('reason') or [])}"
                if canary.get("reason")
                else ""
            )
        )
    for e in (fl.get("events") or [])[-8:]:
        detail = {
            k: v for k, v in e.items() if k not in ("time_s", "kind")
        }
        add(f"  event: {e.get('kind')} {json.dumps(detail, sort_keys=True)}")
    add("")


def render_text(doc: dict) -> str:
    lines: list[str] = []
    add = lines.append
    skew = doc.get("skew") or {}
    add(f"cluster report: {doc.get('cluster_dir')}")
    skew_v = skew.get("round_latency_skew")
    add(
        f"ranks={skew.get('ranks')} rounds [{skew.get('round_min')}, "
        f"{skew.get('round_max')}] lag={skew.get('round_lag')} "
        f"latency skew={skew_v and round(skew_v, 3)}"
    )
    _render_alerts(doc, add)
    add("")
    add("rank  round  age      lat(mean/p99)        consensus  decay(meas/bound)  viol")
    for r in doc.get("ranks") or []:
        lat = r.get("round_latency")
        h = r.get("health") or {}
        age = r.get("heartbeat_age_s")
        add(
            f"{_int_or_dash(r.get('rank')):>4}  {str(r.get('round')):>5}  "
            f"{'-' if age is None else format(age, '.1f'):>6}s  "
            f"{_fmt_s(lat and lat['mean']):>9}/{_fmt_s(lat and lat['p99']):<9}  "
            f"{'-' if r.get('consensus_distance') is None else format(r['consensus_distance'], '.4g'):>9}  "
            f"{'-' if h.get('decay_measured') is None else format(h['decay_measured'], '.4f'):>8}/"
            f"{'-' if h.get('decay_bound') is None else format(h['decay_bound'], '.4f'):<8}  "
            f"{int(h.get('bound_violation') or 0)}"
        )
    if doc.get("links"):
        add("")
        add(f"links (slowest first; {doc.get('links_total')} total):")
        add("  src->dst   probes  mean       p99        bytes/round")
        for l in doc["links"]:
            add(
                f"  {l['src']:>3}->{l['dst']:<3}  {l['probes']:>6}  "
                f"{_fmt_s(l['mean_latency_s']):>9}  "
                f"{_fmt_s(l['p99_latency_s']):>9}  "
                f"{_fmt_b(l['wire_bytes_per_round']):>10}"
            )
    else:
        add("links: absent (no rank exported link families)")
    h = doc.get("health") or {}
    add("")
    add(
        f"health: bound={h.get('decay_bound')} worst measured="
        f"{h.get('decay_measured_worst')} ranks_in_violation="
        f"{h.get('ranks_in_violation')} anomalies={h.get('anomalies_total')}"
    )
    if doc.get("stragglers"):
        add("stragglers:")
        for s in doc["stragglers"]:
            add(f"  rank {s['rank']}: {'; '.join(s['reasons'])}")
    else:
        add("stragglers: none")
    c = doc.get("churn") or {}
    add(
        f"churn: resizes={c.get('elastic_resizes_total', 0):.0f} "
        f"joins={c.get('joined_workers_total', 0):.0f} "
        f"fault_rounds={c.get('fault_rounds_total', 0):.0f} "
        f"drops={c.get('worker_drops_total', 0):.2f} "
        f"watchdog_timeouts={c.get('watchdog_timeouts_total', 0):.0f} "
        f"gossip_bootstraps={c.get('bootstrapped_joiners_total', 0):.0f} "
        f"recovery_rounds={c.get('recovery_rounds_total', 0):.0f}"
    )
    mem = doc.get("membership") or {}
    if not (mem.get("timeline") or mem.get("event_counts")):
        add("membership: absent (no swarm events in snapshots)")
    else:
        counts = mem.get("event_counts") or {}
        add(
            f"membership: epoch={_int_or_dash(mem.get('epoch'))} "
            f"active={_int_or_dash(mem.get('active_members'))} events=["
            + " ".join(f"{k}:{v:.0f}" for k, v in sorted(counts.items()))
            + "]"
        )
        if mem.get("timeline"):
            add("membership timeline (round : event):")
            glyph = {
                "join": "+", "drop": "x", "rejoin": "^", "straggle": "~"
            }
            for row in mem["timeline"]:
                ws = ",".join(f"w{u}" for u in (row.get("workers") or []))
                detail = row.get("detail") or {}
                extra = ""
                if "bootstrap_rounds" in detail:
                    eps = detail.get("eps_measured")
                    extra = (
                        f"  [bootstrap {detail['bootstrap_rounds']} rounds"
                        + (f", eps {eps:.2e}" if eps is not None else "")
                        + "]"
                    )
                elif "duration" in detail:
                    extra = f"  [{detail['duration']} rounds]"
                add(
                    f"  {_int_or_dash(row.get('round')):>5} : "
                    f"{glyph.get(row.get('kind'), '?')} "
                    f"{str(row.get('kind')):<8} {ws}{extra}"
                )
    req = doc.get("requests") or {}
    if not (req.get("traces_indexed") or req.get("slowest")):
        add("request traces: absent (no serving sections in snapshots)")
    else:
        add("")
        add(
            f"request traces: {req.get('traces_indexed', 0)} indexed "
            f"({req.get('in_flight', 0)} in flight)"
        )
        if req.get("slowest"):
            add("slowest requests (SLO exemplars -> traces):")
            add("  metric                               side    value      request_id            trace")
            for r in req["slowest"]:
                tr = r.get("trace") or {}
                detail = (
                    f"ok ticks={tr.get('decode_ticks', 0)}"
                    + (
                        f" defer={tr['defer_ticks']}"
                        if tr.get("defer_ticks")
                        else ""
                    )
                    + (
                        f" preempt={tr['preemptions']}"
                        if tr.get("preemptions")
                        else ""
                    )
                    if r.get("resolved")
                    else "UNRESOLVED"
                )
                add(
                    f"  {r['metric']:<36} {r['side']:<7} "
                    f"{_fmt_s(r['value_s']):>9}  "
                    f"{str(r.get('request_id')):<20}  {detail}"
                )
    timeline = doc.get("round_timeline") or []
    if not timeline:
        add("round timeline: absent (no span digests in snapshots)")
    else:
        add("")
        add("round timeline (cross-rank, straggler time by phase):")
        for row in timeline:
            ranks = " | ".join(
                f"r{r['rank']} {r['dur_ms']:.1f}ms" for r in row["ranks"]
            )
            st = row.get("straggler")
            extra = ""
            if st:
                parts = [f"feed {st['feed_ms']:.1f}"]
                if st.get("gossip_ms_est") is not None:
                    parts.append(f"gossip~{st['gossip_ms_est']:.1f}")
                    parts.append(f"compute~{st['compute_ms_est']:.1f}")
                extra = (
                    f"   straggler r{st['rank']} +{st['extra_ms']:.1f}ms "
                    f"-> {st['phase']} ({', '.join(parts)})"
                )
            add(f"  {row['round']:>5}  {ranks}{extra}")
    attribution = doc.get("attribution") or []
    if attribution:
        add("")
        add("cost attribution (compiled cost ledger, per executable):")
        add("  executable              flops      bytes      compile   expected   measured   x-floor")
        for r in attribution:
            xf = r.get("floor_ratio")
            add(
                f"  {r['executable']:<22} "
                f"{_fmt_count(r.get('flops')):>8}  "
                f"{_fmt_b(r.get('bytes_accessed')):>9}  "
                f"{_fmt_s(r.get('compile_s')):>8}  "
                f"{_fmt_s(r.get('expected_s')):>9}  "
                f"{_fmt_s(r.get('measured_s')):>9}  "
                f"{'-' if xf is None else format(xf, '.1f'):>7}"
            )
    add("")
    _render_fleet(doc, add)
    _render_tenants(doc, add)
    hbm = doc.get("hbm")
    if hbm:
        drift = hbm.get("drift_pct") or {}
        add(
            "hbm reconciliation: analytic "
            f"{_fmt_b(hbm.get('analytic_bytes'))} vs compiled "
            f"{_fmt_b(hbm.get('compiled_bytes'))} vs live "
            f"{_fmt_b(hbm.get('live_peak_bytes'))}"
            + (
                " ("
                + ", ".join(
                    f"{k} {v:+.1f}%" for k, v in sorted(drift.items())
                )
                + ")"
                if drift
                else ""
            )
        )
    add("")
    _render_history(doc, add)
    if doc.get("flight_recorders"):
        add("flight recorders:")
        for fr in doc["flight_recorders"]:
            add(f"  {fr['file']} ({fr['bytes']}B)")
    for cl in doc.get("clients") or []:
        add(f"client [{cl.get('role')}-{cl.get('rank')}]:")
        for k, v in sorted((cl.get("metrics") or {}).items()):
            if isinstance(v, dict):
                add(
                    f"  {k}: mean={_fmt_s(v['mean'])} p50={_fmt_s(v['p50'])} "
                    f"p99={_fmt_s(v['p99'])} n={v['count']}"
                )
            else:
                add(f"  {k}: {v:g}")
    for e in doc.get("errors") or []:
        add(f"unreadable snapshot: {e['_file']}: {e['_error']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("cluster_dir", help="the --obs-cluster-dir to aggregate")
    p.add_argument("--json", action="store_true", help="emit the full JSON doc")
    p.add_argument("--top", type=int, default=16, help="link-ranking depth (0 = all)")
    p.add_argument("--straggler-age", type=float, default=120.0,
                   help="heartbeat staleness (s) that flags a straggler")
    p.add_argument("--straggler-lag", type=int, default=3,
                   help="round lag that flags a straggler")
    args = p.parse_args(argv)

    if not os.path.isdir(args.cluster_dir):
        print(f"error: {args.cluster_dir} does not exist or is not a "
              "directory (pass the --obs-cluster-dir of a run)",
              file=sys.stderr)
        return 1
    from consensusml_tpu_torch.obs.cluster import aggregate

    doc = aggregate(
        args.cluster_dir,
        straggler_age_s=args.straggler_age,
        straggler_round_lag=args.straggler_lag,
        top_links=args.top,
    )
    if not doc["ranks"] and not doc["clients"]:
        print(
            f"error: no obs-*.json snapshots under {args.cluster_dir} "
            "(run python -m consensusml_tpu_torch.train with --obs-cluster-dir pointing here)",
            file=sys.stderr,
        )
        return 1
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        print(render_text(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
