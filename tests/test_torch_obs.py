"""The port's observability plane (``consensusml_tpu_torch.obs``) against
the reference's (``consensusml_tpu.obs``): both fed the same updates.

- metrics: the same sequences of counter, gauge and histogram updates
  (labels, NaN and infinite values, exemplars, custom buckets) give
  byte-equal Prometheus text and equal snapshots; ``parse_metric_key``
  inverts the same keys;
- history and alerts, on injected clocks: the same samples give equal
  rates, increases, quantiles, windows and queries, and the same rules
  fire, sustain and clear at the same evaluations;
- spans, request traces and wide events: the same names, nesting, event
  sequences, rollups and JSON keys (times apart);
- the flight recorder's dump and the HTTP endpoints: the same keys and
  status codes (``/profile`` captures with ``torch.profiler`` in the port);
- the lock contracts (``__guarded_by__``) of every ported class.
"""

import json
import os
import math
import urllib.error
import urllib.request

import pytest
import torch

import consensusml_tpu.obs as R
import consensusml_tpu_torch.obs as Q
from consensusml_tpu.obs import alerts as r_alerts
from consensusml_tpu.obs import events as r_events
from consensusml_tpu.obs import flight as r_flight
from consensusml_tpu.obs import history as r_history
from consensusml_tpu.obs import httpd as r_httpd
from consensusml_tpu.obs import metrics as r_metrics
from consensusml_tpu.obs import requests as r_requests
from consensusml_tpu_torch.obs import alerts as q_alerts
from consensusml_tpu_torch.obs import events as q_events
from consensusml_tpu_torch.obs import flight as q_flight
from consensusml_tpu_torch.obs import history as q_history
from consensusml_tpu_torch.obs import httpd as q_httpd
from consensusml_tpu_torch.obs import metrics as q_metrics
from consensusml_tpu_torch.obs import requests as q_requests

BOTH = [(R, r_metrics), (Q, q_metrics)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _script_basic(obs, m):
    reg = obs.MetricsRegistry()
    c = reg.counter("consensusml_rounds_total", "completed training rounds")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("consensusml_alive_frac", "alive")
    g.set(0.75)
    reg.gauge("consensusml_unset")  # NaN until set
    g2 = reg.gauge("consensusml_edge")
    g2.add(3.0)
    g2.set(float("inf"))
    h = reg.histogram("consensusml_round_latency_seconds", "round wall time")
    for v in (0.0004, 0.003, 0.3, 7.0, 400.0, 0.01):
        h.observe(v)
    return reg


def _script_labels(obs, m):
    reg = obs.MetricsRegistry()
    for src, dst, n in [(0, 1, 100), (1, 0, 250), (0, 1, 7), (3, 2, 1e9)]:
        reg.counter("consensusml_link_wire_bytes_traced_total", "bytes", labels={"src": src, "dst": dst}).inc(n)
    for t in ["a", "b\"q", "c\\d", "default"]:
        reg.counter("consensusml_tenant_requests_total", "per tenant", labels={"tenant": t}).inc()
        reg.histogram("consensusml_tenant_ttft_seconds", "ttft", buckets=m.DEFAULT_SLO_BUCKETS,
                      labels={"tenant": t}).observe(0.02, exemplar=f"req-{t}")
    reg.gauge("consensusml_serve_queue_depth").set(-0.5)
    reg.gauge("consensusml_big").set(1e16)
    reg.gauge("consensusml_small").set(1.25e-7)
    return reg


def _script_exemplars(obs, m):
    reg = obs.MetricsRegistry()
    h = reg.histogram("consensusml_serve_ttft_seconds", "ttft", buckets=m.DEFAULT_SLO_BUCKETS)
    for i in range(20):
        h.observe(0.001 * (i % 7) + 0.0001 * i, exemplar=f"lg0-{i:05d}/0")
    h.observe(3.0)  # no exemplar
    reg.histogram("consensusml_link_latency_seconds", "link", buckets=m.DEFAULT_LINK_LATENCY_BUCKETS).observe(3e-6)
    reg.histogram("consensusml_rounds_to_recover", "k", buckets=m.DEFAULT_ROUND_COUNT_BUCKETS).observe(5)
    reg.histogram("consensusml_custom", "custom", buckets=(3.0, 1.0, 2.0)).observe(2.0)
    return reg


SCRIPTS = {"basic": _script_basic, "labels": _script_labels, "exemplars": _script_exemplars}


def _strip_times(snap):
    snap = dict(snap)
    snap.pop("time_s", None)
    out = {}
    for k, v in snap["metrics"].items():
        if isinstance(v, dict) and "exemplars" in v:
            v = dict(v, exemplars=[{a: b for a, b in e.items() if a != "time_s"} for e in v["exemplars"]])
        out[k] = v
    snap["metrics"] = out
    return json.dumps(snap, sort_keys=True)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_prometheus_text_is_byte_equal(name):
    texts = [SCRIPTS[name](obs, m).to_prometheus() for obs, m in BOTH]
    assert texts[0] == texts[1]
    assert texts[1].endswith("\n") and "# TYPE" in texts[1]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_snapshots_are_equal(name):
    snaps = []
    for obs, m in BOTH:
        reg = SCRIPTS[name](obs, m)
        reg.snapshot({"round": 3})
        snaps.append([_strip_times(s) for s in reg.snapshots()] + [_strip_times(reg.snapshot())])
    assert snaps[0] == snaps[1]


def test_prometheus_textfile_and_jsonl_sinks(tmp_path):
    import io

    out = []
    for i, (obs, m) in enumerate(BOTH):
        reg = _script_labels(obs, m)
        path = reg.write_prometheus(str(tmp_path / f"m{i}.prom"))
        buf = io.StringIO()
        reg.write_jsonl_snapshot(buf, {"round": 1})
        out.append((open(path).read(), _strip_times(json.loads(buf.getvalue()))))
    assert out[0] == out[1]


@pytest.mark.parametrize("key", ['consensusml_x', 'm{src="0",dst="1"}', 'm{tenant="a,b=c"}',
                                 'm{tenant="q\\"x",k="\\\\"}', "m{}"])
def test_parse_metric_key(key):
    assert q_metrics.parse_metric_key(key) == r_metrics.parse_metric_key(key)


def test_registry_refusals_match():
    for obs, _m in BOTH:
        reg = obs.MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("x_total").inc(-1)
        with pytest.raises(ValueError):
            reg.counter("9bad")
        with pytest.raises(ValueError):
            reg.counter("y", labels={"1k": "v"})
    assert Q.DEFAULT_LATENCY_BUCKETS == R.DEFAULT_LATENCY_BUCKETS
    assert q_metrics.DEFAULT_SLO_BUCKETS == r_metrics.DEFAULT_SLO_BUCKETS
    assert Q.get_registry() is q_metrics.get_registry()


def test_lock_contracts_are_the_references():
    pairs = [(r_metrics.Counter, q_metrics.Counter), (r_metrics.Gauge, q_metrics.Gauge),
             (r_metrics.Histogram, q_metrics.Histogram), (r_metrics.MetricsRegistry, q_metrics.MetricsRegistry),
             (r_requests.RequestTraceRegistry, q_requests.RequestTraceRegistry),
             (r_events.WideEventLog, q_events.WideEventLog), (r_history.MetricsHistory, q_history.MetricsHistory),
             (r_alerts.AlertEngine, q_alerts.AlertEngine)]
    for ref, port in pairs:
        assert port.__guarded_by__ == ref.__guarded_by__, port.__name__


# ---------------------------------------------------------------------------
# history and alerts on injected clocks
# ---------------------------------------------------------------------------

def _feed(obs, m, hist_mod, alerts_mod):
    """Sixty samples: a counter, a gauge and a TTFT histogram whose tail
    breaches, recovers; rules of every kind evaluated at each sample."""
    reg = obs.MetricsRegistry()
    hist = hist_mod.MetricsHistory(reg, keep=64)
    rules = [
        alerts_mod.AlertRule("ttft-burn", "consensusml_serve_ttft_seconds", kind="burn_rate", severity="page",
                             slo=alerts_mod.SloSpec("consensusml_serve_ttft_seconds", threshold_s=0.5, objective=0.9),
                             fast_window_s=5.0, slow_window_s=15.0, burn_factor=3.0),
        alerts_mod.AlertRule("queue", "consensusml_serve_queue_depth", threshold=4.0, for_s=2.0),
        alerts_mod.AlertRule("rate", "consensusml_rounds_total", op="below", threshold=0.5, rate_window_s=5.0),
        alerts_mod.AlertRule("stale", "consensusml_heartbeat_time_seconds", kind="stale", max_age_s=10.0),
    ]
    eng = alerts_mod.AlertEngine(hist, rules=rules, registry=reg, tracer=obs.SpanTracer(enabled=False), quiet=True)
    c = reg.counter("consensusml_rounds_total")
    q = reg.gauge("consensusml_serve_queue_depth")
    hb = reg.gauge("consensusml_heartbeat_time_seconds")
    h = reg.histogram("consensusml_serve_ttft_seconds", buckets=m.DEFAULT_SLO_BUCKETS)
    trail = []
    for t in range(60):
        now = 1000.0 + t
        if t < 40:
            c.inc()
            hb.set(now)
        q.set(6.0 if 10 <= t < 20 else 1.0)
        for j in range(5):
            h.observe(2.0 if 20 <= t < 26 else 0.01 * (j + 1))
        hist.record(now=now)
        trans = eng.evaluate(now=now)
        trail.append(([(x["rule"], x["state"]) for x in trans],
                      sorted((a["rule"], a.get("severity")) for a in eng.firing())))
    queries = {
        "rate": hist.rate("consensusml_rounds_total", 10.0, now=1030.0),
        "increase": hist.increase("consensusml_rounds_total", 20.0, now=1035.0),
        "p99": hist.quantile("consensusml_serve_ttft_seconds", 0.99, 5.0, now=1024.0),
        "bad": hist.bad_fraction("consensusml_serve_ttft_seconds", 0.5, 10.0, now=1026.0),
        "query": hist.query("consensusml_serve_ttft_seconds", window_s=10.0, n=5),
        "keys": hist.keys(),
        "last": hist.last("consensusml_serve_queue_depth", 3),
    }
    snap = eng.snapshot()
    return trail, json.dumps(queries, sort_keys=True, default=str), sorted(snap), len(hist)


def test_history_and_alert_lifecycle_are_equal_on_injected_clocks():
    ref = _feed(R, r_metrics, r_history, r_alerts)
    port = _feed(Q, q_metrics, q_history, q_alerts)
    assert port == ref
    fired = {rule for trans, _ in ref[0] for rule, state in trans if state == "firing"}
    assert {"ttft-burn", "queue", "stale"} <= fired  # the script exercises the lifecycle


def test_default_ruleset_is_the_references():
    def fields(rules):
        return [{k: str(getattr(x, k)) for k in x.__dataclass_fields__} for x in rules]

    assert fields(q_alerts.default_ruleset()) == fields(r_alerts.default_ruleset())


# ---------------------------------------------------------------------------
# spans, request traces, wide events
# ---------------------------------------------------------------------------

def _spans(obs):
    t = obs.SpanTracer(capacity=16)
    with t.span("train.round", round=0):
        with t.span("gossip.round", backend="simulated"):
            with t.span("bucket.pack", buckets=2):
                pass
            with t.span("bucket.unpack"):
                pass
        t.instant("watchdog.beat", round=0)
    t.complete("round.fence", 0.001, round=0)
    off = obs.SpanTracer(enabled=False)
    with off.span("x"):
        off.complete("y", 1.0)
        off.instant("z")
    assert off.events() == []
    evs = t.events()
    chrome = t.trace_events()
    digest = t.digest()
    return ([(e["name"], e["depth"], e.get("args"), e.get("instant", False)) for e in evs],
            [(e["name"], e["ph"], sorted(e)) for e in chrome],
            sorted(digest), sorted(digest["spans"]), [sorted(r) for r in digest["rounds"]])


def test_spans_nesting_chrome_trace_and_digest_are_equal(tmp_path):
    assert _spans(Q) == _spans(R)
    t = Q.SpanTracer()
    with t.span("a"):
        pass
    doc = json.load(open(t.write_chrome_trace(str(tmp_path / "t.json"))))
    assert sorted(doc) == ["displayTimeUnit", "metadata", "traceEvents"]


def test_a_span_records_no_device_value():
    """A tensor attribute is recorded by shape: float() of a device tensor
    would synchronize."""
    t = Q.SpanTracer()
    with t.span("serve.decode_step", active=torch.ones(3)):
        pass
    assert t.events()[0]["args"]["active"] == "(3,)"


def _requests(obs, req_mod):
    reg = req_mod.RequestTraceRegistry(capacity=4, max_active=3)
    for i in range(5):
        ctx = obs.TraceContext(f"lg0-{i:05d}")
        reg.start(ctx, 4 + i, max_new_tokens=8, generation=1, tenant="a" if i % 2 else "b")
        for _ in range(20):
            reg.event(ctx.request_id, "admission.defer", reason="budget")
        reg.event(ctx.request_id, "admission", slot=0, bucket=8)
        reg.decode_ticks([ctx.request_id])
        reg.decode_ticks([ctx.request_id, "unknown"])
        reg.spec_ticks([(ctx.request_id, 3, 2)])
        if i == 2:
            reg.event(ctx.request_id, "preempt", reason="blocks_exhausted")
            reg.event(ctx.request_id, "hotswap", generation=2)
            continue  # left in flight
        reg.finish(ctx.request_id, "max_tokens", tokens=8)
    reg.start(obs.TraceContext("lg0-00001"), 3)  # superseded
    snap = reg.snapshot()

    def shape(tr):
        return ({k: v for k, v in tr.items() if k not in ("t_start_us", "t_end_us", "events")},
                [(e["name"], sorted(e)) for e in tr["events"]])

    evs = reg.trace_events()
    return ([shape(t) for t in snap["active"]], [shape(t) for t in snap["completed"]], reg.active_count(),
            [(e["name"], e["ph"]) for e in evs], sorted(snap))


def test_request_traces_are_equal():
    assert _requests(Q, q_requests) == _requests(R, r_requests)
    a, b = Q.TraceContext("t"), R.TraceContext("t")
    assert (a.trace_id, a.request_id) == (b.trace_id, b.request_id) == ("t", "t/0")
    assert Q.TraceContext.mint("srv").trace_id.startswith("srv-")
    doc = Q.merged_chrome_trace(Q.SpanTracer(), q_requests.RequestTraceRegistry())
    assert sorted(doc) == sorted(R.merged_chrome_trace(R.SpanTracer(), r_requests.RequestTraceRegistry()))


TENANTS = [None, "", "acme", "a b/c", "x" * 80, "ünï", 7, "ok-._9"]


def test_sanitize_tenant_is_the_references():
    assert [Q.sanitize_tenant(t) for t in TENANTS] == [R.sanitize_tenant(t) for t in TENANTS]


def _events(mod, path):
    log = mod.WideEventLog(capacity=5, jsonl_path=path)
    for i in range(7):
        log.emit({"trace_id": f"t{i}", "request_id": f"t{i}/0", "tenant": TENANTS[i], "prompt_len": 4 + i,
                  "tokens_out": i, "ttft_s": 0.01 * (7 - i), "tflops": 0.5, "hbm_bytes": 2e9,
                  "block_seconds": 0.25, "shared_block_seconds": float("nan"), "prefix_hit_blocks": i % 2,
                  "decode_ticks": i, "defer_ticks": 1, "preemptions": 0, "time_s": 1.0})
    log.close()
    snap = log.snapshot(last_n=3)
    snap.pop("time_s")
    return (log.emitted_total, len(log), log.tenants(), log.rollup(), log.events(2, tenant="acme"),
            json.dumps(snap, sort_keys=True), open(path).read())


def test_wide_events_rollups_and_sink_are_equal(tmp_path):
    assert _events(q_events, str(tmp_path / "q.jsonl")) == _events(r_events, str(tmp_path / "r.jsonl"))


def test_wide_event_singletons():
    q_events.reset_wide_event_log()
    assert Q.peek_wide_event_log() is None
    log = Q.get_wide_event_log()
    assert Q.peek_wide_event_log() is log and Q.get_wide_event_log() is log
    q_events.reset_wide_event_log()
    assert Q.peek_wide_event_log() is None


# ---------------------------------------------------------------------------
# the flight recorder and the HTTP plane
# ---------------------------------------------------------------------------

def _dump(obs, flight_mod, req_mod, out):
    t = obs.SpanTracer()
    with t.span("train.round", round=0):
        pass
    reg = obs.MetricsRegistry()
    reg.counter("consensusml_rounds_total").inc()
    reg.snapshot({"round": 0})
    rt = req_mod.RequestTraceRegistry()
    rt.start(obs.TraceContext("t"), 3)
    hist = obs.MetricsHistory(reg, keep=4)
    hist.record(now=1.0)
    alerts = obs.AlertEngine(hist, rules=[], registry=reg, tracer=t, quiet=True)
    log = obs.WideEventLog()
    log.emit({"tenant": "a"})
    rec = flight_mod.FlightRecorder(out, tracer=t, registry=reg, requests=rt, history=hist, alerts=alerts,
                                    events=log)
    doc = json.load(open(rec.dump("watchdog-timeout: test", detail="d")))
    return sorted(doc), [s["name"] for s in doc["spans"]], sorted(doc["request_traces"]), doc["reason"]


def test_flight_recorder_dump_is_the_references(tmp_path):
    assert _dump(Q, q_flight, q_requests, str(tmp_path / "q")) == _dump(R, r_flight, r_requests,
                                                                          str(tmp_path / "r"))


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


PATHS = ["/metrics", "/traces", "/requests", "/alerts", "/query", "/query?series=consensusml_rounds_total",
         "/query?series=nope", "/query?series=x&window=abc", "/healthz", "/events?n=2", "/events?n=x",
         "/tenants", "/nope"]


def _endpoints(obs, httpd_mod, ready):
    reg = obs.MetricsRegistry()
    reg.counter("consensusml_rounds_total").inc(3)
    t = obs.SpanTracer()
    with t.span("train.round", round=0):
        pass
    hist = obs.MetricsHistory(reg, keep=8)
    hist.record()
    alerts = obs.AlertEngine(hist, rules=[], registry=reg, tracer=t, quiet=True)
    log = obs.WideEventLog()
    log.emit({"tenant": "a", "tokens_out": 2})
    srv = httpd_mod.MetricsServer(port=0, registry=reg, tracer=t, history=hist, alerts=alerts, events=log,
                                  ready_fn=lambda: ready)
    try:
        out = {}
        for p in PATHS:
            code, body = _get(srv.url(p))
            out[p] = (code, body if p == "/metrics" else sorted(json.loads(body)))
        return out, srv.port > 0
    finally:
        srv.close()


@pytest.mark.parametrize("ready", [True, False])
def test_endpoints_give_the_references_codes_and_keys(ready):
    got, want = _endpoints(Q, q_httpd, ready), _endpoints(R, r_httpd, ready)
    assert got == want
    assert got[0]["/healthz"][0] == (200 if ready else 503)


def test_profile_answers_501(tmp_path):
    """``/profile`` no longer answers 501: it captures the live process
    with ``torch.profiler`` (the name is kept from before the cost plane
    was ported). One capture answers 200 with its trace and summary, and
    counts on ``consensusml_profile_captures_total``."""
    srv = Q.MetricsServer(port=0, registry=Q.MetricsRegistry(), profile_dir=str(tmp_path))
    try:
        code, body = _get(srv.url("/profile?ms=50"))
        doc = json.loads(body)
        assert code == 200 and os.path.exists(doc["trace_json"]) and "device_total_ms" in doc["summary"]
        text = _get(srv.url("/metrics"))[1]
        assert "consensusml_profile_captures_total 1" in text and "consensusml_profile_rejected_total 0" in text
    finally:
        srv.close()


def test_unarmed_event_endpoints_peek_and_create_nothing():
    q_events.reset_wide_event_log()
    srv = Q.MetricsServer(port=0, registry=Q.MetricsRegistry())
    try:
        assert json.loads(_get(srv.url("/events"))[1]) == {"enabled": False, "events": [], "emitted_total": 0}
        assert json.loads(_get(srv.url("/tenants"))[1]) == {"enabled": False, "tenants": {}}
        assert Q.peek_wide_event_log() is None
        assert not math.isnan(json.loads(_get(srv.url("/healthz"))[1])["time_s"])
    finally:
        srv.close()
