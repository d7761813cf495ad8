"""The serving engine's telemetry against the reference's.

The same f32 tiny GPT-2 (numpy-seeded parameters loaded into both
packages) serves the same greedy requests, one at a time, through the JAX
``Engine`` (paged) and the port's on the CPU, with the prefix cache on
(a miss, a copy-on-write full match, a partial match, another tenant's
miss) and three tenants, speculatively (k = 2, the target as its own
draft: every round also decodes a token, so the step's families are the
plain decode's plus the speculative ones).
Each request carries the same ``TraceContext``. Held equal:

- every ``consensusml_serve_*``, ``consensusml_prefix_*``,
  ``consensusml_spec_*`` and ``consensusml_tenant_*`` counter's increase
  (the block-seconds, wall-clock integrals, apart), and the TTFT,
  inter-token and prefill histograms' counts;
- each request's trace: its events' names in order, its decode, defer and
  speculative counts;
- each wide event's deterministic fields (times and the attention tier's
  name apart): one event a terminal request;
- the port's ``ServeServer(metrics_port=0)``: ``/healthz`` 503 before the
  warmup and 200 after, and the endpoints' keys.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

import consensusml_tpu.obs as R
import consensusml_tpu_torch.obs as Q
from consensusml_tpu.serve import Engine as JaxEngine
from consensusml_tpu.serve import ServeConfig as JaxServeConfig
from consensusml_tpu.serve.pool import SpecConfig as JaxSpecConfig
from consensusml_tpu_torch.serve import Engine, ServeConfig, ServeServer
from consensusml_tpu_torch.serve import pool as P
from test_torch_serve import _models

PROMPTS = [list(range(10, 26)), list(range(10, 26)), list(range(10, 26)) + [5, 6, 7], list(range(10, 26)), [9] * 5]
# the prefix cache is namespaced by tenant: tenant b's copy of the prompt misses
TENANTS = ["a", "a", "a", "b", None]
MAX_NEW = 6
FAMILIES = ("consensusml_serve_", "consensusml_prefix_", "consensusml_spec_", "consensusml_tenant_",
            "consensusml_pool_evictions")
DETERMINISTIC = ("trace_id", "request_id", "tenant", "finish_reason", "prompt_len", "tokens_out", "decode_ticks",
                 "defer_ticks", "preemptions", "generation", "spec_proposed", "spec_accepted", "prefix_hit_blocks",
                 "kv_impl", "prefill_buckets", "flops", "hbm_bytes", "tflops", "cost_joined")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters(obs):
    out = {}
    for m in obs.get_registry().metrics():
        if not m.name.startswith(FAMILIES) or "block_seconds" in m.name:  # hold times are wall clock
            continue
        if m.kind == "counter":
            out[m.key] = m.value
        elif m.kind == "histogram":
            out[m.key + ":count"] = m.count
    return out


def _serve(engine, obs, tag):
    log = engine._events  # the global log the engine armed
    seen = log.emitted_total
    before = _counters(obs)
    results = []
    with engine:  # no warmup: each side compiles or builds what the requests use
        for i, (ids, tenant) in enumerate(zip(PROMPTS, TENANTS)):
            ctx = obs.TraceContext(f"{tag}-{i:03d}")
            results.append(engine.submit(ids, MAX_NEW, trace=ctx, tenant=tenant).result(timeout=120))
    after = _counters(obs)
    delta = {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}
    reg = obs.get_request_registry()
    traces = []
    for r in results:
        tr = reg.get(r.request_id)
        traces.append(([e["name"] for e in tr.events], tr.decode_ticks, tr.defer_ticks, tr.spec_proposed,
                       tr.spec_accepted, tr.finish_reason, tr.tenant))
    assert log.emitted_total - seen == len(PROMPTS)
    evs = [{k: e[k] for k in DETERMINISTIC} | {"stages": sorted(e["stages_us"])}
           for e in log.events(len(PROMPTS))]
    return [r.tokens for r in results], delta, traces, evs, results


@pytest.fixture(scope="module")
def served():
    k = 2
    jmodel, params, tmodel = _models()
    jcfg = JaxServeConfig(num_slots=2, max_len=32, kv_impl="paged", block_size=8, prefix_cache=True)
    jspec = JaxSpecConfig(model=jmodel, params=params, k=k) if k else None
    ref = _serve(JaxEngine(jmodel, params, jcfg, spec_decode=jspec), R, f"t{k}")
    import copy

    tspec = P.SpecConfig(model=copy.deepcopy(tmodel), k=k) if k else None
    port = _serve(Engine(tmodel, ServeConfig(num_slots=2, block_size=8, prefix_cache=True), device="cpu",
                         spec_decode=tspec), Q, f"t{k}")
    return k, ref, port


def test_streams_are_the_references(served):
    _k, ref, port = served
    assert port[0] == ref[0]


def test_serving_counters_and_histogram_counts_equal_the_references(served):
    k, ref, port = served
    assert port[1] == ref[1]
    d = port[1]
    assert d["consensusml_serve_completed_total"] == len(PROMPTS)
    assert d["consensusml_prefix_hits_total"] == 2 and d["consensusml_prefix_cow_copies_total"] == 1
    assert d['consensusml_tenant_requests_total{tenant="default"}'] == 1
    assert d["consensusml_spec_rounds_total"] > 0 and d["consensusml_serve_intertoken_seconds:count"] > 0


def test_request_traces_equal_the_references(served):
    _k, ref, port = served
    assert port[2] == ref[2]
    names = port[2][0][0]
    assert names[:3] == ["submit", "admission", "prefill"] and names[-1] == "complete"


def test_one_wide_event_a_request_with_the_references_fields(served):
    _k, ref, port = served
    assert port[3] == ref[3]
    assert len(port[3]) == len(PROMPTS)
    assert all(e["cost_joined"] is False and e["flops"] == 0.0 for e in port[3])
    res = port[4]
    assert [r.tenant for r in res] == ["a", "a", "a", "b", "default"]
    assert [r.trace_id for r in res] == [e["trace_id"] for e in port[3]]
    assert res[1].prefix_hit_blocks == 2 and res[0].block_seconds > 0


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_metrics_port_health_and_endpoints():
    _j, _p, tmodel = _models()
    eng = Engine(tmodel, ServeConfig(num_slots=2, block_size=8), device="cpu")
    server = ServeServer(eng, metrics_port=0, obs_tick_s=0.05)
    try:
        host, port = server.metrics_address
        base = f"http://{host}:{port}"
        assert _get(base + "/healthz")[0] == 503  # not warm yet
        eng.warmup()
        code, body = _get(base + "/healthz")
        assert code == 200 and json.loads(body)["ready"] is True
        eng.submit(PROMPTS[3], 3, tenant="acme").result(timeout=60)
        text = _get(base + "/metrics")[1]
        assert "# TYPE consensusml_serve_ttft_seconds histogram" in text
        assert 'consensusml_tenant_requests_total{tenant="acme"}' in text
        assert json.loads(_get(base + "/tenants")[1])["tenants"]["acme"]["requests"] >= 1
        assert "events" in json.loads(_get(base + "/events?n=1&tenant=acme")[1])
        assert {"active", "completed"} <= set(json.loads(_get(base + "/requests")[1]))
        assert json.loads(_get(base + "/alerts")[1])["enabled"] is True
        assert _get(base + "/profile?ms=50")[0] == 200  # a torch.profiler capture of the live engine
    finally:
        server.shutdown()
    assert server.metrics is not None and not eng._thread.is_alive()
