"""The cluster plane in the port (``consensusml_tpu_torch.obs.health``,
``obs.links``, ``obs.cluster``, ``tools.obs_report``, the loadgen's
``--obs-snapshot`` and the train CLI's ``--link-probes`` and
``--obs-cluster-dir``) held to the reference's.

- ``decay_bound`` for every topology family equals the reference's to
  1e-12 (the port's spectral gaps); the monitor fed one distance sequence
  (a contraction, sustained growth, a NaN run, a recovery) returns the
  reference's records and sets its gauges, lenient and strict.
- The link prober ranks an injected slow transfer slowest, counts the
  edges past ``max_edges`` and, with ``local_ranks`` (one worker a
  process, the collective backend), counts every edge of another process
  as remote; its default transfer times a fenced device copy on the CPU.
  ``link_wire_bytes`` equals the reference's for exact and compressed
  engines on ring, torus, exponential, one-peer and dense graphs, and one
  worker's outgoing sum is the engine's ``wire_bytes_per_round``.
- ``aggregate`` and ``obs_report`` (text and ``--json``) from the same
  snapshot files equal the reference's: a directory of three rank
  snapshots (links with a slowed edge, health, swarm events, span
  digests, alerts and history, a stale heartbeat), a loadgen client
  snapshot with request traces and a flight-recorder dump, written once by
  the port's writers and once by the reference's; partial snapshots render
  their absent blocks; an empty or missing directory is an error.
- The loadgen CLI's ``--obs-snapshot`` against a CPU server writes an
  ``obs-loadgen-*.json`` that merges beside a rank snapshot.
- The train CLI on both backends (the collective one on ``gloo`` ranks)
  writes a rank snapshot a rank with the link and health families; every
  edge of a collective run is remote (the reference's multi-controller
  rule).
"""

import importlib.util
import json
import math
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from consensusml_tpu import obs as jobs
from consensusml_tpu import topology as jtopology
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossipConfig
from consensusml_tpu.compress import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.obs import links as jlinks
from consensusml_tpu_torch import obs, topology
from consensusml_tpu_torch.compress import topk_int8_compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.obs import links
from consensusml_tpu_torch.tools import obs_report

_spec = importlib.util.spec_from_file_location("ref_obs_report", Path(__file__).resolve().parents[1] / "tools" /
                                               "obs_report.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

FAMILIES = [("ring", 8), ("torus", 8), ("dense", 6), ("exp", 8), ("onepeer-exp", 8),
            ("hierarchical", 8, {"slices": 2, "outer_every": 2}), ("ring", 2), ("onepeer-exp", 6)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topos(case):
    name, world, *kw = case
    kw = kw[0] if kw else {}
    return topology.topology_from_name(name, world, **kw), jtopology.topology_from_name(name, world, **kw)


# ---------------------------------------------------------------------------
# consensus health
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FAMILIES, ids=[f"{c[0]}-{c[1]}" for c in FAMILIES])
def test_decay_bound_equals_the_reference(case):
    mine, theirs = _topos(case)
    assert obs.decay_bound(mine) == pytest.approx(jobs.decay_bound(theirs), abs=1e-12)


DISTANCES = [1.0, 0.8, 0.65, 0.6, 0.7, 0.9, 1.2, 1.6, 2.1, 1.0, float("nan"), float("nan"), float("nan"), 0.5,
             0.4, 0.3, float("inf"), 0.2]


@pytest.mark.parametrize("strict", [False, True], ids=["lenient", "strict"])
def test_health_monitor_follows_the_reference(strict, capsys):
    mine, theirs = _topos(("ring", 8))
    reg, jreg = obs.MetricsRegistry(), jobs.MetricsRegistry()
    m = obs.ConsensusHealthMonitor(mine, registry=reg, tracer=obs.SpanTracer(), strict=strict)
    j = jobs.ConsensusHealthMonitor(theirs, registry=jreg, tracer=jobs.SpanTracer(), strict=strict)
    for rnd, d in enumerate(DISTANCES):
        got, want = m.observe(rnd, d), j.observe(rnd, d)
        assert (got is None) == (want is None), rnd
        if got is not None:
            assert got.keys() == want.keys()
            for k in got:
                assert got[k] == pytest.approx(want[k], nan_ok=True), (rnd, k)
    assert len(m.anomalies) == len(j.anomalies) > 0
    for fam in ("consensusml_health_bound_violation", "consensusml_health_decay_bound",
                "consensusml_health_decay_measured", "consensusml_health_consensus_distance"):
        assert reg.gauge(fam).value == pytest.approx(jreg.gauge(fam).value, nan_ok=True), fam
    assert reg.counter("consensusml_health_anomalies_total").value == \
        jreg.counter("consensusml_health_anomalies_total").value
    err = capsys.readouterr().err
    assert err.count("consensus-health ANOMALY") == 2 * m._m_anomalies.value


def test_health_routes_through_the_alert_engine():
    reg = obs.MetricsRegistry()
    alerts = obs.AlertEngine(obs.MetricsHistory(reg), rules=[], registry=reg, tracer=obs.SpanTracer(), quiet=True)
    mon = obs.ConsensusHealthMonitor(topology.RingTopology(4), registry=reg, tracer=obs.SpanTracer(), sustain=2,
                                      alerts=alerts)
    for rnd, d in enumerate([0.5, 1.0, 2.0]):
        mon.observe(rnd, d)
    events = alerts.snapshot()["events_recent"]
    assert [e["source"] for e in events] == ["consensus-health"] and "ANOMALY" in events[0]["message"]


# ---------------------------------------------------------------------------
# link probes
# ---------------------------------------------------------------------------


def test_slowed_link_is_ranked_slowest():
    reg = obs.MetricsRegistry()

    def transfer(src, dst):
        if (src, dst) == (2, 3):
            time.sleep(0.02)  # well past a loaded host's scheduling jitter

    prober = obs.LinkProber(topology.RingTopology(4), registry=reg, transfer=transfer)
    assert len(prober.edges) == 8 and prober.skipped_edges == 0 and prober.remote_edges == 0
    for _ in range(3):
        prober.probe_round()
    top = prober.slowest(1)[0]
    assert (top["src"], top["dst"]) == (2, 3) and top["probes"] == 3
    text = reg.to_prometheus()
    assert 'consensusml_link_latency_seconds_bucket{dst="3"' in text
    assert "consensusml_link_probe_rounds_total 3" in text
    assert 'consensusml_link_bandwidth_bytes_per_sec{dst="0",src="1"}' in text


def test_link_prober_counts_skipped_and_remote_edges():
    reg = obs.MetricsRegistry()
    prober = obs.LinkProber(topology.RingTopology(6), registry=reg, max_edges=4, transfer=lambda s, d: None)
    assert len(prober.edges) == 4 and prober.skipped_edges == 8
    assert reg.gauge("consensusml_link_edges_skipped").value == 8
    # one worker a process: every edge has an endpoint in another process
    for rank in range(3):
        reg = obs.MetricsRegistry()
        prober = obs.LinkProber(topology.RingTopology(8), registry=reg, device="cpu", local_ranks=[rank])
        assert prober.edges == [] and prober.remote_edges == 16
        assert reg.gauge("consensusml_link_edges_remote").value == 16 and prober.probe_round() == {}
    # two workers a process: their shared edges are probed, the rest remote
    prober = obs.LinkProber(topology.RingTopology(8), registry=obs.MetricsRegistry(), device="cpu",
                            local_ranks=[0, 1])
    assert sorted(prober.edges) == [(0, 1), (1, 0)] and prober.remote_edges == 14


def test_default_transfer_times_a_fenced_copy():
    reg = obs.MetricsRegistry()
    prober = obs.LinkProber(topology.RingTopology(4), registry=reg, device="cpu", payload_bytes=1 << 12)
    lat = prober.probe_round()
    assert set(lat) == set(prober.edges) and all(v > 0 for v in lat.values())
    assert reg.gauge("consensusml_link_probe_payload_bytes").value == 4096


LEAVES = {"w": (256, 64), "b": (64,), "v": (96, 33)}


@pytest.mark.parametrize("compressed", [False, True], ids=["exact", "choco"])
@pytest.mark.parametrize("case", FAMILIES[:6], ids=[c[0] for c in FAMILIES[:6]])
def test_link_wire_bytes_equal_the_reference(case, compressed):
    mine, theirs = _topos(case)
    codec = dict(compressor=topk_int8_compressor(ratio=0.1, chunk=128, impl="auto"), gamma=0.5) if compressed else {}
    jcodec = dict(compressor=jax_topk_int8(ratio=0.1, chunk=128, impl="auto"), gamma=0.5) if compressed else {}
    eng = ConsensusEngine(GossipConfig(topology=mine, **codec))
    jeng = JaxEngine(JaxGossipConfig(topology=theirs, **jcodec))
    shapes = {k: torch.empty(s, device="meta") for k, s in LEAVES.items()}
    jshapes = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in LEAVES.items()}
    got = links.link_wire_bytes(eng, shapes)
    assert got == jlinks.link_wire_bytes(jeng, jshapes)
    assert links.edge_sends_per_round(mine) == jlinks.edge_sends_per_round(theirs)
    if not mine.uses_psum and not mine.is_time_varying:
        for rank in range(mine.world_size):
            out = sum(b for (s, _), b in got.items() if s == rank)
            assert out == pytest.approx(eng.wire_bytes_per_round(shapes))


# ---------------------------------------------------------------------------
# snapshots, the aggregate and the report
# ---------------------------------------------------------------------------

NOW = 1_800_000_000.0


def _write_dir(mod, path, rounds_by_rank=(10, 10, 6)):
    """A cluster directory written by ``mod``'s writers (the port's obs or
    the reference's): three ranks, a loadgen client, a flight dump."""
    for rank, rounds in enumerate(rounds_by_rank):
        reg = mod.MetricsRegistry()
        reg.counter("consensusml_rounds_total").inc(rounds)
        h = reg.histogram("consensusml_round_latency_seconds")
        for i in range(rounds):
            h.observe(0.1 * (1 + rank) + 0.001 * i)
        reg.gauge("consensusml_round_progress").set(rounds - 1)
        reg.counter("consensusml_elastic_resizes_total").inc(1)
        reg.counter("consensusml_elastic_joined_workers_total").inc(2)
        topo = (topology if mod is obs else jtopology).RingTopology(4)
        mon = mod.ConsensusHealthMonitor(topo, registry=reg, tracer=mod.SpanTracer())
        for r, d in enumerate([1.0, 0.9, 0.85, 0.8][: 2 + rank]):
            mon.observe(r, d)
        reg.gauge("consensusml_consensus_distance").set(0.8)

        def transfer(src, dst, rank=rank):
            # the slowed edge well past a loaded host's scheduling jitter
            time.sleep(0.05 if (src, dst) == (1, 2) else 0.0001 * (1 + ((src + dst + rank) % 3)))

        prober = mod.LinkProber(topo, registry=reg, transfer=transfer)
        prober.probe_round()
        for (src, dst), _ in list(prober._stats.items()):
            reg.gauge("consensusml_link_wire_bytes_per_round", labels={"src": src, "dst": dst}).set(4096.0)
        tracer = mod.SpanTracer()
        tracer.enabled = True
        tracer.complete("gossip.round", 0.02)
        tracer.complete("train.inner_loop", 0.06)
        for r in range(3):
            tracer.complete("round.feed", 0.001 * (1 + rank), round=r)
            tracer.complete("round.fence", 0.01, round=r)
            tracer.complete("train.round", 0.1 * (1 + rank), round=r)
        history = mod.MetricsHistory(reg, keep=16)
        alerts = mod.AlertEngine(history, registry=reg, tracer=tracer, quiet=True)
        for _ in range(3):
            history.record()
            alerts.evaluate()
        w = mod.ClusterWriter(str(path), rank=rank, registry=reg, world_size=4, tracer=tracer, history=history,
                              alerts=alerts)
        if rank == 0:
            for row in ({"round": 1, "kind": "join", "workers": [4, 5], "epoch": 0,
                         "detail": {"bootstrap_rounds": 6, "eps_measured": 3.1e-8}},
                        {"round": 2, "kind": "drop", "workers": [3], "epoch": 1},
                        {"round": 3, "kind": "straggle", "workers": [5], "epoch": 2, "detail": {"duration": 2}},
                        {"round": 4, "kind": "rejoin", "workers": [3], "epoch": 3}):
                w.record_event(row)
        w.write(round=rounds - 1)
        doc = json.load(open(w.path))
        doc["heartbeat_s"] = NOW - (500.0 if rank == 2 else 1.0 + rank)
        json.dump(doc, open(w.path, "w"))
    # a loadgen client with exemplar-bearing SLOs and its request traces
    reg = mod.MetricsRegistry()
    reqs = mod.RequestTraceRegistry()
    for i, ttft in enumerate([0.05, 0.4, 0.12]):
        rid = f"req-{i}"
        reqs.start(mod.TraceContext(f"lg0-{i:05d}", rid), 8 + i)
        reqs.event(rid, "admitted")
        reqs.finish(rid, "length")
        reg.histogram("consensusml_loadgen_ttft_seconds").observe(ttft, exemplar=rid)
        reg.histogram("consensusml_loadgen_latency_seconds").observe(4 * ttft, exemplar=rid)
    mod.ClusterWriter(str(path), rank=0, role="loadgen", registry=reg).write(
        extra={"report": {"completed": 3, "errors": 0}, "request_traces": reqs.snapshot()})
    rec = mod.FlightRecorder(str(path), tracer=mod.SpanTracer(), registry=mod.MetricsRegistry())
    rec.dump("unit-test")


def _freeze_time(monkeypatch):
    import consensusml_tpu.obs.cluster as jc
    import consensusml_tpu_torch.obs.cluster as pc

    class _T:
        @staticmethod
        def time():
            return NOW

    monkeypatch.setattr(pc, "time", _T)
    monkeypatch.setattr(jc, "time", _T)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_aggregate_and_report_equal_the_reference(writer, tmp_path, monkeypatch, capsys):
    _write_dir(obs if writer == "port" else jobs, tmp_path)
    doc = obs.aggregate(str(tmp_path), now=NOW)
    assert doc == jobs.aggregate(str(tmp_path), now=NOW)
    assert len(doc["ranks"]) == 3 and len(doc["clients"]) == 1 and len(doc["flight_recorders"]) == 1
    assert (doc["links"][0]["src"], doc["links"][0]["dst"]) == (1, 2)
    assert [s["rank"] for s in doc["stragglers"]] == [2]
    assert len(doc["membership"]["timeline"]) == 4 and doc["round_timeline"]
    assert doc["requests"]["traces_indexed"] == 3 and doc["fleet"] is None and doc["hbm"] is None
    assert doc["alerts"] is not None and doc["history"]["series"] and doc["health"]["decay_bound"] is not None
    assert obs_report.render_text(doc) == R.render_text(doc)
    _freeze_time(monkeypatch)
    for argv in ([str(tmp_path)], [str(tmp_path), "--json"], [str(tmp_path), "--top", "3"]):
        assert obs_report.main(argv) == 0
        got = capsys.readouterr().out
        assert R.main(argv) == 0
        assert got == capsys.readouterr().out, argv


def test_partial_snapshots_render_absent_blocks(tmp_path, monkeypatch, capsys):
    (tmp_path / "obs-rank-00000.json").write_text(json.dumps({"rank": 0, "role": "rank", "heartbeat_s": NOW}))
    (tmp_path / "obs-rank-00001.json").write_text(json.dumps({"rank": 1, "role": "rank", "round": 3,
                                                              "metrics": None}))
    (tmp_path / "obs-rank-00002.json").write_text("{not json")
    _freeze_time(monkeypatch)
    assert obs_report.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for block in ("alerts: absent", "links: absent", "request traces: absent", "round timeline: absent",
                  "membership: absent", "history: absent", "unreadable snapshot: obs-rank-00002.json"):
        assert block in out, block
    assert R.main([str(tmp_path)]) == 0
    assert capsys.readouterr().out == out


def test_report_refuses_an_empty_or_missing_directory(tmp_path, capsys):
    assert obs_report.main([str(tmp_path)]) == 1
    assert "no obs-" in capsys.readouterr().err
    assert obs_report.main([str(tmp_path / "nope")]) == 1
    assert "does not exist" in capsys.readouterr().err


def test_loadgen_obs_snapshot_merges_beside_the_ranks(tmp_path, capsys):
    from consensusml_tpu_torch.serve import Engine, ServeConfig, ServeServer
    from consensusml_tpu_torch.tools import loadgen
    from test_torch_serve import _models

    _write_dir(obs, tmp_path, rounds_by_rank=(4,))
    for f in tmp_path.iterdir():
        if f.name.startswith(("obs-loadgen", "flightrec")):
            f.unlink()
    _j, _p, tmodel = _models()
    eng = Engine(tmodel, ServeConfig(num_slots=4, block_size=8), device="cpu")
    eng.warmup()
    server = ServeServer(eng)
    try:
        host, port = server.address
        argv = ["--connect", f"{host}:{port}", "--requests", "6", "--rate", "200", "--prompt-len", "4:12",
                "--max-new", "4", "--seed", "3", "--obs-snapshot", str(tmp_path)]
        assert loadgen.main(argv) == 0
    finally:
        server.shutdown()
    out = capsys.readouterr().out
    assert f"obs snapshot: {tmp_path / 'obs-loadgen-00003.json'}" in out
    doc = obs.aggregate(str(tmp_path))
    (client,) = doc["clients"]
    assert client["role"] == "loadgen" and len(doc["ranks"]) == 1
    ttft = client["metrics"]["consensusml_loadgen_ttft_seconds"]
    assert ttft["count"] >= 6 and math.isfinite(ttft["p99"])
    assert "consensusml_loadgen_ttft_seconds" in {r["series"] for r in doc["history"]["series"]}
    assert obs_report.main([str(tmp_path)]) == 0
    assert "loadgen" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the train CLI, both backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["simulated", "collective"])
def test_train_cli_writes_rank_snapshots(backend, tmp_path, capfd):
    from consensusml_tpu_torch.comm.launch import launch
    from consensusml_tpu_torch.train import collective
    from consensusml_tpu_torch.train.__main__ import main, parse_args

    d = tmp_path / "obs"
    argv = ["--device", "cpu", "--config", "mnist_mlp", "--workers", "4", "--rounds", "3", "--telemetry-every", "2",
            "--link-probes", "--obs-cluster-dir", str(d), "--topology", "ring",
            "--metrics-prom", str(tmp_path / "m.prom")]
    tracer = obs.get_tracer()
    try:
        if backend == "simulated":
            assert main(argv) == 0
        else:
            spec = {**vars(parse_args(argv + ["--backend", "collective", "--dist-backend", "gloo"])), "workers": 4,
                    "sched_start": 0}
            launch(collective.train_runs, 4, [spec], threads=1)
    finally:
        tracer.clear()
    out = capfd.readouterr().out
    edges = 8 if backend == "simulated" else 0
    assert f"link probes armed: {edges} edges (65536 B payload)" in out
    assert f"cluster snapshots: {d / 'obs-rank-00000.json'}" in out
    text = open(tmp_path / "m.prom").read()
    assert "# TYPE consensusml_health_decay_bound gauge" in text and "consensusml_link_wire_bytes_per_round{" in text
    doc = obs.aggregate(str(d))
    ranks = 1 if backend == "simulated" else 4
    assert [r["rank"] for r in doc["ranks"]] == list(range(ranks))
    assert all(r["round"] == 2 for r in doc["ranks"]) and doc["stragglers"] == []
    assert doc["health"]["decay_bound"] == pytest.approx(obs.decay_bound(topology.RingTopology(4)))
    for snap in obs.read_snapshots(str(d)):
        m = snap["metrics"]
        assert m["consensusml_link_edges"] == edges and m["consensusml_link_edges_remote"] == 8 - edges
    probed = [link for link in doc["links"] if link["probes"] > 0]
    assert len(probed) == edges and all(link["wire_bytes_per_round"] for link in doc["links"])
    assert obs_report.main([str(d)]) == 0
