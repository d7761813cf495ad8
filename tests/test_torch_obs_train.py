"""The trainer's and the gossip's telemetry against the reference's.

- The train CLI, ``mnist_mlp`` smoke on a ring for two rounds with every
  sink on, on both packages: the same counters (rounds, wire bytes, the
  round latency histogram's count, the ``*_traced_total`` counters), the
  same engine gauges, and round 0's spans named and nested as the
  reference's trace-time spans (the port records them every round).
- The ``*_traced_total`` counters of whole runs: the reference counts
  while jit traces a gossip program (here: ``lower()`` of its jitted
  round, under ``shard_map`` on the 8 virtual CPU devices for the
  collective backend), the port in the first run of each distinct
  program; over rounds that visit every phase and branch the totals
  match, per directed edge too.
- ``record_fault_metrics`` under the same passed-in masks.
- The port's sinks: the Prometheus file, the Chrome trace, the flight
  recorder's dump on a watchdog timeout, the collective backend's
  per-rank files, ``RoundTimer`` and ``fence``.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import consensusml_tpu.obs as R
import consensusml_tpu_torch.obs as Q
from consensusml_tpu.analysis.jaxpr_contracts import _shard_map_no_check
from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import simulated as jax_simulated
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress.reference import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.consensus import record_fault_metrics as r_record
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.consensus import record_fault_metrics as q_record
from consensusml_tpu_torch.train.__main__ import main as port_main
from consensusml_tpu_torch.utils import tree as T
from consensusml_tpu_torch.utils.profiling import RoundTimer, fence
from consensusml_tpu_torch.utils.watchdog import ProgressWatchdog
from consensusml_tpu_torch.topology import topology_from_name

CLI = ["--config", "mnist_mlp", "--device", "cpu", "--rounds", "2", "--topology", "ring", "--telemetry-every", "1",
       "--log-every", "100"]
COUNTERS = ["consensusml_rounds_total", "consensusml_wire_bytes_total", "consensusml_ppermutes_traced_total",
            "consensusml_wire_fused_encodes_traced_total", "consensusml_wire_fused_decodes_traced_total"]
GAUGES = ["consensusml_wire_bytes_per_round", "consensusml_wire_bytes_per_neighbor", "consensusml_gossip_buckets",
          "consensusml_compression_ratio", "consensusml_neighbor_sends_per_round", "consensusml_wire_fused_buckets",
          "consensusml_wire_fused_kernel_calls_per_round", "consensusml_gossip_pipeline_depth",
          "consensusml_round_progress"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(obs, pred=lambda name: True):
    return {m.key: (m.count if hasattr(m, "count") else m.value)
            for m in obs.get_registry().metrics() if pred(m.name)}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items() if v != before.get(k, 0.0)}


def _run(main, obs, argv):
    obs.get_tracer().clear()
    before = _values(obs)
    assert main(argv) == 0
    after = _values(obs)
    return before, after, obs.get_tracer().events()


def _round0(events):
    out = []
    for e in events:
        out.append((e["name"], e["depth"]))
        if e["name"] == "round.fence":
            return out
    raise AssertionError("no round 0 in the ring")


def _cli_child(tmp):
    """Both CLI runs in this (fresh) interpreter; their metric values
    before and after and their spans go to ``tmp/runs.json``."""
    import train as ref_train

    runs = {}
    for name, main, obs, extra in [("ref", ref_train.main, R, ["--backend", "simulated"]),
                                   ("port", port_main, Q, [])]:
        argv = CLI + extra + ["--trace-events", os.path.join(tmp, f"{name}.json"),
                              "--metrics-prom", os.path.join(tmp, f"{name}.prom")]
        runs[name] = _run(main, obs, argv)
    with open(os.path.join(tmp, "runs.json"), "w") as f:
        json.dump(runs, f, default=str)


@functools.lru_cache(maxsize=None)
def _cli_runs(tmp):
    """The two CLI runs in a fresh interpreter: a cold jit cache (the
    reference records its round-0 spans when jit traces), registries no
    earlier test has fed, and streams no earlier test has captured."""
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; import jax; "
            "jax.config.update('jax_platforms', 'cpu'); import test_torch_obs_train as t; t._cli_child(sys.argv[3])")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    if "xla_force_host_platform_device_count" not in env.get("XLA_FLAGS", ""):
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run([sys.executable, "-c", code, root, os.path.join(root, "tests"), tmp], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(tmp, "runs.json")) as f:
        return {name: tuple(run) for name, run in json.load(f).items()}


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    return tmp, _cli_runs(tmp)


def test_cli_counters_gauges_and_histogram_equal_the_references(cli):
    _tmp, runs = cli
    (rb, ra, _), (qb, qa, _) = runs["ref"], runs["port"]
    for key in COUNTERS + ["consensusml_round_latency_seconds"]:
        assert qa.get(key, 0.0) - qb.get(key, 0.0) == ra.get(key, 0.0) - rb.get(key, 0.0), key
    assert qa["consensusml_rounds_total"] - qb.get("consensusml_rounds_total", 0.0) == 2
    for key in GAUGES:
        assert qa[key] == ra[key], key


def test_cli_round0_spans_nest_as_the_references(cli):
    _tmp, runs = cli
    want = _round0(runs["ref"][2])
    assert _round0(runs["port"][2]) == want
    assert ("gossip.round", 1) in want and ("bucket.pack", 2) in want
    # the port's spans fire every round: round 1 nests as round 0
    port = runs["port"][2]
    assert [(e["name"], e["depth"]) for e in port[len(want):2 * len(want)]] == want


def test_cli_sinks_parse(cli):
    tmp, runs = cli
    doc = json.load(open(os.path.join(tmp, "port.json")))
    rounds = [e for e in doc["traceEvents"] if e.get("name") == "train.round"]
    assert [e["args"]["round"] for e in rounds] == [0, 1]
    g = next(e for e in doc["traceEvents"] if e.get("name") == "gossip.round")
    pack = next(e for e in doc["traceEvents"] if e.get("name") == "bucket.pack")
    assert g["ts"] <= pack["ts"] and pack["ts"] + pack["dur"] <= g["ts"] + g["dur"] + 1e-3
    text = open(os.path.join(tmp, "port.prom")).read()
    for family in ("consensusml_round_latency_seconds histogram", "consensusml_wire_bytes_total counter",
                   "consensusml_consensus_distance gauge", "consensusml_rounds_total counter"):
        assert f"# TYPE {family}" in text
    # every family the reference's run registered, the port's run exports,
    # but the planes the port has not taken yet (consensus health)
    rb, ra, _ = runs["ref"]
    added = {Q.parse_metric_key(k)[0] for k in ra if k not in rb}
    exported = {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")}
    assert added and not {f for f in added - exported if "health" not in f}


# ---------------------------------------------------------------------------
# the trace-time counters of whole runs
# ---------------------------------------------------------------------------

WORLD = 4
# name -> (topology, codec, engine kwargs, round counters): every phase and
# branch of the program is visited by the rounds
TRACED_CASES = {
    "exact_ring": ("ring", None, {}, [0]),
    "exact_onepeer": ("onepeer-exp", None, {}, [0, 1]),
    "int8_onepeer_warm": ("onepeer-exp", "int8", {"codec_warmup_rounds": 2}, [0, 1, 2, 3]),
    "topk_ring_warm": ("ring", "topk_int8", {"codec_warmup_rounds": 1}, [0, 1]),
}


def _engines(name):
    topo, codec, kwargs, _steps = TRACED_CASES[name]
    jcomp = tcomp = None
    if codec == "int8":
        jcomp, tcomp = JaxInt8(chunk=128, impl="interpret"), PallasInt8Compressor(chunk=128)
    elif codec == "topk_int8":
        jcomp = jax_topk_int8(chunk=128, k=13, impl="interpret")
        tcomp = topk_int8_compressor(chunk=128, k=13, impl="auto")
    common = dict(gamma=0.5, bucket_bytes=3000, **kwargs)
    return (JaxEngine(JaxGossip(topology=jax_topology(topo, WORLD), compressor=jcomp, **common)),
            ConsensusEngine(GossipConfig(topology=topology_from_name(topo, WORLD), compressor=tcomp, **common)))


def _tree():
    rng = np.random.default_rng(5)
    shapes = {"a": (300,), "b": (40, 3), "c": (700,)}
    return {"params": {k: rng.normal(size=(WORLD,) + v).astype(np.float32) for k, v in shapes.items()},
            "model_state": {}}


def _ref_traced_collective(name):
    """What tracing the reference's jitted collective round adds."""
    jeng, _teng = _engines(name)
    wm = JaxMesh.create(jeng.topology, platform="cpu")
    spec = P(*jeng.topology.axis_names)

    @jax.jit
    @functools.partial(_shard_map_no_check, mesh=wm.mesh, in_specs=(spec, P()), out_specs=spec)
    def one_round(tree, step):
        tree = jax.tree.map(lambda x: x[0], tree)
        tree, _st = jeng.round_collective(tree, jeng.init_state(tree), step=step)
        return jax.tree.map(lambda x: x[None], tree)

    pred = lambda n: n.endswith("_traced_total")  # noqa: E731
    before = _values(R, pred)
    one_round.lower(jax.device_put(_tree(), wm.worker_sharding()), jnp.int32(0))
    return _delta(before, _values(R, pred))


@functools.lru_cache(maxsize=None)
def _port_traced_collective():
    cases = [(_engines(name)[1], _tree(), TRACED_CASES[name][3], None) for name in TRACED_CASES]
    return launch(check.gossip_cases, WORLD, cases, "gloo", "cpu", timeout=120.0)


@pytest.mark.parametrize("name", list(TRACED_CASES))
def test_collective_traced_totals_equal_the_references(name):
    """Ppermutes, fused encodes and decodes, and the bytes on every
    directed edge: a run over every phase and branch against one trace of
    the reference's program (its ``lax.cond`` warm-up and CHOCO branches,
    its ``lax.switch`` over the one-peer graph's phases)."""
    want = _ref_traced_collective(name)
    got = _port_traced_collective()
    i = list(TRACED_CASES).index(name)
    for rank_result in got:
        assert rank_result[i]["traced"] == want
    assert want["consensusml_ppermutes_traced_total"] > 0
    if "int8" in name and "topk" not in name:
        assert want["consensusml_wire_fused_encodes_traced_total"] > 0
        assert want["consensusml_wire_fused_decodes_traced_total"] > 0
    assert any(k.startswith("consensusml_link_wire_bytes_traced_total{") for k in want)


def test_simulated_fused_traced_totals_equal_the_references():
    """The fused wire on the simulated backend: the reference's trace of
    its jitted round (both ``lax.cond`` branches) against the port's
    rounds 0 to 3 (warm-up, then CHOCO) over both phases; a second run of a program
    adds nothing."""
    jeng, teng = _engines("int8_onepeer_warm")
    tree = _tree()
    w = jax_simulated.phase_matrices(jeng.topology)
    fn = jax.jit(lambda t, step: jeng.round_simulated(t, jeng.init_state(t, world_size=WORLD),
                                                      w[step % 2], step=step))
    pred = lambda n: n.endswith("_traced_total")  # noqa: E731
    before = _values(R, pred)
    fn.lower(tree, jnp.int32(0))
    want = _delta(before, _values(R, pred))
    ttree = T.tree_map(torch.from_numpy, tree)
    st = teng.init_state(ttree, world_size=WORLD)
    wt = simulated.phase_matrices(teng.topology)
    before = _values(Q, pred)
    for step in (0, 1, 2, 3):
        ttree, st = teng.round_simulated(ttree, st, wt[step % 2], step=step)
    assert _delta(before, _values(Q, pred)) == want
    assert want["consensusml_wire_fused_encodes_traced_total"] > 0


# ---------------------------------------------------------------------------
# faults, sinks, profiling
# ---------------------------------------------------------------------------

MASKS = [[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 1], [1, 1, 1, 1], [1, 0.0, 1, 0]]


def test_fault_counters_under_passed_in_masks():
    pred = lambda n: n in ("consensusml_fault_rounds_total", "consensusml_worker_drops_total",  # noqa: E731
                           "consensusml_worker_drop_rounds_total", "consensusml_worker_recoveries_total",
                           "consensusml_alive_frac")
    # the counters by their deltas; the alive_frac gauge by its value (a
    # gauge's delta depends on what an earlier test in the process left)
    counters = lambda n: pred(n) and n != "consensusml_alive_frac"  # noqa: E731
    got = []
    for obs, record in [(R, r_record), (Q, q_record)]:
        before = _values(obs, counters)
        prev = None
        for mask in MASKS:
            record(sum(mask) / len(mask), alive=np.asarray(mask, np.float32), prev_alive=prev)
            prev = np.asarray(mask, np.float32)
        record(1.0)  # a scalar-only round
        got.append((_delta(before, _values(obs, counters)), _values(obs, pred)["consensusml_alive_frac"]))
    assert got[0] == got[1]
    assert got[1][0]['consensusml_worker_recoveries_total{worker="1"}'] == 1


def test_watchdog_timeout_dumps_the_flight_recorder(tmp_path):
    from consensusml_tpu_torch.train.telemetry import Telemetry

    engine = ConsensusEngine(GossipConfig(topology=topology_from_name("ring", 4)))
    shapes = {"params": {"w": torch.empty(3, 5, device="meta")}, "model_state": {}}
    spec = {"flight_recorder": str(tmp_path / "fr"), "telemetry_every": 1}
    before = _values(Q).get("consensusml_watchdog_timeouts_total", 0.0)
    with Telemetry(spec, engine, shapes, h=1) as tel:
        with tel.round(0, 0):
            pass
        tel.after_round(0)
        exits = []
        wd = ProgressWatchdog(0.2, on_timeout=tel.on_timeout, exit_fn=exits.append, arm_on_first_beat=False).start()
        wd._thread.join(timeout=10)
    assert exits == [3]
    assert _values(Q)["consensusml_watchdog_timeouts_total"] == before + 1
    (dump,) = os.listdir(tmp_path / "fr")
    doc = json.load(open(tmp_path / "fr" / dump))
    assert doc["reason"].startswith("watchdog-timeout") and "spans" in doc and "metric_snapshots" in doc
    assert tel.wire == 4 * 15 * 2


def test_collective_ranks_write_their_own_sinks(tmp_path, capfd):
    prom, trace = str(tmp_path / "m.prom"), str(tmp_path / "t.json")
    argv = ["--config", "mnist_mlp", "--device", "cpu", "--backend", "collective", "--dist-backend", "gloo",
            "--workers", "2", "--rounds", "2", "--topology", "ring", "--metrics-prom", prom, "--trace-events", trace]
    assert port_main(argv) == 0
    for path in (prom, prom + ".rank1"):
        text = open(path).read()
        assert "consensusml_rounds_total 2" in text
        assert 'consensusml_link_wire_bytes_traced_total{dst="0",src="1"}' in text
    for path in (trace, trace + ".rank1"):
        names = {e["name"] for e in json.load(open(path))["traceEvents"]}
        assert {"train.round", "gossip.round", "comm.bucket_sends", "train.inner_loop"} <= names


def test_round_timer_and_fence():
    t = RoundTimer(warmup=1)
    for _ in range(3):
        with t.lap(metrics_fn=lambda: {"loss": torch.ones(2), "n": 3.0, "empty": torch.empty(0)}):
            pass
    st = t.stats()
    assert st.count == 2 and len(t.laps) == 2 and st.min_s <= st.p50_s <= st.max_s
    assert "rounds=2" in st.format()
    assert RoundTimer().stats().count == 0
    fence([torch.zeros(3), {"a": np.ones(2)}, None])


def test_chip_smoke_round0_spans_are_the_references(cli):
    """``chip_smoke.py``'s gates on round 0's spans: the exact wire's are
    the reference CLI's; the two-step wire's gossip subtree is what
    tracing the reference's simulated top-k round records (both branches
    of its warm-up ``lax.cond``), and what the port's round records."""
    import chip_smoke

    _tmp, runs = cli
    assert tuple(_round0(runs["ref"][2])) == chip_smoke.ROUND0_SPANS["exact"]
    jeng, teng = _engines("topk_ring_warm")
    tree = _tree()
    w = jax_simulated.mixing_matrix(jeng.topology)
    tracer = R.get_tracer()
    was = tracer.enabled
    tracer.enabled = True
    tracer.clear()
    try:
        jax.jit(lambda t, step: jeng.round_simulated(t, jeng.init_state(t, world_size=WORLD), w, step=step)).lower(
            tree, jnp.int32(0))
        want = [(e["name"], e["depth"] + 1) for e in tracer.events()]
    finally:
        tracer.enabled = was
    gossip = [s for s in chip_smoke.ROUND0_SPANS["two_step"] if s[0].startswith(("bucket.", "gossip."))]
    assert want == gossip
    qt = Q.get_tracer()
    qt.enabled = True
    qt.clear()
    try:
        ttree = T.tree_map(torch.from_numpy, tree)
        teng.round_simulated(ttree, teng.init_state(ttree, world_size=WORLD), simulated.mixing_matrix(teng.topology),
                             step=1)
        assert [(e["name"], e["depth"] + 1) for e in qt.events()] == gossip
    finally:
        qt.enabled = False
