"""The port's load generator (``consensusml_tpu_torch.tools.loadgen``)
against the reference's ``tools/loadgen.py``.

- A recording submitter (and a recording clock: the inter-arrival sleeps
  are recorded, not slept) gives the whole schedule of both for the same
  flags and seed: arrival gaps, prompt lengths and token ids, the shared
  prefix, tenants, trace ids and sampling seeds, and when the swaps fire;
  bit for bit. The reports carry the same keys.
- ``parse_tenant_weights`` and ``sample_prompt_len`` agree.
- One run of the port's CLI in socket mode against a CPU ``ServeServer``
  with its metrics port: no errors, and the completed requests agree
  across the ``LOADGEN`` report, the scraped
  ``consensusml_serve_completed_total``, the wide events and
  ``/requests``; the tenants' rollups sum to the total.
- The refusals: ``--targets`` naming no target and ``--swap-every``
  without an artifact exit 2 (``--obs-snapshot`` writes the cluster
  snapshot: ``tests/test_torch_cluster_obs.py``).
"""

import importlib.util
import json
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from consensusml_tpu_torch.obs import get_registry
from consensusml_tpu_torch.serve import Engine, ServeConfig, ServeServer
from consensusml_tpu_torch.tools import loadgen as Q
from test_torch_serve import _models

_spec = importlib.util.spec_from_file_location("ref_loadgen", Path(__file__).resolve().parents[1] / "tools" /
                                               "loadgen.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """Stands in for the module's ``time``: sleeps are recorded."""

    def __init__(self):
        self.sleeps = []
        self.t = 0.0
        self.lock = threading.Lock()

    def sleep(self, s):
        self.sleeps.append(s)

    def perf_counter(self):
        with self.lock:
            self.t += 1e-3
            return self.t


def _schedule(mod, monkeypatch, **kw):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    calls, swaps = [], []
    lock = threading.Lock()

    def submit(ids, max_new, ctx, sampling):
        with lock:
            calls.append((ctx.trace_id, ctx.request_id, list(ids), max_new, dict(sampling)))
        return {"ttft_s": 0.01, "latency_s": 0.02, "tokens": [1] * max_new, "spec_proposed": 2,
                "spec_accepted": 1}

    report = mod.run_loadgen(submit, swap_fn=lambda: swaps.append(len(calls)), **kw)
    monkeypatch.undo()
    return sorted(calls), clock.sleeps, report


CASES = {
    "uniform": dict(len_dist="uniform"),
    "zipf_tenants_prefix": dict(len_dist="zipf", tenants=[("a", 3.0), ("b", 1.0)], shared_prefix=(24, 0.5)),
    "sampled_swaps": dict(len_dist="uniform", temperature=0.8, top_p=0.9, swap_every=5, seed=7),
}


@pytest.mark.parametrize("name", list(CASES))
def test_schedule_is_the_references_bit_for_bit(name, monkeypatch):
    kw = dict(n_requests=23, rate_rps=50.0, prompt_lens=(4, 40), vocab=64, max_new_tokens=3, seed=3)
    kw.update(CASES[name])
    want = _schedule(R, monkeypatch, **kw)
    got = _schedule(Q, monkeypatch, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1] and len(got[1]) == 23
    assert sorted(got[2]) == sorted(want[2])
    assert got[2]["swaps_triggered"] == want[2]["swaps_triggered"]
    assert got[2]["completed"] == 23 and got[2]["errors"] == 0


def test_weights_and_lengths_match():
    for spec in ["a=3,b=1", "x", " p=2 , q , r=0.5", None, "a b=2"]:
        assert Q.parse_tenant_weights(spec) == R.parse_tenant_weights(spec)
    with pytest.raises(ValueError):
        Q.parse_tenant_weights("a=0")
    for dist in ("uniform", "zipf"):
        ra, qa = np.random.default_rng(1), np.random.default_rng(1)
        assert [Q.sample_prompt_len(qa, 16, 512, dist) for _ in range(200)] == [
            R.sample_prompt_len(ra, 16, 512, dist) for _ in range(200)]


def _scrape(addr, path):
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}", timeout=10) as r:
        return r.read().decode()


def test_cli_against_a_cpu_server(capsys):
    _j, _p, tmodel = _models()
    eng = Engine(tmodel, ServeConfig(num_slots=4, block_size=8, prefix_cache=True), device="cpu")
    eng.warmup()
    server = ServeServer(eng, metrics_port=0, obs_tick_s=0.1)
    completed = get_registry().counter("consensusml_serve_completed_total")
    before, emitted = completed.value, eng._events.emitted_total
    try:
        host, port = server.address
        argv = ["--connect", f"{host}:{port}", "--requests", "12", "--rate", "200", "--prompt-len", "4:12",
                "--len-dist", "zipf", "--shared-prefix", "8:0.5", "--tenants", "a=3,b=1", "--max-new", "4",
                "--seed", "0"]
        assert Q.main(argv) == 0
        line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("LOADGEN ")][-1]
        rep = json.loads(line[len("LOADGEN "):])
        assert rep["errors"] == 0 and rep["completed"] == 12
        text = _scrape(server.metrics_address, "/metrics")
        scraped = float(next(x.split()[-1] for x in text.splitlines()
                             if x.startswith("consensusml_serve_completed_total ")))
        assert scraped - before == completed.value - before == 12
        assert eng._events.emitted_total - emitted == 12
        done = json.loads(_scrape(server.metrics_address, "/requests"))["completed"]
        ids = {r["trace_id"] for r in done if r["trace_id"].startswith("lg0-")}
        assert {f"lg0-{i:05d}" for i in range(12)} <= ids
        assert sum(t["completed"] for t in rep["tenants"].values()) == rep["completed"]
        rollup = json.loads(_scrape(server.metrics_address, "/tenants"))["tenants"]
        assert rollup["a"]["requests"] + rollup["b"]["requests"] >= 12
        assert _scrape(server.metrics_address, "/healthz")
    finally:
        server.shutdown()


@pytest.mark.parametrize("argv", [["--targets", ","],
                                  ["--connect", "127.0.0.1:1", "--swap-every", "4"]])
def test_refusals_exit_2(argv, capsys):
    assert Q.main(argv) == 2
    assert "error:" in capsys.readouterr().err
