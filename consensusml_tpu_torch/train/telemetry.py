"""The train CLI's telemetry, shared by both backends (the reference's
``train.py`` wiring, ``:783-830``, ``:1220-1270``, ``:1341-1370`` and
``:1495-1565``).

:class:`Telemetry` arms the sinks the flags ask for (``--trace-events``,
``--metrics-prom``, ``--metrics-port``, ``--flight-recorder``; any of them
turns the span tracer and the history and alert plane on), gauges the
engine's static wire facts, and around each round records the
``train.round`` span, :class:`~consensusml_tpu_torch.utils.profiling.
RoundTimer`'s lap, the loop's counters, gauges and latency histogram,
``round.feed`` (the round's wait at the prefetcher) and ``round.fence``
as completed spans, the fault counters
(:func:`~consensusml_tpu_torch.consensus.faults.record_fault_metrics`) and,
every ``--telemetry-every`` rounds, :meth:`Telemetry.tick`: the CHOCO
residual, a registry snapshot, the history sample and alert evaluation,
and the Prometheus file, which holds every registered family: the
feed's ``consensusml_feed_*`` (``data/prefetch.py``) and, with
``--native-loader``, the ring's ``consensusml_native_*``
(``native/__init__.py``). ``--profile-dir`` traces rounds 2-3 with
``torch.profiler``. ``--cost-ledger`` (the cost plane, the reference's
``train.py:1305-1352`` and ``:1625-1670``): round 0 counts ``train.step``
(and on the simulated backend ``gossip.round``) into a
:class:`~consensusml_tpu_torch.obs.costs.CostLedger` (:meth:`Telemetry.
register_costs`), each tick samples the live memory gauges and pairs the
round's time with the row, and the end prints the attribution and the HBM
three-way (:meth:`Telemetry.cost_report`). Nothing here reads a device
value the loop does not already fetch, but the tick's CHOCO residual and
link probes, as the reference's.

The cluster plane (the reference's ``train.py:1260-1303``): the
consensus-health monitor (:class:`~consensusml_tpu_torch.obs.health.
ConsensusHealthMonitor`) is always on, fed each round's consensus error
(its episodes routed through the alert engine when telemetry is on);
``--link-probes`` arms a :class:`~consensusml_tpu_torch.obs.links.
LinkProber` (the per-edge wire gauges once, a probe sweep each tick) and
``--obs-cluster-dir DIR`` a :class:`~consensusml_tpu_torch.obs.cluster.
ClusterWriter` that rewrites this rank's ``obs-rank-<rank>.json`` each
tick and at the end of the run.

On the collective backend each rank keeps its own registry and sinks, as
each reference process does: rank 0 writes the paths as given, rank ``r``
writes them with ``.rank<r>`` appended (the flight recorder's directory
too), and ``--metrics-port N`` binds ``N + r`` on rank ``r`` (``0``: a
free port a rank).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

from consensusml_tpu_torch.obs import get_registry, get_tracer
from consensusml_tpu_torch.utils.profiling import RoundTimer
from consensusml_tpu_torch.utils.profiling import trace as profile_trace

__all__ = ["Telemetry", "rank_path"]


def rank_path(path: str | None, rank: int) -> str | None:
    """A sink path of rank ``rank``: as given on rank 0."""
    if path is None or rank == 0:
        return path
    return f"{path}.rank{rank}"


class Telemetry:
    """One run's telemetry. ``spec``: the parsed flags as a dict;
    ``engine`` and ``shapes`` (one worker's gossiped tree, meta tensors
    do) give the wire facts; ``h`` the local steps a round; ``verbose``
    prints the sinks' lines (the endpoint, the armed recorder, the trace,
    the timing), as the CLI does on rank 0. ``device`` is where the link
    probes' payloads live, ``local_ranks`` the workers this process runs
    (None: all, the simulated backend), ``world_size`` the run's. Use as a
    context manager: the exit writes the Chrome trace and the Prometheus
    file and closes the HTTP plane, on an exception too."""

    def __init__(self, spec: dict, engine, shapes: Any, h: int, rank: int = 0, verbose: bool = True,
                 device=None, local_ranks=None, world_size: int | None = None):
        self.spec = spec
        self.h = h
        self.tracer = tracer = get_tracer()
        self.registry = registry = get_registry()
        self.trace_events = rank_path(spec.get("trace_events"), rank)
        self.metrics_prom = rank_path(spec.get("metrics_prom"), rank)
        self.every = max(1, int(spec.get("telemetry_every") or 10))
        port = spec.get("metrics_port")
        self.on = bool(self.trace_events or self.metrics_prom or spec.get("flight_recorder") or port is not None
                       or spec.get("obs_cluster_dir") or spec.get("link_probes") or spec.get("cost_ledger"))
        self._was_enabled = tracer.enabled
        if self.on:
            # host span recording on; without a sink spans are bare ranges
            tracer.enabled = True
        self.wire = engine.wire_bytes_per_round(shapes)
        self._engine = engine
        self.history = self.alerts = None
        self.http = None
        if self.on:
            from consensusml_tpu_torch.obs import get_alert_engine, get_history

            self.history, self.alerts = get_history(), get_alert_engine()
        if port is not None:
            from consensusml_tpu_torch.obs import MetricsServer

            # the loop drives record()/evaluate() from its tick: no ticker
            self.http = MetricsServer(port=port + rank if port else 0, history=self.history, alerts=self.alerts)
            if verbose:
                print(f"metrics endpoint: {self.http.url()} (/metrics /traces /requests /alerts /query /healthz)",
                      flush=True)
        for k, v in engine.telemetry(shapes).items():
            registry.gauge(f"consensusml_{k}").set(v)
        self.recorder = None
        if spec.get("flight_recorder"):
            from consensusml_tpu_torch.obs import FlightRecorder

            out = rank_path(spec["flight_recorder"], rank)
            self.recorder = FlightRecorder(out).install()
            if verbose:
                print(f"flight recorder armed: {out}", flush=True)
        from consensusml_tpu_torch.obs import ClusterWriter, ConsensusHealthMonitor, LinkProber

        # always on: a few float stores a round; with the alert plane armed
        # its episodes route through the alert engine
        self.health = ConsensusHealthMonitor(engine.topology, registry=registry, alerts=self.alerts)
        self.prober = None
        if spec.get("link_probes"):
            self.prober = LinkProber(engine.topology, registry=registry, device=device, local_ranks=local_ranks)
            self.prober.record_wire_rates(engine, shapes)
            if verbose:
                print(f"link probes armed: {len(self.prober.edges)} edges ({self.prober.payload_bytes} B payload)",
                      flush=True)
        self.cluster = None
        if spec.get("obs_cluster_dir"):
            self.cluster = ClusterWriter(spec["obs_cluster_dir"], rank=rank, registry=registry,
                                         world_size=world_size, history=self.history, alerts=self.alerts)
            if verbose:
                print(f"cluster snapshots: {self.cluster.path}", flush=True)
        self.ledger = self.accountant = None
        if spec.get("cost_ledger"):
            from consensusml_tpu_torch.obs.costs import CostLedger, device_kind
            from consensusml_tpu_torch.obs.memviz import HbmAccountant

            # this card's peaks (the CPU's anchor on a CPU run), over the registry
            self.ledger = CostLedger(registry=registry, platform=device_kind(device or "cpu"))
            self.accountant = HbmAccountant(registry=registry, device=device)
        self.costs = None  # the end's cost report (finish)
        self.timer = RoundTimer(warmup=1)  # round 0 builds kernels
        self.fence_s = 0.0
        self.prev_alive = None
        self._profiling = None
        self._verbose = verbose
        self.m_rounds = registry.counter("consensusml_rounds_total", "completed training rounds")
        self.m_wire_total = registry.counter("consensusml_wire_bytes_total",
                                             "bytes one worker has put on the gossip wire")
        self.m_latency = registry.histogram("consensusml_round_latency_seconds",
                                            "wall time of one full training round (inner loop + gossip)")
        self.m_heartbeat = registry.gauge(
            "consensusml_heartbeat_time_seconds",
            "unix time of this rank's latest completed round (cluster-view liveness; staleness flags a straggler)")
        self.m_progress = registry.gauge("consensusml_round_progress",
                                         "this rank's latest completed round index (cluster-view skew)")

    # -- the round ---------------------------------------------------------
    @contextlib.contextmanager
    def round(self, i: int, rnd: int):
        """Round ``rnd`` (the ``i``-th of this run): the profiler window
        (rounds 2-3 of the run), the ``train.round`` span and the lap."""
        pdir = self.spec.get("profile_dir")
        if pdir and i == 2:
            self._profiling = profile_trace(pdir)
            self._profiling.__enter__()
        with self.tracer.span("train.round", round=rnd), self.timer.lap():
            yield
        if pdir and i == 4:
            self._end_profile()

    def fetch(self, fn):
        """``fn()``, the loop's own fetch of the round's values (its device
        fence), timed as the round's fence wait."""
        t = time.time()
        out = fn()
        self.fence_s = time.time() - t
        return out

    def after_round(self, rnd: int, consensus_error: float | None = None, alive_frac: float | None = None,
                    alive_mask=None, state=None, feed_s: float = 0.0) -> None:
        """The per-round feed, the reference's order; ``alive_mask``: the
        round's participation vector on the host (fault runs only);
        ``feed_s``: the round's wait for its batch at the prefetcher (0
        without one)."""
        reg, timer = self.registry, self.timer
        self.m_rounds.inc()
        self.m_wire_total.inc(self.wire)
        self.m_latency.observe(timer.last_lap_s)
        self.m_heartbeat.set(time.time())
        self.m_progress.set(rnd)
        if self.tracer.enabled:
            self.tracer.complete("round.feed", feed_s, round=rnd)
            self.tracer.complete("round.fence", self.fence_s, round=rnd)
        if consensus_error is not None:
            reg.gauge("consensusml_consensus_distance",
                      "post-gossip consensus distance sqrt(mean_i ||x_i - xbar||^2)").set(consensus_error)
            # measured decay against the spectral bound; loud on sustained divergence
            self.health.observe(rnd, consensus_error)
        reg.gauge("consensusml_round_stall_seconds",
                  "host wait at the round's execution fence (overlap headroom)").set(self.fence_s)
        if timer.last_lap_s > 0:
            reg.gauge("consensusml_inner_steps_per_sec",
                      "local optimizer steps per second per worker").set(self.h / timer.last_lap_s)
        if alive_frac is not None:
            from consensusml_tpu_torch.consensus.faults import record_fault_metrics

            record_fault_metrics(alive_frac, alive=alive_mask, prev_alive=self.prev_alive)
            self.prev_alive = alive_mask
        if self.on and (rnd + 1) % self.every == 0 and state is not None:
            self.tick(rnd, state)

    # -- the cost plane (--cost-ledger) --------------------------------------
    def register_costs(self, step, state, batch, engine=None) -> None:
        """Round 0's ledger registration (the reference's
        ``register_run_costs``): ``train.step`` counted in one fake pass of
        ``step(state, batch)`` and, with ``engine`` (the simulated backend,
        whose transport program is the stacked round), ``gossip.round``
        under its bucket plan. Analysis only: nothing launches, nothing is
        allocated on the card, no generator advances. A registration that
        fails prints why and the run goes on without the ledger."""
        if self.ledger is None:
            return
        try:
            row = self.ledger.register("train.step", step, state, batch)
            if self._verbose:
                print(f"cost ledger: train.step {row.flops:.3g} flops {row.bytes_accessed:.3g} B accessed, "
                      f"compile {row.compile_s * 1e3:.0f} ms", flush=True)
            if engine is not None:
                grow = engine.register_costs(self.ledger, {"params": state.params, "model_state": state.model_state})
                if self._verbose:
                    print(f"cost ledger: gossip.round {grow.flops:.3g} flops, {grow.meta['buckets']} bucket(s), "
                          f"compile {grow.compile_s * 1e3:.0f} ms", flush=True)
        except Exception as e:  # analysis must never kill a run
            print(f"cost ledger: registration failed ({type(e).__name__}: {e}); continuing without", flush=True)
            self.ledger = None

    def observe_cost(self, name: str, seconds: float) -> None:
        """Pair a measured time with ledger row ``name`` (the simulated
        backend's ``gossip.round`` each round); nothing without the row."""
        if self.ledger is not None and self.ledger.row(name) is not None:
            self.ledger.observe_measured(name, seconds)

    def cost_report(self) -> dict | None:
        """End of the run (the reference's ``train.py:1625-1670``): the
        ``cost attribution:`` line (``train.step``'s median steady round
        against its floor) and the HBM three-way (``hbm_model.predict``
        for this config, stacked over the workers on the simulated
        backend; the ledger row's footprint; the allocator's peak). Returns
        ``{"attribution", "hbm"}``, or None without a ledger."""
        if self.ledger is None or self.accountant is None or not self.timer.last_lap_s:
            return None
        out = {"attribution": None, "hbm": None}
        if self.ledger.row("train.step") is not None:
            attr = self.ledger.observe_measured("train.step", self.timer.stats().p50_s)
            out["attribution"] = attr
            if self._verbose:
                print(f"cost attribution: train.step measured {1e3 * attr['measured_s']:.1f} ms vs {attr['bound']}-"
                      f"bound floor {1e3 * attr['expected_s']:.2f} ms ({attr['ratio_to_floor']:.1f}x)", flush=True)
        analytic = None
        try:
            from consensusml_tpu_torch.obs.memviz import load_tool

            hm = load_tool("hbm_model")
            spec = self.spec
            pred = hm.predict(spec.get("config", "gpt2_topk"), spec.get("scale", "smoke"), world=spec.get("workers"))
            # predict() models ONE worker; the simulated backend stacks every
            # worker on this card (the frozen base once)
            analytic = float(hm.stacked_bytes(pred, pred["world"]) if spec.get("backend", "simulated") == "simulated"
                             else pred["predicted_peak_bytes"])
        except Exception as e:
            print(f"hbm reconciliation: no analytic side ({e})", flush=True)
        row = self.ledger.row("train.step")
        self.accountant.tick()  # a run shorter than the cadence has no sample yet
        rec = self.accountant.reconcile(analytic_bytes=analytic,
                                        compiled_bytes=float(row.peak_bytes) if row else None)
        out["hbm"] = rec
        if self._verbose:
            drift = ", ".join(f"{k} {v:+.1f}%" for k, v in sorted(rec["drift_pct"].items()))
            print("hbm reconciliation: analytic "
                  f"{(rec['analytic_bytes'] or 0) / 1e6:.1f} MB vs compiled "
                  f"{(rec['compiled_bytes'] or 0) / 1e6:.1f} MB vs live "
                  f"{(rec['live_peak_bytes'] or 0) / 1e6:.1f} MB" + (f" ({drift})" if drift else ""), flush=True)
        return out

    def cost_snapshot(self) -> dict | None:
        """The ledger's table (rows, floors, measured times), or None."""
        return None if self.ledger is None else self.ledger.snapshot()

    def tick(self, rnd: int, state) -> None:
        """The heavier sampled telemetry: the link probes, the live memory
        gauges and the ``train.step`` attribution (``--cost-ledger``), the
        CHOCO residual (one fetch), a registry snapshot, the history
        sample and the alert rules, the Prometheus file, the cluster
        snapshot."""
        if self.prober is not None:
            self.prober.probe_round()
        if self.accountant is not None:
            self.accountant.tick()  # live memory gauges (host bookkeeping only)
        if self.ledger is not None and self.ledger.row("train.step") is not None and self.timer.last_lap_s:
            # the measured round paired with the counted row
            self.ledger.observe_measured("train.step", self.timer.last_lap_s)
        resid = self._engine.choco_residual(state.gossip)
        if resid is not None:
            self.registry.gauge("consensusml_choco_residual", "CHOCO tracking residual ||s - xhat|| (sampled)"
                                ).set(resid)
        self.registry.snapshot({"round": rnd})
        if self.history is not None:
            self.history.record()
            self.alerts.evaluate()
        if self.metrics_prom:
            self.registry.write_prometheus(self.metrics_prom)
        if self.cluster is not None:
            self.cluster.write(round=rnd)

    def finish(self, end: int, state) -> None:
        """End of the loop: close a profiler window the run cut short, the
        cost report (``--cost-ledger``; before the last tick, so the last
        snapshot carries the reconciled gauges), and a final tick unless
        the cadence just ticked (then the cluster snapshot's heartbeat
        alone is refreshed, a clean exit)."""
        if self._profiling is not None:
            self._end_profile()
        self.costs = self.cost_report()
        if self.on and self.timer.last_lap_s and end % self.every != 0:
            self.tick(end - 1, state)
        elif self.cluster is not None:
            self.cluster.write(round=end - 1)
        if self._verbose and self.timer.last_lap_s:
            print(f"timing: {self.timer.stats().format()}", flush=True)

    def _end_profile(self) -> None:
        self._profiling.__exit__(None, None, None)
        self._profiling = None
        if self._verbose:
            print(f"profile trace: {self.spec['profile_dir']}", flush=True)

    def on_timeout(self, reason: str) -> None:
        """The watchdog's hook with a flight recorder: count, snapshot,
        dump (before the watchdog's exit)."""
        self.registry.counter("consensusml_watchdog_timeouts_total", "watchdog round-progress timeouts").inc()
        self.registry.snapshot({"watchdog_timeout": True})
        self.recorder.dump(reason)

    # -- exit --------------------------------------------------------------
    def close(self) -> None:
        if self.trace_events:
            path = self.tracer.write_chrome_trace(self.trace_events)
            if self._verbose:
                print(f"trace events: {path}", flush=True)
        if self.metrics_prom:
            self.registry.write_prometheus(self.metrics_prom)
        if self.http is not None:
            self.http.close()
        self.tracer.enabled = self._was_enabled

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

