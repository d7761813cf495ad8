"""Per-link probes: measured latency/bandwidth for every gossip edge (port
of ``consensusml_tpu/obs/links.py``: the same families, labels, edge
walk and bookkeeping).

The gossip round's per-edge timing cannot be read out of it without
poisoning the hot path with host syncs. So link health is measured by a
SIDEBAND probe: at telemetry cadence (``python -m
consensusml_tpu_torch.train --link-probes`` + ``--telemetry-every``), the
:class:`LinkProber` times a small device-to-device transfer across each
directed edge of the active topology and feeds per-(src, dst) labeled
metrics:

- ``consensusml_link_latency_seconds{src,dst}`` — probe histogram per
  edge (fine microsecond buckets);
- ``consensusml_link_bandwidth_bytes_per_sec{src,dst}`` — payload /
  latest latency;
- ``consensusml_link_wire_bytes_per_round{src,dst}`` — the STEADY-STATE
  gossip bytes each edge carries per round, from the engine's wire
  accounting (:func:`link_wire_bytes`);
- ``consensusml_link_probe_*`` — probe bookkeeping (rounds, total time
  spent probing).

The default transfer copies a device-resident buffer of the source rank
and fences the copy with ``torch.cuda.synchronize`` — deliberate host
syncs OUTSIDE the round, on the telemetry path only. Every worker a
process runs lives on the process's device, so the probe is a timed copy
on it (on the simulated backend, every rank's): the numbers stop meaning
"wire" but stay cheap, deterministic in shape, and keep the report
schema identical, as the reference's self-copies do.

The collective backend runs one process per worker, and a process copies
only between the buffers of the workers it runs. As in the reference's
multi-controller rule, each process probes only the edges whose two
endpoints it runs (``local_ranks``) and counts the rest on
``consensusml_link_edges_remote``: with one worker a process, every edge
of a collective run is remote. A cross-process probe would have to ride
the transport in a phase of its own; the reference names that future
work, and it is not added here.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import torch

from consensusml_tpu_torch.obs.metrics import (
    DEFAULT_LINK_LATENCY_BUCKETS,
    MetricsRegistry,
    get_registry,
)

__all__ = ["LinkProber", "link_wire_bytes", "edge_sends_per_round"]


def edge_sends_per_round(topology) -> dict[tuple[int, int], float]:
    """Payload sends per round along each directed edge.

    Parallel shifts that land on the same edge (a ring of 2's +1/-1)
    count as SEPARATE sends — they are separate exchanges on the wire —
    which is why this walks shifts rather than :meth:`Topology.edges`
    (whose merged weights lose multiplicity). Dense (all-reduce)
    topologies count one send to every peer (the all-reduce's logical
    edge set); time-varying topologies average over the period.
    """
    if topology.is_time_varying:
        acc: dict[tuple[int, int], float] = {}
        for phase in topology.phases:
            for e, n in edge_sends_per_round(phase).items():
                acc[e] = acc.get(e, 0.0) + n / topology.period
        return acc
    n = topology.world_size
    if topology.uses_psum:
        return {
            (src, dst): 1.0
            for dst in range(n)
            for src in range(n)
            if src != dst
        }
    out: dict[tuple[int, int], float] = {}
    for shift in topology.shifts:
        for dst in range(n):
            src = topology.shift_src(dst, shift)
            if src != dst:
                out[(src, dst)] = out.get((src, dst), 0.0) + 1.0
    return out


def link_wire_bytes(engine, params: Any) -> dict[tuple[int, int], float]:
    """Steady-state gossip bytes per round on each directed edge.

    One send's payload (``telemetry()``'s ``wire_bytes_per_neighbor``)
    times that edge's sends per round times ``gossip_steps`` — summed
    over ONE worker's outgoing edges this reproduces its
    ``wire_bytes_per_round`` (up to push-sum's mass scalar) for shift
    topologies; the full edge dict covers every worker. Dense topologies
    spread the all-reduce payload over every logical peer edge, so their
    sum intentionally exceeds the one-send accounting. ``params`` are
    one worker's leaves (meta tensors do)."""
    t = engine.telemetry(params)
    per_send = t["wire_bytes_per_neighbor"] * max(
        engine.config.gossip_steps, 1
    )
    return {
        e: per_send * sends
        for e, sends in edge_sends_per_round(engine.topology).items()
    }


class LinkProber:
    """Times one transfer per directed topology edge and feeds the
    ``consensusml_link_*`` families.

    ``device``: where the payloads live (default the current CUDA
    device). A process's workers share its device, so every probe is a
    copy on it; on the simulated backend every rank is this process's
    and the probes are self-copies. ``local_ranks``: the worker ranks
    this process runs (None: all of them); with the default transfer
    only the edges between two of them are probed, the rest land on
    ``consensusml_link_edges_remote``.
    ``transfer``: override ``(src, dst) -> None`` — the test/chaos hook
    (a transfer that sleeps makes that link measurably slow, which must
    surface in ``slowest()`` and the cluster report); injected transfers
    see every edge: they define their own reachability. ``max_edges``:
    probe at most this many edges per round (dense world-N is N*(N-1)
    edges); the overflow is counted loudly on
    ``consensusml_link_edges_skipped``, never silently dropped.
    """

    def __init__(
        self,
        topology,
        registry: MetricsRegistry | None = None,
        payload_bytes: int = 1 << 16,
        transfer: Callable[[int, int], None] | None = None,
        max_edges: int = 512,
        device=None,
        local_ranks=None,
    ):
        self.topology = topology
        self.registry = registry if registry is not None else get_registry()
        self.payload_bytes = int(payload_bytes)
        self.device = torch.device("cuda") if device is None else torch.device(device)
        self._transfer = transfer
        self._bufs: dict[int, torch.Tensor] = {}  # src rank -> staged device buffer
        edges = [(s, d) for s, d, _ in topology.edges()]
        # a process copies only between the devices of the workers it
        # runs: with the default transfer it keeps the edges whose BOTH
        # endpoints are its own, which partitions the process-local edges
        # exactly once across the processes; the others are counted on
        # consensusml_link_edges_remote rather than probed
        self.remote_edges = 0
        if transfer is None and local_ranks is not None:
            mine = set(int(r) for r in local_ranks)
            local = [e for e in edges if e[0] in mine and e[1] in mine]
            self.remote_edges = len(edges) - len(local)
            edges = local
        self.skipped_edges = max(0, len(edges) - max_edges)
        self.edges = edges[: max_edges]
        self._stats: dict[tuple[int, int], tuple[int, float]] = {
            e: (0, 0.0) for e in self.edges
        }
        self._warmed = False
        r = self.registry
        r.gauge(
            "consensusml_link_edges",
            "directed gossip edges the link prober covers",
        ).set(len(self.edges))
        r.gauge(
            "consensusml_link_edges_skipped",
            "edges past the prober's max_edges cap (0 = full coverage)",
        ).set(self.skipped_edges)
        r.gauge(
            "consensusml_link_edges_remote",
            "cross-process edges this rank cannot probe with a local "
            "device_put (multi-controller; 0 on single-process runs)",
        ).set(self.remote_edges)
        r.gauge(
            "consensusml_link_probe_payload_bytes",
            "payload size of one link probe transfer",
        ).set(self.payload_bytes)
        self._m_rounds = r.counter(
            "consensusml_link_probe_rounds_total",
            "completed link-probe sweeps (one timing per edge each)",
        )
        self._m_spent = r.counter(
            "consensusml_link_probe_seconds_total",
            "wall time spent probing links (the probe's total overhead)",
        )

    # -- the default transfer: a fenced copy on the process's device ------
    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _buf(self, rank: int) -> torch.Tensor:
        buf = self._bufs.get(rank)
        if buf is None:
            buf = torch.zeros((self.payload_bytes // 4,), dtype=torch.float32, device=self.device)
            self._fence()
            self._bufs[rank] = buf
        return buf

    def _default_transfer(self, src: int, dst: int) -> None:
        # the source rank's device-resident buffer copied, fenced: the
        # one-hop transfer cost the gossip wire pays per payload. Host
        # syncs by design (telemetry sideband, never inside a round).
        self._buf(src).clone()
        self._fence()

    # -- probing -----------------------------------------------------------
    def probe_round(self) -> dict[tuple[int, int], float]:
        """One timed transfer per edge; returns {edge: seconds} and
        feeds the labeled histograms/gauges."""
        transfer = self._transfer or self._default_transfer
        if not self._warmed:
            # throwaway sweep: first-touch allocation and dispatch-path
            # warmup must not pollute the recorded latencies
            for src, dst in self.edges:
                transfer(src, dst)
            self._warmed = True
        t_sweep = time.perf_counter()
        out: dict[tuple[int, int], float] = {}
        for src, dst in self.edges:
            t0 = time.perf_counter()
            transfer(src, dst)
            dt = time.perf_counter() - t0
            out[(src, dst)] = dt
            n, tot = self._stats[(src, dst)]
            self._stats[(src, dst)] = (n + 1, tot + dt)
            labels = {"src": src, "dst": dst}
            self.registry.histogram(
                "consensusml_link_latency_seconds",
                "one-hop probe transfer time per directed gossip edge",
                buckets=DEFAULT_LINK_LATENCY_BUCKETS,
                labels=labels,
            ).observe(dt)
            self.registry.gauge(
                "consensusml_link_bandwidth_bytes_per_sec",
                "probe payload / latest probe latency per edge",
                labels=labels,
            ).set(self.payload_bytes / dt if dt > 0 else 0.0)
        self._m_rounds.inc()
        self._m_spent.inc(time.perf_counter() - t_sweep)
        return out

    def slowest(self, k: int | None = None) -> list[dict[str, Any]]:
        """Edges ranked by mean probed latency, slowest first — the
        ordering the cluster report consumes."""
        rows = [
            {
                "src": s,
                "dst": d,
                "probes": n,
                "mean_latency_s": tot / n,
            }
            for (s, d), (n, tot) in self._stats.items()
            if n > 0
        ]
        rows.sort(key=lambda r: -r["mean_latency_s"])
        return rows if k is None else rows[:k]

    # -- steady-state wire rates ------------------------------------------
    def record_wire_rates(self, engine, params: Any) -> None:
        """Set the per-edge steady-state wire gauges from the engine's
        accounting (host-side, once at startup — meta tensors fine)."""
        for (src, dst), nbytes in link_wire_bytes(engine, params).items():
            self.registry.gauge(
                "consensusml_link_wire_bytes_per_round",
                "steady-state gossip bytes per round on each directed "
                "edge (engine wire accounting)",
                labels={"src": src, "dst": dst},
            ).set(nbytes)
