"""Cost ledger: per-executable work and memory accounting (port of
``consensusml_tpu/obs/costs.py``).

Every gauge and span in the stack answers "how long did it take"; the
ledger answers "how long SHOULD it have taken". For every executable the
stack owns (the train step, the gossip round under its bucket plan, the
paged prefill, decode and speculative serving stages, the hot-swap
staging transfer) the :class:`CostLedger` records

- **work**: flops and bytes accessed, the roofline inputs;
- **memory**: argument, output and temp bytes and the live-footprint
  combination (arguments + temps + outputs - aliases) the HBM
  reconciliation uses (:mod:`.memviz`);
- **analysis wall time**: the counting pass's, under the reference's
  ``consensusml_compile_seconds`` family.

XLA's ``lower().compile()`` has no counterpart in eager PyTorch. The
port's answer (:mod:`consensusml_tpu_torch.workcount`): the executable
runs once under ``FakeTensorMode`` on fake copies of its arguments,
modules and generators, and a dispatch mode counts every aten op
(``torch.utils.flop_counter``'s formulas for matmul, convolution and
attention, one flop an output element for the rest; every input read
once, every output written once, views free). A hand-written kernel
reports its own work from its shapes (its wrapper's ``work``), so the
kernel, its plain version and the counting pass give one count.
``temp_bytes`` is the pass's high-water mark of live storage less its
outputs. ``generated_code_bytes`` has no counterpart (eager PyTorch
generates no program; the kernels' libraries are built once a process,
not an executable): it is reported as 0, the value the reference's own
``register_transfer`` rows carry, and the port's rows say so in
``meta["generated_code"] = "none (eager)"``.

Every family name, label and help text is the reference's, so a
dashboard or a Prometheus diff reads the port unchanged (the help texts
say "compiled": the port's "compile" is the counting pass).

Registration is ANALYSIS ONLY: the counting pass launches no kernel,
allocates nothing on the device, draws from no generator (it draws from
clones) and writes no real tensor. Its price is one traced pass an
executable, paid once, which is why ``--cost-ledger`` is opt-in, while
the run-time side (:meth:`CostLedger.observe_measured`, a few gauge
stores) is cheap enough for every telemetry tick.

Expected-vs-measured attribution, as the reference's:

    compute floor = flops / peak_flops_per_s
    memory  floor = bytes_accessed / peak_bytes_per_s
    expected      = max(compute floor, memory floor)

Peaks are per CARD (``DEVICE_PEAKS``, keyed by
``torch.cuda.get_device_name()``), not per platform: each is an upper
bound of what the card can do (dense bf16 tensor-core flops, HBM bytes,
the host link's line rate), so every floor is a true lower bound and a
measured/floor ratio under 1 is a counting fault, never a fast run. An
unknown card raises unless the caller passes its own peaks.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable

from consensusml_tpu_torch.obs._annotations import guarded_by
from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = [
    "DEVICE_PEAKS",
    "TRANSFER_PEAKS",
    "ExecutableCost",
    "CostLedger",
    "get_cost_ledger",
    "device_kind",
]

# (peak FLOP/s, peak bytes/s) per card name (torch.cuda.get_device_name)
# and the reference's "cpu" anchor. The H100's are the figures the
# kernels' bounds use (PERF.md): dense bf16 tensor-core flops and HBM3
# bytes, each an upper bound of the card.
DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
    "cpu": (5e10, 2e10),
}

# host<->device staging bandwidth per card: transfer rows (the hot-swap
# stage) cross the host link, NOT the HBM bus. The H100 SXM's is PCIe Gen5
# x16's line rate, an upper bound of a pinned copy: one measured 38.68 GB/s
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's check.cost_counts,
# pinned_h2d_rate; PERF.md).
TRANSFER_PEAKS: dict[str, float] = {
    "NVIDIA H100 80GB HBM3": 64e9,
    "cpu": 10e9,  # a memcpy between host buffers
}


def device_kind(device: Any = None) -> str:
    """The ``DEVICE_PEAKS`` key of ``device``: the card's name for a CUDA
    device (default: the current one when CUDA is up), else ``"cpu"``."""
    import torch

    if device is None:
        device = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _tree_device_bytes(tree: Any) -> int:
    """Total bytes of a tensor tree's distinct storages (a module's
    parameters and buffers count too)."""
    import torch

    from consensusml_tpu_torch.workcount import nbytes_of

    if isinstance(tree, torch.nn.Module):
        tree = [*tree.parameters(), *tree.buffers()]
    return nbytes_of(tree)


@dataclasses.dataclass(frozen=True)
class ExecutableCost:
    """One ledger row: what the counting pass found for one executable."""

    name: str
    platform: str
    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    generated_code_bytes: int
    compile_s: float
    kind: str = "compiled"  # "compiled" | "transfer"
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def peak_bytes(self) -> int:
        """The live device footprint of one invocation: arguments + temps +
        outputs - aliases (outputs updated in an argument's storage) —
        the number the three-way HBM reconciliation compares against the
        analytic model and the live runtime (:mod:`.memviz`)."""
        return self.argument_bytes + self.temp_bytes + self.output_bytes - self.alias_bytes

    def floors_s(
        self,
        peak_flops_per_s: float,
        peak_bytes_per_s: float,
        peak_transfer_bytes_per_s: float | None = None,
    ) -> tuple[float, float]:
        """(compute floor, memory floor) in seconds. Transfer rows have no
        flops: their floor is bytes over the host<->device staging
        bandwidth (``peak_transfer_bytes_per_s``), not the HBM bus."""
        compute = self.flops / peak_flops_per_s if peak_flops_per_s else 0.0
        if self.kind == "compiled":
            moved, bw = self.bytes_accessed, peak_bytes_per_s
        else:
            moved = float(self.argument_bytes)
            bw = peak_transfer_bytes_per_s or peak_bytes_per_s
        memory = moved / bw if bw else 0.0
        return compute, memory

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["peak_bytes"] = self.peak_bytes
        return d


@guarded_by("_lock", "_rows", "_measured")
class CostLedger:
    """Get-or-create per-executable cost table + metric exporter.

    One process-wide instance (:func:`get_cost_ledger`) feeds the global
    registry; tests build private instances over private registries.
    Thread-safe: serving registers from the client thread while the
    engine thread serves, and observe_measured may come from a telemetry
    tick. ``platform`` is the card's name (``DEVICE_PEAKS``' key; default
    the current CUDA device's, or ``"cpu"`` without one); an unknown card
    raises unless both peaks are given."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        platform: str | None = None,
        peak_flops_per_s: float | None = None,
        peak_bytes_per_s: float | None = None,
        peak_transfer_bytes_per_s: float | None = None,
    ):
        self.registry = registry if registry is not None else get_registry()
        if platform is None:
            platform = device_kind()
        self.platform = platform
        known = DEVICE_PEAKS.get(platform)
        if known is None and not (peak_flops_per_s and peak_bytes_per_s):
            raise ValueError(
                f"no peaks known for {platform!r} (known: {sorted(DEVICE_PEAKS)}); pass peak_flops_per_s and "
                "peak_bytes_per_s (upper bounds of the card, so every floor stays a lower bound)"
            )
        dflops, dbytes = known or (0.0, 0.0)
        self.peak_flops_per_s = peak_flops_per_s or dflops
        self.peak_bytes_per_s = peak_bytes_per_s or dbytes
        self.peak_transfer_bytes_per_s = (
            peak_transfer_bytes_per_s or TRANSFER_PEAKS.get(platform) or self.peak_bytes_per_s
        )
        self._rows: dict[str, ExecutableCost] = {}
        self._measured: dict[str, float] = {}
        self._lock = threading.RLock()
        reg = self.registry
        # monotonic analysis-side counters (the "is something re-registering
        # behind my back" signal reads these, so they must only go up)
        self._m_compiles = reg.counter(
            "consensusml_compile_total",
            "executables lowered+compiled into the cost ledger",
        )
        self._m_compile_s = reg.counter(
            "consensusml_compile_seconds_total",
            "cumulative ledger compile wall time",
        )

    # -- registration -----------------------------------------------------

    def register(
        self,
        name: str,
        fn: Callable,
        *args: Any,
        meta: dict[str, Any] | None = None,
        setup: Callable | None = None,
        **kwargs: Any,
    ) -> ExecutableCost:
        """Count ``fn(*args, **kwargs)`` in one fake pass
        (:func:`consensusml_tpu_torch.workcount.analyze`) and record its
        row. ``args`` are the executable's real arguments (or fakes):
        NOTHING executes on the device, nothing is allocated there, no
        real tensor is written and no generator advances. ``setup`` builds
        further fake arguments from the faked ones (``workcount.analyze``).
        Re-registering a name overwrites its row (an executable at a new
        world or shape)."""
        from consensusml_tpu_torch.workcount import analyze

        a = analyze(fn, *args, setup=setup, **kwargs)
        row = ExecutableCost(
            name=name,
            platform=self.platform,
            flops=float(a.flops),
            bytes_accessed=float(a.bytes_accessed),
            argument_bytes=int(a.argument_bytes),
            output_bytes=int(a.output_bytes),
            temp_bytes=int(a.temp_bytes),
            alias_bytes=int(a.alias_bytes),
            generated_code_bytes=0,
            compile_s=a.seconds,
            meta={
                "generated_code": "none (eager)",
                "kernel_flops": a.kernel_flops,
                "kernel_bytes": a.kernel_bytes,
                "kernels": a.kernels,
                "ops": a.ops,
                **dict(meta or {}),
            },
        )
        self._record(row)
        return row

    def register_transfer(self, name: str, tree: Any, meta: dict[str, Any] | None = None) -> ExecutableCost:
        """Record a host<->device staging transfer (the hot-swap artifact
        stage) as a bytes-only row: no flops, no analysis — its floor is
        pure bandwidth."""
        nbytes = _tree_device_bytes(tree)
        row = ExecutableCost(
            name=name,
            platform=self.platform,
            flops=0.0,
            bytes_accessed=float(nbytes),
            argument_bytes=nbytes,
            output_bytes=nbytes,
            temp_bytes=0,
            alias_bytes=nbytes,  # staged in place: not double-resident
            generated_code_bytes=0,
            compile_s=0.0,
            kind="transfer",
            meta=dict(meta or {}),
        )
        self._record(row)
        return row

    def _record(self, row: ExecutableCost) -> None:
        reg = self.registry
        labels = {"executable": row.name}
        reg.gauge(
            "consensusml_cost_flops",
            "compiled FLOPs per invocation (XLA cost analysis)",
            labels=labels,
        ).set(row.flops)
        reg.gauge(
            "consensusml_cost_bytes_accessed",
            "compiled bytes accessed per invocation (XLA cost analysis)",
            labels=labels,
        ).set(row.bytes_accessed)
        reg.gauge(
            "consensusml_cost_argument_bytes",
            "compiled argument buffer bytes",
            labels=labels,
        ).set(row.argument_bytes)
        reg.gauge(
            "consensusml_cost_output_bytes",
            "compiled output buffer bytes",
            labels=labels,
        ).set(row.output_bytes)
        reg.gauge(
            "consensusml_cost_temp_bytes",
            "compiled temp buffer bytes (XLA scratch)",
            labels=labels,
        ).set(row.temp_bytes)
        reg.gauge(
            "consensusml_cost_generated_code_bytes",
            "compiled program code size",
            labels=labels,
        ).set(row.generated_code_bytes)
        reg.gauge(
            "consensusml_cost_peak_bytes",
            "compiled live footprint: arguments + temps + outputs - aliases",
            labels=labels,
        ).set(row.peak_bytes)
        reg.gauge(
            "consensusml_compile_seconds",
            "ledger-measured lower+compile wall time for this executable",
            labels=labels,
        ).set(row.compile_s)
        if row.kind == "compiled":
            self._m_compiles.inc()
            self._m_compile_s.inc(row.compile_s)
        with self._lock:
            self._rows[row.name] = row

    # -- queries ----------------------------------------------------------

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._rows)

    def row(self, name: str) -> ExecutableCost | None:
        with self._lock:
            return self._rows.get(name)

    def rows(self) -> list[ExecutableCost]:
        with self._lock:
            return [self._rows[k] for k in sorted(self._rows)]

    # -- run-time attribution --------------------------------------------

    def observe_measured(self, name: str, seconds: float) -> dict[str, Any]:
        """Pair a measured wall time with ``name``'s counted cost.

        Feeds the ``consensusml_cost_{measured,expected}_seconds`` and
        ``consensusml_cost_floor_ratio`` gauges and returns the
        attribution row. Raises ``KeyError`` for an unregistered name — a
        silent typo here would report an executable as free."""
        row = self.row(name)
        if row is None:
            raise KeyError(f"executable {name!r} is not in the cost ledger (registered: {self.names()})")
        with self._lock:
            self._measured[name] = float(seconds)
        attr = self.attribution(name)
        labels = {"executable": name}
        reg = self.registry
        reg.gauge(
            "consensusml_cost_measured_seconds",
            "measured wall time paired with this executable's cost row",
            labels=labels,
        ).set(seconds)
        reg.gauge(
            "consensusml_cost_expected_seconds",
            "roofline floor: max(flops/peak_flops, bytes/peak_bw)",
            labels=labels,
        ).set(attr["expected_s"])
        reg.gauge(
            "consensusml_cost_floor_ratio",
            "measured / roofline floor (1.0 = at the hardware bound)",
            labels=labels,
        ).set(attr["ratio_to_floor"])
        return attr

    def attribution(self, name: str) -> dict[str, Any]:
        """Expected-vs-measured row for one executable (measured fields are
        NaN until :meth:`observe_measured` pairs a wall time)."""
        row = self.row(name)
        if row is None:
            raise KeyError(f"executable {name!r} is not in the cost ledger")
        compute_s, memory_s = row.floors_s(
            self.peak_flops_per_s,
            self.peak_bytes_per_s,
            self.peak_transfer_bytes_per_s,
        )
        expected = max(compute_s, memory_s)
        if row.kind == "transfer":
            bound = "transfer"
        else:
            bound = "compute" if compute_s >= memory_s else "memory"
        with self._lock:
            measured = self._measured.get(name, math.nan)
        ratio = measured / expected if expected > 0 else math.nan
        return {
            "executable": name,
            "kind": row.kind,
            "bound": bound,
            "compute_floor_s": compute_s,
            "memory_floor_s": memory_s,
            "expected_s": expected,
            "measured_s": measured,
            "ratio_to_floor": ratio,
            "unattributed_s": max(0.0, measured - expected) if not math.isnan(measured) else math.nan,
        }

    def snapshot(self) -> dict[str, Any]:
        """The full table as one JSON-able doc (cluster snapshots,
        obs_report)."""
        out = []
        for row in self.rows():
            d = row.as_dict()
            d.update(self.attribution(row.name))
            out.append(d)
        return {
            "platform": self.platform,
            "peak_flops_per_s": self.peak_flops_per_s,
            "peak_bytes_per_s": self.peak_bytes_per_s,
            "peak_transfer_bytes_per_s": self.peak_transfer_bytes_per_s,
            "executables": out,
        }


_GLOBAL: CostLedger | None = None
_GLOBAL_LOCK = threading.Lock()


def get_cost_ledger() -> CostLedger:
    """The process-wide ledger over the global metrics registry (built
    lazily, on the current card's peaks)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = CostLedger()
        return _GLOBAL
