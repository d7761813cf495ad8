"""Live device-memory accounting + three-way memory reconciliation (port
of ``consensusml_tpu/obs/memviz.py``; every ``consensusml_hbm_*`` family,
label and help text is the reference's).

``consensusml_tpu_torch/tools/hbm_model.py`` PREDICTS per-device bytes
from first principles; the cost ledger (:mod:`.costs`) records what the
counting pass found an executable holds; the runtime knows what is
actually LIVE. This module makes all three gauges and reconciles them:

- **analytic** — ``hbm_model.predict()``'s peak model (state + batch +
  max(activations, codec transients) + payloads).
- **compiled** — the ledger row's live footprint (arguments + temps +
  outputs - aliases), from the counting pass's high-water mark.
- **live** — ``torch.cuda.memory_allocated`` plus the serving engine's
  tagged consumers, and ``torch.cuda.memory_stats``' peak on the card. On
  the CPU no runtime accounts its tensors: there the live side is None
  and drops out of the drift pairs rather than faking a zero.

Pairwise drift lands on ``consensusml_hbm_drift_pct{pair=...}``.
"""

from __future__ import annotations

import importlib.util
import math
import os
import time
from typing import Any

from consensusml_tpu_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = [
    "live_array_bytes",
    "device_memory_stats",
    "compiled_footprint",
    "load_tool",
    "HbmAccountant",
    "reconcile_config",
]

# the engine's tagged resident consumers (pool pages, params): gauges the
# serving engine sets, reported beside the allocator's total
_TAGGED = ("consensusml_pool_hbm_bytes", "consensusml_serve_params_bytes")


def _cuda(device: Any = None):
    import torch

    if device is not None:
        device = torch.device(device)
        return device if device.type == "cuda" else None
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None


def live_array_bytes(device: Any = None, registry: MetricsRegistry | None = None) -> dict[str, Any]:
    """Bytes of live tensors on the card: the caching allocator's
    ``memory_allocated`` (host bookkeeping, no device sync) and, from
    ``registry``, the serving engine's tagged consumers (``tagged``: name
    -> bytes; they are part of ``bytes``). On the CPU ``bytes`` is None:
    no runtime accounts CPU tensors."""
    import torch

    reg = registry if registry is not None else get_registry()
    tagged = {}
    for m in reg.metrics():
        if m.name in _TAGGED and not getattr(m, "labels", None):
            tagged[m.name] = float(m.value)
    dev = _cuda(device)
    if dev is None:
        return {"bytes": None, "arrays": None, "tagged": tagged}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes": int(torch.cuda.memory_allocated(dev)),
        "arrays": int(stats.get("active.all.current", 0)),
        "tagged": tagged,
    }


def device_memory_stats(device: Any = None) -> dict[str, float] | None:
    """The runtime's own accounting — ``peak_bytes_in_use``,
    ``bytes_in_use``, ``bytes_limit`` (the reference's keys, from
    ``torch.cuda.memory_stats`` and ``mem_get_info``) plus every raw
    allocator stat — or None on the CPU."""
    import torch

    dev = _cuda(device)
    if dev is None:
        return None
    stats = {k: float(v) for k, v in torch.cuda.memory_stats(dev).items() if isinstance(v, (int, float))}
    free, total = torch.cuda.mem_get_info(dev)
    stats["peak_bytes_in_use"] = float(torch.cuda.max_memory_allocated(dev))
    stats["bytes_in_use"] = float(torch.cuda.memory_allocated(dev))
    stats["bytes_limit"] = float(total)
    stats["bytes_free"] = float(free)
    return stats


def compiled_footprint(ma: Any) -> int:
    """The live device footprint from a memory analysis (a ledger row, or
    anything with the reference's ``*_size_in_bytes`` fields): arguments +
    temps + outputs - aliases. The ONE definition shared by the cost
    ledger, ``hbm_model`` and the reconciliation below."""
    if hasattr(ma, "argument_size_in_bytes"):
        return int(ma.argument_size_in_bytes + ma.temp_size_in_bytes + ma.output_size_in_bytes
                   - ma.alias_size_in_bytes)
    return int(ma.argument_bytes + ma.temp_bytes + ma.output_bytes - ma.alias_bytes)


def _drift_pct(a: float, b: float) -> float:
    """Signed drift of ``a`` relative to ``b`` in percent."""
    if not b:
        return math.nan
    return 100.0 * (a - b) / b


class HbmAccountant:
    """Live device-memory gauges + the three-way reconciliation writer."""

    def __init__(self, registry: MetricsRegistry | None = None, device: Any = None):
        self.registry = registry if registry is not None else get_registry()
        self.device = device
        reg = self.registry
        self._g_live = reg.gauge(
            "consensusml_hbm_live_bytes",
            "bytes held by live jax arrays in this process (floor on "
            "runtimes without memory_stats: XLA temps are invisible)",
        )
        self._g_arrays = reg.gauge("consensusml_hbm_live_arrays", "live jax array count")
        self._g_peak = reg.gauge(
            "consensusml_hbm_peak_bytes",
            "runtime peak_bytes_in_use (NaN when the backend hides "
            "memory_stats)",
        )
        self._g_limit = reg.gauge(
            "consensusml_hbm_limit_bytes",
            "runtime bytes_limit (NaN when unavailable)",
        )
        self._live_peak = 0.0  # high-water mark of our own live samples

    def tick(self) -> dict[str, Any]:
        """One sample: refresh the live gauges (telemetry-tick cadence;
        host bookkeeping only, no device sync)."""
        live = live_array_bytes(self.device, self.registry)
        nbytes = live["bytes"]
        if nbytes is not None:
            self._live_peak = max(self._live_peak, float(nbytes))
        self._g_live.set(math.nan if nbytes is None else nbytes)
        self._g_arrays.set(math.nan if live["arrays"] is None else live["arrays"])
        stats = device_memory_stats(self.device)
        peak = (stats or {}).get("peak_bytes_in_use", math.nan)
        limit = (stats or {}).get("bytes_limit", math.nan)
        self._g_peak.set(peak)
        self._g_limit.set(limit)
        return {
            "time_s": time.time(),
            "live_bytes": nbytes,
            "live_arrays": live["arrays"],
            "tagged": live["tagged"],
            "runtime_peak_bytes": peak,
            "runtime_limit_bytes": limit,
        }

    @property
    def live_peak_bytes(self) -> float | None:
        """Best live peak this accountant knows: the allocator's
        ``max_memory_allocated`` on the card, else the high-water mark of
        the samples taken so far (None where nothing was sampled: the
        CPU)."""
        stats = device_memory_stats(self.device)
        if stats and stats.get("peak_bytes_in_use"):
            return float(stats["peak_bytes_in_use"])
        return self._live_peak or None

    def reconcile(
        self,
        analytic_bytes: float | None,
        compiled_bytes: float | None,
        live_peak_bytes: float | None = None,
    ) -> dict[str, Any]:
        """Set the three absolute gauges + pairwise drift gauges and return
        the reconciliation doc. ``None`` sides render as NaN and drop out of
        the drift pairs rather than faking a zero."""
        if live_peak_bytes is None:
            live_peak_bytes = self.live_peak_bytes
        reg = self.registry
        vals = {"analytic": analytic_bytes, "compiled": compiled_bytes, "live": live_peak_bytes}
        reg.gauge(
            "consensusml_hbm_analytic_bytes",
            "tools/hbm_model.py predicted per-device peak",
        ).set(math.nan if analytic_bytes is None else analytic_bytes)
        reg.gauge(
            "consensusml_hbm_compiled_bytes",
            "XLA memory_analysis live footprint (args+temps+outputs-aliases)",
        ).set(math.nan if compiled_bytes is None else compiled_bytes)
        reg.gauge(
            "consensusml_hbm_live_peak_bytes",
            "observed live peak (runtime peak_bytes_in_use, or the "
            "live-array high-water mark where the runtime hides stats)",
        ).set(math.nan if live_peak_bytes is None else live_peak_bytes)
        drift: dict[str, float] = {}
        for a, b in (("analytic", "compiled"), ("compiled", "live"), ("analytic", "live")):
            if vals[a] is None or vals[b] is None:
                continue
            pct = _drift_pct(float(vals[a]), float(vals[b]))
            drift[f"{a}_vs_{b}"] = pct
            reg.gauge(
                "consensusml_hbm_drift_pct",
                "signed drift between two HBM accountings "
                "(100*(first-second)/second per pair label)",
                labels={"pair": f"{a}_vs_{b}"},
            ).set(pct)
        return {
            "analytic_bytes": analytic_bytes,
            "compiled_bytes": compiled_bytes,
            "live_peak_bytes": live_peak_bytes,
            "drift_pct": drift,
        }


def load_tool(name: str):
    """Import ``consensusml_tpu_torch/tools/<name>.py`` by path (the
    port's own tools, never the repo's ``tools/``). None when absent. The
    ONE loader the port's obs modules share (``/profile`` and the
    reconciliation)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", f"{name}.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location(f"_cml_torch_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_hbm_model():
    return load_tool("hbm_model")


def reconcile_config(
    name: str,
    scale: str = "smoke",
    rounds: int = 2,
    registry: MetricsRegistry | None = None,
    ledger: Any = None,
    device: Any = None,
) -> dict[str, Any]:
    """The full three-way for one config at world=1: analytic
    ``predict()`` vs the train step's ledger row (registered through the
    cost ledger, so it lands in ``consensusml_cost_*`` too) vs the live
    peak after running ``rounds`` rounds. ``device`` defaults to the card;
    on the CPU the live side is None (no runtime accounts CPU tensors) and
    only the analytic-vs-compiled pair is reported."""
    import torch

    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.device import resolve_device
    from consensusml_tpu_torch.obs.costs import get_cost_ledger
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    dev = resolve_device(device)
    hbm_model = _load_hbm_model()
    if hbm_model is None:
        raise RuntimeError("consensusml_tpu_torch/tools/hbm_model.py not found: the reconciliation needs "
                           "the analytic side")
    analytic = hbm_model.predict(name, scale, world=1, model_axes=())  # the simulated step: no model axes
    if ledger is None:
        ledger = get_cost_ledger()
    acct = HbmAccountant(registry=registry, device=dev)
    bundle = configs.build(name, scale, world=1, device=dev)
    params, model_state = configs.init_on_device(bundle, 0, dev)
    state = init_stacked_state(bundle.cfg, params, 1, model_state=model_state,
                               frozen=configs.frozen_on_device(bundle, dev))
    del params, model_state
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    batches = list(bundle.batches(rounds, 0))
    row = ledger.register(f"train.step.{name}", step, state, batches[0],
                          meta={"config": name, "scale": scale, "world": 1})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    acct.tick()
    metrics = None
    for b in batches:
        state, metrics = step(state, b)
        acct.tick()
    if metrics is not None:  # execute for real; fence on the loss
        float(metrics["loss"])
    acct.tick()
    doc = acct.reconcile(analytic_bytes=float(analytic["predicted_peak_bytes"]), compiled_bytes=float(row.peak_bytes))
    doc.update({"config": name, "scale": scale, "executable": row.name, "compile_s": row.compile_s,
                "analytic_detail": analytic["per_device"]})
    return doc
