"""Metrics logging: JSONL records of the rounds, fed into the telemetry
registry (port of ``consensusml_tpu/utils/logging.py``).

``MetricsLogger(path)`` appends one JSON object a logged round: ``round``,
``wall_s`` (seconds since the logger opened, to the millisecond) and the
round's metrics, tensors and numpy scalars as floats, as the reference
writes them. Every float field also sets the process-wide registry's
``consensusml_<name>`` gauge (:mod:`consensusml_tpu_torch.obs.metrics`;
characters Prometheus refuses become ``_``), so the Prometheus exporter and
the flight recorder see what the JSONL gets. It is a context manager, so
the file closes on an exception too. The train CLI's ``--metrics-out
PATH`` writes it at ``--log-every``.
"""

from __future__ import annotations

import json
import re
import time
from typing import IO, Any

from consensusml_tpu_torch.obs import MetricsRegistry, get_registry

__all__ = ["MetricsLogger"]

# caller metric keys are free-form but Prometheus names are not: one bad
# character would make a textfile collector reject the whole file
_PROM_SAFE = re.compile(r"[^a-zA-Z0-9_:]")


def _scalar(v: Any) -> Any:
    if hasattr(v, "item") and getattr(v, "ndim", 0) == 0:
        return float(v.item())
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsLogger:
    """One JSONL record a logged round at ``jsonl_path`` (appended; no file
    with ``None``); the float fields feed ``registry`` (default: the
    process-wide one)."""

    def __init__(self, jsonl_path: str | None = None, registry: MetricsRegistry | None = None):
        self._file: IO | None = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()
        self._registry = registry if registry is not None else get_registry()

    def log(self, round_idx: int, metrics: dict[str, Any]) -> dict:
        """Write round ``round_idx``'s record, set its gauges and return it."""
        record = {"round": round_idx, "wall_s": round(time.time() - self._t0, 3),
                  **{k: _scalar(v) for k, v in metrics.items()}}
        for k, v in record.items():
            if k != "round" and isinstance(v, float):
                self._registry.gauge(_PROM_SAFE.sub("_", f"consensusml_{k}")).set(v)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        return record

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
