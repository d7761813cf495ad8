"""Metrics logging: JSONL records of the rounds (port of
``consensusml_tpu/utils/logging.py``, without the observability registry
the reference's shim also feeds).

``MetricsLogger(path)`` appends one JSON object a logged round: ``round``,
``wall_s`` (seconds since the logger opened, to the millisecond) and the
round's metrics, tensors and numpy scalars as floats, as the reference
writes them. It is a context manager, so the file closes on an exception
too. The train CLI's ``--metrics-out PATH`` writes it at ``--log-every``.
"""

from __future__ import annotations

import json
import time
from typing import IO, Any

__all__ = ["MetricsLogger"]


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
    with ``None``)."""

    def __init__(self, jsonl_path: str | None = None):
        self._file: IO | None = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

    def log(self, round_idx: int, metrics: dict[str, Any]) -> dict:
        """Write round ``round_idx``'s record and return it."""
        record = {"round": round_idx, "wall_s": round(time.time() - self._t0, 3),
                  **{k: _scalar(v) for k, v in metrics.items()}}
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
