"""Bounded-time failure detection for training (port of
``consensusml_tpu/utils/watchdog.py``).

When a peer process dies mid-round, the survivors' next collective never
completes: a gloo or NCCL call waits for a participant that is gone,
inside C++ code that Python cannot interrupt. The watchdog bounds the
exit anyway: a daemon thread watches a heartbeat the round loop taps once
a round, and when no beat lands within the timeout it prints a diagnostic
and hard-exits (``os._exit``: the main thread cannot be recovered, so the
interpreter's cleanup is skipped) with ``exit_code`` 3, which a launcher
tells apart from a bad configuration's 2.

The train CLI's ``--round-timeout SECONDS`` turns it on; it arms after the
first completed round (``arm_on_first_beat``), so the first round's
kernel builds and warm-up never count, and :meth:`ProgressWatchdog.pause`
suspends it while a periodic eval runs. Each beat also counts
``consensusml_watchdog_beats_total`` in the telemetry registry, as the
reference's does; the train CLI's ``on_timeout`` counts the timeout and
dumps the flight recorder (``--flight-recorder``) before the exit.
"""

from __future__ import annotations

import os
import sys
import threading
import time

__all__ = ["ProgressWatchdog"]


class ProgressWatchdog:
    """Hard-exit the process if :meth:`beat` stops arriving.

    ``beat(tag)`` is called after every unit of progress; the monitor
    thread fires when ``timeout_s`` passes without one and exits with
    ``exit_code`` through ``exit_fn`` (``os._exit``; injectable for
    tests). ``on_timeout(reason)`` runs, exception-guarded, between the
    diagnostic and the exit. The deadline, tag and armed flag move under
    one lock, so the monitor always reads a consistent beat."""

    def __init__(self, timeout_s: float, label: str = "train round", exit_code: int = 3,
                 arm_on_first_beat: bool = True, on_timeout=None, exit_fn=os._exit):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.label = label
        self.exit_code = exit_code
        self.on_timeout = on_timeout
        self._exit_fn = exit_fn
        self._lock = threading.Lock()
        self._armed = not arm_on_first_beat
        self._last = time.monotonic()
        self._tag: object = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "ProgressWatchdog":
        with self._lock:
            self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, name="progress-watchdog", daemon=True)
        self._thread.start()
        return self

    def beat(self, tag: object = None) -> None:
        """Record progress (one uncontended lock, once a round)."""
        with self._lock:
            self._last = time.monotonic()
            self._tag = tag
            self._armed = True
        from consensusml_tpu_torch.obs import get_registry

        get_registry().counter(
            "consensusml_watchdog_beats_total", "watchdog progress beats (one per completed unit of work)"
        ).inc()

    def pause(self) -> None:
        """Suspend the deadline until the next :meth:`beat`, for a phase
        with no per-round budget (a periodic eval); the clock restarts from
        the resuming beat."""
        with self._lock:
            self._armed = False

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        poll = min(1.0, self.timeout_s / 4)
        while not self._stop.wait(poll):
            with self._lock:
                if not self._armed:
                    self._last = time.monotonic()
                    continue
                stalled = time.monotonic() - self._last
                tag = self._tag
            if stalled > self.timeout_s:
                reason = (f"no {self.label} progress for {stalled:.0f}s (timeout {self.timeout_s:.0f}s, "
                          f"last progress: {tag})")
                print(f"watchdog: {reason}; a peer process has likely died mid-collective: exiting so the "
                      "launcher can reschedule (see consensusml_tpu_torch.utils.watchdog)",
                      file=sys.stderr, flush=True)
                if self.on_timeout is not None:
                    try:
                        self.on_timeout(f"watchdog-timeout: {reason}")
                    except Exception as e:
                        print(f"watchdog: on_timeout hook failed: {e}", file=sys.stderr, flush=True)
                self._exit_fn(self.exit_code)
                return  # only reached with a test's exit_fn
