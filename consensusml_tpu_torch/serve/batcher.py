"""Slot-based continuous batching: requests, handles, slot table.

Port of ``consensusml_tpu/serve/batcher.py`` (host-side bookkeeping, with
the reference's tracing, tenant, speculative and accounting fields).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator

__all__ = ["Request", "RequestHandle", "GenResult", "SlotTable", "Slot"]

_DONE = object()  # stream sentinel


@dataclasses.dataclass
class GenResult:
    """Terminal record of one request."""

    tokens: list[int]
    finish_reason: str  # "eos" | "max_tokens" | "length" | "cancelled"
    ttft_s: float  # arrival -> first token
    latency_s: float  # arrival -> completion
    prompt_len: int
    generation: int = 0  # artifact generation that finished the stream
    # request-scoped tracing identity (obs/requests.py): clients join
    # their own observations to the server's trace on these
    trace_id: str = ""
    request_id: str = ""
    # resolved sampling parameters, echoed for deterministic replay
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    # speculative-decode accounting of this stream (0/0 without a draft)
    spec_proposed: int = 0
    spec_accepted: int = 0
    tenant: str = "default"  # the workload label (obs/events.py)
    # pool block-seconds held exclusively, and prefix-shared (charged apart)
    block_seconds: float = 0.0
    shared_block_seconds: float = 0.0
    prefix_hit_blocks: int = 0  # blocks mapped in from the prefix index


class RequestHandle:
    """Client-side view of an in-flight request: a token stream plus the
    final :class:`GenResult`. Thread-safe; one consumer per handle."""

    def __init__(self, prompt_len: int):
        self._stream: "queue.Queue[Any]" = queue.Queue()
        self._done = threading.Event()
        self._result: GenResult | None = None
        self._all: list[int] = []  # engine-thread only until _finish
        self._ttft_s = 0.0
        self.prompt_len = prompt_len

    # engine side -----------------------------------------------------------
    def _emit(self, token: int) -> None:
        self._all.append(token)
        self._stream.put(token)

    def _finish(self, result: GenResult) -> None:
        self._result = result
        self._done.set()
        self._stream.put(_DONE)

    # client side -----------------------------------------------------------
    def tokens(self, timeout: float | None = None) -> Iterator[int]:
        """Stream generated tokens as they land (blocks between tokens)."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is _DONE:
                return
            yield item

    def result(self, timeout: float | None = None) -> GenResult:
        if not self._done.wait(timeout):
            raise TimeoutError("request still in flight")
        return self._result

    @property
    def done(self) -> bool:
        return self._done.is_set()


@dataclasses.dataclass
class Request:
    ids: list[int]
    max_new_tokens: int
    handle: RequestHandle
    arrival_t: float = dataclasses.field(default_factory=time.perf_counter)
    # obs.TraceContext: trace_id / request_id carried end to end
    ctx: Any = None
    # per-request sampling: temperature 0 = greedy; the seed keys the
    # (seed, position) draws, so the same seed replays the same stream
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    eos_id: int | None = None  # None = stop on the token cap only
    tenant: str = "default"  # the prefix cache's namespace and the wide event's label
    # speculative accounting (per stream, across preemptions)
    spec_proposed: int = 0
    spec_accepted: int = 0
    # the wide event's cost join: resident ticks, block-seconds held, the
    # prefill bucket (and kind, "full" or "prefix") of every admission
    decode_ticks: int = 0
    block_seconds: float = 0.0
    prefill_buckets: list[int] = dataclasses.field(default_factory=list)
    prefix_hit_blocks: int = 0
    shared_block_seconds: float = 0.0
    prefill_kinds: list[str] = dataclasses.field(default_factory=list)

    @property
    def request_id(self) -> str:
        return getattr(self.ctx, "request_id", "") or ""


@dataclasses.dataclass
class Slot:
    """One decode lane. ``next_pos`` is where the PENDING token will be
    written/attended on the next decode step; ``pending`` is that token
    (the newest generated one, already emitted to the client)."""

    request: Request
    next_pos: int  # == prompt_len right after prefill
    pending: int
    generated: int = 1  # prefill produced token #1
    ttft_s: float = 0.0
    last_token_t: float = 0.0
    generation: int = 0  # the artifact generation the stream runs under


class SlotTable:
    """Fixed-size slot bookkeeping (engine-thread only, no locking)."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.slots: list[Slot | None] = [None] * num_slots

    @property
    def active(self) -> list[tuple[int, Slot]]:
        return [(i, s) for i, s in enumerate(self.slots) if s is not None]

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def occupy(self, idx: int, slot: Slot) -> None:
        if self.slots[idx] is not None:
            raise RuntimeError(f"slot {idx} already occupied")
        self.slots[idx] = slot

    def release(self, idx: int) -> Slot:
        slot = self.slots[idx]
        if slot is None:
            raise RuntimeError(f"slot {idx} already free")
        self.slots[idx] = None
        return slot
