"""The overlapped host-to-device feed (port of
``consensusml_tpu/data/prefetch.py``): a round prefetcher.

:class:`DevicePrefetcher` pulls host round batches from a source iterator
on a background thread and stages each on the device while the current
round runs, so the consumer's ``__next__`` is a queue pop: no host work,
no copy and no host sync between rounds.

On a CUDA device each host leaf goes to the card with a ``non_blocking``
copy on a side stream, and an event is recorded after the batch's copies.
A leaf of a :class:`FeedItem` with an ``on_done`` (a source's own buffer,
untouched until ``on_done``) that lies in page-locked memory (the native
ring's slots, which its loader registers with ``cudaHostRegister``) is
copied in place; any other host leaf (numpy's arrays, the Python loaders'
tensors) is first copied into a pinned buffer, since a copy from pageable
memory would not overlap. The
consumer's stream waits on the event in ``__next__`` (no host wait) and
every staged tensor is recorded on the consumer's stream, so the caching
allocator never hands its memory out early. A :class:`FeedItem`'s
``on_done`` (the native ring's slot release) fires on the background
thread once that event has completed: the copy reads the slot itself, so
only then may the producers rewrite it. The window of copies in flight is
``depth``, clamped to ``pool - 1`` for a source that rotates ``pool``
buffers, and the background thread waits on the oldest copy's event
before it takes another item.

On the CPU numpy leaves are copied (a tensor made from an array aliases
its memory, so a rotating buffer would rewrite a batch the consumer still
holds), as the reference copies them for its CPU backend; host tensors
are taken as they are.

Determinism: one producer thread, a FIFO queue and sources that are pure
functions of ``(seed, round)``, so the batch sequence is the same at every
depth, with or without the prefetcher.

Telemetry, the reference's families: ``consensusml_feed_stall_seconds``
(the last round's wait for its batch), ``consensusml_feed_stall_seconds_total``,
``consensusml_feed_batches_total``, ``consensusml_feed_inflight`` (staged
batches ready at the pop) and ``consensusml_feed_staged_bytes``.
"""

from __future__ import annotations

import ctypes
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from consensusml_tpu_torch.obs import get_registry
from consensusml_tpu_torch.utils import tree as T

__all__ = ["FeedItem", "DevicePrefetcher", "prefetch_to_device"]

_STALL = get_registry().gauge(
    "consensusml_feed_stall_seconds",
    "host wait for the current round's batch at the prefetch queue "
    "(~0 when transfer fully overlaps compute)",
)
_STALL_TOTAL = get_registry().counter(
    "consensusml_feed_stall_seconds_total",
    "cumulative feed-stall wait across rounds",
)
_BATCHES_OUT = get_registry().counter(
    "consensusml_feed_batches_total",
    "round batches delivered by the device prefetcher",
)
_INFLIGHT = get_registry().gauge(
    "consensusml_feed_inflight",
    "staged round batches ready in the prefetch queue (sampled at pop)",
)
_STAGED_BYTES = get_registry().gauge(
    "consensusml_feed_staged_bytes",
    "device bytes of round batches staged ahead by the prefetcher "
    "(queue occupancy x per-batch bytes, sampled at pop)",
)


class FeedItem(NamedTuple):
    """One source item: a host batch, an optional hook fired (on the
    background thread) once the batch's copy to the device has completed,
    and ``pool``, how many host buffers the source rotates (each copy in
    flight pins one, so the prefetcher keeps at most ``pool - 1`` in
    flight)."""

    batch: Any
    on_done: Callable[[], None] | None = None
    pool: int | None = None


class _Stop(Exception):
    """Internal: the consumer closed while the producer was blocked."""


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _host_tensor(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``x``'s own bytes, for a copy to the card. A
    read-only view (a ring slot's) is aliased through its address, as
    ``torch.from_numpy`` would warn on it; its owner keeps it alive until
    the copy has completed."""
    if x.flags.writeable or not x.flags.c_contiguous or x.nbytes == 0:
        return torch.from_numpy(np.ascontiguousarray(x))
    buf = (ctypes.c_char * x.nbytes).from_address(x.ctypes.data)
    return torch.frombuffer(buf, dtype=torch.uint8).view(_torch_dtype(x.dtype)).view(x.shape)


class DevicePrefetcher:
    """Stage the next round batches on ``device`` while the current round
    runs (``depth`` of them ready ahead of the consumer; 2 = double
    buffering). ``device=None`` is the card. Iterate it; it closes itself
    at the end of the source, and ``close()`` is idempotent for early
    exits."""

    def __init__(self, source: Iterable[Any], depth: int = 2, *, device=None):
        from consensusml_tpu_torch.device import resolve_device

        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        self._source = iter(source)
        self._queue: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._error: BaseException | None = None
        self._closed = False
        self._exhausted = False
        # this feed's own numbers, beside the process-wide registry
        self.stall_seconds_total = 0.0
        self.last_stall_s = 0.0
        self.batches_out = 0
        self.h2d_bytes_total = 0  # host bytes copied to the card
        self.last_h2d_bytes = 0
        self._batch_nbytes: int | None = None
        self._thread = threading.Thread(target=self._run, name="device-prefetch", daemon=True)
        self._thread.start()

    # -- producer side (background thread) --------------------------------

    def _put_leaf(self, x: Any, in_place: bool):
        """``(staged leaf, host bytes copied to the card)``; ``in_place``: a
        pooled source's buffer, copied from where it lies when that is
        page-locked."""
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x, 0  # already placed: never a second copy
        if not self._cuda:
            if isinstance(x, np.ndarray):
                return torch.from_numpy(x.copy()), 0
            return torch.as_tensor(x).to(self.device), 0
        host = _host_tensor(x) if isinstance(x, np.ndarray) else torch.as_tensor(x)
        # is_pinned() reads only the first byte's page: a source's own buffers
        # lie whole inside one registration, arbitrary arrays may not
        if not (in_place and host.is_pinned()):
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            pinned.copy_(host)
            host = pinned
        with torch.cuda.stream(self._stream):
            return host.to(self.device, non_blocking=True), host.nbytes

    def _stage(self, batch: Any, in_place: bool):
        """``(staged batch, its copies' event or None, host bytes copied)``."""
        leaves, spec = T.flatten(batch)
        staged = [self._put_leaf(x, in_place) for x in leaves]
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
        return T.unflatten(spec, [s for s, _ in staged]), event, sum(n for _, n in staged)

    def _enqueue(self, item: Any) -> None:
        while True:
            if self._stop.is_set():
                raise _Stop
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    @staticmethod
    def _drain_one(pending: list) -> None:
        event, on_done = pending.pop(0)
        if event is not None:
            # on this thread: the host bytes behind the batch stay untouched
            # until its copies to the card have completed
            event.synchronize()
        if on_done is not None:
            on_done()

    def _run(self) -> None:
        pending: list = []  # (event, on_done), oldest first
        window = self.depth  # copies in flight before the oldest is waited on and released
        try:
            for item in self._source:
                if self._stop.is_set():
                    if isinstance(item, FeedItem) and item.on_done is not None:
                        item.on_done()  # pulled, never staged: hand its buffer back
                    break
                if not isinstance(item, FeedItem):
                    item = FeedItem(item)
                if item.pool is not None:
                    # leave at least one buffer of the source's pool to its producers
                    window = min(window, max(0, item.pool - 1))
                staged, event, nbytes = self._stage(item.batch, item.on_done is not None)
                pending.append((event, item.on_done))
                while len(pending) > window:
                    self._drain_one(pending)
                self._enqueue((staged, event, nbytes))
        except _Stop:
            pass
        except BaseException as e:  # surfaced to the consumer
            with self._lock:
                self._error = e
        finally:
            try:
                while pending:
                    self._drain_one(pending)
            except BaseException as e:
                with self._lock:
                    if self._error is None:
                        self._error = e
            try:
                self._enqueue(None)  # end of stream
            except _Stop:
                pass

    # -- consumer side -----------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        with self._lock:
            if self._exhausted:
                raise StopIteration
        _INFLIGHT.set(self._queue.qsize())
        t0 = time.perf_counter()
        item = self._queue.get()
        wait = time.perf_counter() - t0
        if item is None:
            with self._lock:
                self._exhausted = True
            self.close()
            with self._lock:
                err = self._error
            if err is not None:
                raise err
            raise StopIteration
        batch, event, nbytes = item
        if event is not None:
            # the consumer's stream waits for the copies; the host does not
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in T.leaves(batch):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(stream)
        with self._lock:
            self.last_stall_s = wait
            self.stall_seconds_total += wait
            self.batches_out += 1
            self.last_h2d_bytes = nbytes
            self.h2d_bytes_total += nbytes
        _STALL.set(wait)
        _STALL_TOTAL.inc(wait)
        _BATCHES_OUT.inc()
        if self._batch_nbytes is None:
            self._batch_nbytes = sum(int(getattr(x, "nbytes", 0)) for x in T.leaves(batch))
        _STAGED_BYTES.set(self._batch_nbytes * (self._queue.qsize() + 1))
        return batch

    def close(self) -> None:
        """Stop the background thread and close the source; idempotent,
        and safe when the consumer and a GC-driven ``__del__`` race."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._exhausted = True
        self._stop.set()
        try:  # unblock a producer stuck in put
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        try:  # ... and a consumer blocked in get
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            # a wedged producer: closing its source now would raise over the caller's error
            return
        close = getattr(self._source, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(source: Iterable[Any], depth: int = 2, *, device=None) -> Iterable[Any]:
    """``source`` wrapped in a :class:`DevicePrefetcher`; ``depth <= 0``
    returns it unchanged (no overlap: ``--prefetch-depth 0``)."""
    if depth <= 0:
        return source
    return DevicePrefetcher(source, depth, device=device)
