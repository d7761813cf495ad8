"""The collective backend's transport: how the bytes of a gossip round
move between ranks (one process per worker, one ``torch.distributed``
process group).

Two implementations behind one small interface, chosen explicitly
(``--dist-backend``); neither switches to the other on its own, and
neither moves compute off the rank's device:

- :class:`NcclTransport`: CUDA tensors go to NCCL as they are. NCCL
  refuses two ranks on one GPU, so it needs a card per rank
  (:func:`check_nccl_world`).
- :class:`GlooTransport`: CPU tensors go to ``gloo`` as they are. CUDA
  tensors are copied into pinned host buffers, sent and received by
  ``gloo``, and copied back to the rank's device; a CUDA tensor is never
  handed to a ``gloo`` op. This runs any number of ranks on one card:
  the kernels run on the card in every rank, and only the bytes between
  ranks cross host memory.

Every tensor crosses as its raw bytes (a ``uint8`` view), so any dtype
rides either backend (``uint16`` top-k indices, ``float8_e4m3fn`` codes).
A receive takes the shape and dtype of the sender's tensor in the same
position: every rank runs one plan, so its tensors match its peers'.

Each transport counts what it moved (:class:`TransportStats`): the bytes
it sent (a payload sent to two neighbours counts twice; an all-reduce
counts its input once, one send of the wire model), the bytes it staged
between card and host, and the host time spent staging and waiting on
the wire.

Exchanges and all-reduces come in two halves: :meth:`Transport.
exchange_start` and :meth:`Transport.all_reduce_sum_start` stage what is
sent (``gloo``: on a side CUDA stream into pinned host buffers) and post
every request, then return an :class:`InFlight` whose ``wait()`` waits on
the requests, copies what came back to the rank's device and returns it.
Between the two the rank may do other work (overlap gossip runs its local
steps there). :meth:`Transport.exchange` and :meth:`Transport.
all_reduce_sum` are the two halves back to back. What is sent is staged
at the start, so the caller may overwrite its tensors in between; on the
CPU, where ``gloo`` reads the tensors themselves, the start sends
copies.
"""

from __future__ import annotations

import abc
import dataclasses
import time

import torch
import torch.distributed as dist

__all__ = [
    "DIST_BACKENDS",
    "InFlight",
    "TransportStats",
    "Transport",
    "GlooTransport",
    "NcclTransport",
    "make_transport",
    "check_nccl_world",
]

DIST_BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class TransportStats:
    """What a transport moved since it was made (totals; read deltas)."""

    bytes_sent: int = 0  # payload bytes this rank sent (exchanges and all-reduce inputs)
    bytes_staged: int = 0  # bytes copied between the card and pinned host buffers, both ways
    staging_ms: float = 0.0  # host time of those copies, each direction ending in a synchronisation
    wire_ms: float = 0.0  # host time waiting on the process group's sends, receives and reductions

    def snapshot(self) -> "TransportStats":
        return dataclasses.replace(self)

    def since(self, before: "TransportStats") -> dict:
        return {f.name: getattr(self, f.name) - getattr(before, f.name) for f in dataclasses.fields(self)}


class InFlight:
    """Posted requests: :meth:`wait` finishes them once and returns what
    the start's ``finish`` gives (later calls return the same)."""

    def __init__(self, finish):
        self._finish, self._done, self._out = finish, False, None

    def wait(self):
        if not self._done:
            self._out, self._finish = self._finish(), None
            self._done = True
        return self._out


def check_nccl_world(world_size: int, device_count: int) -> None:
    """NCCL takes one rank per card: refuse a world larger than the cards."""
    if world_size > device_count:
        raise ValueError(
            f"--dist-backend nccl needs one CUDA device per rank, but the world is {world_size} ranks "
            f"and {device_count} device(s) are visible (NCCL refuses two ranks on one GPU); use "
            "--dist-backend gloo, which stages the wire through pinned host memory"
        )


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class Transport(abc.ABC):
    """Shift exchanges and all-reduce sums of tensor lists on one rank."""

    name: str

    def __init__(self, group, rank: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.device = device
        self.stats = TransportStats()

    def exchange(self, tensors: list[torch.Tensor], routes: list[tuple[int, int]]) -> list[list[torch.Tensor]]:
        """For each route ``(dst, src)``: send every tensor of ``tensors``
        to rank ``dst`` and receive the same list's counterparts from rank
        ``src``. Every send and receive of every route is posted before
        any is waited on. Returns, per route, the received tensors on this
        rank's device, shaped and typed as ``tensors``."""
        return self.exchange_start(tensors, routes).wait()

    def all_reduce_sum(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor summed over every rank (new tensors, same device)."""
        return self.all_reduce_sum_start(tensors).wait()

    @abc.abstractmethod
    def exchange_start(self, tensors: list[torch.Tensor], routes: list[tuple[int, int]]) -> InFlight:
        """:meth:`exchange` with every request posted and nothing waited
        on: ``wait()`` gives its result."""

    @abc.abstractmethod
    def all_reduce_sum_start(self, tensors: list[torch.Tensor]) -> InFlight:
        """:meth:`all_reduce_sum` posted: ``wait()`` gives its result."""

    @staticmethod
    def _tag(route: int, item: int, items: int) -> int:
        # ring(2) sends both shifts to one peer: a tag per (route, item)
        # keeps every message apart
        return route * items + item

    def _count_sent(self, tensors: list[torch.Tensor], routes: int) -> None:
        self.stats.bytes_sent += routes * sum(t.numel() * t.element_size() for t in tensors)


class GlooTransport(Transport):
    """``gloo`` over CPU tensors; CUDA tensors staged through pinned host
    buffers (see the module docstring)."""

    name = "gloo"

    def __init__(self, group, rank: int, device: torch.device):
        super().__init__(group, rank, device)
        self._side = None  # the side CUDA stream the start stages on, made at first use

    def _to_host(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Pinned host copies of ``tensors``' bytes, staged on the side
        stream (after the work queued so far on the current one) and
        complete on return; on the CPU, copies of the tensors (``gloo``
        reads a buffer while the request is in flight)."""
        raw = [_as_bytes(t) for t in tensors]
        if self.device.type != "cuda":
            return [r.clone() for r in raw]
        t0 = time.perf_counter()
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        host = [torch.empty(r.numel(), dtype=torch.uint8, pin_memory=True) for r in raw]
        with torch.cuda.stream(self._side):
            for h, r in zip(host, raw):
                h.copy_(r, non_blocking=True)
        self._side.synchronize()
        self.stats.staging_ms += 1e3 * (time.perf_counter() - t0)
        self.stats.bytes_staged += sum(r.numel() for r in raw)
        return host

    def _to_device(self, host: list[torch.Tensor], likes: list) -> list[torch.Tensor]:
        """``host`` bytes as tensors shaped and typed as ``likes`` (each a
        ``(shape, dtype)``) on the rank's device."""
        if self.device.type != "cuda":
            return [h.view(dtype).reshape(shape) for h, (shape, dtype) in zip(host, likes)]
        t0 = time.perf_counter()
        out = [torch.empty(shape, dtype=dtype, device=self.device) for shape, dtype in likes]
        for o, h in zip(out, host):
            _as_bytes(o).copy_(h, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats.staging_ms += 1e3 * (time.perf_counter() - t0)
        self.stats.bytes_staged += sum(h.numel() for h in host)
        return out

    def exchange_start(self, tensors, routes):
        if not routes or not tensors:
            return InFlight(lambda: [[] for _ in routes])
        self._count_sent(tensors, len(routes))
        likes = [(tuple(t.shape), t.dtype) for t in tensors]
        # staged once, whatever the number of neighbours it goes to
        host = self._to_host(tensors)
        pinned = self.device.type == "cuda"
        recv = [[torch.empty(h.numel(), dtype=torch.uint8, pin_memory=pinned) for h in host] for _ in routes]
        reqs = []
        for k, (dst, src) in enumerate(routes):
            for i, h in enumerate(host):
                tag = self._tag(k, i, len(host))
                reqs.append(dist.irecv(recv[k][i], src=src, group=self.group, tag=tag))
                reqs.append(dist.isend(h, dst=dst, group=self.group, tag=tag))

        def finish():
            t0 = time.perf_counter()
            for req in reqs:
                req.wait()
            self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
            del host[:]
            return [self._to_device(r, likes) for r in recv]

        return InFlight(finish)

    def all_reduce_sum_start(self, tensors):
        if not tensors:
            return InFlight(list)
        self._count_sent(tensors, 1)
        # one reduction a dtype over the tensors laid end to end: each gloo
        # call costs the host a fixed overhead, which a tree of hundreds of
        # small leaves (the consensus error's mean) would pay once a leaf
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        posted = []
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            if self.device.type == "cuda":
                flat = self._to_host([flat])[0].view(flat.dtype)
            posted.append((idx, flat, dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group,
                                                      async_op=True)))
        shapes = [t.shape for t in tensors]

        def finish():
            out: list = [None] * len(shapes)
            for idx, flat, work in posted:
                t0 = time.perf_counter()
                work.wait()
                self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
                if self.device.type == "cuda":
                    flat = self._to_device([flat.view(torch.uint8)], [(tuple(flat.shape), flat.dtype)])[0]
                offset = 0
                for i in idx:
                    n = shapes[i].numel()
                    out[i] = flat[offset: offset + n].view(shapes[i])
                    offset += n
            return out

        return InFlight(finish)


class NcclTransport(Transport):
    """NCCL on the rank's own card: no staging. Needs a card per rank."""

    name = "nccl"

    def __init__(self, group, rank: int, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"--dist-backend nccl moves CUDA tensors only; the rank's device is {device}")
        super().__init__(group, rank, device)

    def exchange_start(self, tensors, routes):
        if not routes or not tensors:
            return InFlight(lambda: [[] for _ in routes])
        self._count_sent(tensors, len(routes))
        # copies: NCCL reads its send buffers while the requests are in flight
        raw = [_as_bytes(t).clone() for t in tensors]
        likes = [(tuple(t.shape), t.dtype) for t in tensors]
        recv = [[torch.empty_like(r) for r in raw] for _ in routes]
        ops = []
        for k, (dst, src) in enumerate(routes):
            for i, r in enumerate(raw):
                tag = self._tag(k, i, len(raw))
                ops.append(dist.P2POp(dist.irecv, recv[k][i], src, self.group, tag))
                ops.append(dist.P2POp(dist.isend, r, dst, self.group, tag))
        reqs = dist.batch_isend_irecv(ops)

        def finish():
            t0 = time.perf_counter()
            for req in reqs:
                req.wait()
            self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
            del raw[:]
            return [[b.view(dtype).reshape(shape) for b, (shape, dtype) in zip(per_route, likes)]
                    for per_route in recv]

        return InFlight(finish)

    def all_reduce_sum_start(self, tensors):
        if not tensors:
            return InFlight(list)
        self._count_sent(tensors, 1)
        out = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
        reqs = [dist.all_reduce(o, op=dist.ReduceOp.SUM, group=self.group, async_op=True) for o in out]

        def finish():
            t0 = time.perf_counter()
            for req in reqs:
                req.wait()
            self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
            return out

        return InFlight(finish)


def make_transport(dist_backend: str, group, rank: int, device: torch.device) -> Transport:
    if dist_backend == "gloo":
        return GlooTransport(group, rank, device)
    if dist_backend == "nccl":
        return NcclTransport(group, rank, device)
    raise ValueError(f"unknown dist backend {dist_backend!r} (one of {DIST_BACKENDS})")
