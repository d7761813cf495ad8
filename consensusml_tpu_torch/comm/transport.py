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
"""

from __future__ import annotations

import abc
import dataclasses
import time

import torch
import torch.distributed as dist

__all__ = [
    "DIST_BACKENDS",
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


def _from_bytes(raw: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return raw.view(like.dtype).reshape(like.shape)


class Transport(abc.ABC):
    """Shift exchanges and all-reduce sums of tensor lists on one rank."""

    name: str

    def __init__(self, group, rank: int, device: torch.device):
        self.group = group
        self.rank = rank
        self.device = device
        self.stats = TransportStats()

    @abc.abstractmethod
    def exchange(self, tensors: list[torch.Tensor], routes: list[tuple[int, int]]) -> list[list[torch.Tensor]]:
        """For each route ``(dst, src)``: send every tensor of ``tensors``
        to rank ``dst`` and receive the same list's counterparts from rank
        ``src``. Every send and receive of every route is posted before
        any is waited on. Returns, per route, the received tensors on this
        rank's device, shaped and typed as ``tensors``."""

    @abc.abstractmethod
    def all_reduce_sum(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor summed over every rank (new tensors, same device)."""

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

    def _to_host(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        raw = [_as_bytes(t) for t in tensors]
        if self.device.type != "cuda":
            return raw
        t0 = time.perf_counter()
        host = [torch.empty(r.numel(), dtype=torch.uint8, pin_memory=True) for r in raw]
        for h, r in zip(host, raw):
            h.copy_(r, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats.staging_ms += 1e3 * (time.perf_counter() - t0)
        self.stats.bytes_staged += sum(r.numel() for r in raw)
        return host

    def _to_device(self, host: list[torch.Tensor], likes: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.device.type != "cuda":
            return [_from_bytes(h, like) for h, like in zip(host, likes)]
        t0 = time.perf_counter()
        out = [torch.empty_like(like, memory_format=torch.contiguous_format) for like in likes]
        for o, h in zip(out, host):
            _as_bytes(o).copy_(h, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        self.stats.staging_ms += 1e3 * (time.perf_counter() - t0)
        self.stats.bytes_staged += sum(h.numel() for h in host)
        return out

    def exchange(self, tensors, routes):
        if not routes or not tensors:
            return [[] for _ in routes]
        self._count_sent(tensors, len(routes))
        # staged once, whatever the number of neighbours it goes to
        host = self._to_host(tensors)
        pinned = self.device.type == "cuda"
        recv = [[torch.empty(h.numel(), dtype=torch.uint8, pin_memory=pinned) for h in host] for _ in routes]
        t0 = time.perf_counter()
        reqs = []
        for k, (dst, src) in enumerate(routes):
            for i, h in enumerate(host):
                tag = self._tag(k, i, len(host))
                reqs.append(dist.irecv(recv[k][i], src=src, group=self.group, tag=tag))
                reqs.append(dist.isend(h, dst=dst, group=self.group, tag=tag))
        for req in reqs:
            req.wait()
        self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
        return [self._to_device(r, tensors) for r in recv]

    def all_reduce_sum(self, tensors):
        if not tensors:
            return []
        self._count_sent(tensors, 1)
        # one reduction a dtype over the tensors laid end to end: each gloo
        # call costs the host a fixed overhead, which a tree of hundreds of
        # small leaves (the consensus error's mean) would pay once a leaf
        out: list = [None] * len(tensors)
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            if self.device.type == "cuda":
                t0 = time.perf_counter()
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                host.copy_(flat, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                self.stats.staging_ms += 1e3 * (time.perf_counter() - t0)
                self.stats.bytes_staged += flat.numel() * flat.element_size()
                flat = host
            t0 = time.perf_counter()
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
            if self.device.type == "cuda":
                t0 = time.perf_counter()
                flat = flat.to(self.device, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                self.stats.staging_ms += 1e3 * (time.perf_counter() - t0)
                self.stats.bytes_staged += flat.numel() * flat.element_size()
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[offset: offset + n].view(tensors[i].shape)
                offset += n
        return out


class NcclTransport(Transport):
    """NCCL on the rank's own card: no staging. Needs a card per rank."""

    name = "nccl"

    def __init__(self, group, rank: int, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"--dist-backend nccl moves CUDA tensors only; the rank's device is {device}")
        super().__init__(group, rank, device)

    def exchange(self, tensors, routes):
        if not routes or not tensors:
            return [[] for _ in routes]
        self._count_sent(tensors, len(routes))
        raw = [_as_bytes(t) for t in tensors]
        recv = [[torch.empty_like(r) for r in raw] for _ in routes]
        ops = []
        for k, (dst, src) in enumerate(routes):
            for i, r in enumerate(raw):
                tag = self._tag(k, i, len(raw))
                ops.append(dist.P2POp(dist.irecv, recv[k][i], src, self.group, tag))
                ops.append(dist.P2POp(dist.isend, r, dst, self.group, tag))
        t0 = time.perf_counter()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
        return [[_from_bytes(b, t) for b, t in zip(per_route, tensors)] for per_route in recv]

    def all_reduce_sum(self, tensors):
        if not tensors:
            return []
        self._count_sent(tensors, 1)
        out = [t.clone(memory_format=torch.contiguous_format) for t in tensors]
        t0 = time.perf_counter()
        reqs = [dist.all_reduce(o, op=dist.ReduceOp.SUM, group=self.group, async_op=True) for o in out]
        for req in reqs:
            req.wait()
        self.stats.wire_ms += 1e3 * (time.perf_counter() - t0)
        return out


def make_transport(dist_backend: str, group, rank: int, device: torch.device) -> Transport:
    if dist_backend == "gloo":
        return GlooTransport(group, rank, device)
    if dist_backend == "nccl":
        return NcclTransport(group, rank, device)
    raise ValueError(f"unknown dist backend {dist_backend!r} (one of {DIST_BACKENDS})")
