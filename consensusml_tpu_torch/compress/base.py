"""Compressor interface and payloads (port of ``consensusml_tpu/compress/base.py``).

This module carries the API the bucketed CHOCO wires read
(``bucket_alignment``, ``fused_wire``, ``stochastic``, ``wire_bytes``,
``compress_tree``/``decompress_tree``, ``decompress_accumulate``), the
int8, int4 and top-k payloads, and :class:`ComposedCompressor` (an outer
codec on a top-k payload's values). The fp8 payload, and its codec, are
not ported yet.

Stacked workers: the reference vmaps ``compress``/``decompress`` over the
worker axis of the simulated backend. Here that axis is written out:
``compress(x, stacked=True)`` treats ``x``'s leading axis as workers,
compresses each worker's slice on its own (its own chunking and padding),
and returns a payload whose every tensor carries that leading axis;
``decompress`` reads the axis off the payload. A payload's ``shape`` is
always the per-worker shape.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar

import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "Compressor",
    "Int8Payload",
    "Int4Payload",
    "Fp8Payload",
    "TopKPayload",
    "LocalTopKPayload",
    "ComposedCompressor",
    "static_k",
    "worker_rows",
    "FP8_E4M3_MAX",
]

# float8_e4m3fn's largest finite value: the "levels" of the fp8 codecs, as
# 127 is int8's and 7 int4's
FP8_E4M3_MAX = 448.0


def static_k(size: int, ratio: float, k: int | None) -> int:
    """The static per-tensor k: explicit ``k`` wins, else ``round(ratio *
    size)``, clamped to ``[1, size]`` (the reference's shared policy)."""
    if k is not None:
        return max(1, min(k, size))
    return max(1, min(size, int(round(size * ratio))))


def worker_rows(x: torch.Tensor, stacked: bool) -> tuple[tuple[int, ...], torch.Tensor]:
    """``(lead, flat)``: ``flat`` is ``(L, n)`` f32 with one row per worker
    (``L = 1`` unstacked), ``lead`` the leading shape payloads carry."""
    lead = (x.shape[0],) if stacked else ()
    return lead, x.reshape(x.shape[0] if stacked else 1, -1).to(torch.float32)


def _wire(t) -> tuple[torch.Tensor, ...]:
    return t.wire_tensors() if hasattr(t, "wire_tensors") else (t,)


class _WirePayload:
    """A payload dataclass whose ``WIRE`` fields, in that order, are what
    travels: each a tensor or a nested payload. The one statement of the
    payload's wire format, read both ways."""

    WIRE: ClassVar[tuple[str, ...]]

    def wire_tensors(self) -> tuple[torch.Tensor, ...]:
        return tuple(t for name in self.WIRE for t in _wire(getattr(self, name)))

    def with_wire(self, tensors):
        """This payload with its wire tensors replaced, in
        :meth:`wire_tensors` order, by ``tensors`` (what a neighbour sent:
        the same shapes and dtypes)."""
        it = iter(tensors)
        out = self._take(it)
        if next(it, None) is not None:
            raise ValueError("more tensors than the payload has wire tensors")
        return out

    def _take(self, it):
        changes = {}
        for name in self.WIRE:
            value = getattr(self, name)
            changes[name] = value._take(it) if isinstance(value, _WirePayload) else next(it)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Int8Payload(_WirePayload):
    """Per-chunk symmetric int8 quantization: int8 data + f32 chunk scales."""

    data: torch.Tensor  # (padded_n,) int8, or (W, padded_n) stacked
    scales: torch.Tensor  # (num_chunks,) float32, or (W, num_chunks)
    shape: tuple[int, ...]
    dtype: Any
    chunk: int

    WIRE: ClassVar[tuple[str, ...]] = ("data", "scales")


@dataclasses.dataclass(frozen=True)
class Int4Payload(_WirePayload):
    """Per-chunk symmetric int4 quantization, two values per byte: within
    each ``chunk``-wide row, byte ``j`` holds element ``j`` in its low
    nibble and element ``j + chunk // 2`` in its high nibble (half-split
    pairing), two's complement in ``[-7, 7]``; one f32 scale a chunk. A
    chunk costs ``chunk / 2 + 4`` wire bytes."""

    data: torch.Tensor  # (padded_n // 2,) uint8, or (W, padded_n // 2) stacked
    scales: torch.Tensor  # (num_chunks,) float32, or (W, num_chunks)
    shape: tuple[int, ...]
    dtype: Any
    chunk: int

    WIRE: ClassVar[tuple[str, ...]] = ("data", "scales")


@dataclasses.dataclass(frozen=True)
class Fp8Payload(_WirePayload):
    """Per-chunk scaled float8 (e4m3fn): ``scale = absmax / 448`` a chunk,
    so each chunk's largest magnitude lands on the format's largest finite
    value and the rest keep e4m3's three mantissa bits of relative
    precision. One byte an element, as int8; a zero chunk gets scale 0."""

    data: torch.Tensor  # (padded_n,) float8_e4m3fn, or (W, padded_n) stacked
    scales: torch.Tensor  # (num_chunks,) float32, or (W, num_chunks)
    shape: tuple[int, ...]
    dtype: Any
    chunk: int

    WIRE: ClassVar[tuple[str, ...]] = ("data", "scales")


@dataclasses.dataclass(frozen=True)
class TopKPayload(_WirePayload):
    """Top-k sparse tensor: k signed values + flat int32 indices."""

    values: Any  # (k,) tensor or a nested payload; (W, k) stacked
    indices: torch.Tensor  # (k,) int32 into the flattened tensor; (W, k) stacked
    shape: tuple[int, ...]
    dtype: Any

    WIRE: ClassVar[tuple[str, ...]] = ("values", "indices")


@dataclasses.dataclass(frozen=True)
class LocalTopKPayload(_WirePayload):
    """Chunked top-k with narrow chunk-local indices: ``indices[c, j]`` is
    the position of winner ``j`` inside chunk ``c`` (uint16; chunks are at
    most 65536 wide), made global at decode."""

    values: Any  # (nchunks * k,) tensor or a nested payload; (W, ...) stacked
    indices: torch.Tensor  # (nchunks, k) uint16; (W, nchunks, k) stacked
    shape: tuple[int, ...]
    dtype: Any
    chunk: int

    WIRE: ClassVar[tuple[str, ...]] = ("values", "indices")


class Compressor(abc.ABC):
    """Stateless, shape-preserving lossy codec for one tensor:
    ``decompress(compress(x))`` has ``x``'s shape and dtype."""

    stochastic: bool = False

    def bucket_alignment(self) -> int | None:
        """Element alignment under which leaf-aligned bucket packing keeps
        the per-leaf semantics (the chunk, for chunked codecs); ``None``
        keeps the per-leaf path."""
        return None

    def fused_wire(self) -> str | None:
        """Wire format tag of the fused one-pass encode (``"int8"``,
        ``"int4"``, ``"fp8"``), or ``None`` for codecs that keep the
        two-step path."""
        return None

    @abc.abstractmethod
    def compress(self, x: torch.Tensor, stacked: bool = False):
        ...

    @abc.abstractmethod
    def decompress(self, payload) -> torch.Tensor:
        ...

    def wire_bytes(self, shape: tuple[int, ...], dtype=torch.float32) -> int:
        """Bytes exchanged per tensor of ``shape``: the payload of a
        compress on a ``meta`` tensor (shapes only, nothing computed)."""
        payload = self.compress(torch.zeros(shape, dtype=dtype, device="meta"))
        return sum(t.numel() * t.element_size() for t in payload.wire_tensors())

    def compress_tree(self, tree: Any) -> Any:
        if self.stochastic:
            raise NotImplementedError("stochastic codecs are not ported yet")
        return T.tree_map(self.compress, tree)

    def decompress_tree(self, payload_tree: Any, like: Any) -> Any:
        """Decompress a payload tree; ``like`` gives the original structure."""
        # payloads are leaves of the payload tree (dataclasses are not containers)
        return T.unflatten(T.flatten(like)[1], [self.decompress(p) for p in T.leaves(payload_tree)])

    def decompress_accumulate(self, payload, acc: torch.Tensor, weight) -> torch.Tensor:
        """The receive: ``acc + weight * decompress(payload)``, the product
        and the sum each rounded (sparse codecs override it with a
        scatter-add)."""
        return acc + weight * self.decompress(payload).to(acc.dtype)

    def decompress_accumulate_tree(self, payload_tree: Any, acc_tree: Any, weight) -> Any:
        """Leaf-wise :meth:`decompress_accumulate` over a payload tree."""
        acc_leaves, spec = T.flatten(acc_tree)
        out = [self.decompress_accumulate(p, a, weight)
               for p, a in zip(T.leaves(payload_tree), acc_leaves)]
        return T.unflatten(spec, out)


@dataclasses.dataclass(frozen=True)
class ComposedCompressor(Compressor):
    """``outer(inner)``: the outer codec quantizes the values of the inner
    codec's top-k payload; the indices stay exact (int32 global for
    :class:`TopKPayload`, uint16 chunk-local for :class:`LocalTopKPayload`).
    The config-5 codec "top-k sparsified + 8-bit quantized gossip"."""

    inner: Compressor  # produces a TopKPayload or LocalTopKPayload
    outer: Compressor  # applied to payload.values

    @property
    def stochastic(self) -> bool:  # type: ignore[override]
        return self.inner.stochastic or self.outer.stochastic

    def bucket_alignment(self) -> int | None:
        # the inner codec sees the bucket layout; the outer one only
        # quantizes the selected values
        return self.inner.bucket_alignment()

    def compress(self, x: torch.Tensor, stacked: bool = False):
        if self.stochastic:
            raise NotImplementedError("stochastic codecs are not ported yet")
        p = self.inner.compress(x, stacked=stacked)
        if not isinstance(p, (TopKPayload, LocalTopKPayload)):
            raise TypeError("ComposedCompressor.inner must produce a top-k payload")
        return dataclasses.replace(p, values=self.outer.compress(p.values, stacked=stacked))

    def decompress(self, payload) -> torch.Tensor:
        return self.inner.decompress(self._inner_payload(payload))

    def decompress_accumulate(self, payload, acc: torch.Tensor, weight) -> torch.Tensor:
        # decode the (small) values, then the inner codec's scatter-add
        return self.inner.decompress_accumulate(self._inner_payload(payload), acc, weight)

    def _inner_payload(self, payload):
        return dataclasses.replace(payload, values=self.outer.decompress(payload.values))
