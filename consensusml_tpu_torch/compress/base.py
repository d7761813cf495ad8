"""Compressor interface and payloads (port of ``consensusml_tpu/compress/base.py``).

This slice carries the API the bucketed CHOCO wire reads
(``bucket_alignment``, ``fused_wire``, ``stochastic``, ``wire_bytes``,
``compress_tree``/``decompress_tree``) and the int8 payload. The top-k,
int4 and fp8 payloads come with their codecs in later slices.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import torch

from consensusml_tpu_torch.utils import tree as T

__all__ = ["Compressor", "Int8Payload"]


@dataclasses.dataclass(frozen=True)
class Int8Payload:
    """Per-chunk symmetric int8 quantization: int8 data + f32 chunk scales."""

    data: torch.Tensor  # (padded_n,) int8, or (..., padded_n) stacked
    scales: torch.Tensor  # (num_chunks,) float32
    shape: tuple[int, ...]
    dtype: Any
    chunk: int

    def wire_tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.data, self.scales)


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
        """Wire format tag of the fused one-pass encode (``"int8"``), or
        ``None`` for codecs that keep the two-step path."""
        return None

    @abc.abstractmethod
    def compress(self, x: torch.Tensor):
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
