"""Gossip bucketing (port of ``consensusml_tpu/consensus/bucketing.py``).

A static :class:`BucketPlan` packs the gossiped leaves, in the
reference's flatten order, into dtype-homogeneous flat buffers capped at
about ``bucket_bytes`` of estimated wire bytes. Every leaf starts at a
multiple of ``align`` (the codec's chunk) and is zero-padded up to it, so
per-chunk scales inside a bucket see exactly the per-leaf elements, and
zero padding stays zero through CHOCO tracking. A leaf is never split: a
leaf larger than the cap becomes its own bucket.

:class:`FusedWirePlan` marries a plan to the codec's
:class:`~consensusml_tpu_torch.compress.kernels.FusedBucketCodec`: one
encode launch per bucket on the send side. The simulated round drives its
codec bucket by bucket (so one bucket's temporaries are alive at a time);
:meth:`FusedWirePlan.encode`, :meth:`~FusedWirePlan.decode` and
:meth:`~FusedWirePlan.decode_accumulate` are the reference's all-buckets
form, which the collective round uses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

__all__ = ["BucketLeaf", "Bucket", "BucketPlan", "FusedWirePlan", "build_plan", "build_fused_plan"]


def _round_up(n: int, align: int) -> int:
    return -(-n // align) * align


@dataclasses.dataclass(frozen=True)
class BucketLeaf:
    """One leaf's slot inside a bucket (per-worker positions)."""

    index: int  # position in the caller's flat leaf list
    shape: tuple[int, ...]  # per-worker shape
    size: int
    padded: int  # size rounded up to the plan's alignment
    offset: int  # start inside the bucket's flat buffer


@dataclasses.dataclass(frozen=True)
class Bucket:
    dtype: torch.dtype
    leaves: tuple[BucketLeaf, ...]
    total: int  # flat buffer length = sum of padded leaf sizes


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static packing layout, built from per-worker shapes in flatten order."""

    buckets: tuple[Bucket, ...]
    align: int
    n_leaves: int

    @property
    def num_buckets(self) -> int:
        return len(self.buckets)

    def pack(self, leaves: list, stacked: bool = False) -> list[torch.Tensor]:
        """Concatenate ``leaves`` into bucket buffers; ``stacked=True``:
        leaves carry a leading worker axis and buckets come out ``(W,
        total)``."""
        if len(leaves) != self.n_leaves:
            raise ValueError(f"plan covers {self.n_leaves} leaves, got {len(leaves)}")
        out = []
        for bucket in self.buckets:
            parts = []
            for bl in bucket.leaves:
                x = leaves[bl.index]
                flat = x.reshape(x.shape[0], -1) if stacked else x.reshape(-1)
                if bl.padded != bl.size:
                    flat = F.pad(flat, (0, bl.padded - bl.size))
                parts.append(flat)
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=1 if stacked else 0))
        return out

    def unpack(self, bufs: list[torch.Tensor], stacked: bool = False) -> list:
        """Invert :meth:`pack`: views of the buffers in leaf order (padding
        dropped); dtype is the buffer's."""
        if len(bufs) != len(self.buckets):
            raise ValueError(f"plan has {len(self.buckets)} buckets, got {len(bufs)}")
        leaves: list = [None] * self.n_leaves
        for bucket, buf in zip(self.buckets, bufs):
            for bl in bucket.leaves:
                if stacked:
                    piece = buf[:, bl.offset: bl.offset + bl.size]
                    leaves[bl.index] = piece.reshape((buf.shape[0],) + bl.shape)
                else:
                    leaves[bl.index] = buf[bl.offset: bl.offset + bl.size].reshape(bl.shape)
        return leaves


def build_plan(
    leaves: list[tuple[tuple[int, ...], Any]],
    *,
    bucket_bytes: int,
    align: int = 1,
    wire_bytes: Callable[[int, Any], float] | None = None,
) -> BucketPlan:
    """Greedy dtype-grouped packing of ``(per_worker_shape, dtype)`` pairs,
    the reference's algorithm: one bucket open per dtype, closed when the
    next leaf would push its estimate past ``bucket_bytes``; buckets in
    order of their first leaf."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    if wire_bytes is None:
        wire_bytes = lambda n, dtype: n * torch.empty((), dtype=dtype).element_size()

    open_buckets: dict = {}  # dtype -> (leaves, total, est_bytes)
    done: list[Bucket] = []

    def close(dtype) -> None:
        leaves_, total, _ = open_buckets.pop(dtype)
        done.append(Bucket(dtype=dtype, leaves=tuple(leaves_), total=total))

    for index, (shape, dtype) in enumerate(leaves):
        size = 1
        for d in shape:
            size *= d
        padded = _round_up(max(size, 1), align)
        est = wire_bytes(padded, dtype)
        cur = open_buckets.get(dtype)
        if cur is not None and cur[2] + est > bucket_bytes:
            close(dtype)
            cur = None
        if cur is None:
            cur = ([], 0, 0.0)
        bl = BucketLeaf(index=index, shape=tuple(shape), size=size, padded=padded, offset=cur[1])
        open_buckets[dtype] = (cur[0] + [bl], cur[1] + padded, cur[2] + est)
    for dtype in list(open_buckets):
        close(dtype)
    done.sort(key=lambda b: b.leaves[0].index)
    return BucketPlan(buckets=tuple(done), align=align, n_leaves=len(leaves))


@dataclasses.dataclass(frozen=True)
class FusedWirePlan:
    """A :class:`BucketPlan` with the codec's fused one-pass wire. Buffers
    are lists parallel to ``plan.buckets``, flat ``(total,)`` or stacked
    ``(W, total)``."""

    plan: BucketPlan
    codec: Any  # compress.kernels.FusedBucketCodec

    @property
    def num_buckets(self) -> int:
        return self.plan.num_buckets

    def _check(self, bufs: list, what: str) -> None:
        if len(bufs) != self.plan.num_buckets:
            raise ValueError(
                f"fused wire {what}: plan has {self.plan.num_buckets} buckets, got {len(bufs)} buffers"
            )

    def encode(self, bufs: list, xhat_bufs: list):
        """Per bucket ``(payload, xhat')``, one encode each. Returns
        ``(payloads, new_xhat_bufs)``."""
        self._check(bufs, "encode")
        pairs = [self.codec.encode(b, h) for b, h in zip(bufs, xhat_bufs)]
        return [p for p, _ in pairs], [h for _, h in pairs]

    def decode(self, payloads: list) -> list:
        self._check(payloads, "decode")
        return [self.codec.decode(q) for q in payloads]

    def decode_accumulate(self, s_bufs: list, sources: list, weights) -> list:
        """Per bucket ``s + sum_j weights[j] * dec(sources[b][j])``, one
        :func:`~consensusml_tpu_torch.compress.kernels.
        fused_dequantize_accumulate` launch each; ``sources[b]`` lists
        bucket ``b``'s payloads in weight order (self first, then one per
        neighbour shift)."""
        self._check(s_bufs, "decode_accumulate")
        if len(sources) != len(s_bufs):
            raise ValueError(f"{len(s_bufs)} buckets but {len(sources)} source lists")
        return [self.codec.decode_accumulate(s, plist, weights) for s, plist in zip(s_bufs, sources)]


def build_fused_plan(plan: BucketPlan, compressor) -> FusedWirePlan | None:
    """``FusedWirePlan`` for ``plan`` under ``compressor``, or ``None`` when
    the codec has no fused wire."""
    from consensusml_tpu_torch.compress.kernels import fused_bucket_codec

    codec = fused_bucket_codec(compressor)
    if codec is None:
        return None
    if plan.align != codec.chunk:
        raise ValueError(
            f"bucket plan alignment {plan.align} != fused codec chunk {codec.chunk}: "
            "build the plan from this codec's bucket_alignment()"
        )
    return FusedWirePlan(plan=plan, codec=codec)
