"""Reference codec semantics in plain PyTorch (port of
``consensusml_tpu/compress/reference.py``: the int8, int4, fp8 and top-k
codecs).

These define the numbers every kernel must reproduce bit for bit:
flatten, zero-pad to whole chunks, ``scale = absmax * f32(1/levels)`` per
chunk (levels 127 for int8, 7 for int4, 448 for fp8; see
:func:`quantize_rows`), ``inv = 1 / scale`` (0 for a zero chunk), ``y = x
* inv``, then ``q = clip(rint(y), ±levels)`` with round-half-to-even and
NaN to 0 (int8, int4) or ``q = e4m3(y)`` (fp8, :func:`to_e4m3`), decode
``q * scale``. Int4 packs two codes a byte, element ``j`` of a chunk in
the low nibble and element ``j + chunk / 2`` in the high one. Top-k picks
the k largest magnitudes, equal magnitudes going to the lower index (the
``jax.lax.top_k`` order; ``torch.topk`` promises no order among ties, so
selection here is a stable descending sort, :func:`topk_by_magnitude`).

f32 subnormals: the reference's compiled program treats every subnormal
input of its arithmetic as a signed zero and flushes every subnormal
result to one (the CPU runs XLA's programs with flush-to-zero and
denormals-are-zero set; the TPU has no f32 subnormals). PyTorch keeps
them, so the codecs flush explicitly (``numerics.ftz``) where it
changes a result: the input rows, the scale, the decoded values and the
CHOCO tracking update.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from consensusml_tpu_torch.compress.base import (
    FP8_E4M3_MAX,
    ComposedCompressor,
    Compressor,
    Fp8Payload,
    Int4Payload,
    Int8Payload,
    TopKPayload,
    static_k,
    worker_rows,
)
from consensusml_tpu_torch.numerics import ftz

__all__ = [
    "Int8Compressor",
    "Int4Compressor",
    "Fp8Compressor",
    "TopKCompressor",
    "topk_int8_compressor",
    "topk_int4_compressor",
    "quantize_rows",
    "dequantize_rows",
    "to_e4m3",
    "from_e4m3",
    "round_clip_int8",
    "round_clip_int4",
    "pack_int4",
    "unpack_int4",
    "chunk_rows",
    "unchunk",
    "topk_by_magnitude",
    "fma_f32",
]


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with ONE rounding, as XLA computes the
    reference's ``c + a * b`` chains: it fuses them into a multiply-add
    (the ``multiply_add_fusion`` of the compiled round). The product of two
    f32 values is exact in f64 and so is the sum unless its span exceeds
    53 bits; the final rounding to f32 then equals a fused multiply-add
    except for double rounding onto an f32 midpoint, which needs the
    addend to sit within 2**-29 relative of half an ulp of the other
    (never seen in the parity tests)."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


_E4M3_NAN = 0x7F  # e4m3fn's NaN code, with the sign bit clear
# the f32 e4m3fn's NaN codes decode to, by sign: the reference's bits (PyTorch's
# own cast gives another NaN payload)
_F32_QNAN = (0x7FC00000, -0x400000)  # 0x7FC00000 and 0xFFC00000 as int32
# e4m3fn has no inf: the reference casts |y| > 464 (the midpoint between
# 448 and the NaN code's 480) to NaN, where PyTorch saturates to 448
_E4M3_OVERFLOW = 464.0


def quantize_rows(chunks: torch.Tensor, levels: float = 127.0):
    """Per-row symmetric scaling of ``(C, chunk)`` f32 rows: ``(y (C,
    chunk), scales (C,))`` with ``y = x * inv``, each code's value before
    rounding. ``amax`` propagates NaN, as ``jnp.max`` does.

    ``scale = absmax * f32(1 / levels)``, not ``absmax / levels``: the
    reference writes the division, but XLA compiles a division by a
    constant into a product with the constant's f32 reciprocal, and every
    path that trains (jitted rounds, the Pallas kernels) runs that product
    — it differs from the quotient in the last bit for ~8% of rows (int8),
    ~60% (fp8). ``inv = 1 / scale`` is a true division, tensor by tensor
    (PyTorch may turn a division by a Python scalar into a reciprocal
    product). Subnormal elements count as zeros and a subnormal scale is
    flushed to 0, as in the reference: a row of 1e-39 gets scale 0 and
    codes 0, not codes of 127."""
    x = ftz(chunks)
    absmax = x.abs().amax(dim=1)
    recip = np.float32(1.0) / np.float32(levels)
    scales = ftz(absmax * torch.tensor(recip, dtype=torch.float32, device=absmax.device))
    pos = scales > 0
    one = torch.ones_like(scales)
    inv = torch.where(pos, one / torch.where(pos, scales, one), torch.zeros_like(scales))
    return x * inv[:, None], scales


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``codes * scale`` per row of ``(R, chunk)`` f32 code values, one
    rounding, a subnormal scale read and a subnormal product written as
    zero (a small e4m3 code times a small scale can be subnormal)."""
    return ftz(codes * ftz(scales)[:, None])


def to_e4m3(y: torch.Tensor) -> torch.Tensor:
    """f32 -> ``float8_e4m3fn`` as the reference casts: round to nearest
    even (subnormal codes too), NaN, inf and ``|y| > 464`` to the NaN
    code of ``y``'s sign (PyTorch's cast saturates those at ±448)."""
    q = y.to(torch.float8_e4m3fn).view(torch.uint8)
    bad = torch.isnan(y) | (y.abs() > _E4M3_OVERFLOW)
    nan = (torch.signbit(y).to(torch.uint8) << 7) | _E4M3_NAN
    return torch.where(bad, nan, q).view(torch.float8_e4m3fn)


def from_e4m3(q: torch.Tensor) -> torch.Tensor:
    """``float8_e4m3fn`` -> f32, exact, a NaN code to the reference's f32
    NaN of its sign."""
    f = q.to(torch.float32)
    nan = torch.tensor(_F32_QNAN, dtype=torch.int32, device=q.device).view(torch.float32)
    return torch.where(torch.isnan(f), torch.where(torch.signbit(f), nan[1], nan[0]), f)


def _round_clip(y: torch.Tensor, levels: float) -> torch.Tensor:
    # NaN (only from a non-finite input) maps to 0, as XLA converts it,
    # rather than to an undefined conversion
    r = torch.clamp(torch.round(y), -levels, levels)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r)


def round_clip_int8(y: torch.Tensor) -> torch.Tensor:
    """``clip(rint(y), ±127)`` as int8, half to even, NaN to 0."""
    return _round_clip(y, 127.0).to(torch.int8)


def round_clip_int4(y: torch.Tensor) -> torch.Tensor:
    """``clip(rint(y), ±7)`` as int32 codes, half to even, NaN to 0."""
    return _round_clip(y, 7.0).to(torch.int32)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int32 codes ``(R, C)`` in ``[-7, 7]``, C even -> uint8 ``(R, C / 2)``:
    byte ``j`` = low nibble of ``q[:, j]`` | high nibble of ``q[:, j + C / 2]``
    (two's complement, so -7 is nibble 0x9)."""
    half = q.shape[1] // 2
    return ((q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``(R, H)`` -> int32 codes ``(R,
    2H)``, each nibble sign-extended (``nib > 7 -> nib - 16``)."""
    b = packed.to(torch.int32)
    lo, hi = b & 0xF, b >> 4
    return torch.cat([torch.where(lo > 7, lo - 16, lo), torch.where(hi > 7, hi - 16, hi)], dim=1)


def chunk_rows(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """``(L, n)`` rows, each zero-padded to whole chunks on its own, as
    ``(L * ceil(n / chunk), chunk)``."""
    pad = (-flat.shape[1]) % chunk
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, chunk)


def topk_by_magnitude(rows: torch.Tensor, k: int) -> torch.Tensor:
    """int32 ``(R, k)`` positions of each row's k largest ``|x|``, in
    descending order, equal magnitudes to the lower index."""
    order = torch.sort(rows.abs(), dim=1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


def unchunk(dense: torch.Tensor, payload) -> torch.Tensor:
    """Decoded ``(rows, chunk)`` of an int8, int4 or fp8 payload back to the
    payload's (stacked) shape: per worker, drop the padding."""
    lead = tuple(payload.data.shape[:-1])
    n = math.prod(payload.shape)
    flat = dense.reshape((lead[0] if lead else 1), -1)[:, :n]
    return flat.to(payload.dtype).reshape(lead + tuple(payload.shape))


@dataclasses.dataclass(frozen=True)
class Int8Compressor(Compressor):
    """Symmetric per-chunk int8 quantization (the semantics oracle); the
    chunk is clamped to the tensor."""

    chunk: int = 256

    def bucket_alignment(self) -> int | None:
        return self.chunk

    def fused_wire(self) -> str | None:
        return "int8"

    def compress(self, x: torch.Tensor, stacked: bool = False) -> Int8Payload:
        lead, flat = worker_rows(x, stacked)
        chunk = min(self.chunk, flat.shape[1])
        y, scales = quantize_rows(chunk_rows(flat, chunk))
        return Int8Payload(data=round_clip_int8(y).reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
                           shape=tuple(x.shape[len(lead):]), dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Int8Payload) -> torch.Tensor:
        q = payload.data.reshape(-1, payload.chunk).to(torch.float32)
        return unchunk(dequantize_rows(q, payload.scales.reshape(-1)), payload)


@dataclasses.dataclass(frozen=True)
class Int4Compressor(Compressor):
    """Symmetric per-chunk int4 quantization, two codes a byte
    (:class:`Int4Payload`; the semantics oracle). The chunk is clamped to
    the tensor and then made even (one more element of padding for an odd
    one), so nibbles always pair up."""

    chunk: int = 256

    def bucket_alignment(self) -> int | None:
        return self.chunk + self.chunk % 2  # the even effective width

    def fused_wire(self) -> str | None:
        return "int4"

    def compress(self, x: torch.Tensor, stacked: bool = False) -> Int4Payload:
        lead, flat = worker_rows(x, stacked)
        chunk = min(self.chunk, flat.shape[1])
        chunk += chunk % 2
        y, scales = quantize_rows(chunk_rows(flat, chunk), levels=7.0)
        return Int4Payload(data=pack_int4(round_clip_int4(y)).reshape(lead + (-1,)),
                           scales=scales.reshape(lead + (-1,)), shape=tuple(x.shape[len(lead):]),
                           dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Int4Payload) -> torch.Tensor:
        q = unpack_int4(payload.data.reshape(-1, payload.chunk // 2)).to(torch.float32)
        return unchunk(dequantize_rows(q, payload.scales.reshape(-1)), payload)


@dataclasses.dataclass(frozen=True)
class Fp8Compressor(Compressor):
    """Per-chunk scaled float8 (e4m3fn) quantization (:class:`Fp8Payload`;
    the semantics oracle): ``scale = absmax * f32(1/448)``, ``q =
    e4m3(x * inv)`` (:func:`to_e4m3`). The chunk is clamped to the
    tensor."""

    chunk: int = 256

    def bucket_alignment(self) -> int | None:
        return self.chunk

    def fused_wire(self) -> str | None:
        return "fp8"

    def compress(self, x: torch.Tensor, stacked: bool = False) -> Fp8Payload:
        lead, flat = worker_rows(x, stacked)
        chunk = min(self.chunk, flat.shape[1])
        y, scales = quantize_rows(chunk_rows(flat, chunk), levels=FP8_E4M3_MAX)
        return Fp8Payload(data=to_e4m3(y).reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
                          shape=tuple(x.shape[len(lead):]), dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Fp8Payload) -> torch.Tensor:
        q = from_e4m3(payload.data.reshape(-1, payload.chunk))
        return unchunk(dequantize_rows(q, payload.scales.reshape(-1)), payload)


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Magnitude top-k over the whole tensor with a static k
    (``round(ratio * size)`` or ``k``): the semantics oracle of
    ``topk_int8_compressor(impl="reference")``. Its ``bucket_alignment`` is
    ``None``: global selection does not decompose per chunk, so the engine
    would take the per-leaf wire, which is not ported."""

    ratio: float = 0.01
    k: int | None = None

    def compress(self, x: torch.Tensor, stacked: bool = False) -> TopKPayload:
        lead, flat = worker_rows(x, stacked)
        k = static_k(flat.shape[1], self.ratio, self.k)
        idx = topk_by_magnitude(flat, k)
        values = torch.gather(x.reshape(flat.shape), 1, idx.long())
        return TopKPayload(values=values.reshape(lead + (k,)), indices=idx.reshape(lead + (k,)),
                           shape=tuple(x.shape[len(lead):]), dtype=x.dtype)

    def decompress(self, payload: TopKPayload) -> torch.Tensor:
        lead, idx = self._rows(payload)
        vals = payload.values.reshape(idx.shape).to(payload.dtype)
        out = torch.zeros((idx.shape[0], math.prod(payload.shape)), dtype=payload.dtype, device=idx.device)
        return out.scatter_(1, idx, vals).reshape(lead + tuple(payload.shape))

    def decompress_accumulate(self, payload: TopKPayload, acc: torch.Tensor, weight) -> torch.Tensor:
        """Scatter-add the k weighted values into ``acc`` (indices are
        distinct: no dense temporary, same numbers as decode + axpy)."""
        _lead, idx = self._rows(payload)
        flat = acc.reshape(idx.shape[0], -1)
        vals = weight * payload.values.reshape(idx.shape).to(flat.dtype)
        return flat.scatter_add(1, idx, vals).reshape(acc.shape)

    @staticmethod
    def _rows(payload: TopKPayload):
        lead = tuple(payload.indices.shape[:-1])
        return lead, payload.indices.reshape(-1, payload.indices.shape[-1]).long()


def topk_int8_compressor(ratio: float = 0.01, chunk: int = 256, k: int | None = None,
                         impl: str = "reference") -> ComposedCompressor:
    """Config-5 codec: top-k sparsify, then int8-quantize the k values.

    ``impl="reference"``: global top-k + :class:`Int8Compressor` (the
    semantics oracle). ``impl="auto"``: the kernel-backed pair, per-chunk
    top-k (``k_per_chunk = k or round(ratio * chunk)`` winners per
    ``chunk`` elements) then :class:`PallasInt8Compressor` at ``max(chunk,
    128)``, the reference's kernel path; its wrappers launch the kernels
    for CUDA tensors and run the plain versions for CPU ones."""
    if impl == "reference":
        return ComposedCompressor(inner=TopKCompressor(ratio=ratio, k=k), outer=Int8Compressor(chunk=chunk))
    if impl != "auto":
        raise ValueError(f"unknown topk_int8 impl {impl!r} (reference|auto)")
    from consensusml_tpu_torch.compress.kernels import ChunkedTopKCompressor, PallasInt8Compressor

    k_per_chunk = k if k is not None else max(1, round(ratio * chunk))
    return ComposedCompressor(
        inner=ChunkedTopKCompressor(chunk=chunk, k_per_chunk=k_per_chunk),
        outer=PallasInt8Compressor(chunk=max(chunk, 128)),
    )


def topk_int4_compressor(ratio: float = 0.01, chunk: int = 256, k: int | None = None,
                         impl: str = "reference") -> ComposedCompressor:
    """Top-k sparsify, then int4-quantize the k values: half the value
    bytes of :func:`topk_int8_compressor`, for slow links.

    ``impl="reference"``: global top-k + :class:`Int4Compressor`.
    ``impl="auto"``: per-chunk top-k then :class:`PallasInt4Compressor` at
    ``max(chunk, 128)``, the reference's kernel path (kernels for CUDA
    tensors, their plain versions for CPU ones)."""
    if impl == "reference":
        return ComposedCompressor(inner=TopKCompressor(ratio=ratio, k=k), outer=Int4Compressor(chunk=chunk))
    if impl != "auto":
        raise ValueError(f"unknown topk_int4 impl {impl!r} (reference|auto)")
    from consensusml_tpu_torch.compress.kernels import ChunkedTopKCompressor, PallasInt4Compressor

    k_per_chunk = k if k is not None else max(1, round(ratio * chunk))
    return ComposedCompressor(
        inner=ChunkedTopKCompressor(chunk=chunk, k_per_chunk=k_per_chunk),
        outer=PallasInt4Compressor(chunk=max(chunk, 128)),
    )
