"""Kernel-backed codecs (port of ``consensusml_tpu/compress/kernels.py``).

Each kernel has a wrapper and a plain PyTorch version beside it. The
wrapper runs the plain version for tensors on the CPU (and for shape-only
``meta`` tensors, which ``Compressor.wire_bytes`` compresses) and
launches its CUDA kernel for CUDA tensors, raising on what the kernel
does not take (never falling back). Each launch adds one to the
wrapper's ``launches``. Under a
``workcount`` counter each wrapper reports its function's work from its
shapes (``workcount.counted``) and runs with counting suspended; a fake
tensor (the counting pass's) takes the plain route, on ``meta`` copies.

- :func:`quantize_int8` / :func:`dequantize_int8`, :func:`quantize_fp8` /
  :func:`dequantize_fp8`: ``csrc/int8_codec.cu``;
- :func:`quantize_int4` / :func:`dequantize_int4`: ``csrc/int4_codec.cu``;
- :func:`chunked_topk`: ``csrc/chunked_topk.cu``;
- :func:`chunk_scatter`: ``csrc/chunk_scatter.cu``;
- :func:`fused_pack_quantize` (the fused one-pass CHOCO encode of the
  bucketed wire, int8, int4 and fp8): ``csrc/fused_choco_encode.cu``;
- :func:`fused_dequantize_accumulate` (the fused wire's receive, ``s +
  sum_j w_j dec(q_j)``): ``csrc/fused_choco_decode.cu``.

The codecs: :class:`PallasInt8Compressor`, :class:`PallasInt4Compressor`
and :class:`PallasFp8Compressor` (names kept from the reference so a
reader finds the counterpart), :class:`ChunkedTopKCompressor`, and the
fused wire's :class:`FusedBucketCodec`. The reference's ``impl`` field of
these codecs has no counterpart: every wrapper picks kernel or plain
version by the tensor's device. The simulated backend decodes the fused
wire with plain ops and mixes through the matrix; only the collective
round calls :meth:`FusedBucketCodec.decode_accumulate`, and only its
two-step receive launches :func:`chunk_scatter`'s accumulating form.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.compress.base import (
    FP8_E4M3_MAX,
    Compressor,
    Fp8Payload,
    Int4Payload,
    Int8Payload,
    LocalTopKPayload,
    TopKPayload,
    worker_rows,
)
from consensusml_tpu_torch.compress.reference import (
    chunk_rows,
    dequantize_rows,
    fma_f32,
    from_e4m3,
    pack_int4,
    quantize_rows,
    round_clip_int4,
    round_clip_int8,
    to_e4m3,
    topk_by_magnitude,
    unchunk,
    unpack_int4,
)
from consensusml_tpu_torch.numerics import ftz
from consensusml_tpu_torch.workcount import counted, on_card

__all__ = [
    "PallasInt8Compressor",
    "PallasInt4Compressor",
    "PallasFp8Compressor",
    "ChunkedTopKCompressor",
    "FusedBucketCodec",
    "fused_bucket_codec",
    "quantize_int8",
    "quantize_int8_plain",
    "dequantize_int8",
    "dequantize_int8_plain",
    "quantize_int4",
    "quantize_int4_plain",
    "dequantize_int4",
    "dequantize_int4_plain",
    "quantize_fp8",
    "quantize_fp8_plain",
    "dequantize_fp8",
    "dequantize_fp8_plain",
    "chunked_topk",
    "chunked_topk_plain",
    "chunk_scatter",
    "chunk_scatter_plain",
    "fused_pack_quantize",
    "fused_pack_quantize_plain",
    "fused_dequantize_accumulate",
    "fused_dequantize_accumulate_plain",
]

_LANE = 128  # the reference's chunk granularity; the CUDA kernels' too (32 lanes x float4)
_TOPK_MAX_CHUNK = 1024  # the top-k kernel holds a row in registers
# the top-k kernel keeps at most two winners a lane; equals kMaxK in
# csrc/chunked_topk.cu, and ChunkedTopKCompressor branches on it
_TOPK_MAX_K = 64


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != device or t.data_ptr() % 16:
        raise ValueError(
            f"{name} must be a contiguous, 16-byte aligned {dtype} tensor on {device}, "
            f"got {t.dtype} contiguous={t.is_contiguous()} on {t.device}"
        )


def _check_chunk(what: str, chunk: int) -> None:
    if chunk % _LANE:
        raise ValueError(f"the CUDA {what} takes chunks that are multiples of {_LANE}, got {chunk}")


def _bind(source: str, symbol: str, argtypes: list):
    fn = getattr(kernels.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launched(wrapper, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
    wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _launch_quantize(wrapper, source: str, chunks: torch.Tensor, dtype: torch.dtype, width: int):
    """``wrapper``'s per-row quantize kernel (``cml_<wrapper name>`` in
    ``csrc/<source>.cu``) on contiguous f32 CUDA rows: ``(codes (R,
    width) dtype, scales (R,) f32)``."""
    rows, chunk = chunks.shape
    _check_chunk(wrapper.__name__, chunk)
    _check_operand("chunks", chunks, torch.float32, chunks.device)
    q = torch.empty((rows, width), dtype=dtype, device=chunks.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=chunks.device)
    if rows:
        fn = _bind(source, f"cml_{wrapper.__name__}", [_P, _P, _P, _LL, _I, _P])
        rc = fn(chunks.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, chunk, _stream(chunks))
        _launched(wrapper, wrapper.__name__, rc)
    return q, scales


def _launch_dequantize(wrapper, source: str, q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype,
                       chunk: int) -> torch.Tensor:
    """``wrapper``'s per-row dequantize kernel on ``(R, .)`` codes of
    ``dtype`` and ``(R,)`` f32 scales: ``(R, chunk)`` f32."""
    rows = q.shape[0]
    _check_chunk(wrapper.__name__, chunk)
    _check_operand("q", q, dtype, q.device)
    _check_operand("scales", scales, torch.float32, q.device)
    out = torch.empty((rows, chunk), dtype=torch.float32, device=q.device)
    if rows:
        fn = _bind(source, f"cml_{wrapper.__name__}", [_P, _P, _P, _LL, _I, _P])
        rc = fn(q.data_ptr(), scales.data_ptr(), out.data_ptr(), rows, chunk, _stream(q))
        _launched(wrapper, wrapper.__name__, rc)
    return out


def _check_codes(q: torch.Tensor, scales: torch.Tensor) -> None:
    if q.dim() != 2 or scales.shape != q.shape[:1]:
        raise ValueError(f"codes must be (R, .) and scales (R,), got {tuple(q.shape)} {tuple(scales.shape)}")


# ---------------------------------------------------------------------------
# each kernel's work, from its arguments' shapes (workcount.counted): the
# figures its bound prices, operands read once and results written once
# ---------------------------------------------------------------------------


def _quantize_work(code_bytes: float):
    """A per-row quantize of ``(R, C)`` f32: 3 operations an element
    (scale, product, round); reads the rows, writes the codes
    (``code_bytes`` each) and the scales."""
    def work(chunks):
        r, c = chunks.shape
        m = r * c
        return 3.0 * m, 4.0 * m + code_bytes * m + 4.0 * r
    return work


def _dequantize_work(values_per_code: int):
    """A per-row dequantize to ``(R, C)`` f32: a product an element; reads
    the codes and scales, writes the rows."""
    def work(q, scales):
        r = q.shape[0]
        m = r * q.shape[1] * values_per_code
        return float(m), float(q.numel() * q.element_size()) + 4.0 * r + 4.0 * m
    return work


def _topk_work(chunks, k):
    """k extraction passes over each row; reads the rows, writes k values
    and k int32 indices a row."""
    r, c = chunks.shape
    return float(k * r * c), 4.0 * r * c + 8.0 * r * k


def _scatter_work(vals, idx, chunk, acc=None, weight=1.0):
    """A product and a sum a value; reads the values and indices (and
    ``acc``), writes the dense rows."""
    r, k = vals.shape
    return 2.0 * r * k, 4.0 * r * chunk * (2 if acc is not None else 1) + 8.0 * r * k


def _wire_bytes(n: int, fmt: str) -> int:
    return n // 2 if fmt == "int4" else n


def _encode_work(x, xhat, *, fmt="int8"):
    """5 operations an element (difference, scale, round, product, sum);
    reads x and xhat, writes the codes, scales and xhat'."""
    n, r = x.numel(), x.shape[0]
    return 5.0 * n, 8.0 * n + _wire_bytes(n, fmt) + 4.0 * r + 4.0 * n


def _decode_work(s, sources, *, fmt, weights):
    """3 operations an element a source and the sum with ``s``; reads
    ``s`` and every source's codes and scales, writes ``s'``."""
    n, r, j = s.numel(), s.shape[0], len(weights)
    return float((3 * j + 1) * n), 4.0 * n + j * (_wire_bytes(n, fmt) + 4.0 * r) + 4.0 * n


# ---------------------------------------------------------------------------
# int8, int4 and fp8 (e4m3) quantize / dequantize: kernels + plain versions
# ---------------------------------------------------------------------------


def quantize_int8_plain(chunks: torch.Tensor):
    """``(R, C)`` f32 rows -> ``(q int8 (R, C), scales (R,))``: the
    reference's ``_quant_kernel`` as XLA compiles it (subnormals flushed,
    :func:`~.reference.quantize_rows`)."""
    y, scales = quantize_rows(chunks)
    return round_clip_int8(y), scales


@counted(_quantize_work(1.0))
def quantize_int8(chunks: torch.Tensor):
    """Per-row symmetric int8 of ``(R, C)`` f32 rows: ``(q int8 (R, C),
    scales (R,) f32)``. CPU tensors run :func:`quantize_int8_plain`; CUDA
    tensors launch ``csrc/int8_codec.cu`` (contiguous f32, C a multiple of
    128) or raise."""
    if chunks.dim() != 2:
        raise ValueError(f"chunks must be (R, C), got {tuple(chunks.shape)}")
    if not on_card(chunks):
        return quantize_int8_plain(chunks)
    return _launch_quantize(quantize_int8, "int8_codec", chunks, torch.int8, chunks.shape[1])


quantize_int8.launches = 0


def dequantize_int8_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale`` per row, one rounding: ``_dequant_kernel``."""
    return dequantize_rows(q.to(torch.float32), scales)


@counted(_dequantize_work(1))
def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: ``(R, C)`` int8 and ``(R,)`` f32
    scales -> ``(R, C)`` f32. CPU tensors run :func:`dequantize_int8_plain`;
    CUDA tensors launch ``csrc/int8_codec.cu`` or raise."""
    _check_codes(q, scales)
    if not on_card(q):
        return dequantize_int8_plain(q, scales)
    return _launch_dequantize(dequantize_int8, "int8_codec", q, scales, torch.int8, q.shape[1])


dequantize_int8.launches = 0


def quantize_int4_plain(chunks: torch.Tensor):
    """``(R, C)`` f32 rows, C even -> ``(packed uint8 (R, C / 2), scales
    (R,))``: ``scale = absmax * f32(1/7)``, codes ``clip(rint(x * inv),
    ±7)`` (NaN to 0) packed two a byte, the reference's ``_quant4_kernel``
    as XLA compiles it."""
    y, scales = quantize_rows(chunks, levels=7.0)
    return pack_int4(round_clip_int4(y)), scales


@counted(_quantize_work(0.5))
def quantize_int4(chunks: torch.Tensor):
    """Per-row symmetric int4 of ``(R, C)`` f32 rows, two codes a byte
    (see :func:`quantize_int4_plain`). CPU tensors run the plain version;
    CUDA tensors launch ``csrc/int4_codec.cu`` (contiguous f32, C a
    multiple of 128) or raise."""
    if chunks.dim() != 2 or chunks.shape[1] % 2:
        raise ValueError(f"chunks must be (R, C) with C even, got {tuple(chunks.shape)}")
    if not on_card(chunks):
        return quantize_int4_plain(chunks)
    return _launch_quantize(quantize_int4, "int4_codec", chunks, torch.uint8, chunks.shape[1] // 2)


quantize_int4.launches = 0


def dequantize_int4_plain(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Sign-extended nibbles times their row's scale, one rounding:
    ``_dequant4_kernel``."""
    return dequantize_rows(unpack_int4(packed).to(torch.float32), scales)


@counted(_dequantize_work(2))
def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int4`: ``(R, C / 2)`` uint8 and ``(R,)``
    f32 scales -> ``(R, C)`` f32. CPU tensors run
    :func:`dequantize_int4_plain`; CUDA tensors launch
    ``csrc/int4_codec.cu`` or raise."""
    _check_codes(packed, scales)
    if not on_card(packed):
        return dequantize_int4_plain(packed, scales)
    return _launch_dequantize(dequantize_int4, "int4_codec", packed, scales, torch.uint8, 2 * packed.shape[1])


dequantize_int4.launches = 0


def quantize_fp8_plain(chunks: torch.Tensor):
    """``(R, C)`` f32 rows -> ``(q float8_e4m3fn (R, C), scales (R,))``:
    ``scale = absmax * f32(1/448)``, ``q = e4m3(x * inv)`` (round to
    nearest even; NaN, inf and overflow to NaN), the reference's
    ``_quant_fp8_kernel`` as XLA compiles it."""
    y, scales = quantize_rows(chunks, levels=FP8_E4M3_MAX)
    return to_e4m3(y), scales


@counted(_quantize_work(1.0))
def quantize_fp8(chunks: torch.Tensor):
    """Per-row scaled e4m3 of ``(R, C)`` f32 rows (see
    :func:`quantize_fp8_plain`). CPU tensors run the plain version; CUDA
    tensors launch ``csrc/int8_codec.cu`` (contiguous f32, C a multiple of
    128) or raise."""
    if chunks.dim() != 2:
        raise ValueError(f"chunks must be (R, C), got {tuple(chunks.shape)}")
    if not on_card(chunks):
        return quantize_fp8_plain(chunks)
    return _launch_quantize(quantize_fp8, "int8_codec", chunks, torch.float8_e4m3fn, chunks.shape[1])


quantize_fp8.launches = 0


def dequantize_fp8_plain(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale`` per row, one rounding, a subnormal product
    flushed: ``_dequant_kernel`` fed e4m3 rows."""
    return dequantize_rows(from_e4m3(q), scales)


@counted(_dequantize_work(1))
def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_fp8`: ``(R, C)`` e4m3 and ``(R,)`` f32
    scales -> ``(R, C)`` f32. CPU tensors run :func:`dequantize_fp8_plain`;
    CUDA tensors launch ``csrc/int8_codec.cu`` (the int8 dequantize's
    kernel on e4m3 input) or raise."""
    _check_codes(q, scales)
    if not on_card(q):
        return dequantize_fp8_plain(q, scales)
    return _launch_dequantize(dequantize_fp8, "int8_codec", q, scales, torch.float8_e4m3fn, q.shape[1])


dequantize_fp8.launches = 0


# ---------------------------------------------------------------------------
# chunked top-k: kernel + plain version
# ---------------------------------------------------------------------------


def chunked_topk_plain(chunks: torch.Tensor, k: int):
    """Per row of ``(R, C)`` f32, the k largest ``|x|`` in descending
    order, equal magnitudes to the lower index: ``(values f32 (R, k),
    chunk-local indices int32 (R, k))``, the reference's ``_topk_kernel``.
    Its value is a masked row sum, so a ``-0.0`` winner comes out ``+0.0``
    (``+ 0.0`` does the same here). Its compiled program reads a subnormal
    as zero: a subnormal ``|x|`` ties with the zeros (the lower index
    wins) and a subnormal winner's value is ``+0.0``."""
    idx = topk_by_magnitude(ftz(chunks), k)
    return ftz(torch.gather(chunks, 1, idx.long())) + 0.0, idx


@counted(_topk_work)
def chunked_topk(chunks: torch.Tensor, k: int):
    """Top-k by magnitude per row of ``(R, C)`` f32 (see
    :func:`chunked_topk_plain`). CPU tensors run the plain version; CUDA
    tensors launch ``csrc/chunked_topk.cu`` (C a multiple of 128 up to
    1024, k at most 64) or raise."""
    if chunks.dim() != 2 or not 0 < k <= chunks.shape[1]:
        raise ValueError(f"chunks must be (R, C) with 0 < k <= C, got {tuple(chunks.shape)}, k={k}")
    if not on_card(chunks):
        return chunked_topk_plain(chunks, k)
    rows, chunk = chunks.shape
    if chunk % _LANE or chunk > _TOPK_MAX_CHUNK or k > _TOPK_MAX_K:
        raise ValueError(
            f"the CUDA top-k holds a row of a multiple of {_LANE} up to {_TOPK_MAX_CHUNK} in "
            f"registers and at most {_TOPK_MAX_K} winners, got C={chunk}, k={k}"
        )
    _check_operand("chunks", chunks, torch.float32, chunks.device)
    vals = torch.empty((rows, k), dtype=torch.float32, device=chunks.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=chunks.device)
    if rows:
        fn = _bind("chunked_topk", "cml_chunked_topk", [_P, _P, _P, _LL, _I, _I, _P])
        rc = fn(chunks.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, chunk, k, _stream(chunks))
        _launched(chunked_topk, "chunked_topk", rc)
    return vals, idx


chunked_topk.launches = 0


# ---------------------------------------------------------------------------
# chunk-local scatter: kernel + plain version
# ---------------------------------------------------------------------------


def chunk_scatter_plain(vals: torch.Tensor, idx: torch.Tensor, chunk: int,
                        acc: torch.Tensor | None = None, weight: float = 1.0) -> torch.Tensor:
    """``(R, k)`` values at distinct chunk-local indices -> dense ``(R,
    chunk)`` f32, on top of ``acc`` (or zeros): the reference's
    ``chunk_scatter``. Its roundings: the values are pre-scaled (``v *
    weight``, one rounding) and then added (a second). Its kernel adds a
    masked ``+0.0`` to every element k times, so a ``-0.0`` in ``acc``
    comes out ``+0.0``, and so does a ``-0.0`` value (``+ 0.0`` here).
    Every operand and result is flushed (:func:`~consensusml_tpu_torch.
    numerics.ftz`): a subnormal value or ``acc`` element comes out
    ``+0.0``, as from the reference's compiled kernel."""
    v = ftz(ftz(vals.to(torch.float32)) * torch.full((), np.float32(weight), dtype=torch.float32, device=vals.device)) + 0.0
    base = acc.to(torch.float32) if acc is not None else torch.zeros(
        (vals.shape[0], chunk), dtype=torch.float32, device=vals.device)
    base = ftz(base) + 0.0
    i = idx.long()
    return base.scatter(1, i, ftz(torch.gather(base, 1, i) + v))


@counted(_scatter_work)
def chunk_scatter(vals: torch.Tensor, idx: torch.Tensor, chunk: int,
                  acc: torch.Tensor | None = None, weight: float = 1.0) -> torch.Tensor:
    """Densify ``(R, k)`` f32 values at distinct int32 chunk-local indices
    into ``(R, chunk)`` f32, optionally ``acc + weight * dense`` (see
    :func:`chunk_scatter_plain`). CPU tensors run the plain version; CUDA
    tensors launch ``csrc/chunk_scatter.cu`` (chunk a multiple of 128) or
    raise."""
    if vals.dim() != 2 or idx.shape != vals.shape:
        raise ValueError(f"vals and idx must be one (R, k) shape, got {tuple(vals.shape)} {tuple(idx.shape)}")
    if acc is not None and tuple(acc.shape) != (vals.shape[0], chunk):
        raise ValueError(f"acc must be ({vals.shape[0]}, {chunk}), got {tuple(acc.shape)}")
    if not on_card(vals):
        return chunk_scatter_plain(vals, idx, chunk, acc, weight)
    rows, k = vals.shape
    _check_chunk("chunk scatter", chunk)
    _check_operand("vals", vals, torch.float32, vals.device)
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.device != vals.device:
        raise ValueError(f"idx must be a contiguous int32 tensor on {vals.device}, got {idx.dtype} on {idx.device}")
    if acc is not None:
        _check_operand("acc", acc, torch.float32, vals.device)
    out = torch.empty((rows, chunk), dtype=torch.float32, device=vals.device)
    if rows:
        fn = _bind("chunk_scatter", "cml_chunk_scatter", [_P, _P, _P, _P, _LL, _I, _I, ctypes.c_float, _P])
        rc = fn(vals.data_ptr(), idx.data_ptr(), acc.data_ptr() if acc is not None else None,
                out.data_ptr(), rows, k, chunk, float(np.float32(weight)), _stream(vals))
        _launched(chunk_scatter, "chunk_scatter", rc)
        if acc is not None:
            chunk_scatter.acc_launches += 1
    return out


chunk_scatter.launches = 0
chunk_scatter.acc_launches = 0  # the accumulating form's share of launches


# ---------------------------------------------------------------------------
# the fused wire's formats, encode and decode: kernels + plain versions
# ---------------------------------------------------------------------------

# format -> (levels, values a wire byte-lane, wire dtype, payload class,
# the id the CUDA sources take)
_FUSED_FORMATS = {
    "int8": (127.0, 1, torch.int8, Int8Payload, 0),
    "int4": (7.0, 2, torch.uint8, Int4Payload, 1),
    "fp8": (FP8_E4M3_MAX, 1, torch.float8_e4m3fn, Fp8Payload, 2),
}
# the decode kernel takes at most this many sources (self + neighbours)
_DECODE_MAX_SOURCES = 8


def _fused_format(fmt: str):
    if fmt not in _FUSED_FORMATS:
        raise ValueError(f"unknown fused wire format {fmt!r} (one of {list(_FUSED_FORMATS)})")
    return _FUSED_FORMATS[fmt]


def _fused_codes(y: torch.Tensor, fmt: str):
    """Scaled rows -> ``(wire data, the codes' f32 values)``: the quantize
    half of the reference's ``_fused_quant``."""
    if fmt == "int8":
        q = round_clip_int8(y)
        return q, q.to(torch.float32)
    if fmt == "int4":
        q = round_clip_int4(y)
        return pack_int4(q), q.to(torch.float32)
    q = to_e4m3(y)
    return q, from_e4m3(q)


def _code_values(data: torch.Tensor, fmt: str) -> torch.Tensor:
    """``(R, wire_width)`` wire rows -> ``(R, chunk)`` f32 code values
    (int4 nibbles sign-extended): the reference's ``_fused_dequant``
    before its product with the scale."""
    if fmt == "int4":
        return unpack_int4(data).to(torch.float32)
    if fmt == "fp8":
        return from_e4m3(data)
    return data.to(torch.float32)


def fused_pack_quantize_plain(x: torch.Tensor, xhat: torch.Tensor, fmt: str = "int8"):
    """``(data, scales, xhat')`` of the fused encode, as XLA compiles the
    reference's ``_fused_encode_kernel``: ``d = x - xhat``, the codec's
    payload of ``d`` and ``xhat' = q * scale + xhat`` rounded once (a fused
    multiply-add; rounding the product first differs in ~3-11% of
    elements), with subnormal inputs read and results written as zeros."""
    levels = _fused_format(fmt)[0]
    h = ftz(xhat)
    y, scales = quantize_rows(ftz(x) - h, levels)
    data, codes = _fused_codes(y, fmt)
    return data, scales, ftz(fma_f32(codes, scales[:, None], h))


@counted(_encode_work)
def fused_pack_quantize(x: torch.Tensor, xhat: torch.Tensor, *, fmt: str = "int8"):
    """Fused wire ENCODE over ``(R, chunk)`` f32 rows: ``q = Q(x - xhat)``
    with per-row scales, plus the CHOCO tracking update ``xhat' = xhat +
    q * scale`` (one rounding). Returns ``(data, scales (R,) f32, xhat')``,
    ``data`` int8 ``(R, chunk)``, packed int4 uint8 ``(R, chunk / 2)`` or
    e4m3 ``(R, chunk)`` by ``fmt``: the bytes the stand-alone codec of the
    format ships for ``x - xhat``.

    CPU tensors run :func:`fused_pack_quantize_plain`; CUDA tensors launch
    ``csrc/fused_choco_encode.cu`` (contiguous f32, chunk a multiple of
    128) or raise."""
    _levels, pack, dtype, _cls, fmt_id = _fused_format(fmt)
    if x.shape != xhat.shape or x.dim() != 2 or x.shape[1] % pack:
        raise ValueError(f"x and xhat must be one (R, chunk) shape (chunk a multiple of {pack}), "
                         f"got {tuple(x.shape)} {tuple(xhat.shape)}")
    if not on_card(x):
        return fused_pack_quantize_plain(x, xhat, fmt)
    rows, chunk = x.shape
    _check_chunk("encode", chunk)
    for name, t in (("x", x), ("xhat", xhat)):
        _check_operand(name, t, torch.float32, x.device)
    data = torch.empty((rows, chunk // pack), dtype=dtype, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    hat = torch.empty_like(x)
    if rows:
        fn = _bind("fused_choco_encode", "cml_fused_choco_encode", [_P, _P, _P, _P, _P, _LL, _I, _I, _P])
        rc = fn(x.data_ptr(), xhat.data_ptr(), data.data_ptr(), scales.data_ptr(), hat.data_ptr(),
                rows, chunk, fmt_id, _stream(x))
        _launched(fused_pack_quantize, "fused_choco_encode", rc)
    return data, scales, hat


fused_pack_quantize.launches = 0


def fused_dequantize_accumulate_plain(s: torch.Tensor, sources, *, fmt: str, weights) -> torch.Tensor:
    """``s + sum_j weights[j] * dec(q_j)`` over ``(R, chunk)`` f32 rows,
    ``sources`` the ``(data, scales)`` of each payload, self first: the
    reference's ``_fused_decode_kernel`` as XLA compiles it. Each ``dec =
    q * scale`` is rounded; the weighted sum fuses its first product
    (``fma(w0, d0, w1 d1)``) and each later ``+ wj dj`` (``fma(wj, dj,
    .)``), and ``s`` joins last, on its own rounding; with one source it
    is ``fma(w0, d0, s)``. Subnormal inputs and results are zeros."""
    decs = [dequantize_rows(_code_values(data, fmt), scales) for data, scales in sources]
    w = [torch.full((), np.float32(wj), dtype=torch.float32, device=s.device) for wj in weights]
    base = ftz(s)
    if len(decs) == 1:
        return ftz(fma_f32(w[0], decs[0], base))
    recv = ftz(fma_f32(w[0], decs[0], ftz(w[1] * decs[1])))
    for wj, dj in zip(w[2:], decs[2:]):
        recv = ftz(fma_f32(wj, dj, recv))
    return ftz(base + recv)


@counted(_decode_work)
def fused_dequantize_accumulate(s: torch.Tensor, sources, *, fmt: str, weights) -> torch.Tensor:
    """Fused wire DECODE: ``s' = s + sum_j weights[j] * dec(q_j)`` in one
    pass over ``(R, chunk)`` f32 rows (see
    :func:`fused_dequantize_accumulate_plain`); ``sources`` holds each
    payload's ``(data (R, wire_width), scales (R,))``, self first,
    ``weights`` the mixing weights in the same order.

    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/fused_choco_decode.cu`` (contiguous operands, chunk a multiple
    of 128, at most 8 sources) or raise."""
    _levels, pack, dtype, _cls, fmt_id = _fused_format(fmt)
    weights = tuple(float(w) for w in weights)
    sources = list(sources)
    if s.dim() != 2 or s.shape[1] % pack:
        raise ValueError(f"s must be (R, chunk) with chunk a multiple of {pack}, got {tuple(s.shape)}")
    if not sources or len(sources) != len(weights):
        raise ValueError(f"{len(sources)} sources vs {len(weights)} weights (at least one of each)")
    rows, chunk = s.shape
    for data, scales in sources:
        if tuple(data.shape) != (rows, chunk // pack) or tuple(scales.shape) != (rows,):
            raise ValueError(f"a source must be ({rows}, {chunk // pack}) data and ({rows},) scales, "
                             f"got {tuple(data.shape)} {tuple(scales.shape)}")
    if not on_card(s):
        return fused_dequantize_accumulate_plain(s, sources, fmt=fmt, weights=weights)
    _check_chunk("decode", chunk)
    if len(sources) > _DECODE_MAX_SOURCES:
        raise ValueError(f"the CUDA decode takes at most {_DECODE_MAX_SOURCES} sources, got {len(sources)}")
    _check_operand("s", s, torch.float32, s.device)
    for data, scales in sources:
        _check_operand("data", data, dtype, s.device)
        _check_operand("scales", scales, torch.float32, s.device)
    out = torch.empty_like(s)
    if rows:
        n = len(sources)
        data_ptrs = (ctypes.c_void_p * n)(*(d.data_ptr() for d, _ in sources))
        scale_ptrs = (ctypes.c_void_p * n)(*(sc.data_ptr() for _, sc in sources))
        wts = (ctypes.c_float * n)(*(float(np.float32(w)) for w in weights))
        fn = _bind("fused_choco_decode", "cml_fused_choco_decode", [_P, _P, _P, _P, _I, _P, _LL, _I, _I, _P])
        rc = fn(s.data_ptr(), data_ptrs, scale_ptrs, wts, n, out.data_ptr(), rows, chunk, fmt_id, _stream(s))
        _launched(fused_dequantize_accumulate, "fused_dequantize_accumulate", rc)
    return out


fused_dequantize_accumulate.launches = 0


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PallasInt8Compressor(Compressor):
    """Per-chunk symmetric int8 codec on :func:`quantize_int8` /
    :func:`dequantize_int8`. Its payloads equal
    :class:`~.reference.Int8Compressor`'s, except that the chunk is clamped
    to the tensor rounded up to 128, as the reference's kernel path does
    (its off-TPU ``impl="auto"`` takes the jnp path, which clamps to the
    tensor itself). The reference's ``impl`` field has no counterpart:
    the wrappers pick kernel or plain version by the tensor's device."""

    chunk: int = 512

    def __post_init__(self):
        if self.chunk % _LANE:
            raise ValueError(f"chunk must be a multiple of {_LANE}, got {self.chunk}")

    def bucket_alignment(self) -> int | None:
        return self.chunk

    def fused_wire(self) -> str | None:
        return "int8"

    def compress(self, x: torch.Tensor, stacked: bool = False) -> Int8Payload:
        lead, flat = worker_rows(x, stacked)
        chunk = min(self.chunk, _round_up(flat.shape[1], _LANE))
        q, scales = quantize_int8(chunk_rows(flat, chunk).contiguous())
        return Int8Payload(data=q.reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
                           shape=tuple(x.shape[len(lead):]), dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Int8Payload) -> torch.Tensor:
        q = payload.data.reshape(-1, payload.chunk)
        return unchunk(dequantize_int8(q, payload.scales.reshape(-1)), payload)


@dataclasses.dataclass(frozen=True)
class PallasInt4Compressor(Compressor):
    """Per-chunk symmetric int4 codec on :func:`quantize_int4` /
    :func:`dequantize_int4` (:class:`Int4Payload`). Its payloads equal
    :class:`~.reference.Int4Compressor`'s, except that the chunk is clamped
    to the tensor rounded up to 128, as the reference's kernel path does.
    Bare, it rides the fused wire in its ``"int4"`` format (``--codec
    int4``); inside the top-k codec (which has no fused wire) it rides the
    two-step wire."""

    chunk: int = 512

    def __post_init__(self):
        if self.chunk % _LANE:
            raise ValueError(f"chunk must be a multiple of {_LANE}, got {self.chunk}")

    def bucket_alignment(self) -> int | None:
        return self.chunk  # a multiple of 128, so always even

    def fused_wire(self) -> str | None:
        return "int4"

    def compress(self, x: torch.Tensor, stacked: bool = False) -> Int4Payload:
        lead, flat = worker_rows(x, stacked)
        chunk = min(self.chunk, _round_up(flat.shape[1], _LANE))
        packed, scales = quantize_int4(chunk_rows(flat, chunk).contiguous())
        return Int4Payload(data=packed.reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
                           shape=tuple(x.shape[len(lead):]), dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Int4Payload) -> torch.Tensor:
        packed = payload.data.reshape(-1, payload.chunk // 2)
        return unchunk(dequantize_int4(packed, payload.scales.reshape(-1)), payload)


@dataclasses.dataclass(frozen=True)
class PallasFp8Compressor(Compressor):
    """Per-chunk scaled e4m3 codec on :func:`quantize_fp8` /
    :func:`dequantize_fp8` (:class:`Fp8Payload`). Its payloads equal
    :class:`~.reference.Fp8Compressor`'s, except that the chunk is clamped
    to the tensor rounded up to 128, as the reference's kernel path does.
    Bare, it rides the fused wire in its ``"fp8"`` format (``--codec
    fp8``); with ``fused_wire=False`` the two-step wire runs its two
    kernels."""

    chunk: int = 512

    def __post_init__(self):
        if self.chunk % _LANE:
            raise ValueError(f"chunk must be a multiple of {_LANE}, got {self.chunk}")

    def bucket_alignment(self) -> int | None:
        return self.chunk

    def fused_wire(self) -> str | None:
        return "fp8"

    def compress(self, x: torch.Tensor, stacked: bool = False) -> Fp8Payload:
        lead, flat = worker_rows(x, stacked)
        chunk = min(self.chunk, _round_up(flat.shape[1], _LANE))
        q, scales = quantize_fp8(chunk_rows(flat, chunk).contiguous())
        return Fp8Payload(data=q.reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
                          shape=tuple(x.shape[len(lead):]), dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Fp8Payload) -> torch.Tensor:
        q = payload.data.reshape(-1, payload.chunk)
        return unchunk(dequantize_fp8(q, payload.scales.reshape(-1)), payload)


@dataclasses.dataclass(frozen=True)
class ChunkedTopKCompressor(Compressor):
    """Per-chunk top-k: ``k_per_chunk`` winners by magnitude in every
    ``chunk`` elements (:func:`chunked_topk`), with uint16 chunk-local
    indices (:class:`LocalTopKPayload`, ``narrow_indices``) or int32 global
    ones (:class:`TopKPayload`). Decoding is :func:`chunk_scatter` for the
    narrow payload and a generic scatter-add for the wide one.

    The reference's own crossover is kept: past ``_TOPK_MAX_K = 64``
    winners its kernel (one sweep per winner) loses to one sort, so on
    every device a larger k selects by a stable sort in plain ops (the
    reference's ``lax.top_k`` branch, which keeps a subnormal magnitude
    and a ``-0.0`` winner's sign). That is a branch on k, not a fallback:
    it launches no kernel and counts none. Padded-tail winners (past the tensor's end) carry
    value 0.
    """

    chunk: int = 512
    k_per_chunk: int = 16
    narrow_indices: bool = True

    def __post_init__(self):
        if self.chunk % _LANE:
            raise ValueError(f"chunk must be a multiple of {_LANE}, got {self.chunk}")
        if not 0 < self.k_per_chunk <= self.chunk:
            raise ValueError("k_per_chunk must be in (0, chunk]")
        if self.narrow_indices and self.chunk > 2**16:
            raise ValueError(
                f"narrow_indices stores chunk-local positions as uint16, so chunk must be "
                f"<= {2**16} (got {self.chunk}); pass narrow_indices=False for wider chunks"
            )

    def bucket_alignment(self) -> int | None:
        # selection is chunk-local: with every leaf chunk-aligned in a
        # bucket, each chunk sees one leaf's elements (plus zero padding)
        return self.chunk

    def compress(self, x: torch.Tensor, stacked: bool = False):
        lead, flat = worker_rows(x, stacked)
        n = flat.shape[1]
        chunk = min(self.chunk, _round_up(n, _LANE))
        k = min(self.k_per_chunk, chunk)
        chunks = chunk_rows(flat, chunk).contiguous()
        rows = chunks.shape[0] // flat.shape[0]
        if k > _TOPK_MAX_K:
            lidx = topk_by_magnitude(chunks, k)
            vals = torch.gather(chunks, 1, lidx.long())
        else:
            vals, lidx = chunked_topk(chunks, k)
        gidx = None
        if n % chunk or not self.narrow_indices:
            gidx = self._offsets(chunks.shape[0], rows, chunk, chunks.device) + lidx
            vals = torch.where(gidx < n, vals, torch.zeros_like(vals))
        values = vals.to(x.dtype).reshape(lead + (-1,))
        shape = tuple(x.shape[len(lead):])
        if self.narrow_indices:
            return LocalTopKPayload(values=values, indices=lidx.to(torch.uint16).reshape(lead + (rows, k)),
                                    shape=shape, dtype=x.dtype, chunk=chunk)
        gidx = torch.where(gidx < n, gidx, torch.zeros_like(gidx))
        return TopKPayload(values=values, indices=gidx.reshape(lead + (-1,)), shape=shape, dtype=x.dtype)

    @staticmethod
    def _offsets(total_rows: int, rows: int, chunk: int, device) -> torch.Tensor:
        """int32 ``(total_rows, 1)``: each chunk row's start in its worker's
        flat tensor (the worker axis only repeats the rows)."""
        r = torch.arange(total_rows, dtype=torch.int32, device=device) % rows
        return (r * chunk)[:, None]

    @staticmethod
    def _global_indices(payload) -> torch.Tensor:
        """int64 ``(L, m)`` flat scatter targets of either payload form
        (padded-tail slots clamp to 0; their values are zero, so they add
        nothing)."""
        n = math.prod(payload.shape)
        if isinstance(payload, LocalTopKPayload):
            lidx = payload.indices.to(torch.int32)
            rows, k = lidx.shape[-2:]
            lead = lidx.shape[:-2]
            lidx = lidx.reshape(-1, k)
            g = ChunkedTopKCompressor._offsets(lidx.shape[0], rows, payload.chunk, lidx.device) + lidx
            g = torch.where(g < n, g, torch.zeros_like(g)).reshape(lead + (-1,))
        else:
            g = payload.indices
        return g.reshape(-1, g.shape[-1]).long()

    def _kernel_scatter(self, payload: LocalTopKPayload, acc: torch.Tensor | None, weight) -> torch.Tensor:
        """:func:`chunk_scatter` of a narrow payload: dense
        ``decompress`` (``acc`` None) or ``acc + weight * dense``."""
        n = math.prod(payload.shape)
        k = payload.indices.shape[-1]
        lead = tuple(payload.indices.shape[:-2])
        workers = lead[0] if lead else 1
        idx = payload.indices.reshape(-1, k).to(torch.int32)
        # the values are stored flat (per worker); the indices carry (rows, k)
        vals = payload.values.to(torch.float32).reshape(idx.shape).contiguous()
        if acc is not None:
            flat = acc.reshape(workers, -1).to(torch.float32)
            base = chunk_rows(flat, payload.chunk).contiguous()
            dense = chunk_scatter(vals, idx, payload.chunk, base, weight=weight)
            shape, dtype = tuple(acc.shape), acc.dtype
        else:
            dense = chunk_scatter(vals, idx, payload.chunk)
            shape, dtype = lead + tuple(payload.shape), payload.dtype
        out = dense.reshape(workers, -1)[:, :n]
        return out.to(dtype).reshape(shape)

    def decompress(self, payload) -> torch.Tensor:
        if isinstance(payload, LocalTopKPayload):
            return self._kernel_scatter(payload, None, 1.0)
        g = self._global_indices(payload)
        out = torch.zeros((g.shape[0], math.prod(payload.shape)), dtype=payload.dtype, device=g.device)
        out = _scatter_add_ftz(out, g, payload.values.reshape(g.shape).to(payload.dtype))
        return out.reshape(tuple(payload.values.shape[:-1]) + tuple(payload.shape))

    def decompress_accumulate(self, payload, acc: torch.Tensor, weight) -> torch.Tensor:
        """The scatter-add receive, ``acc + weight * decompress(payload)``
        without the dense temporary (padded-tail slots carry zero
        values, so their duplicate index-0 entries add nothing)."""
        if acc.dtype == torch.float32 and isinstance(payload, LocalTopKPayload):
            return self._kernel_scatter(payload, acc, weight)
        g = self._global_indices(payload)
        flat = acc.reshape(g.shape[0], -1)
        vals = ftz(weight * ftz(payload.values.reshape(g.shape).to(flat.dtype)))
        return _scatter_add_ftz(flat, g, vals).reshape(acc.shape)


def _scatter_add_ftz(flat: torch.Tensor, g: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``flat.scatter_add(1, g, vals)`` as the reference's compiled
    ``.at[g].add(vals)``: each element it adds to is read and written
    flushed (the others are copied as they are)."""
    out = flat.scatter(1, g, ftz(flat.gather(1, g)))
    out = out.scatter_add(1, g, ftz(vals))
    return out.scatter(1, g, ftz(out.gather(1, g)))


@dataclasses.dataclass(frozen=True)
class FusedBucketCodec:
    """One-pass pack+quantize wire over flat bucket buffers, in one of the
    formats ``"int8"``, ``"int4"`` or ``"fp8"``: ``(total,)`` per worker or
    stacked ``(W, total)`` — reshaped to chunk rows either way, so the
    worker axis only adds rows and one launch covers every worker's copy
    of a bucket. The encode is the :func:`fused_pack_quantize` wrapper and
    :meth:`decode_accumulate` the :func:`fused_dequantize_accumulate` one:
    the kernels for CUDA tensors, the plain versions for CPU ones.
    :meth:`decode` is plain ops, as the reference leaves it to XLA.
    """

    fmt: str
    chunk: int

    def __post_init__(self):
        _fused_format(self.fmt)
        if self.fmt == "int4" and self.chunk % 2:
            raise ValueError(f"the int4 fused wire needs an even chunk, got {self.chunk}")

    @property
    def wire_width(self) -> int:
        """Wire bytes of one chunk row (int4 packs two values a byte)."""
        return self.chunk // _fused_format(self.fmt)[1]

    def encode(self, x: torch.Tensor, xhat: torch.Tensor):
        """``(payload, new_xhat)`` for one bucket buffer: the codec's exact
        payload of ``x - xhat`` plus ``xhat + dec(payload)``."""
        lead = tuple(x.shape[:-1])
        total = x.shape[-1]
        data, scales, hat = fused_pack_quantize(x.reshape(-1, self.chunk), xhat.reshape(-1, self.chunk),
                                                fmt=self.fmt)
        payload = _fused_format(self.fmt)[3](
            data=data.reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
            shape=(total,), dtype=torch.float32, chunk=self.chunk,
        )
        return payload, hat.reshape(x.shape)

    def _rows(self, payload):
        return payload.data.reshape(-1, self.wire_width), payload.scales.reshape(-1)

    def decode(self, payload) -> torch.Tensor:
        """Dense f32 decode, ``q * scale`` (int4 nibbles sign-extended)."""
        lead = tuple(payload.data.shape[:-1])
        data, scales = self._rows(payload)
        return dequantize_rows(_code_values(data, self.fmt), scales).reshape(lead + (-1,))

    def decode_accumulate(self, s: torch.Tensor, payloads, weights) -> torch.Tensor:
        """``s + sum_j weights[j] * dec(payloads[j])`` (self first, then
        each neighbour): the collective round's receive, one
        :func:`fused_dequantize_accumulate` launch for CUDA tensors."""
        weights = tuple(float(w) for w in weights)
        if len(payloads) != len(weights):
            raise ValueError(f"{len(payloads)} payloads vs {len(weights)} weights")
        sources = [tuple(t.contiguous() for t in self._rows(p)) for p in payloads]
        out = fused_dequantize_accumulate(s.reshape(-1, self.chunk).contiguous(), sources, fmt=self.fmt,
                                          weights=weights)
        return out.reshape(s.shape)


def fused_bucket_codec(comp: Compressor) -> FusedBucketCodec | None:
    """The fused wire for ``comp``, or ``None`` when it cannot ride it (no
    ``fused_wire()`` tag, a stochastic codec, an alignment below 2, or an
    odd one for int4): the reference's rules. Its third, a kernel-path
    alignment that is not a multiple of 128, cannot arise here: the
    kernel-backed codecs refuse such a chunk, and on a CUDA tensor the
    encode's wrapper refuses one (it never falls back)."""
    fmt = comp.fused_wire()
    if fmt is None or comp.stochastic:
        return None
    align = comp.bucket_alignment()
    if align is None or align < 2 or (fmt == "int4" and align % 2):
        return None
    return FusedBucketCodec(fmt=fmt, chunk=align)
