"""Kernel-backed codecs (port of ``consensusml_tpu/compress/kernels.py``).

This slice ports the fused one-pass CHOCO encode of the bucketed gossip
wire, int8 format: :func:`fused_pack_quantize` launches
``csrc/fused_choco_encode.cu`` for CUDA tensors and runs its plain
version :func:`fused_pack_quantize_plain` for tensors on the CPU (never
as a fallback). Each launch adds one to ``fused_pack_quantize.launches``.

Still to port (ROADMAP Queue B): the stand-alone ``quantize_int8`` /
``dequantize_int8`` kernels behind :class:`PallasInt8Compressor`'s
``compress``/``decompress`` (this slice computes them in plain ops on the
CPU and raises on the card), the int4/fp8 formats, and the receive-side
``fused_dequantize_accumulate`` kernel (:meth:`FusedBucketCodec.
decode_accumulate` is plain ops here; the simulated backend mixes the
decoded innovations with the mixing matrix and never calls it).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.compress.base import Compressor, Int8Payload
from consensusml_tpu_torch.compress.reference import (
    Int8Compressor,
    fma_f32,
    quantize_rows,
    round_clip_int8,
)

__all__ = [
    "CODEC_IMPLS",
    "PallasInt8Compressor",
    "FusedBucketCodec",
    "fused_bucket_codec",
    "resolve_codec_impl",
    "fused_pack_quantize",
    "fused_pack_quantize_plain",
    "fused_quant_plain",
]

CODEC_IMPLS = ("torch", "cuda")
_LANE = 128  # the reference's chunk granularity; the CUDA kernel's too (32 lanes x float4)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def resolve_codec_impl(requested: str = "auto", device=None) -> str:
    """``"auto"`` -> ``"cuda"`` (the kernels) on a CUDA device, ``"torch"``
    (their plain versions) elsewhere; explicit values pass through."""
    if requested == "auto":
        dev = torch.device(device) if device is not None else torch.device("cpu")
        return "cuda" if dev.type == "cuda" else "torch"
    if requested not in CODEC_IMPLS:
        raise ValueError(f"unknown codec impl {requested!r} (auto|{'|'.join(CODEC_IMPLS)})")
    return requested


# ---------------------------------------------------------------------------
# fused CHOCO encode: kernel + plain version
# ---------------------------------------------------------------------------


def fused_quant_plain(d: torch.Tensor):
    """``(R, chunk)`` f32 delta rows -> ``(q int8 (R, chunk), scales (R,))``:
    the reference's ``_fused_quant`` for ``"int8"``."""
    scales, inv = quantize_rows(d)
    return round_clip_int8(d * inv[:, None]), scales


def fused_pack_quantize_plain(x: torch.Tensor, xhat: torch.Tensor):
    """``(q, scales, xhat')`` with ``xhat' = q * scale + xhat`` rounded
    once: the reference's ``xhat + dec`` as XLA compiles it (a fused
    multiply-add; rounding the product first differs in ~8% of elements)."""
    q, scales = fused_quant_plain(x - xhat)
    return q, scales, fma_f32(q, scales[:, None], xhat)


def _encode_lib():
    fn = kernels.load("fused_choco_encode").cml_fused_choco_encode_int8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, p]
        fn.restype = i
    return fn


def fused_pack_quantize(x: torch.Tensor, xhat: torch.Tensor, *, fmt: str = "int8"):
    """Fused wire ENCODE over ``(R, chunk)`` f32 rows: ``q = Q(x - xhat)``
    with per-row scales, plus the CHOCO tracking update ``xhat' = xhat +
    q * scale`` (one rounding). Returns ``(q int8 (R, chunk), scales (R,)
    f32, xhat')``.

    CPU tensors run :func:`fused_pack_quantize_plain`; CUDA tensors launch
    ``csrc/fused_choco_encode.cu`` (contiguous f32, chunk a multiple of
    128) or raise."""
    if fmt != "int8":
        raise NotImplementedError(f"fused wire format {fmt!r} is not ported yet (int8 only)")
    if x.shape != xhat.shape or x.dim() != 2:
        raise ValueError(f"x and xhat must be one (R, chunk) shape, got {tuple(x.shape)} {tuple(xhat.shape)}")
    if not x.is_cuda:
        return fused_pack_quantize_plain(x, xhat)
    rows, chunk = x.shape
    if chunk % _LANE:
        raise ValueError(f"the CUDA encode takes chunks that are multiples of {_LANE}, got {chunk}")
    for name, t in (("x", x), ("xhat", xhat)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16:
            raise ValueError(
                f"{name} must be a contiguous, 16-byte aligned f32 tensor on {x.device}, "
                f"got {t.dtype} contiguous={t.is_contiguous()} on {t.device}"
            )
    q = torch.empty((rows, chunk), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    hat = torch.empty_like(x)
    if rows:
        rc = _encode_lib()(
            x.data_ptr(), xhat.data_ptr(), q.data_ptr(), scales.data_ptr(), hat.data_ptr(),
            rows, chunk, torch.cuda.current_stream(x.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"fused_choco_encode launch failed: CUDA error {rc}")
        fused_pack_quantize.launches += 1
    return q, scales, hat


fused_pack_quantize.launches = 0


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PallasInt8Compressor(Compressor):
    """Per-chunk symmetric int8 codec (name kept from the reference so a
    reader finds the counterpart). Its payloads equal
    :class:`~.reference.Int8Compressor`'s; the chunk is clamped to the
    tensor rounded up to 128, as the reference's kernel path does.

    ``compress``/``decompress`` run plain ops for CPU (and shape-only
    ``meta``) tensors and raise for CUDA tensors: their stand-alone
    kernels (``quantize_int8``/``dequantize_int8``) are ported with the
    top-k codec. On this slice's path the codec rides the fused wire
    (:class:`FusedBucketCodec`), whose encode is a kernel.
    """

    chunk: int = 512
    impl: str = "auto"

    def __post_init__(self):
        if self.chunk % _LANE:
            raise ValueError(f"chunk must be a multiple of {_LANE}, got {self.chunk}")
        resolve_codec_impl(self.impl)

    def bucket_alignment(self) -> int | None:
        return self.chunk

    def fused_wire(self) -> str | None:
        return "int8"

    def _refuse_cuda(self, t: torch.Tensor, what: str) -> None:
        if t.is_cuda:
            raise NotImplementedError(
                f"PallasInt8Compressor.{what} on the card needs the stand-alone "
                "quantize_int8/dequantize_int8 kernels, not ported yet; the "
                "bucketed CHOCO wire uses the fused encode kernel instead"
            )

    def compress(self, x: torch.Tensor) -> Int8Payload:
        self._refuse_cuda(x, "compress")
        n = x.numel()
        chunk = min(self.chunk, _round_up(n, _LANE))
        flat = x.reshape(-1).to(torch.float32)
        chunks = F.pad(flat, (0, (-n) % chunk)).reshape(-1, chunk)
        scales, inv = quantize_rows(chunks)
        q = round_clip_int8(chunks * inv[:, None])
        return Int8Payload(data=q.reshape(-1), scales=scales, shape=tuple(x.shape),
                           dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Int8Payload) -> torch.Tensor:
        self._refuse_cuda(payload.data, "decompress")
        return Int8Compressor(chunk=payload.chunk).decompress(payload)


@dataclasses.dataclass(frozen=True)
class FusedBucketCodec:
    """One-pass pack+quantize wire over flat bucket buffers: ``(total,)``
    per worker or stacked ``(W, total)`` — reshaped to chunk rows either
    way, so the worker axis only adds rows and one launch covers every
    worker's copy of a bucket. The encode is the :func:`fused_pack_quantize`
    wrapper: the kernel for CUDA tensors, the plain version for CPU ones.
    """

    fmt: str
    chunk: int

    def __post_init__(self):
        if self.fmt != "int8":
            raise NotImplementedError(f"fused wire format {self.fmt!r} is not ported yet (int8 only)")

    @property
    def wire_width(self) -> int:
        return self.chunk

    def encode(self, x: torch.Tensor, xhat: torch.Tensor):
        """``(payload, new_xhat)`` for one bucket buffer: the codec's exact
        payload of ``x - xhat`` plus ``xhat + dec(payload)``."""
        lead = tuple(x.shape[:-1])
        total = x.shape[-1]
        x2 = x.reshape(-1, self.chunk)
        h2 = xhat.reshape(-1, self.chunk)
        data, scales, hat = fused_pack_quantize(x2, h2, fmt=self.fmt)
        payload = Int8Payload(
            data=data.reshape(lead + (-1,)), scales=scales.reshape(lead + (-1,)),
            shape=(total,), dtype=torch.float32, chunk=self.chunk,
        )
        return payload, hat.reshape(x.shape)

    def decode(self, payload: Int8Payload) -> torch.Tensor:
        """Dense f32 decode, ``q * scale`` (plain elementwise ops, as the
        reference leaves it to XLA)."""
        lead = tuple(payload.data.shape[:-1])
        dec = payload.data.reshape(-1, self.wire_width).to(torch.float32) * payload.scales.reshape(-1, 1)
        return dec.reshape(lead + (-1,))

    def decode_accumulate(self, s: torch.Tensor, payloads, weights) -> torch.Tensor:
        """``s + sum_j weights[j] * dec(payloads[j])``: weighted payloads
        summed first (self, then each neighbour), ``s`` added last — the
        reference's order, with the roundings of the program XLA compiles
        from it: ``w0 d0 + w1 d1`` fuses the first product
        (``fma(w0, d0, w1 d1)``), each later ``+ wj dj`` is ``fma(wj, dj,
        .)``, and ``s +`` rounds on its own (bit-equal for the ring's three
        sources, tests/test_torch_codec.py). Plain ops: its kernel comes
        with the collective backend."""
        weights = tuple(float(w) for w in weights)
        if len(payloads) != len(weights):
            raise ValueError(f"{len(payloads)} payloads vs {len(weights)} weights")
        decs = [self.decode(p).reshape(s.shape) for p in payloads]
        w = [torch.tensor(wj, dtype=torch.float32, device=s.device) for wj in weights]
        if len(decs) == 1:
            return s + w[0] * decs[0]
        recv = fma_f32(w[0], decs[0], w[1] * decs[1])
        for wj, dj in zip(w[2:], decs[2:]):
            recv = fma_f32(wj, dj, recv)
        return s + recv


def fused_bucket_codec(comp: Compressor) -> FusedBucketCodec | None:
    """The fused wire for ``comp``, or ``None`` when it cannot ride it (no
    ``fused_wire()`` tag, a stochastic codec, or a chunk the kernel cannot
    tile when the codec's impl is ``"cuda"``; ``"auto"`` resolves by
    ``torch.cuda.is_available()``, and codecs without an impl are
    ``"torch"``)."""
    fmt = comp.fused_wire()
    if fmt is None or comp.stochastic:
        return None
    align = comp.bucket_alignment()
    if align is None or align < 2:
        return None
    impl = getattr(comp, "impl", "torch")
    if impl == "auto":
        impl = "cuda" if torch.cuda.is_available() else "torch"
    if impl != "torch" and align % _LANE:
        return None
    return FusedBucketCodec(fmt=fmt, chunk=align)
