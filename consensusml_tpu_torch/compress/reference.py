"""Reference codec semantics in plain PyTorch (port of
``consensusml_tpu/compress/reference.py``, the int8 part).

These define the numbers every kernel must reproduce bit for bit:
flatten, zero-pad to whole chunks, ``scale = absmax * f32(1/127)`` per
chunk (see :func:`quantize_rows`),
``inv = 1 / scale`` (0 for a zero chunk), ``q = clip(rint(x * inv),
±127)`` with round-half-to-even, decode ``q * scale``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from consensusml_tpu_torch.compress.base import Compressor, Int8Payload

__all__ = ["Int8Compressor", "chunk_for_quantization", "quantize_rows", "fma_f32"]


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


def quantize_rows(chunks: torch.Tensor, levels: float = 127.0):
    """Per-row symmetric scales of ``(C, chunk)`` f32 rows: ``(scales (C,),
    inv (C,))``. ``amax`` propagates NaN, as ``jnp.max`` does.

    ``scale = absmax * f32(1 / levels)``, not ``absmax / levels``: the
    reference writes the division, but XLA compiles a division by a
    constant into a product with the constant's f32 reciprocal, and every
    path that trains (jitted rounds, the Pallas kernels) runs that product
    — it differs from the quotient in the last bit for ~8% of rows. ``inv =
    1 / scale`` is a true division, tensor by tensor (PyTorch may turn a
    division by a Python scalar into a reciprocal product)."""
    absmax = chunks.abs().amax(dim=1)
    recip = np.float32(1.0) / np.float32(levels)
    scales = absmax * torch.tensor(recip, dtype=torch.float32, device=absmax.device)
    pos = scales > 0
    one = torch.ones_like(scales)
    inv = torch.where(pos, one / torch.where(pos, scales, one), torch.zeros_like(scales))
    return scales, inv


def round_clip_int8(y: torch.Tensor) -> torch.Tensor:
    """``clip(rint(y), ±127)`` as int8; NaN (only from a non-finite input)
    maps to 0 rather than to an undefined conversion."""
    r = torch.clamp(torch.round(y), -127.0, 127.0)
    return torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)


def chunk_for_quantization(x: torch.Tensor, chunk: int, levels: float = 127.0):
    """Flatten, clamp the chunk to the tensor, zero-pad, and compute
    per-chunk scales: ``(chunks (C, chunk) f32, scales, inv, chunk)``."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.numel()
    chunk = min(chunk, n)
    pad = (-n) % chunk
    chunks = F.pad(flat, (0, pad)).reshape(-1, chunk)
    scales, inv = quantize_rows(chunks, levels)
    return chunks, scales, inv, chunk


@dataclasses.dataclass(frozen=True)
class Int8Compressor(Compressor):
    """Symmetric per-chunk int8 quantization (the semantics oracle)."""

    chunk: int = 256

    def bucket_alignment(self) -> int | None:
        return self.chunk

    def fused_wire(self) -> str | None:
        return "int8"

    def compress(self, x: torch.Tensor) -> Int8Payload:
        chunks, scales, inv, chunk = chunk_for_quantization(x, self.chunk)
        q = round_clip_int8(chunks * inv[:, None])
        return Int8Payload(data=q.reshape(-1), scales=scales, shape=tuple(x.shape),
                           dtype=x.dtype, chunk=chunk)

    def decompress(self, payload: Int8Payload) -> torch.Tensor:
        chunks = payload.data.reshape(-1, payload.chunk).to(torch.float32)
        flat = (chunks * payload.scales[:, None]).reshape(-1)
        n = 1
        for d in payload.shape:
            n *= d
        return flat[:n].to(payload.dtype).reshape(payload.shape)
