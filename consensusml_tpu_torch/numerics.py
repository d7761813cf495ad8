"""f32 subnormals as the reference's compiled program treats them.

The reference is the program XLA compiles, and it runs with flush-to-zero
and denormals-are-zero (on the CPU XLA sets both; the TPU has no f32
subnormals): a subnormal operand of its f32 arithmetic reads as a zero of
its sign, and a subnormal result is written as one. PyTorch keeps
subnormals, so the port's plain versions flush explicitly with
:func:`ftz` wherever that changes a result, and its kernels use the PTX
instructions' ``.ftz`` forms (``csrc/``), which do the same at no cost.
"""

from __future__ import annotations

import struct

import torch

__all__ = ["F32_MIN_NORMAL", "ftz", "inv_rows"]

F32_MIN_NORMAL = 2.0**-126


def ftz(t: torch.Tensor) -> torch.Tensor:
    """``t`` with every f32 subnormal replaced by a zero of its sign (a NaN,
    an infinity, a zero and every normal value unchanged). Under autograd
    its derivative is 1 wherever the value is kept, an exact zero
    included (so a plain version differentiated through it, as the
    ``"torch"`` attention tier is, loses no gradient at, say, the softmax's
    ``logits - max = 0``), and 0 only at a nonzero subnormal."""
    return t * ((t.abs() >= F32_MIN_NORMAL) | (t == 0))


def inv_rows(m: int) -> float:
    """``f32(1 / f32(m))``: the reference divides by a constant (``s / m``,
    ``jnp.mean`` over m elements), which XLA compiles into a product with
    its f32 reciprocal (``s * inv_rows(m)`` in f32 is that product; probed
    at m = 777 and 1000, where the quotient differs)."""
    return 1.0 / struct.unpack("f", struct.pack("f", m))[0]
