"""Ulysses attention: all-to-all sequence parallelism (counterpart of
``consensusml_tpu/parallel/ulysses.py``).

The second long-context strategy beside ring attention (DeepSpeed-Ulysses,
Jacobs et al. 2023):

1. each of P ranks of a sequence :class:`~.axis.Axis` holds a ``(B,
   S/P, H, D)`` block of Q, K and V;
2. one all-to-all a tensor reshards sequence -> heads: every rank then
   holds the whole sequence for ``H/P`` heads, ``(B, S, H/P, D)``;
3. plain, exact attention runs on those heads
   (:func:`~consensusml_tpu_torch.models.attention.dot_product_attention`:
   the flash kernels on a CUDA tensor of a flash-sized sequence);
4. a second all-to-all reshards heads -> sequence, ``(B, S/P, H, D)``.

It moves Q, K, V and O once each, where the ring moves K/V P times but
overlaps them with its steps; it needs ``H % P == 0``. The all-to-alls
are :func:`.axis.all_to_all`, so the function is differentiable.
"""

from __future__ import annotations

import torch

from consensusml_tpu_torch.models.attention import dot_product_attention
from consensusml_tpu_torch.parallel.axis import Axis, all_to_all

__all__ = ["ulysses_attention"]


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis: Axis, *,
                      causal: bool = False) -> torch.Tensor:
    """Exact attention across the whole (split) sequence by all-to-all:
    this rank's output block ``(B, S_blk, H, D)`` in ``q.dtype``. The head
    count must divide by the axis size."""
    p, h = axis.size, q.shape[2]
    if h % p:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the '{axis.name}' axis size ({p}); use "
            "ring_attention for head-count-exceeding parallelism"
        )
    # sequence-split -> head-split: (B, S/P, H, D) -> (B, S, H/P, D)
    qg, kg, vg = (all_to_all(x, axis, split_dim=2, concat_dim=1) for x in (q, k, v))
    out = dot_product_attention(qg, kg, vg, causal=causal, dtype=q.dtype)
    # head-split -> sequence-split: (B, S, H/P, D) -> (B, S/P, H, D)
    return all_to_all(out, axis, split_dim=1, concat_dim=2)
