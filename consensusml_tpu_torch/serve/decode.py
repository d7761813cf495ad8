"""Decode-model geometry and prompt buckets (port of ``consensusml_tpu/serve/decode.py``).

The reference compiles one prefill program per power-of-two prompt bucket
so that serving never recompiles; PyTorch runs eagerly, but the buckets
stay: they fix the prefill shapes, the prefill budget's unit, and which
prompts cross the flash-attention threshold (the 1024 bucket at
GPT-2-medium's max_len).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["DecodeModel", "prefill_buckets"]


@dataclasses.dataclass(frozen=True)
class DecodeModel:
    """A causal LM plus the cache geometry the engine needs off it."""

    model: Any
    layers: int
    kv_heads: int
    head_dim: int
    max_len: int
    vocab_size: int
    cache_dtype: torch.dtype
    device: torch.device

    @classmethod
    def wrap(cls, model: Any) -> "DecodeModel":
        from consensusml_tpu_torch.models.gpt2 import GPT2LM

        if not isinstance(model, GPT2LM):
            raise ValueError(
                f"{type(model).__name__} has no paged decode path; serving "
                "needs a causal LM (GPT2LM)"
            )
        c = model.config
        return cls(
            model=model,
            layers=c.layers,
            kv_heads=c.heads,
            head_dim=c.head_dim,
            max_len=c.max_len,
            vocab_size=c.vocab_size,
            cache_dtype=c.dtype,
            device=model.wte.embedding.device,
        )


def prefill_buckets(max_len: int, smallest: int = 8) -> tuple[int, ...]:
    """Power-of-two prompt-length buckets up to ``max_len``; each prompt
    pads to the smallest bucket that fits."""
    buckets = []
    b = smallest
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)
