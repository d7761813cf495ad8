"""Decode-model geometry and prompt buckets (port of ``consensusml_tpu/serve/decode.py``).

The reference compiles one prefill program per power-of-two prompt bucket
so that serving never recompiles; PyTorch runs eagerly, but the buckets
stay: they fix the prefill shapes, the prefill budget's unit, and which
prompts cross the flash-attention threshold (the buckets from 1024 up:
GPT-2-medium's max_len, and 1024 to 4096 at Llama-2-7B's).
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
        """The geometry of a ``GPT2LM`` or ``LlamaLM`` (the reference's
        ``supports_decode``): Llama's pages hold its pre-repeat kv heads."""
        from consensusml_tpu_torch.models.gpt2 import GPT2LM
        from consensusml_tpu_torch.models.llama import LlamaLM

        if not isinstance(model, (GPT2LM, LlamaLM)):
            raise ValueError(
                f"{type(model).__name__} has no paged decode path; serving "
                "needs a causal LM (GPT2LM / LlamaLM)"
            )
        c = model.config
        emb = model.wte if isinstance(model, GPT2LM) else model.tok_emb
        return cls(
            model=model,
            layers=c.layers,
            kv_heads=getattr(c, "kv_heads", c.heads),
            head_dim=c.head_dim,
            max_len=c.max_len,
            vocab_size=c.vocab_size,
            cache_dtype=c.dtype,
            device=emb.embedding.device,
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
