"""Model configurations of the port (counterpart of ``consensusml_tpu.configs``).

This slice carries only the GPT-2 geometry of ``gpt2_topk`` — the
reference's ``_gpt2_topk``: ``scale="full"`` is ``GPT2Config()``
(GPT-2-medium: 24 layers, hidden 1024, 16 heads, vocab 50257, max_len
1024), ``scale="smoke"`` the tiny test model (vocab 64, hidden 32, 2
layers, 2 heads, max_len 32). The training half of the config (topology,
codec, optimizer) comes with the training slice.
"""

from __future__ import annotations

import torch

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

__all__ = ["CONFIGS", "gpt2_config", "build_model"]

CONFIGS = ("gpt2_topk",)


def gpt2_config(scale: str = "smoke", dtype: torch.dtype = torch.bfloat16) -> GPT2Config:
    if scale == "full":
        return GPT2Config(dtype=dtype)
    if scale == "smoke":
        return GPT2Config(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32, dtype=dtype)
    raise ValueError(f"unknown scale {scale!r} (smoke|full)")


def build_model(
    name: str = "gpt2_topk",
    scale: str = "smoke",
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
) -> GPT2LM:
    """The config's model on ``device`` (``None`` = CUDA; raises without a
    GPU) with random weights drawn from a generator seeded by ``seed``."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r} (one of {CONFIGS})")
    dev = resolve_device(device)
    model = GPT2LM(gpt2_config(scale, dtype), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model.init_weights(gen).eval()
