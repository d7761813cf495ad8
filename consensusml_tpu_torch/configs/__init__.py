"""Run configurations of the port (counterpart of ``consensusml_tpu.configs``).

``gpt2_topk`` is the reference's ``_gpt2_topk``
(``consensusml_tpu/configs/__init__.py:443-512``): GPT-2 pretraining by
CHOCO compressed gossip on a ring.

- ``scale="full"``: GPT-2-medium (24 layers, hidden 1024, 16 heads,
  vocab 50257, max_len 1024, dropout 0.1), 8 workers by default, batch
  8 x seq 1024, h = 2 local Adam(1e-4) steps per round, gamma 0.1, 50
  exact warm-up rounds and a dense refresh every 50;
- ``scale="smoke"``: the tiny test model (vocab 64, hidden 32, 2 layers,
  2 heads, max_len 32, dropout 0), 4 workers, batch 8 x seq 16, h = 2,
  Adam(3e-3), gamma 0.5, no warm-up or refresh.

Codecs (``codec=None`` is the config's own, as ``train.py`` without
``--codec``):

- ``"topk_int8"``, the config's: ``topk_int8_compressor(chunk=512, k=8)``
  full, ``topk_int8_compressor(ratio=0.1, chunk=128)`` (13 of 128) smoke;
  chunked top-k then int8 on the values, on the two-step bucketed wire
  (four kernels an exchange: top-k, quantize, dequantize, scatter);
- ``"int8"``, the reference's ``train.py --codec int8`` variant:
  ``PallasInt8Compressor`` at the config's chunk, which rides the fused
  one-pass bucketed wire.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from consensusml_tpu_torch.device import resolve_device
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

__all__ = ["CONFIGS", "RunBundle", "build", "gpt2_config", "build_model", "gpt2_init_params"]

CONFIGS = ("gpt2_topk",)
CODECS = ("topk_int8", "int8")


def gpt2_config(scale: str = "smoke", dtype: torch.dtype = torch.bfloat16) -> GPT2Config:
    if scale == "full":
        return GPT2Config(dtype=dtype)
    if scale == "smoke":
        return GPT2Config(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32, dropout=0.0,
                          dtype=dtype)
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


def gpt2_init_params(cfg: GPT2Config, seed: int, world_size: int) -> dict[str, np.ndarray]:
    """Stacked ``(W, ...)`` f32 flax-layout parameters, numpy-seeded per
    worker by ``(seed, rank)``: N(0, 0.02) kernels and embeddings, zero
    biases, unit LayerNorm scales. Keys are flax paths joined by dots, in
    the reference's flatten order (feed :func:`.models.convert.
    gpt2_from_flax`'s output format)."""
    meta = GPT2LM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in meta.named_parameters()}
    rngs = [np.random.default_rng((seed, r)) for r in range(world_size)]
    out = {}
    for name in sorted(shapes, key=lambda n: tuple(n.split("."))):
        shape = (world_size,) + shapes[name]
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
        elif name.endswith("scale"):
            out[name] = np.ones(shape, np.float32)
        else:
            arr = np.empty(shape, np.float32)
            for r, rng in enumerate(rngs):
                rng.standard_normal(shapes[name], dtype=np.float32, out=arr[r])
                arr[r] *= np.float32(0.02)
            out[name] = arr
    return out


@dataclasses.dataclass
class RunBundle:
    """Everything a run needs, as the reference's ``RunBundle``."""

    name: str
    world_size: int
    cfg: Any  # train.local_sgd.LocalSGDConfig
    model: GPT2LM  # structure only (meta device); parameters live in the train state
    loss_fn: Callable
    batches: Callable  # (rounds, seed, start=0) -> iterator of {"input_ids": (W, H, B, S)}
    init_params: Callable  # (seed) -> stacked {flax path: (W, ...) f32 numpy}
    codec_path: str
    description: str = ""


def build(name: str = "gpt2_topk", scale: str = "smoke", *, world: int | None = None,
          codec: str | None = None, gamma: float | None = None,
          codec_warmup: int | None = None, device=None) -> RunBundle:
    """The run recipe of config ``name`` at ``scale`` with the reference's
    overrides (``world`` = ``--workers``, ``codec``, ``gamma``,
    ``codec_warmup`` = ``--codec-warmup``). ``device`` (``None`` = CUDA)
    resolves the codec path: the CUDA kernels on a CUDA device, their
    plain versions on the CPU."""
    from consensusml_tpu_torch.compress import PallasInt8Compressor, resolve_codec_impl, topk_int8_compressor
    from consensusml_tpu_torch.consensus import GossipConfig
    from consensusml_tpu_torch.data import SyntheticLM, lm_round_batches
    from consensusml_tpu_torch.models.gpt2 import gpt2_loss_fn
    from consensusml_tpu_torch.topology import topology_from_name
    from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig
    from consensusml_tpu_torch.train.optim import adam

    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r} (one of {CONFIGS})")
    codec = codec or "topk_int8"
    if codec not in CODECS:
        raise NotImplementedError(f"codec {codec!r} is not ported yet (one of {CODECS})")
    full = scale == "full"
    mcfg = gpt2_config(scale)
    world = world or (8 if full else 4)
    batch, seq = (8, 1024) if full else (8, 16)
    chunk = 512 if full else 128
    impl = resolve_codec_impl("auto", resolve_device(device))
    if codec == "topk_int8":
        # train.py --codec topk_int8 reads the config's chunk and k: the same codec
        comp = (topk_int8_compressor(chunk=512, k=8, impl="auto") if full
                else topk_int8_compressor(ratio=0.1, chunk=128, impl="auto"))
        codec_name = f"topk_int8/{chunk} k={comp.inner.k_per_chunk}"
    else:
        comp, codec_name = PallasInt8Compressor(chunk=chunk, impl=impl), f"int8/{chunk}"
    gossip = GossipConfig(
        topology=topology_from_name("ring", world),
        compressor=comp,
        gamma=(0.1 if full else 0.5) if gamma is None else gamma,
        codec_warmup_rounds=(50 if full else 0) if codec_warmup is None else codec_warmup,
        codec_refresh_every=50 if full else 0,
    )
    cfg = LocalSGDConfig(gossip=gossip, optimizer=adam(1e-4 if full else 3e-3), h=2)
    data = SyntheticLM(vocab_size=mcfg.vocab_size, seq_len=seq)
    model = GPT2LM(mcfg, device="meta")
    path = "hand-written CUDA kernels" if impl == "cuda" else "plain PyTorch versions (no card)"
    return RunBundle(
        name=name,
        world_size=world,
        cfg=cfg,
        model=model,
        loss_fn=gpt2_loss_fn(model),
        batches=lambda rounds, seed, start=0: lm_round_batches(
            data, world, cfg.h, batch, rounds, seed, start=start
        ),
        init_params=lambda seed: gpt2_init_params(mcfg, seed, world),
        codec_path=f"{codec_name} -> {path}",
        description=f"GPT-2 pretrain with {codec} compressed gossip (CHOCO)",
    )
