"""Synthetic LM data (port of ``consensusml_tpu/data/synthetic.py``, the
language-model part).

numpy-seeded exactly as the reference: the Markov chain's successor table
from ``default_rng(seed)``, each round's per-worker block from
``default_rng((seed, round, rank))``, so the port yields the identical
token ids. The BERT-style corruption (``mlm_rate > 0``) and the image
datasets come with their configs.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = ["SyntheticLM", "lm_round_batches"]


@dataclasses.dataclass
class SyntheticLM:
    """Procedural token streams over a fixed random Markov chain: each token
    has 4 likely successors; the last vocab id is reserved (never emitted)."""

    vocab_size: int = 256
    seq_len: int = 128
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        succ = rng.integers(0, self.vocab_size - 1, size=(self.vocab_size, 4))
        self.successors = succ.astype(np.int32)

    def sample(self, rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
        """Token id sequences of shape ``(*shape, seq_len)``, int32."""
        n = int(np.prod(shape))
        out = np.empty((n, self.seq_len), np.int32)
        state = rng.integers(0, self.vocab_size - 1, size=n)
        for t in range(self.seq_len):
            out[:, t] = state
            choice = rng.integers(0, 4, size=n)
            state = self.successors[state, choice]
        return out.reshape(*shape, self.seq_len)


def lm_round_batches(
    dataset: SyntheticLM,
    world_size: int,
    h: int,
    batch: int,
    rounds: int,
    seed: int = 0,
    start: int = 0,
) -> Iterator[dict[str, torch.Tensor]]:
    """Stacked ``(W, H, B, S)`` int32 round batches keyed by ``(seed,
    absolute round, rank)``: ``start=N`` continues the exact stream a fresh
    run would produce at round N."""
    for r in range(start, start + rounds):
        per_worker = [
            dataset.sample(np.random.default_rng((seed, r, rank)), (h, batch))
            for rank in range(world_size)
        ]
        yield {"input_ids": torch.from_numpy(np.stack(per_worker))}
