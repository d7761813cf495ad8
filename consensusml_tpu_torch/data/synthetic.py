"""Synthetic data (port of ``consensusml_tpu/data/synthetic.py``: the
classification dataset and the language-model streams).

numpy-seeded exactly as the reference, so the port yields the identical
arrays: the class prototypes, labels and noisy images from
``default_rng(seed)``, each round's per-worker samples from
``default_rng((seed, round))``; the Markov chain's successor table from
``default_rng(seed)``, each round's per-worker token block from
``default_rng((seed, round, rank))``; the BERT-style corruption
(:func:`mlm_corrupt`, ``mlm_rate > 0``) from ``default_rng((seed, round,
10**6))``.

Held-out data (the reference's ``_cls_eval_batches`` and
``_lm_eval_batches``, ``consensusml_tpu/configs/__init__.py``): the
classification set's :meth:`SyntheticClassification.holdout` split (same
prototypes, another sample stream) and the LM stream under keys offset by
:data:`EVAL_SEED_OFFSET`, disjoint from every training round's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = [
    "SyntheticClassification", "round_batches", "SyntheticLM", "lm_round_batches", "cls_eval_batches",
    "lm_eval_batches", "mlm_corrupt", "EVAL_SEED_OFFSET",
]

# keeps held-out sample streams disjoint from every training round key
EVAL_SEED_OFFSET = 999_983


@dataclasses.dataclass
class SyntheticClassification:
    """Class-prototype + noise classification: class k's images cluster
    around a fixed random prototype. ``sample_seed=None`` is the training
    split (samples from the prototypes' stream); an int selects another
    sample stream over the same prototypes (:meth:`holdout`)."""

    # the u8 wire's affine for this data: u8 = clip((x + 4) * 32) covers [-4, 4)
    U8_QSCALE = 32.0
    U8_QOFF = 4.0

    n: int = 8192
    image_shape: tuple[int, ...] = (28, 28, 1)
    classes: int = 10
    noise: float = 0.35
    seed: int = 0
    sample_seed: int | None = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.prototypes = rng.normal(size=(self.classes, *self.image_shape)).astype(np.float32)
        if self.sample_seed is not None:
            rng = np.random.default_rng((self.seed, self.sample_seed))
        self.labels = rng.integers(0, self.classes, size=self.n).astype(np.int32)
        self.images = (
            self.prototypes[self.labels] + self.noise * rng.normal(size=(self.n, *self.image_shape))
        ).astype(np.float32)

    def holdout(self, n: int | None = None) -> "SyntheticClassification":
        """Held-out split: the same class prototypes, a disjoint sample stream."""
        return dataclasses.replace(self, n=n or self.n, sample_seed=(self.sample_seed or 0) + 1)

    def worker_shard(self, rank: int, world_size: int) -> tuple[np.ndarray, np.ndarray]:
        """Disjoint contiguous shard of one worker."""
        per = self.n // world_size
        lo = rank * per
        return self.images[lo: lo + per], self.labels[lo: lo + per]


def round_batches(
    dataset: SyntheticClassification,
    world_size: int,
    h: int,
    batch: int,
    rounds: int,
    seed: int = 0,
    start: int = 0,
) -> Iterator[dict[str, torch.Tensor]]:
    """Stacked round batches ``{"image": (W, H, B, *image_shape) f32,
    "label": (W, H, B) int32}``: each worker samples with replacement from
    its own shard, keyed by ``(seed, absolute round)`` so ``start=N``
    continues the exact stream."""
    shards = [dataset.worker_shard(r, world_size) for r in range(world_size)]
    for rnd in range(start, start + rounds):
        rng = np.random.default_rng((seed, rnd))
        imgs = np.empty((world_size, h, batch, *dataset.image_shape), np.float32)
        labs = np.empty((world_size, h, batch), np.int32)
        for r, (x, y) in enumerate(shards):
            idx = rng.integers(0, len(x), size=(h, batch))
            imgs[r] = x[idx]
            labs[r] = y[idx]
        yield {"image": torch.from_numpy(imgs), "label": torch.from_numpy(labs)}


def cls_eval_batches(dataset: SyntheticClassification, batch: int, n_batches: int,
                     seed: int = 0) -> Iterator[dict[str, torch.Tensor]]:
    """``n_batches`` held-out batches ``{"image": (B, *image_shape) f32,
    "label": (B,) int32}`` from ``dataset``'s holdout split, batch ``r``
    drawn with replacement under ``default_rng((seed + EVAL_SEED_OFFSET,
    r))``, as the reference draws them. Unstacked: every worker and the
    mean model score the same batch."""
    held = dataset.holdout()
    for r in range(n_batches):
        rng = np.random.default_rng((seed + EVAL_SEED_OFFSET, r))
        idx = rng.integers(0, held.n, size=batch)
        yield {"image": torch.from_numpy(held.images[idx]), "label": torch.from_numpy(held.labels[idx])}


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

    @property
    def mask_token(self) -> int:
        """The reserved id the chain never emits: BERT's [MASK]."""
        return self.vocab_size - 1

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


def mlm_corrupt(ids: np.ndarray, dataset: SyntheticLM, seed: int, r: int,
                mlm_rate: float) -> dict[str, torch.Tensor]:
    """BERT-style corruption of a round's token block, keyed ``(seed, r,
    10**6)`` as the reference's: each position is masked with probability
    ``mlm_rate`` (replaced by the dataset's reserved ``mask_token``,
    ``vocab - 1``). Returns ``input_ids`` (corrupted, int32),
    ``labels`` (the original ids, int32) and ``mlm_mask`` (1.0 where
    masked, f32)."""
    rng = np.random.default_rng((seed, r, 10**6))
    mask = rng.random(ids.shape) < mlm_rate
    return {
        "input_ids": torch.from_numpy(np.where(mask, dataset.mask_token, ids).astype(np.int32)),
        "labels": torch.from_numpy(np.asarray(ids, np.int32)),
        "mlm_mask": torch.from_numpy(mask.astype(np.float32)),
    }


def lm_round_batches(
    dataset: SyntheticLM,
    world_size: int,
    h: int,
    batch: int,
    rounds: int,
    seed: int = 0,
    start: int = 0,
    mlm_rate: float = 0.0,
) -> Iterator[dict[str, torch.Tensor]]:
    """Stacked ``(W, H, B, S)`` int32 round batches keyed by ``(seed,
    absolute round, rank)``: ``start=N`` continues the exact stream a fresh
    run would produce at round N. ``mlm_rate > 0`` yields the
    :func:`mlm_corrupt` dict of the round's block instead."""
    for r in range(start, start + rounds):
        ids = np.stack([
            dataset.sample(np.random.default_rng((seed, r, rank)), (h, batch))
            for rank in range(world_size)
        ])
        if mlm_rate > 0:
            yield mlm_corrupt(ids, dataset, seed, r, mlm_rate)
        else:
            yield {"input_ids": torch.from_numpy(ids)}


def lm_eval_batches(dataset: SyntheticLM, batch: int, n_batches: int,
                    seed: int = 0, mlm_rate: float = 0.0) -> Iterator[dict[str, torch.Tensor]]:
    """``n_batches`` held-out ``{"input_ids": (B, S) int32}`` batches: the
    same Markov chain under keys ``(seed + EVAL_SEED_OFFSET, r)``, which no
    training round uses; ``mlm_rate > 0`` corrupts each as
    :func:`mlm_corrupt` under ``(seed + EVAL_SEED_OFFSET, r)``, as the
    reference's ``_lm_eval_batches``. A dataset with a held-out split (a
    token file's, :class:`~consensusml_tpu_torch.data.files.TokenFileDataset`)
    is sampled there."""
    held = dataset.holdout() if hasattr(dataset, "holdout") else dataset
    for r in range(n_batches):
        rng = np.random.default_rng((seed + EVAL_SEED_OFFSET, r))
        ids = held.sample(rng, (batch,))
        if mlm_rate > 0:
            yield mlm_corrupt(ids, held, seed + EVAL_SEED_OFFSET, r, mlm_rate)
        else:
            yield {"input_ids": torch.from_numpy(ids)}
