"""File datasets: MNIST, CIFAR-10 and token corpora (port of
``consensusml_tpu/data/files.py``, numpy only).

Nothing is downloaded: these readers take files a user puts in
``--data-dir``, and every config falls back to the procedural data of
:mod:`consensusml_tpu_torch.data.synthetic` when they are absent. The
layouts are the usual ones:

- **MNIST**: idx files (``train-images-idx3-ubyte``,
  ``train-labels-idx1-ubyte``, ``t10k-*`` for the held-out split), gzipped
  or not; pixels scaled to [0, 1);
- **CIFAR-10**: the binary batches (``data_batch_1..5.bin``,
  ``test_batch.bin``; 3073-byte records, CHW uint8), in ``data_dir`` or
  ``data_dir/cifar-10-batches-bin``, turned into NHWC f32;
- **token corpora**: a flat file of token ids (``tokens.bin`` or
  ``train.bin``, uint16 little-endian, or uint32 told apart by
  :func:`_sniff_token_dtype`), with an optional ``tokens.val.bin`` or
  ``val.bin`` held out.

Without held-out files the training set's tail is carved off at
construction (the last 10% of images, the last 5% of tokens), so a
training worker never sees a held-out sample. :class:`FileClassification`
has the procedural classification set's interface (``n``,
``image_shape``, ``worker_shard``, ``holdout``), so ``round_batches`` and
``cls_eval_batches`` take it; :class:`TokenFileDataset` the procedural
LM's (``sample``, ``vocab_size``, ``seq_len``, ``mask_token``), with its
own round batches, :func:`token_round_batches`, in which worker ``r``
draws windows from its own contiguous region under ``(seed, round, r)``.
The arrays equal the reference's for the same files, seed and round.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Iterator

import numpy as np
import torch

__all__ = [
    "FileClassification", "TokenFileDataset", "read_idx", "load_mnist", "load_cifar10", "load_tokens",
    "find_classification", "find_tokens", "token_round_batches",
]

_IDX_DTYPES = {
    0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"), 0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
    0x0E: np.dtype(">f8"),
}


def read_idx(path: str) -> np.ndarray:
    """One idx array (MNIST's container), ``.gz`` or not: a 4-byte magic
    (two zero bytes, the dtype code, ndim), ndim big-endian uint32 dims,
    then the row-major data."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    zero, dtype_code, ndim = raw[0] << 8 | raw[1], raw[2], raw[3]
    if zero != 0:
        raise ValueError(f"{path}: bad idx magic {raw[:4]!r}")
    if dtype_code not in _IDX_DTYPES:
        raise ValueError(f"{path}: unknown idx dtype code {dtype_code:#x}")
    dims = struct.unpack(f">{ndim}I", raw[4: 4 + 4 * ndim])
    return np.frombuffer(raw, _IDX_DTYPES[dtype_code], offset=4 + 4 * ndim).reshape(dims)


def _first_existing(data_dir: str, names: list[str]) -> str | None:
    for name in names:
        for cand in (name, name + ".gz"):
            p = os.path.join(data_dir, cand)
            if os.path.exists(p):
                return p
    return None


@dataclasses.dataclass
class FileClassification:
    """A labeled image set in memory with the procedural set's interface."""

    images: np.ndarray  # (N, H, W, C) f32
    labels: np.ndarray  # (N,) int32
    holdout_images: np.ndarray | None = None
    holdout_labels: np.ndarray | None = None
    source: str = "file"

    def __post_init__(self):
        # no held-out files: carve the last 10% off the training set now,
        # so worker_shard never hands a worker a held-out image
        if self.holdout_images is None:
            cut = max(1, len(self.images) // 10)
            self.holdout_images, self.holdout_labels = self.images[-cut:], self.labels[-cut:]
            self.images, self.labels = self.images[:-cut], self.labels[:-cut]
            self.source += ":tail-carved"

    @property
    def n(self) -> int:
        return len(self.images)

    @property
    def image_shape(self) -> tuple[int, ...]:
        return tuple(self.images.shape[1:])

    @property
    def classes(self) -> int:
        return int(self.labels.max()) + 1

    def worker_shard(self, rank: int, world_size: int) -> tuple[np.ndarray, np.ndarray]:
        per = self.n // world_size
        lo = rank * per
        return self.images[lo: lo + per], self.labels[lo: lo + per]

    def holdout(self) -> "FileClassification":
        """The test split (the held-out files, or the carved tail)."""
        held_i, held_l = np.asarray(self.holdout_images), np.asarray(self.holdout_labels)
        return FileClassification(held_i, held_l, held_i, held_l, source=self.source + ":holdout")


def load_mnist(data_dir: str) -> FileClassification | None:
    """MNIST from idx files in ``data_dir`` or ``data_dir/mnist``, or None."""
    for root in (data_dir, os.path.join(data_dir, "mnist")):
        if not os.path.isdir(root):
            continue
        img_p = _first_existing(root, ["train-images-idx3-ubyte", "train-images.idx3-ubyte"])
        lab_p = _first_existing(root, ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"])
        if img_p is None or lab_p is None:
            continue
        images = read_idx(img_p).astype(np.float32) / 255.0
        images = images.reshape(*images.shape[:3], 1)  # (N, 28, 28, 1)
        labels = read_idx(lab_p).astype(np.int32)
        hi = _first_existing(root, ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
        hl = _first_existing(root, ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
        held_i = held_l = None
        if hi is not None and hl is not None:
            held_i = read_idx(hi).astype(np.float32) / 255.0
            held_i = held_i.reshape(*held_i.shape[:3], 1)
            held_l = read_idx(hl).astype(np.int32)
        return FileClassification(images, labels, held_i, held_l, source=f"mnist:{root}")
    return None


def _read_cifar_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    rec = 1 + 3 * 32 * 32
    raw = np.fromfile(path, np.uint8)
    if raw.size % rec:
        raise ValueError(f"{path}: size {raw.size} not a multiple of {rec}")
    raw = raw.reshape(-1, rec)
    labels = raw[:, 0].astype(np.int32)
    # records are CHW; the models take NHWC
    images = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0
    return images, labels


def load_cifar10(data_dir: str) -> FileClassification | None:
    """CIFAR-10 from its binary batches, or None."""
    for root in (data_dir, os.path.join(data_dir, "cifar-10-batches-bin")):
        if not os.path.isdir(root):
            continue
        paths = [p for p in (os.path.join(root, f"data_batch_{i}.bin") for i in range(1, 6)) if os.path.exists(p)]
        if not paths:
            continue
        imgs, labs = zip(*(_read_cifar_bin(p) for p in paths))
        held_i = held_l = None
        test_p = os.path.join(root, "test_batch.bin")
        if os.path.exists(test_p):
            held_i, held_l = _read_cifar_bin(test_p)
        return FileClassification(np.concatenate(imgs), np.concatenate(labs), held_i, held_l,
                                  source=f"cifar10:{root}")
    return None


def find_classification(data_dir: str) -> FileClassification | None:
    """MNIST or CIFAR-10 under ``data_dir``, whichever is there."""
    return load_mnist(data_dir) or load_cifar10(data_dir)


@dataclasses.dataclass
class TokenFileDataset:
    """Random ``seq_len`` windows of a flat token file (memmapped). The
    highest id must stay below ``vocab_size - 1``: the last id is [MASK],
    as in the procedural data."""

    tokens: np.ndarray
    seq_len: int
    vocab_size: int
    val_tokens: np.ndarray | None = None
    source: str = "file"

    def __post_init__(self):
        if len(self.tokens) < self.seq_len + 1:
            raise ValueError(f"token file has {len(self.tokens)} tokens < seq_len+1={self.seq_len + 1}")
        # no held-out file: carve the last 5% off the training stream now,
        # so no training window overlaps the held-out region
        if self.val_tokens is None:
            cut = max(self.seq_len + 1, len(self.tokens) // 20)
            if len(self.tokens) - cut >= self.seq_len + 1:
                self.val_tokens, self.tokens = self.tokens[-cut:], self.tokens[:-cut]
                self.source += ":tail-carved"
            else:  # too small to carve: eval on train, and say so
                self.val_tokens = self.tokens
                self.source += ":eval-on-train"

    @property
    def mask_token(self) -> int:
        return self.vocab_size - 1

    def sample(self, rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
        return _sample_windows(self.tokens, rng, shape, self.seq_len)

    def holdout(self) -> "TokenFileDataset":
        """Held-out windows: the val file, or the carved tail."""
        return TokenFileDataset(self.val_tokens, self.seq_len, self.vocab_size, self.val_tokens,
                                source=self.source + ":holdout")

    def worker_region(self, rank: int, world_size: int) -> tuple[int, int]:
        """The contiguous ``[lo, hi)`` token region of worker ``rank``."""
        per = len(self.tokens) // world_size
        if per < self.seq_len + 1:
            raise ValueError(
                f"token stream too small for this world: {len(self.tokens)} train tokens / {world_size} "
                f"workers = {per} per worker, need at least seq_len+1={self.seq_len + 1} each"
            )
        lo = rank * per
        return lo, lo + per


def _sample_windows(tokens: np.ndarray, rng: np.random.Generator, shape: tuple[int, ...],
                    seq_len: int) -> np.ndarray:
    n = int(np.prod(shape))
    starts = rng.integers(0, len(tokens) - seq_len, size=n)
    out = np.empty((n, seq_len), np.int32)
    for i, s in enumerate(starts):
        out[i] = tokens[s: s + seq_len]
    return out.reshape(*shape, seq_len)


def _sniff_token_dtype(path: str, vocab_size: int):
    """uint16 or uint32. A uint32 file read as uint16 becomes ``(id, 0)``
    pairs whose every id passes the vocabulary check, so a misread would
    be silent: the file is uint32 when it is 4-byte aligned and, in its
    first 128 KiB, the odd uint16 positions are almost all zero while the
    even ones are not. A vocabulary over 2^16 forces uint32."""
    if vocab_size > 1 << 16:
        return np.uint32
    size = os.path.getsize(path)
    probe = np.fromfile(path, np.uint16, count=min(size // 2, 65536))
    if size % 4 == 0 and probe.size >= 8:
        odd, even = probe[1::2], probe[0::2]
        if np.count_nonzero(odd) * 100 <= odd.size and np.count_nonzero(even):
            return np.uint32
    return np.uint16


def load_tokens(data_dir: str, seq_len: int, vocab_size: int, *,
                names: tuple[str, ...] = ("tokens.bin", "train.bin"), dtype="auto") -> TokenFileDataset | None:
    """Memmap ``tokens.bin`` (and ``tokens.val.bin`` or ``val.bin``), or
    None. ``dtype="auto"`` sniffs the token width."""
    if not os.path.isdir(data_dir):
        return None
    for name in names:
        p = os.path.join(data_dir, name)
        if not os.path.exists(p):
            continue
        dt = _sniff_token_dtype(p, vocab_size) if dtype == "auto" else np.dtype(dtype)
        toks = np.memmap(p, dtype=dt, mode="r")
        stem = name.rsplit(".bin", 1)[0]
        val = None
        for vname in (f"{stem}.val.bin", "val.bin"):
            vp = os.path.join(data_dir, vname)
            if os.path.exists(vp):
                val = np.memmap(vp, dtype=dt, mode="r")
                break
        return TokenFileDataset(toks, seq_len, vocab_size, val, source=f"tokens:{p}[{np.dtype(dt).name}]")
    return None


find_tokens = load_tokens


def token_round_batches(dataset: TokenFileDataset, world_size: int, h: int, batch: int, rounds: int,
                        seed: int = 0, mlm_rate: float = 0.0, start: int = 0) -> Iterator[dict]:
    """Stacked ``(W, H, B, S)`` int32 batches of file windows, worker ``r``
    drawing from its own region under ``(seed, round, r)``: ``start=N``
    continues the stream a run from round 0 would give. ``mlm_rate > 0``
    yields :func:`~consensusml_tpu_torch.data.synthetic.mlm_corrupt`'s dict."""
    from consensusml_tpu_torch.data.synthetic import mlm_corrupt

    regions = [dataset.worker_region(r, world_size) for r in range(world_size)]
    for r in range(start, start + rounds):
        ids = np.stack([
            _sample_windows(dataset.tokens[lo:hi], np.random.default_rng((seed, r, rank)), (h, batch),
                            dataset.seq_len)
            for rank, (lo, hi) in enumerate(regions)
        ])
        if mlm_rate > 0:
            yield mlm_corrupt(ids, dataset, seed, r, mlm_rate)
        else:
            yield {"input_ids": torch.from_numpy(ids)}
