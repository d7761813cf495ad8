"""Round-batch iterators over the native C++ prefetch ring (port of
``consensusml_tpu/data/native_pipeline.py``).

The same stacked ``(W, H, B, ...)`` batches as :mod:`.synthetic`, but made
by the ring's producer threads, which run ahead of the training loop. The
native stream is procedural and endless (every sample fresh from the
prototypes or the Markov chain, or gathered from a file's table), so its
samples differ from the Python loaders' numpy draws by design, as the
reference's do; its bytes are a pure function of ``(seed, round)``.

Two ways out of the ring, as the reference's:

- the copying iterators yield fresh host tensors a round (``next()``
  copies the slot out and releases it);
- ``views=True`` yields :class:`~consensusml_tpu_torch.data.prefetch.
  FeedItem`\\ s whose leaves are read-only numpy views of the slot itself
  and whose ``on_done`` releases it. They must go through the device
  prefetcher, which releases each slot once its copy to the device has
  completed; ``pool`` tells it the ring's depth so it never holds every
  slot. The release closures keep the loader alive until the last one has
  fired; then refcounting closes it.

``wire="u8"`` ships quantized bytes (a quarter of the f32 wire); the
consumer dequants on the device as ``u8 / qscale - qoff``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from consensusml_tpu_torch.data.synthetic import SyntheticClassification, SyntheticLM, mlm_corrupt

__all__ = [
    "dequant_u8",
    "native_round_batches",
    "native_lm_round_batches",
    "native_file_round_batches",
    "native_file_token_batches",
    "native_cls_feed",
    "plan_ring",
]


def dequant_u8(img: torch.Tensor, qscale: float, qoff: float) -> torch.Tensor:
    """The u8 wire's bytes back to f32, ``u8 / qscale - qoff``, on
    ``img``'s device, as the reference's compiled step computes it: XLA
    turns the division by a constant into a product by its f32 reciprocal,
    so this multiplies by ``f32(1) / f32(qscale)`` (for qscale 255 a plain
    division differs in the last bit on some codes)."""
    recip = float(np.float32(1.0) / np.float32(qscale))
    return img.to(torch.float32) * recip - qoff


def plan_ring(samples_per_slot: int, sample_wire_bytes: int, prefetch: int = 2,
              cpu_count: int | None = None) -> tuple[int, int]:
    """``(depth, nthreads)`` of the ring for a round's shape: ``prefetch +
    2`` slots (the prefetcher's staged batches, one in transfer, one free
    for the producers) and about one producer thread per 8 MB of slot,
    within ``[2, cpus - 2]``."""
    depth = max(2, int(prefetch) + 2)
    cpus = cpu_count if cpu_count is not None else (os.cpu_count() or 4)
    slot_mb = samples_per_slot * max(1, sample_wire_bytes) / 1e6
    nthreads = int(min(max(2, slot_mb // 8 + 1), max(2, cpus - 2)))
    return depth, nthreads


def _ring_yield(loader, rounds, world_size, h, batch, image_shape):
    """The copying consume loop: fresh host tensors a round."""
    for _ in range(rounds):
        data, ints = loader.next()
        yield {
            "image": torch.from_numpy(data.reshape(world_size, h, batch, *image_shape)),
            "label": torch.from_numpy(ints.reshape(world_size, h, batch)),
        }


def _ring_view_yield(loader, rounds, world_size, h, batch, image_shape, depth):
    """The zero-copy consume loop: FeedItems of slot views, released by
    their ``on_done``."""
    from consensusml_tpu_torch.data.prefetch import FeedItem

    for _ in range(rounds):
        idx, data, ints = loader.acquire_view()
        yield FeedItem(
            {"image": data.reshape(world_size, h, batch, *image_shape),
             "label": ints.reshape(world_size, h, batch)},
            lambda i=idx: loader.release_slot(i),
            pool=depth,
        )


def _cls_stream(loader, rounds, world_size, h, batch, image_shape, depth, views):
    if views:
        # no close here: in-flight copies read the slots after this generator ends
        yield from _ring_view_yield(loader, rounds, world_size, h, batch, image_shape, depth)
    else:
        with loader:
            yield from _ring_yield(loader, rounds, world_size, h, batch, image_shape)


def native_round_batches(dataset: SyntheticClassification, world_size: int, h: int, batch: int, rounds: int,
                         seed: int = 0, depth: int = 4, nthreads: int = 2, start: int = 0, wire: str = "f32",
                         qscale: float = 32.0, qoff: float = 4.0, views: bool = False):
    """``rounds`` stacked ``{"image": (W, H, B, *image_shape), "label": (W,
    H, B)}`` batches of the prototypes-plus-noise set from the ring.
    ``start`` continues the stream at that round (the slot sequence is the
    round number)."""
    from consensusml_tpu_torch.native import NativeLoader

    sample_floats = int(np.prod(dataset.image_shape))
    loader = NativeLoader(
        kind="classification", samples_per_slot=world_size * h * batch, sample_floats=sample_floats,
        sample_ints=1, nclasses_or_vocab=dataset.classes, noise=dataset.noise,
        prototypes=dataset.prototypes.reshape(dataset.classes, sample_floats), depth=depth, nthreads=nthreads,
        seed=seed, start_seq=start, wire=wire, qscale=qscale, qoff=qoff,
    )
    yield from _cls_stream(loader, rounds, world_size, h, batch, dataset.image_shape, depth, views)


def _lm_stream(loader, dataset, world_size, h, batch, rounds, seed, start, mlm_rate):
    with loader:
        for r in range(start, start + rounds):
            _, ints = loader.next()
            ids = ints.reshape(world_size, h, batch, dataset.seq_len)
            if mlm_rate <= 0:
                yield {"input_ids": torch.from_numpy(ids)}
            else:
                yield mlm_corrupt(ids, dataset, seed, r, mlm_rate)


def native_lm_round_batches(dataset: SyntheticLM, world_size: int, h: int, batch: int, rounds: int, seed: int = 0,
                            mlm_rate: float = 0.0, depth: int = 4,
                            nthreads: int = 2, start: int = 0):
    """Stacked ``{"input_ids": (W, H, B, S)}`` Markov-chain batches from the
    ring; ``mlm_rate > 0`` yields :func:`~consensusml_tpu_torch.data.
    synthetic.mlm_corrupt`'s dict of each, keyed by ``(seed, round)``."""
    from consensusml_tpu_torch.native import NativeLoader

    loader = NativeLoader(
        kind="lm", samples_per_slot=world_size * h * batch, sample_floats=0, sample_ints=dataset.seq_len,
        nclasses_or_vocab=dataset.vocab_size, successors=dataset.successors, depth=depth, nthreads=nthreads,
        seed=seed, start_seq=start,
    )
    yield from _lm_stream(loader, dataset, world_size, h, batch, rounds, seed, start, mlm_rate)


def native_file_round_batches(dataset, world_size: int, h: int, batch: int, rounds: int, seed: int = 0,
                              depth: int = 4, nthreads: int = 2, start: int = 0, wire: str = "f32",
                              qscale: float = 32.0, qoff: float = 4.0, views: bool = False):
    """A file's classification batches (``data.files.FileClassification``)
    from the ring: its producers gather each worker's samples from that
    worker's contiguous shard of the image table."""
    from consensusml_tpu_torch.native import NativeLoader

    sample_floats = int(np.prod(dataset.image_shape))
    loader = NativeLoader(
        kind="file_classification", samples_per_slot=world_size * h * batch, sample_floats=sample_floats,
        sample_ints=1, world=world_size, images=dataset.images.reshape(dataset.n, sample_floats),
        labels=dataset.labels, depth=depth, nthreads=nthreads, seed=seed, start_seq=start, wire=wire,
        qscale=qscale, qoff=qoff,
    )
    yield from _cls_stream(loader, rounds, world_size, h, batch, dataset.image_shape, depth, views)


def native_cls_feed(dataset, world_size: int, h: int, batch: int, rounds: int, *, seed: int = 0, start: int = 0,
                    wire: str = "u8", qscale: float = 32.0, qoff: float = 4.0, prefetch: int = 2,
                    depth: int | None = None, nthreads: int | None = None, device=None):
    """The overlapped classification feed end to end: slot views through a
    :class:`~consensusml_tpu_torch.data.prefetch.DevicePrefetcher` onto
    ``device`` (None: the card). ``depth``/``nthreads`` default to
    :func:`plan_ring`'s. ``prefetch <= 0`` returns the plain copying
    iterator: the same bytes, no overlap."""
    from consensusml_tpu_torch.data.files import FileClassification
    from consensusml_tpu_torch.data.prefetch import prefetch_to_device

    wire_bytes = 1 if wire == "u8" else 4
    sample_floats = int(np.prod(dataset.image_shape))
    plan_depth, plan_threads = plan_ring(world_size * h * batch, sample_floats * wire_bytes, max(prefetch, 1))
    depth = plan_depth if depth is None else depth
    nthreads = plan_threads if nthreads is None else nthreads
    fn = native_file_round_batches if isinstance(dataset, FileClassification) else native_round_batches
    source = fn(dataset, world_size, h, batch, rounds, seed=seed, depth=depth, nthreads=nthreads, start=start,
                wire=wire, qscale=qscale, qoff=qoff, views=prefetch > 0)
    return prefetch_to_device(source, prefetch, device=device)


def native_file_token_batches(dataset, world_size: int, h: int, batch: int, rounds: int, seed: int = 0,
                              mlm_rate: float = 0.0, depth: int = 4,
                              nthreads: int = 2, start: int = 0):
    """A token file's windows (``data.files.TokenFileDataset``) from the
    ring: each worker's windows start in its contiguous region; uint16
    files are read in place."""
    from consensusml_tpu_torch.native import NativeLoader

    loader = NativeLoader(
        kind="file_lm", samples_per_slot=world_size * h * batch, sample_floats=0, sample_ints=dataset.seq_len,
        world=world_size, tokens=dataset.tokens, depth=depth, nthreads=nthreads, seed=seed, start_seq=start,
    )
    yield from _lm_stream(loader, dataset, world_size, h, batch, rounds, seed, start, mlm_rate)
