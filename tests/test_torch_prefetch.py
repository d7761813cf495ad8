"""The port's device prefetcher (``consensusml_tpu_torch.data.prefetch``)
against the reference's ``DevicePrefetcher`` on the CPU.

- The delivered sequence at depths 0-3, from plain batches and from the
  native ring's zero-copy views, byte-equal to the reference's and to the
  source's own.
- ``on_done`` fires once an item, after the item is staged; a pooled
  source never has more than ``pool - 1`` items awaiting release when it
  yields the next, and a source without a pool never more than ``depth``,
  as in the reference.
- A source's error reaches the consumer after the batches before it;
  ``close()`` mid-stream returns, stops the thread, closes the source and
  releases every staged item.
- A read-only view (a ring slot's) becomes a tensor over its own bytes,
  with no copy and no warning.
- ``consensusml_feed_batches_total`` and the stall counters move as the
  reference's; ``batches_out``, ``stall_seconds_total`` and the staged
  bytes.

Every wait on the prefetcher runs in a helper thread joined with a
timeout, so a hang fails the test instead of stalling the suite.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import consensusml_tpu.obs as R
import consensusml_tpu_torch.obs as Q
from consensusml_tpu.data.prefetch import DevicePrefetcher as JaxPrefetcher
from consensusml_tpu.data.prefetch import FeedItem as JaxItem
from consensusml_tpu.data.prefetch import prefetch_to_device as jax_prefetch
from consensusml_tpu_torch.data import native_pipeline as pipe
from consensusml_tpu_torch.data.prefetch import DevicePrefetcher, FeedItem, _host_tensor, prefetch_to_device
from consensusml_tpu_torch.data.synthetic import SyntheticClassification

TIMEOUT = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bounded(fn):
    """``fn()`` on a helper thread, joined with a timeout."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - handed to the caller
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive(), "prefetcher wait timed out"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _batches(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.normal(size=(2, 1, 3, 4)).astype(np.float32),
             "label": rng.integers(0, 10, (2, 1, 3)).astype(np.int32)} for _ in range(n)]


def _bytes(seq):
    return [{k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).tobytes() for k, v in b.items()}
            for b in seq]


def _counter(obs, name):
    # by name first: the registry also holds histograms, which have no .value
    return next((m.value for m in obs.get_registry().metrics() if m.key == name), 0.0)


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_sequence_equals_the_references(depth):
    src = _batches()
    want = _bounded(lambda: _bytes(jax_prefetch(iter(src), depth)))
    feed = prefetch_to_device(iter(src), depth, device="cpu")
    assert isinstance(feed, DevicePrefetcher) == (depth > 0)
    got = _bounded(lambda: list(feed))
    assert _bytes(got) == want == _bytes(src)
    if depth:
        # numpy leaves are copied: the delivered tensors own their memory
        assert all(isinstance(v, torch.Tensor) for b in got for v in b.values())
        src[0]["image"][...] = 0
        assert _bytes(got[:1]) == want[:1]


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_ring_views_through_the_feed_equal_the_copies(depth):
    """The native ring's zero-copy views through the prefetcher deliver the
    bytes of its copying iterator (the reference's determinism: a function
    of ``(seed, round)`` only, whatever the depth)."""
    ds = SyntheticClassification(n=64, image_shape=(4, 4, 3))
    want = _bytes(pipe.native_round_batches(ds, 2, 1, 4, 5, seed=3, wire="u8"))
    got = _bounded(lambda: _bytes(pipe.native_cls_feed(ds, 2, 1, 4, 5, seed=3, prefetch=depth, device="cpu")))
    assert got == want


class _Pooled:
    """A source of ``n`` FeedItems over ``pool`` buffers that records, at
    each yield, how many earlier items still await their ``on_done``."""

    def __init__(self, item_cls, n, pool, fail_at=None):
        self.item_cls, self.n, self.pool, self.fail_at = item_cls, n, pool, fail_at
        self.done = [0] * n
        self.held_at_yield: list = []
        self.closed = False

    def __iter__(self):
        try:
            for i in range(self.n):
                if i == self.fail_at:
                    raise ValueError(f"source failed at {i}")
                self.held_at_yield.append(sum(1 for j in range(i) if not self.done[j]))
                yield self.item_cls({"x": np.full((3,), i, np.float32)},
                                    lambda i=i: self.done.__setitem__(i, self.done[i] + 1), pool=self.pool)
        finally:
            self.closed = True


@pytest.mark.parametrize("depth,pool", [(1, 3), (2, 2), (3, 2), (3, 5)])
def test_on_done_once_and_the_pool_clamp(depth, pool):
    runs = {}
    for name, make, item in [("ref", lambda s: JaxPrefetcher(s, depth), JaxItem),
                             ("port", lambda s: DevicePrefetcher(s, depth, device="cpu"), FeedItem)]:
        src = _Pooled(item, 8, pool)
        out = _bounded(lambda: [float(np.asarray(b["x"])[0]) for b in make(iter(src))])
        assert out == [float(i) for i in range(8)]
        assert src.done == [1] * 8 and src.closed
        runs[name] = max(src.held_at_yield)
    assert runs["port"] == runs["ref"] <= pool - 1


def test_source_errors_reach_the_consumer():
    for make, item in [(lambda s: JaxPrefetcher(s, 2), JaxItem),
                       (lambda s: DevicePrefetcher(s, 2, device="cpu"), FeedItem)]:
        src = _Pooled(item, 8, 4, fail_at=3)
        feed = make(iter(src))
        seen = []

        def consume():
            for b in feed:
                seen.append(float(np.asarray(b["x"])[0]))

        with pytest.raises(ValueError, match="source failed at 3"):
            _bounded(consume)
        assert seen == [0.0, 1.0, 2.0] and src.done == [1, 1, 1] + [0] * 5


def test_close_mid_stream_releases_and_stops():
    src = _Pooled(FeedItem, 50, 4)
    feed = DevicePrefetcher(iter(src), 2, device="cpu")
    first = _bounded(lambda: next(feed))
    assert float(first["x"][0]) == 0.0
    _bounded(feed.close)
    assert not feed._thread.is_alive() and src.closed
    pulled = len(src.held_at_yield)
    assert src.done[:pulled] == [1] * pulled and not any(src.done[pulled:])
    with pytest.raises(StopIteration):
        next(feed)
    feed.close()  # idempotent


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_window_without_a_pool_is_the_depth(depth):
    runs = {}
    for name, make, item in [("ref", lambda s: JaxPrefetcher(s, depth), JaxItem),
                             ("port", lambda s: DevicePrefetcher(s, depth, device="cpu"), FeedItem)]:
        src = _Pooled(item, 8, None)
        _bounded(lambda: list(make(iter(src))))
        assert src.done == [1] * 8
        runs[name] = max(src.held_at_yield)
    assert runs["port"] == runs["ref"] == depth


def test_read_only_views_alias_without_a_copy():
    base = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    view = base.reshape(6, 4)
    view.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = _host_tensor(view)
    assert t.dtype == torch.float32 and tuple(t.shape) == (6, 4) and t.data_ptr() == base.ctypes.data
    assert t.numpy().tobytes() == base.tobytes()
    # a non-contiguous or empty view is copied, a writable one aliased as torch.from_numpy does
    assert _host_tensor(base[:, :, ::2]).numpy().tobytes() == np.ascontiguousarray(base[:, :, ::2]).tobytes()
    assert _host_tensor(np.empty((0, 3), np.uint8)).shape == (0, 3)
    assert _host_tensor(base).data_ptr() == base.ctypes.data


def test_batches_total_and_stall_counters_move_as_the_references():
    src = _batches(5)
    deltas = []
    for obs, make in [(R, lambda: JaxPrefetcher(iter(src), 2)),
                      (Q, lambda: DevicePrefetcher(iter(src), 2, device="cpu"))]:
        before = _counter(obs, "consensusml_feed_batches_total")
        feed = make()
        n = len(_bounded(lambda: list(feed)))
        deltas.append((n, _counter(obs, "consensusml_feed_batches_total") - before, feed.batches_out))
        assert feed.stall_seconds_total >= feed.last_stall_s >= 0.0
        assert _counter(obs, "consensusml_feed_stall_seconds") == feed.last_stall_s
    assert deltas[0] == deltas[1] == (5, 5, 5)
    assert _counter(Q, "consensusml_feed_staged_bytes") % (2 * 3 * 4 * 4 + 2 * 3 * 4) == 0
    # host tensors on the CPU are taken as they are; nothing is copied to a card
    feed = DevicePrefetcher(iter([{"x": torch.ones(3)}]), 2, device="cpu")
    assert _bounded(lambda: list(feed))[0]["x"].data_ptr() != 0 and feed.h2d_bytes_total == 0
