"""The port's native ring against the reference's (``consensusml_tpu.native``
and ``consensusml_tpu.data.native_pipeline``), on the CPU.

- :class:`NativeLoader`: every slot of every kind (procedural and file
  classification on the f32 and u8 wires, the Markov LM, token windows of
  int32 and uint16 files) byte-equal through ``next()`` and through the
  zero-copy views, whatever the thread count and depth, from a resumed
  sequence number too; the refusals and a closed loader's errors.
- The five iterators (procedural and file classification, both wires and
  views; procedural and file LM, with and without MLM corruption) equal
  the reference's round for round, and ``plan_ring``.
- The host codecs (per-chunk int8 and the magnitude top-k).
- Each config's ``native_batches`` at smoke scale equal the reference
  bundle's, the image configs' u8 wire and its constants included.
- The build: a library named by its sources' hash, built once under a file
  lock by processes that start together.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu import native as ref_native
from consensusml_tpu.data import files as jax_files
from consensusml_tpu.data import native_pipeline as ref_pipe
from consensusml_tpu.data.synthetic import SyntheticClassification as JaxCls
from consensusml_tpu.data.synthetic import SyntheticLM as JaxLM
from consensusml_tpu_torch import configs, native
from consensusml_tpu_torch.data import files, native_pipeline as pipe
from consensusml_tpu_torch.data.prefetch import DevicePrefetcher
from consensusml_tpu_torch.data.synthetic import SyntheticClassification, SyntheticLM

TIMEOUT = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _file_tables(n=48, shape=(4, 4, 3), seed=2):
    rng = np.random.default_rng(seed)
    images = rng.random((n, *shape), dtype=np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    return images, labels


def _tokens(n=4000, vocab=200, dtype=np.int32, seed=3):
    return np.random.default_rng(seed).integers(0, vocab - 1, n).astype(dtype)


def _loader_kwargs(kind, wire):
    cls = SyntheticClassification(n=32, image_shape=(4, 4, 3))
    lm = SyntheticLM(vocab_size=64, seq_len=12)
    images, labels = _file_tables()
    base = dict(samples_per_slot=8, seed=7, wire=wire)
    if kind == "classification":
        return dict(base, kind=kind, sample_floats=48, sample_ints=1, nclasses_or_vocab=10, noise=0.35,
                    prototypes=cls.prototypes.reshape(10, 48))
    if kind == "lm":
        return dict(base, kind=kind, sample_floats=0, sample_ints=12, nclasses_or_vocab=64, successors=lm.successors)
    if kind == "file_classification":
        return dict(base, kind=kind, sample_floats=48, sample_ints=1, world=2, images=images.reshape(48, 48),
                    labels=labels)
    tokens = _tokens(dtype=np.uint16 if kind == "file_lm16" else np.int32)
    return dict(base, kind="file_lm", sample_floats=0, sample_ints=12, world=4, tokens=tokens)


LOADER_CASES = [("classification", "f32"), ("classification", "u8"), ("lm", "f32"),
                ("file_classification", "f32"), ("file_classification", "u8"), ("file_lm", "f32"),
                ("file_lm16", "f32")]


@pytest.mark.parametrize("kind,wire", LOADER_CASES)
def test_loader_slots_byte_equal_the_references(kind, wire):
    kw = _loader_kwargs(kind, wire)
    with ref_native.NativeLoader(**kw, depth=3, nthreads=2) as ref:
        want = [ref.next() for _ in range(5)]
    # other depths and thread counts, both consume paths
    with native.NativeLoader(**kw, depth=2, nthreads=3) as got:
        copies = [got.next() for _ in range(5)]
    with native.NativeLoader(**kw, depth=4, nthreads=1) as got:
        views = []
        for _ in range(5):
            idx, d, i = got.acquire_view()
            assert d.size == 0 or not d.flags.writeable
            views.append((d.copy(), i.copy()))
            got.release_slot(idx)
    for (wd, wi), (cd, ci), (vd, vi) in zip(want, copies, views):
        assert cd.dtype == wd.dtype == (np.uint8 if wire == "u8" else np.float32)
        assert cd.tobytes() == wd.tobytes() == vd.tobytes()
        assert ci.tobytes() == wi.tobytes() == vi.tobytes()
    # resume: the stream from slot 3 on
    with native.NativeLoader(**kw, start_seq=3) as got:
        assert got.next()[1].tobytes() == want[3][1].tobytes()


def test_loader_next_out_reuse_and_refusals():
    kw = _loader_kwargs("classification", "f32")
    with native.NativeLoader(**kw) as got, ref_native.NativeLoader(**kw) as ref:
        out = (np.empty((8, 48), np.float32), np.empty((8, 1), np.int32))
        d, i = got.next(out=out)
        assert d is out[0] and i is out[1]
        assert d.tobytes() == ref.next()[0].tobytes()
        for bad in [(np.empty((8, 47), np.float32), out[1]), (out[0],), [out[0], torch.zeros(8, 1)]]:
            with pytest.raises(ValueError) as e_got:
                got.next(out=bad)
            with pytest.raises(ValueError) as e_ref:
                ref.next(out=bad)
            assert str(e_got.value) == str(e_ref.value)
    for pkg in (native, ref_native):
        with pytest.raises(ValueError, match="unknown wire"):
            pkg.NativeLoader(**dict(kw, wire="bf16"))
        with pytest.raises(ValueError, match="unknown kind"):
            pkg.NativeLoader(**dict(kw, kind="video"))
        with pytest.raises(ValueError, match="requires a successors table"):
            pkg.NativeLoader(**dict(_loader_kwargs("lm", "f32"), successors=None))
        with pytest.raises(RuntimeError, match="cml_loader_create failed"):
            pkg.NativeLoader(**dict(_loader_kwargs("lm", "u8")))  # u8 is an image wire
        with pytest.raises(RuntimeError, match="cml_loader_create_file failed"):
            pkg.NativeLoader(**dict(_loader_kwargs("file_classification", "f32"), world=3))
        loader = pkg.NativeLoader(**kw)
        loader.close()
        loader.release_slot(0)  # a deferred release after close is a no-op
        with pytest.raises(RuntimeError, match="loader closed"):
            loader.next()


def test_closing_wakes_a_blocked_consumer():
    """Every slot held: a consumer blocked in acquire wakes with ``loader
    stopped`` when the loader closes."""
    loader = native.NativeLoader(**_loader_kwargs("classification", "f32"), depth=2)
    held = [loader.acquire_view()[0] for _ in range(2)]
    errors: list = []

    def consume():
        try:
            loader.acquire_view()
        except RuntimeError as e:
            errors.append(str(e))

    import threading

    t = threading.Thread(target=consume)
    t.start()
    t.join(timeout=0.3)
    assert t.is_alive() and held == [0, 1]
    loader.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and errors == ["loader stopped"]


def _eq_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            gv, wv = _np(g[k]), _np(w[k])
            assert gv.dtype == wv.dtype and gv.shape == wv.shape, k
            assert gv.tobytes() == wv.tobytes(), k


def _views(src):
    """A view stream's batches, copied out and released as the prefetcher does."""
    for item in src:
        yield {k: v.copy() for k, v in item.batch.items()}
        item.on_done()


@pytest.mark.parametrize("wire", ["f32", "u8"])
@pytest.mark.parametrize("source", ["synthetic", "file"])
def test_classification_iterators_equal_the_references(wire, source):
    if source == "synthetic":
        kw = dict(n=64, image_shape=(4, 4, 3), noise=0.25)
        got_ds, want_ds = SyntheticClassification(**kw), JaxCls(**kw)
        got_fn, want_fn = pipe.native_round_batches, ref_pipe.native_round_batches
    else:
        images, labels = _file_tables()
        got_ds = files.FileClassification(images, labels, images[:4], labels[:4])
        want_ds = jax_files.FileClassification(images, labels, images[:4], labels[:4])
        got_fn, want_fn = pipe.native_file_round_batches, ref_pipe.native_file_round_batches
    args = (4, 2, 2, 3)
    kw = dict(seed=5, start=2, wire=wire, qscale=255.0 if source == "file" else 32.0,
              qoff=0.0 if source == "file" else 4.0)
    want = list(want_fn(want_ds, *args, **kw))
    _eq_batches(got_fn(got_ds, *args, **kw, depth=2, nthreads=3), want)
    _eq_batches(_views(got_fn(got_ds, *args, **kw, views=True)), want)
    # the feed end to end on the CPU: the prefetcher's copies of the views
    feed = pipe.native_cls_feed(got_ds, *args, **kw, prefetch=2, device="cpu")
    assert isinstance(feed, DevicePrefetcher)
    _eq_batches(feed, want)
    _eq_batches(pipe.native_cls_feed(got_ds, *args, **kw, prefetch=0, device="cpu"), want)


@pytest.mark.parametrize("mlm_rate", [0.0, 0.15])
@pytest.mark.parametrize("source", ["synthetic", "file16", "file32"])
def test_lm_iterators_equal_the_references(mlm_rate, source):
    if source == "synthetic":
        got_ds, want_ds = SyntheticLM(vocab_size=64, seq_len=12), JaxLM(vocab_size=64, seq_len=12)
        got_fn, want_fn = pipe.native_lm_round_batches, ref_pipe.native_lm_round_batches
    else:
        tok = _tokens(dtype=np.uint16 if source == "file16" else np.int32)
        got_ds = files.TokenFileDataset(tok, 12, 200, tok[:100])
        want_ds = jax_files.TokenFileDataset(tok, 12, 200, tok[:100])
        got_fn, want_fn = pipe.native_file_token_batches, ref_pipe.native_file_token_batches
    args = (4, 2, 3, 3)
    kw = dict(seed=9, mlm_rate=mlm_rate, start=1)
    _eq_batches(got_fn(got_ds, *args, **kw, nthreads=3), list(want_fn(want_ds, *args, **kw)))


@pytest.mark.parametrize("spans,want", [
    ([(0, 4096), (4096, 4096)], [(0, 0), (1, 1)]),  # page-aligned neighbours stay apart
    ([(100, 5000), (5100, 4000), (20000, 10)], [(0, 2), (4, 4)]),  # a shared page merges
    ([(8192, 1), (0, 100000)], [(0, 24)]),  # a span inside another
])
def test_page_runs_hold_each_span_in_one_run(spans, want):
    runs = native.page_runs(spans, 4096)
    assert runs == want
    for a, n in spans:
        assert sum(lo <= a // 4096 and (a + n - 1) // 4096 <= hi for lo, hi in runs) == 1


def test_plan_ring_is_the_references():
    for args in [(8, 48, 2, 8), (1024, 3072, 2, 8), (65536, 3072, 3, 32), (4, 1, 0, 2), (1 << 20, 4, 1, None)]:
        assert pipe.plan_ring(*args) == ref_pipe.plan_ring(*args)


def test_host_codecs_equal_the_references():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 128)).astype(np.float32)
    x[2] = 0.0
    x[3, :5] = 7.0  # ties
    for got, want in [(native.quantize_int8_chunks(x), ref_native.quantize_int8_chunks(x)),
                      (native.topk_chunks(x, 9), ref_native.topk_chunks(x, 9)),
                      (native.topk(x, 40), ref_native.topk(x, 40)),
                      (native.topk(x[0], 500), ref_native.topk(x[0], 500))]:
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    q, s = ref_native.quantize_int8_chunks(x)
    assert native.dequantize_int8_chunks(q, s).tobytes() == ref_native.dequantize_int8_chunks(q, s).tobytes()


@pytest.mark.parametrize("name", list(configs.CONFIGS))
def test_config_native_batches_equal_the_references(name):
    got = configs.build(name, "smoke", device="cpu")
    want = jax_configs.build(name, "smoke")
    for attr in ("supports_wire", "supports_views"):
        assert got.native_batches.supports_wire == bool(getattr(want.native_batches, attr, False)), attr
    for attr in ("qscale", "qoff"):
        assert getattr(got.native_batches, attr) == getattr(want.native_batches, attr, None), attr
    _eq_batches(got.native_batches(2, 3, 1), list(want.native_batches(2, 3, 1)))
    if getattr(want.native_batches, "supports_wire", False):
        want_u8 = list(want.native_batches(2, 3, 1, wire="u8"))
        _eq_batches(got.native_batches(2, 3, 1, wire="u8"), want_u8)
        _eq_batches(_views(got.native_batches(2, 3, 1, wire="u8", views=True, prefetch=3)), want_u8)


CHILD = ("import sys; from pathlib import Path; import consensusml_tpu_torch.native as n; "
         "n.BUILD_DIR = Path(sys.argv[1]); print(n.lib_path() if n.available() else n.load_error())")


def test_library_is_built_once_under_a_lock(tmp_path):
    """Processes that start together against an empty build directory all
    load the one library the first of them built."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root)}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path / "native")], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=90) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = [out.strip() for out, _err in outs]
    assert len(set(paths)) == 1 and paths[0].startswith(str(tmp_path)), paths
    assert [f.name for f in (tmp_path / "native").iterdir() if f.suffix == ".so"] == [Path(paths[0]).name]
    assert native.lib_path().name.startswith("libcml_native-")
