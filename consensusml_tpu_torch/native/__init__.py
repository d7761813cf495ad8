"""ctypes bindings for the repo's native C++ runtime (port of
``consensusml_tpu/native/__init__.py``): the threaded prefetch ring behind
``--native-loader`` and the host codecs.

The library is the repo's own C++ (``native/src/loader.cc``, ``kernels.cc``,
``rng.h``; C API ``loader.cc:311-384``), built with ``g++`` at first use
into ``consensusml_tpu_torch/build/native/`` under a name that hashes the
sources and flags, so an edited source rebuilds. The build and the
``dlopen`` hold an ``fcntl`` lock on that directory: processes that start
together (test workers, the collective backend's ranks) build it once and
never load a half-written file. A build or load failure is kept:
:func:`available` returns False and every entry point raises
``RuntimeError("native library unavailable: ...")`` with the compiler's
output; nothing falls back to Python.

:class:`NativeLoader` is the ring: one acquired slot is one round batch of
``samples_per_slot`` samples, its bytes a pure function of ``(seed,
slot sequence number)`` whatever the thread count, depth or timing.
:meth:`NativeLoader.next` copies a slot out; :meth:`NativeLoader.
acquire_view` / :meth:`NativeLoader.release_slot` hand out the slot's own
memory, which the device prefetcher (``data/prefetch.py``) copies to the
card in place and releases once that copy has completed. The slots are
pageable memory allocated by the C++ ring: in a process that holds a CUDA
context, the first ``acquire_view`` page-locks every slot at once
(``cudaHostRegister``), so a copy is a DMA from the slot itself, and
``close()`` unlocks them before the ring frees them.

Telemetry, the reference's families: ``consensusml_native_batches_total``,
``consensusml_native_reuse_hits_total``, ``consensusml_native_queue_depth``.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import mmap
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from consensusml_tpu_torch.obs import get_registry

__all__ = [
    "available",
    "load_error",
    "lib_path",
    "quantize_int8_chunks",
    "dequantize_int8_chunks",
    "topk",
    "topk_chunks",
    "NativeLoader",
]

_BATCHES = get_registry().counter(
    "consensusml_native_batches_total",
    "round batches handed out by the native prefetch ring",
)
_REUSE_HITS = get_registry().counter(
    "consensusml_native_reuse_hits_total",
    "staging-buffer reuses: next(out=...) caller-buffer fills plus "
    "zero-copy slot releases (release_slot)",
)
_QUEUE_DEPTH = get_registry().gauge(
    "consensusml_native_queue_depth",
    "slots the producer ring is ahead of the consumer (sampled at next())",
)

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG.parent / "native" / "src"
BUILD_DIR = _PKG / "build" / "native"
SOURCES = ("loader.cc", "kernels.cc")
HEADERS = ("rng.h",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed: str | None = None

_CUDA_HOST_REGISTER_PORTABLE = 1

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def lib_path() -> Path:
    """The library's path: sources, headers and flags hashed into its name."""
    blob = b"".join((SRC_DIR / n).read_bytes() for n in SOURCES + HEADERS)
    digest = hashlib.sha256(blob + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libcml_native-{digest[:12]}.so"


def _build(lib: Path) -> None:
    # a private name, then a rename: nothing ever opens a partial file
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / n) for n in SOURCES)],
        check=True, capture_output=True, text=True, timeout=300,
    )
    os.replace(tmp, lib)


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed is not None:
            return _lib
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib_file = lib_path()
            with open(BUILD_DIR / ".lock", "w") as lock:
                # across processes: one builds, the others wait and load it
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not lib_file.exists():
                    _build(lib_file)
                lib = ctypes.CDLL(str(lib_file))
            _declare(lib)
        except (OSError, subprocess.SubprocessError, AttributeError) as e:
            detail = getattr(e, "stderr", None)
            _load_failed = f"{type(e).__name__}: {e}" + (
                f"\n--- build stderr ---\n{detail}" if detail else ""
            )
            return None
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    """Bind argtypes; raises AttributeError if any symbol is missing."""
    lib.cml_quant_int8.argtypes = [_f32p, ctypes.c_int64, ctypes.c_int64, _i8p, _f32p]
    lib.cml_dequant_int8.argtypes = [_i8p, _f32p, ctypes.c_int64, ctypes.c_int64, _f32p]
    lib.cml_topk.argtypes = [_f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _i32p]
    lib.cml_topk_chunks.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f32p, _i32p,
    ]
    lib.cml_loader_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, _f32p, _i32p, ctypes.c_uint64,
        ctypes.c_int32, ctypes.c_float, ctypes.c_float,
    ]
    lib.cml_loader_create.restype = ctypes.c_void_p
    lib.cml_loader_create_file.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        _f32p, _i32p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_uint64, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
    ]
    lib.cml_loader_create_file.restype = ctypes.c_void_p
    lib.cml_loader_acquire.argtypes = [ctypes.c_void_p, ctypes.POINTER(_f32p), ctypes.POINTER(_i32p)]
    lib.cml_loader_acquire.restype = ctypes.c_int
    lib.cml_loader_acquire_u8.argtypes = [ctypes.c_void_p, ctypes.POINTER(_u8p), ctypes.POINTER(_i32p)]
    lib.cml_loader_acquire_u8.restype = ctypes.c_int
    lib.cml_loader_float_bytes.argtypes = [ctypes.c_void_p]
    lib.cml_loader_float_bytes.restype = ctypes.c_int32
    lib.cml_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cml_loader_produced.argtypes = [ctypes.c_void_p]
    lib.cml_loader_produced.restype = ctypes.c_uint64
    lib.cml_loader_destroy.argtypes = [ctypes.c_void_p]


def available() -> bool:
    """True if the native library is loadable (builds it if needed)."""
    return _load() is not None


def load_error() -> str | None:
    """Why the library could not be built or loaded (None: it could)."""
    _load()
    return _load_failed


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_failed}")
    return lib


def _as_f32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float32)


def quantize_int8_chunks(chunks) -> tuple[np.ndarray, np.ndarray]:
    """Quantize ``(nchunks, chunk)`` f32 rows -> (int8 rows, f32 scales):
    the per-chunk int8 codec's math on the host."""
    lib = _lib_or_raise()
    chunks = _as_f32(chunks)
    nchunks, chunk = chunks.shape
    q = np.empty((nchunks, chunk), np.int8)
    scales = np.empty((nchunks,), np.float32)
    lib.cml_quant_int8(chunks.ctypes.data_as(_f32p), nchunks, chunk, q.ctypes.data_as(_i8p),
                       scales.ctypes.data_as(_f32p))
    return q, scales


def dequantize_int8_chunks(q, scales) -> np.ndarray:
    lib = _lib_or_raise()
    q = np.ascontiguousarray(q, dtype=np.int8)
    scales = _as_f32(scales)
    nchunks, chunk = q.shape
    out = np.empty((nchunks, chunk), np.float32)
    lib.cml_dequant_int8(q.ctypes.data_as(_i8p), scales.ctypes.data_as(_f32p), nchunks, chunk,
                         out.ctypes.data_as(_f32p))
    return out


def topk(x, k: int) -> tuple[np.ndarray, np.ndarray]:
    """k largest by magnitude: (values, indices), largest first, ties to
    the lower index."""
    lib = _lib_or_raise()
    x = _as_f32(x).reshape(-1)
    k = min(k, x.size)
    vals = np.empty((k,), np.float32)
    idx = np.empty((k,), np.int32)
    lib.cml_topk(x.ctypes.data_as(_f32p), x.size, k, vals.ctypes.data_as(_f32p), idx.ctypes.data_as(_i32p))
    return vals, idx


def topk_chunks(chunks, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k over ``(nchunks, chunk)``: (values, local indices)."""
    lib = _lib_or_raise()
    chunks = _as_f32(chunks)
    nchunks, chunk = chunks.shape
    k = min(k, chunk)
    vals = np.empty((nchunks, k), np.float32)
    idx = np.empty((nchunks, k), np.int32)
    lib.cml_topk_chunks(chunks.ctypes.data_as(_f32p), nchunks, chunk, k, vals.ctypes.data_as(_f32p),
                        idx.ctypes.data_as(_i32p))
    return vals, idx


_KINDS = {"classification": 0, "lm": 1, "file_classification": 2, "file_lm": 3}


def page_runs(spans, page: int) -> list[tuple[int, int]]:
    """The pages under byte ``spans`` (``(address, nbytes)``, nbytes > 0)
    as sorted, disjoint ``(first, last)`` page runs: spans that share a
    page fall in one run, so every span lies inside a single run."""
    runs: list[list[int]] = []
    for first, last in sorted((a // page, (a + n - 1) // page) for a, n in spans):
        if runs and first <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], last)
        else:
            runs.append([first, last])
    return [(lo, hi) for lo, hi in runs]


class NativeLoader:
    """The threaded prefetch ring (the reference's ``NativeLoader``, its
    arguments, errors and slot layout).

    ``kind``: ``"classification"`` (prototypes + noise), ``"lm"`` (a
    Markov chain over ``successors``), ``"file_classification"`` (gathers
    from ``images``/``labels``, contiguous worker shards) or ``"file_lm"``
    (token windows of ``tokens``, uint16 read in place). ``wire="u8"``
    ships ``clip((x + qoff) * qscale)`` bytes, which the consumer dequants
    on the device as ``u8 / qscale - qoff``.

    The handle and the consumed count move under a lock: the device
    prefetcher's background thread releases slots while the consumer
    acquires and teardown closes; the blocking C++ acquire runs outside
    it, and ``close()`` wakes a blocked consumer with ``loader stopped``.
    """

    def __init__(self, *, kind: str, samples_per_slot: int, sample_floats: int, sample_ints: int,
                 nclasses_or_vocab: int = 1, noise: float = 0.0, prototypes: np.ndarray | None = None,
                 successors: np.ndarray | None = None, world: int = 1, images: np.ndarray | None = None,
                 labels: np.ndarray | None = None, tokens: np.ndarray | None = None, depth: int = 4,
                 nthreads: int = 2, seed: int = 0, start_seq: int = 0, wire: str = "f32",
                 qscale: float = 32.0, qoff: float = 4.0):
        # first: __del__ -> close() must find the lock even when __init__ raises
        self._lock = threading.Lock()
        self._consumed = 0
        self._depth = depth
        self._held: collections.deque = collections.deque()  # slots acquired to lock, not yet handed out
        self._locked_runs: list[int] | None = None  # cudaHostRegister'd addresses once decided, unlocked by close()
        lib = _lib_or_raise()
        if wire not in ("f32", "u8"):
            raise ValueError(f"unknown wire {wire!r}")
        self._lib = lib
        self._wire = wire
        self.qscale, self.qoff = float(qscale), float(qoff)
        self._shape_f = (samples_per_slot, sample_floats)
        self._shape_i = (samples_per_slot, sample_ints)
        fb = 1 if wire == "u8" else 4
        if kind not in _KINDS:
            raise ValueError(f"unknown kind {kind!r}")
        if kind in ("file_classification", "file_lm"):
            data_p = label_p = tok_p = None
            token_bytes = 4
            if kind == "file_classification":
                if images is None or labels is None:
                    raise ValueError(f"{kind} requires images= and labels=")
                # held on self: the C++ side borrows these pointers
                self._images = _as_f32(images).reshape(len(labels), sample_floats)
                self._labels = np.ascontiguousarray(labels, np.int32)
                data_p = self._images.ctypes.data_as(_f32p)
                label_p = self._labels.ctypes.data_as(_i32p)
                n_items = len(self._labels)
            else:
                if tokens is None:
                    raise ValueError(f"{kind} requires tokens=")
                tok = np.asarray(tokens).reshape(-1)
                if tok.dtype == np.uint16:
                    # the C++ side widens a window at a time: no copy of the corpus
                    self._tokens = np.ascontiguousarray(tok)
                    token_bytes = 2
                else:
                    self._tokens = np.ascontiguousarray(tok, np.int32)
                tok_p = self._tokens.ctypes.data_as(ctypes.c_void_p)
                n_items = len(self._tokens)
            self._h = lib.cml_loader_create_file(
                depth, nthreads, seed, _KINDS[kind], samples_per_slot, sample_floats, sample_ints, world,
                data_p, label_p, tok_p, n_items, token_bytes, start_seq, fb, self.qscale, self.qoff,
            )
            if not self._h:
                raise RuntimeError(
                    "cml_loader_create_file failed (check world divides samples_per_slot, and the table "
                    f"is large enough for {world} workers: n_items={n_items})"
                )
            self._check_wire(self._h, fb)
            return
        proto_p = succ_p = None
        if prototypes is not None:
            self._proto = _as_f32(prototypes).reshape(nclasses_or_vocab, sample_floats)
            proto_p = self._proto.ctypes.data_as(_f32p)
        if successors is not None:
            self._succ = np.ascontiguousarray(successors, np.int32).reshape(nclasses_or_vocab, 4)
            succ_p = self._succ.ctypes.data_as(_i32p)
        if kind == "lm" and succ_p is None:
            raise ValueError("lm kind requires a successors table")
        self._h = lib.cml_loader_create(
            depth, nthreads, seed, _KINDS[kind], samples_per_slot, sample_floats, sample_ints,
            nclasses_or_vocab, noise, proto_p, succ_p, start_seq, fb, self.qscale, self.qoff,
        )
        if not self._h:
            raise RuntimeError("cml_loader_create failed (bad arguments)")
        self._check_wire(self._h, fb)

    def _check_wire(self, h, fb: int) -> None:
        got = int(self._lib.cml_loader_float_bytes(h))
        if got != fb:
            raise RuntimeError(f"native loader wire mismatch: library reports float_bytes={got}, wrapper "
                               f"expected {fb} — rebuild {BUILD_DIR}")

    def _handle(self):
        with self._lock:
            h = getattr(self, "_h", None)
        if not h:
            raise RuntimeError("loader closed")
        return h

    def _count_consumed(self) -> int:
        with self._lock:
            self._consumed += 1
            return self._consumed

    def _acquire(self):
        h = self._handle()
        data_p = _u8p() if self._wire == "u8" else _f32p()
        iptr = _i32p()
        acquire = self._lib.cml_loader_acquire_u8 if self._wire == "u8" else self._lib.cml_loader_acquire
        idx = acquire(h, ctypes.byref(data_p), ctypes.byref(iptr))
        if idx < 0:
            raise RuntimeError("loader stopped")
        return h, idx, data_p, iptr

    def _wire_dtype(self):
        return np.uint8 if self._wire == "u8" else np.float32

    def next(self, out=None) -> tuple[np.ndarray, np.ndarray]:
        """Blocking: the next slot's (floats-or-u8, ints) arrays, copied
        out (into ``out``, a ``(data, ints)`` pair of ndarrays of exactly
        the slot's layout, when given)."""
        wire_dtype = self._wire_dtype()
        if out is not None:
            if not isinstance(out, (tuple, list)) or len(out) != 2:
                raise ValueError(
                    "next(out=...) takes a (data, ints) pair of ndarrays, got "
                    f"{type(out).__name__} of length {len(out) if isinstance(out, (tuple, list)) else 'n/a'}"
                )
            for name, arr, shape, dtype in (("data", out[0], self._shape_f, wire_dtype),
                                            ("ints", out[1], self._shape_i, np.int32)):
                if not isinstance(arr, np.ndarray):
                    raise ValueError(f"next(out=...) {name} buffer must be a numpy ndarray, got "
                                     f"{type(arr).__name__}")
                if tuple(arr.shape) != shape or arr.dtype != np.dtype(dtype):
                    raise ValueError(
                        f"next(out=...) {name} buffer mismatch: expected shape {shape} dtype "
                        f"{np.dtype(dtype).name}, got shape {tuple(arr.shape)} dtype {arr.dtype.name}"
                    )
        h, idx, data_p, iptr = self._acquire()

        def _copy(ptr, shape, dt, dst):
            if 0 in shape:  # an empty buffer's data() may be NULL
                return np.empty(shape, dt)
            src = np.ctypeslib.as_array(ptr, shape=shape)
            if dst is not None:
                np.copyto(dst, src)
                return dst
            return src.copy()

        try:
            data = _copy(data_p, self._shape_f, wire_dtype, out and out[0])
            ints = _copy(iptr, self._shape_i, np.int32, out and out[1])
        finally:
            self._lib.cml_loader_release(h, idx)
        consumed = self._count_consumed()
        _BATCHES.inc()
        if out is not None:
            _REUSE_HITS.inc()
        _QUEUE_DEPTH.set(max(0, self.produced() - consumed))
        return data, ints

    def acquire_view(self) -> tuple[int, np.ndarray, np.ndarray]:
        """Zero-copy consume: ``(slot_idx, data_view, ints_view)``, read-only
        views of the slot's own memory, valid until :meth:`release_slot`
        of that index. Every acquired slot must be released, or the ring
        stalls once all ``depth`` slots are held."""
        if self._locked_runs is None:
            import torch

            self._locked_runs = []
            if torch.cuda.is_initialized():
                # every slot, once: the ring hands each out in turn, and they go out in that order
                self._held.extend(self._view_slot() for _ in range(self._depth))
                self._page_lock([v for _idx, data, ints in self._held for v in (data, ints)])
        idx, data, ints = self._held.popleft() if self._held else self._view_slot()
        consumed = self._count_consumed()
        _BATCHES.inc()
        _QUEUE_DEPTH.set(max(0, self.produced() - consumed))
        return idx, data, ints

    def _view_slot(self) -> tuple[int, np.ndarray, np.ndarray]:
        _h, idx, data_p, iptr = self._acquire()

        def _view(ptr, shape, dt):
            if 0 in shape:
                return np.empty(shape, dt)
            arr = np.ctypeslib.as_array(ptr, shape=shape)
            arr.flags.writeable = False
            return arr

        return idx, _view(data_p, self._shape_f, self._wire_dtype()), _view(iptr, self._shape_i, np.int32)

    def _page_lock(self, views: list) -> None:
        """Page-lock the pages under ``views`` (every slot's buffers). A copy
        from registered memory must lie inside one registration, and two
        buffers may share a page, so overlapping page spans are merged and
        each merged run is registered once."""
        import torch

        cudart = torch.cuda.cudart()
        page = mmap.PAGESIZE
        with self._lock:
            if not self._h:
                return  # closed: the ring's memory is gone
            for lo, hi in page_runs([(v.ctypes.data, v.nbytes) for v in views if v.nbytes], page):
                code = int(cudart.cudaHostRegister(lo * page, (hi - lo + 1) * page, _CUDA_HOST_REGISTER_PORTABLE))
                if code != 0:
                    raise torch.cuda.CudaError(code)
                self._locked_runs.append(lo * page)

    def release_slot(self, idx: int) -> None:
        """Hand slot ``idx`` back to the producers; a no-op after
        :meth:`close` (the release runs under the handle's lock, so it
        never races the ring's destruction)."""
        with self._lock:
            if not self._h:
                return
            self._lib.cml_loader_release(self._h, idx)
        _REUSE_HITS.inc()

    def produced(self) -> int:
        return int(self._lib.cml_loader_produced(self._handle()))

    def close(self) -> None:
        with self._lock:
            h = getattr(self, "_h", None)
            self._h = None
            runs, self._locked_runs = getattr(self, "_locked_runs", None) or [], []
        try:
            if runs:
                import torch

                # no copy reads a slot now: the prefetcher has released them all
                for addr in runs:
                    code = int(torch.cuda.cudart().cudaHostUnregister(addr))
                    if code != 0:
                        raise torch.cuda.CudaError(code)
        finally:
            if h:
                # outside the lock: destroy joins the producers and wakes consumers
                self._lib.cml_loader_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
