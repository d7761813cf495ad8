"""Fused BatchNorm(+ReLU) for training: CUDA kernels + plain versions
(port of ``consensusml_tpu/models/fused_bn.py``).

Three kernels in ``csrc/fused_bn.cu``, each over a contiguous ``(M, C)``
view (channels last) of f32 or bf16 input, all arithmetic in f32:

- :func:`bn_forward_stats`: per-channel f32 ``sum x`` and ``sum x**2``,
  folded in the same launch into the forward's per-channel vectors
  (``mean``, ``var``, ``scale``, ``shift``, ``rsqrt``); :func:`bn_stats`
  returns that launch's two sums;
- :func:`bn_norm`: ``y = x * scale + shift`` (then ``max(y, 0)`` with
  relu), ``y`` in x's dtype;
- :func:`bn_bwd`: the whole backward in one launch: ``g = dy`` (zeroed
  where ``x * scale + shift <= 0`` with relu), ``xhat = (x - mean) *
  rsqrt``, ``db = sum g``, ``dg = sum g * xhat``, ``c1 = db / M``, ``c2 =
  dg / M`` (products with ``f32(1/M)``, as the compiled reference),
  ``dx = scale * ((g - c1) - xhat * c2)`` in x's dtype. Its plain
  version is :func:`bn_bwd_reduce_plain` then :func:`bn_bwd_dx_plain`,
  the reference's two kernel bodies, with the division between them.

Each wrapper runs its plain version (``*_plain``, beside it) for a CPU
tensor and launches its kernel for a CUDA tensor, raising on what the
kernel does not take (a non-contiguous view is refused, not copied); it
never falls back. Each launch adds one to the wrapper's ``launches``. Under a
``workcount`` counter each wrapper reports its function's work from its
shapes (``workcount.counted``) and runs with counting suspended; a fake
tensor (the counting pass's) takes the plain route, on ``meta`` copies.

Forward and backward (kernels, plain versions and the plain per-channel
ops between them) flush f32 subnormals as the reference's compiled
program does: a subnormal operand of its arithmetic counts as a zero of
its sign and a subnormal result is written as one
(``tests/test_torch_fused_bn.py`` pins both against the jitted
reference).

:func:`fused_batch_norm` is the reference's ``custom_vjp`` as a
``torch.autograd.Function``: forward = stats, then the "fast variance"
``var = max(sq/m - mean**2, 0)`` (not Welford's) and the folded
``scale``/``shift`` in f32 (:func:`bn_forward_stats`: on the card in the
statistics' fold, so no plain op runs between the two kernels; its plain
version is :func:`batch_moments` and :func:`fold_params`), then the
normalize pass; backward =
one :func:`bn_bwd` call. The statistics' cotangents are dropped, and
``mean``/``var`` come back detached (the mutable-state convention).

``impl``: ``"auto"``, ``"pallas"`` and ``"interpret"`` all run the
wrappers (the kernels on the card, the plain versions on the CPU);
``"jnp"`` names the plain versions on any device (the reference's jnp
path, the parity oracle; ``chip_smoke.py`` runs it on the card beside
the kernels). ``pack_small`` is accepted and does nothing: packing rows
of a narrow C into the TPU's 128 lanes is a TPU layout device, and the
CUDA kernels read any C in 16-byte vectors (or one element a thread when
C is not a multiple of the vector width).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch import nn

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.numerics import ftz, inv_rows
from consensusml_tpu_torch.workcount import counted, on_card

__all__ = [
    "IMPLS",
    "fused_batch_norm",
    "FusedBatchNorm",
    "fold_params",
    "bn_stats",
    "bn_stats_plain",
    "bn_forward_stats",
    "bn_forward_stats_plain",
    "bn_norm",
    "bn_norm_plain",
    "bn_bwd",
    "bn_bwd_plain",
    "bn_bwd_reduce_plain",
    "bn_bwd_dx_plain",
    "inv_rows",
    "batch_moments",
    "BwdPlan",
    "bn_bwd_plan",
    "StatsPlan",
    "bn_stats_plan",
]

IMPLS = ("auto", "pallas", "jnp", "interpret")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
_THREADS = 256
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic in PyTorch ops, f32)
# ---------------------------------------------------------------------------


def bn_stats_plain(x2: torch.Tensor):
    """``(sum x, sum x**2)`` per channel of ``(M, C)`` ``x2``, in f32, each
    operand, product and sum flushed as the reference's compiled program
    does."""
    xf = ftz(x2.float())
    return ftz(xf.sum(0)), ftz(ftz(xf * xf).sum(0))


def bn_norm_plain(x2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """``x * scale + shift`` (each product and sum rounded, and flushed, on
    its own), then relu; in x's dtype."""
    y = ftz(ftz(ftz(x2.float()) * ftz(scale)) + ftz(shift))
    if relu:
        y = torch.relu(y)
    return y.to(x2.dtype)


def _bwd_operands(dy2, x2, scale, shift, mean, rsqrt, relu: bool):
    """``(g, xhat, scale)`` of the backward, each operation's operands and
    result flushed as the reference's compiled program does (the kernel's
    ``.ftz`` instructions)."""
    x = ftz(x2.float())
    g = ftz(dy2.float())
    scale, shift, mean, rsqrt = (ftz(v) for v in (scale, shift, mean, rsqrt))
    if relu:
        g = torch.where(ftz(ftz(x * scale) + shift) > 0, g, 0.0)
    xhat = ftz(ftz(x - mean) * rsqrt)
    return g, xhat, scale


def bn_bwd_reduce_plain(dy2, x2, scale, shift, mean, rsqrt, relu: bool):
    """``(dbeta, dgamma) = (sum g, sum g * xhat)`` per channel, in f32 (the
    reference's ``_bwd_reduce_kernel``)."""
    g, xhat, _ = _bwd_operands(dy2, x2, scale, shift, mean, rsqrt, relu)
    return ftz(g.sum(0)), ftz(ftz(g * xhat).sum(0))


def bn_bwd_dx_plain(dy2, x2, scale, shift, mean, rsqrt, c1, c2, relu: bool) -> torch.Tensor:
    """``dx = scale * ((g - c1) - xhat * c2)``, in x's dtype (the
    reference's ``_bwd_dx_kernel``)."""
    g, xhat, scale = _bwd_operands(dy2, x2, scale, shift, mean, rsqrt, relu)
    c1, c2 = ftz(c1), ftz(c2)
    return ftz(scale * ftz(ftz(g - c1) - ftz(xhat * c2))).to(x2.dtype)


def bn_bwd_plain(dy2, x2, scale, shift, mean, rsqrt, relu: bool):
    """``(dx, dbeta, dgamma)``: the reference's ``_bn_train_bwd`` in plain
    ops, :func:`bn_bwd_reduce_plain` then :func:`bn_bwd_dx_plain` with
    ``c1 = dbeta / M`` and ``c2 = dgamma / M`` (products with
    :func:`inv_rows`, as the compiled reference computes them)."""
    inv = inv_rows(x2.shape[0])
    db, dg = bn_bwd_reduce_plain(dy2, x2, scale, shift, mean, rsqrt, relu)
    dx = bn_bwd_dx_plain(dy2, x2, scale, shift, mean, rsqrt, ftz(db * inv), ftz(dg * inv), relu)
    return dx, db, dg


# ---------------------------------------------------------------------------
# the backward's launch plan
# ---------------------------------------------------------------------------


class BwdPlan(NamedTuple):
    """How :func:`bn_bwd` cuts an ``(M, C)`` view (``csrc/fused_bn.cu``'s
    header): a cluster of ``cluster`` blocks per channel tile of ``tile``
    channels, ``rows`` rows a block, staged in chunks of ``chunk`` rows
    through ``nbuf`` buffers of dy and x (``onchip``: the whole stripe
    stays in shared memory, dy and x are read once; else a ring, and the
    chunks that left it are read again); ``smem`` bytes of dynamic shared
    memory a block. ``chunk`` and ``nbuf`` are 0 on the one-element path."""

    cluster: int
    tile: int
    rows: int
    chunk: int
    nbuf: int
    onchip: bool
    smem: int


_BWD_CLUSTERS = (8, 16)  # blocks of a cluster (16 is H100's non-portable size)
_BWD_MIN_ROWS = 128  # rows a block before a cluster takes more blocks
_BWD_FILL = 64  # blocks a launch should reach
_BWD_MAX_ROW_BYTES = 128  # a tile's row: 64 bf16 or 32 f32 channels
_BWD_ONCHIP_BYTES = 200 * 1024  # a block's staged stripe (one block an SM)
_BWD_STAGE_BYTES = 16 * 1024  # dy (or x) bytes of one chunk
_BWD_RING_BYTES = 96 * 1024  # a streaming block's ring
_BWD_MAX_BUFS = 64


def _align128(n: int) -> int:
    return -(-n // 128) * 128


@functools.lru_cache(maxsize=None)
def bn_bwd_plan(m: int, c: int, elem: int, vec: int, *, cluster: int | None = None,
                tile: int | None = None, onchip: bool | None = None) -> BwdPlan:
    """The plan of :func:`bn_bwd` for an ``(m, c)`` view of ``elem``-byte
    elements read ``vec`` to a thread (16 bytes, or 1 element).

    One cluster of 8 or 16 blocks per channel tile (fewer where M gives a
    block fewer than 128 rows). For each cluster size the tile is the
    widest power of two of 16-byte vectors, up to a 128-byte row, that
    still gives the launch >= 64 blocks; the wider of the two wins (8 on a
    tie: the card holds about 30 clusters of 8 at once, 14 of 16). Narrow
    tiles lose: at ResNet-50's views a 16-byte row read 2-7x slower than a
    128-byte one (consensusml_tpu_torch/tools/bn_bwd_sweep.py, PERF.md).
    The stripe stays in shared memory (the on-chip form: dy and x read
    once) where it fits in 200 KB, else it streams through a 96 KB ring.
    ``cluster``, ``tile`` and ``onchip`` pin those choices (the sweep)."""
    head = lambda tile, nbuf: _align128((2 * _THREADS * vec + 2 * tile) * 4 + 8 * nbuf)  # noqa: E731
    most = min(max(_BWD_CLUSTERS), max(1, -(-m // _BWD_MIN_ROWS)))
    sizes = [cluster] if cluster else sorted({min(s, most) for s in _BWD_CLUSTERS})

    def shape(s):  # (blocks of a cluster, rows a block): no block without rows
        rows = -(-m // s)
        return -(-m // rows), rows

    if vec == 1:
        s, rows = shape(sizes[-1])
        tile = tile or min(32, 1 << (c - 1).bit_length())
        return BwdPlan(s, tile, rows, 0, 0, False, head(tile, 0))
    widths = [vec << k for k in range(6) if (vec << k) * elem <= _BWD_MAX_ROW_BYTES and (vec << k) < 2 * c]
    if tile is None:
        best = None
        for s in sizes:
            fill = [t for t in widths if shape(s)[0] * -(-c // t) >= _BWD_FILL]
            t = fill[-1] if fill else widths[0]
            if best is None or t > best[1]:
                best = (s, t)
        s, tile = best
    else:
        s = sizes[-1]
    s, rows = shape(s)
    chunk = max(1, min(256, rows, _BWD_STAGE_BYTES // (tile * elem)))
    buf = _align128(chunk * tile * elem)
    n = -(-rows // chunk)
    fits = n <= _BWD_MAX_BUFS and 2 * n * buf <= _BWD_ONCHIP_BYTES
    if onchip is None:
        onchip = fits
    if onchip and not fits:
        raise ValueError(f"a ({rows}, {tile}) stripe of dy and x does not fit in {_BWD_ONCHIP_BYTES} bytes")
    nbuf = n if onchip else max(2, min(_BWD_MAX_BUFS, n, _BWD_RING_BYTES // (2 * buf)))
    return BwdPlan(s, tile, rows, chunk, nbuf, onchip, head(tile, nbuf) + 2 * nbuf * buf)


class StatsPlan(NamedTuple):
    """How :func:`bn_forward_stats` cuts an ``(M, C)`` view
    (``csrc/fused_bn.cu``'s header): ``splits`` clusters of ``cluster``
    blocks per channel tile of ``tile`` channels (with ``splits`` > 1 the
    last cluster of a tile to finish folds the clusters' sums in order),
    ``rows`` rows a block, streamed in
    chunks of ``chunk`` rows through a ring of ``nbuf`` buffers by TMA, or,
    with ``chunk`` and ``nbuf`` 0, read with 16-byte loads from device
    memory (and on the one-element path); ``smem`` bytes of dynamic shared
    memory a block."""

    cluster: int
    splits: int
    tile: int
    rows: int
    chunk: int
    nbuf: int
    smem: int


_STATS_STAGE_BYTES = 16 * 1024  # x bytes of one TMA chunk
_STATS_RING_BYTES = 32 * 1024  # a staging block's ring: two chunks
_STATS_BIG_CLUSTER_ROWS = 32768  # from this M on, clusters of 16 blocks
_STATS_SPLIT_ROWS = 4096  # rows a block from which a tile takes several clusters
_STATS_FILL = 128  # blocks the splits aim for
_STATS_MAX_SPLITS = 4


@functools.lru_cache(maxsize=None)
def bn_stats_plan(m: int, c: int, elem: int, vec: int, *, cluster: int | None = None, splits: int | None = None,
                  tile: int | None = None, ring: int | None = None, staged: bool | None = None) -> StatsPlan:
    """The plan of the statistics' one launch for an ``(m, c)`` view of
    ``elem``-byte elements read ``vec`` to a thread (16 bytes, or 1
    element). From the sweep at ResNet-50's eleven BN views on the H100
    (``tools/norm_sweep.py``, PERF.md), where a plan that fills the card
    with wide tiles and deep rings did not win:

    - one cluster of 16 blocks per channel tile from M = 32768 on, of 8
      below (never a block under 128 rows);
    - M <= 2048 (a block's stripe is one chunk or less): 16-byte loads,
      128-byte rows;
    - otherwise TMA chunks of 16 KB of 64-byte rows through a ring of two
      (32 KB: deeper rings and wider rows read slower), and where a block
      would still walk 4096 rows or more, up to 4 clusters a tile (the
      last to finish folds them), toward 128 blocks;
    - with neither (C <= 64 and M < 65536): 16-byte loads, one vector of
      channels a tile.

    ``cluster``, ``splits``, ``tile``, ``ring`` and ``staged`` pin those
    choices (the sweep)."""
    head = lambda nbuf: _align128(2 * _THREADS * vec * 4 + 8 * nbuf)  # noqa: E731
    most = min(max(_BWD_CLUSTERS), max(1, -(-m // _BWD_MIN_ROWS)))
    s = min(cluster or (16 if m >= _STATS_BIG_CLUSTER_ROWS else 8), most)
    short = m <= 2048
    if tile is None and vec > 1:
        rows_bytes = 128 if short else 64
        widths = [vec << k for k in range(6) if (vec << k) * elem <= rows_bytes and (vec << k) < 2 * c]
        tile = widths[-1]
    if splits is None:
        tiles = -(-c // tile) if vec > 1 else 1
        splits = 1
        if vec > 1 and not short and m // s >= _STATS_SPLIT_ROWS:
            splits = max(1, min(_STATS_MAX_SPLITS, _STATS_FILL // (s * tiles)))
    k = max(1, min(splits, m // (s * _BWD_MIN_ROWS)))
    rows = -(-m // (s * k))
    while -(-m // rows) < s * k:  # no block without rows
        if k > 1:
            k -= 1
        else:
            s = -(-m // rows)
        rows = -(-m // (s * k))
    if vec == 1:
        return StatsPlan(s, k, tile or min(32, 1 << (c - 1).bit_length()), rows, 0, 0, head(0))
    narrow = c * elem <= 128 and k == 1
    if staged is None:
        staged = not (short or narrow)
    if narrow and not staged and tile * elem > 16 and cluster is None:
        tile = vec
    if not staged:
        return StatsPlan(s, k, tile, rows, 0, 0, head(0))
    chunk = max(1, min(256, rows, _STATS_STAGE_BYTES // (tile * elem)))
    buf = _align128(chunk * tile * elem)
    nbuf = max(1, min(_BWD_MAX_BUFS, -(-rows // chunk), (ring or _STATS_RING_BYTES) // buf))
    return StatsPlan(s, k, tile, rows, chunk, nbuf, head(nbuf) + nbuf * buf)


_STATS_TICKETS: dict[torch.device, torch.Tensor] = {}


def _stats_tickets(device: torch.device, tiles: int) -> torch.Tensor:
    """The statistics' uint32 tickets on ``device``, one a channel tile:
    zero before a launch, and left zero by it (launches on one stream run
    one at a time)."""
    t = _STATS_TICKETS.get(device)
    if t is None or t.numel() < tiles:
        t = _STATS_TICKETS[device] = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
    return t


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_view(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    if t.dim() != 2 or t.dtype not in _DTYPE_CODE or not t.is_contiguous() or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(
            f"{name} must be a contiguous (M, C) f32 or bf16 tensor with M, C >= 1 (the kernels read a "
            f"view and never copy one), got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if t.shape[1] >= 2**31:
        raise ValueError(f"{name}: C = {t.shape[1]} does not fit the kernels' int")
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype or t.device != like.device):
        raise ValueError(
            f"{name} must match x: {like.dtype} {tuple(like.shape)} on {like.device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _check_vectors(x2: torch.Tensor, **vecs: torch.Tensor) -> None:
    c = x2.shape[1]
    for name, v in vecs.items():
        if v.dtype != torch.float32 or tuple(v.shape) != (c,) or not v.is_contiguous() or v.device != x2.device:
            raise ValueError(
                f"{name} must be a contiguous ({c},) f32 tensor on {x2.device}, got "
                f"{v.dtype} {tuple(v.shape)} on {v.device}"
            )


def _vec(x2: torch.Tensor, *tensors: torch.Tensor) -> int:
    """The kernels' vector width: 16 bytes of x's dtype when C is a multiple
    of it and every operand is 16-byte aligned, else one element."""
    width = _VEC[x2.dtype]
    if x2.shape[1] % width or any(t.data_ptr() % 16 for t in (x2, *tensors)):
        return 1
    return width


def _bind(symbol: str, argtypes: list):
    fn = getattr(kernels.load("fused_bn"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _launched(wrapper, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error {rc}")
    wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _stats_launch(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
                  plan: StatsPlan | None = None) -> torch.Tensor:
    """The statistics' one launch of ``csrc/fused_bn.cu`` (``plan``, by
    default :func:`bn_stats_plan`'s): a ``(7, C)`` f32 tensor of ``(sum x,
    sum x**2, mean, var, scale, shift, rsqrt)``. Adds one to
    ``bn_stats.launches``."""
    _check_view("x", x2)
    _check_vectors(x2, gamma=gamma, beta=beta)
    m, c = x2.shape
    vec = _vec(x2)
    p = plan or bn_stats_plan(m, c, x2.element_size(), vec)
    out = torch.empty((7, c), dtype=torch.float32, device=x2.device)
    partials = tickets = None
    if p.splits > 1:
        partials = torch.empty((p.splits, 2, c), dtype=torch.float32, device=x2.device)
        tickets = _stats_tickets(x2.device, -(-c // p.tile))
    rc = _bind("cml_bn_stats", [_P, _I, _LL, _I, _I, _I, _I, _I, _LL, _I, _I, _P, _P, ctypes.c_float, _P, _P, _P,
                                _P])(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, vec, p.cluster, p.splits, p.tile, p.rows, p.chunk, p.nbuf,
        gamma.data_ptr(), beta.data_ptr(), float(eps), partials.data_ptr() if partials is not None else None,
        tickets.data_ptr() if tickets is not None else None, out.data_ptr(), _stream(x2),
    )
    _launched(bn_stats, rc)
    return out



def _stats_work(x2, *_args):
    """The statistics kernel: 3 operations an element; reads x, writes two
    f32 per-channel vectors (the figures its bound prices)."""
    n, c = x2.numel(), x2.shape[1]
    return 3.0 * n, float(x2.element_size() * n + 8 * c)


def _norm_work(x2, scale, shift, relu):
    """3 operations an element; reads x and two f32 vectors, writes y."""
    n, c = x2.numel(), x2.shape[1]
    return 3.0 * n, float(2 * x2.element_size() * n + 8 * c)


def _bwd_work(dy2, x2, *_args, plan=None):
    """11 operations an element (the mask, xhat, the two sums, dx); reads
    dy and x, writes dx, reads four f32 vectors and writes two."""
    n, c = x2.numel(), x2.shape[1]
    return 11.0 * n, float((dy2.element_size() + 2 * x2.element_size()) * n + 24 * c)


@counted(_stats_work)
def bn_stats(x2: torch.Tensor):
    """``(sum x, sum x**2)`` per channel of ``(M, C)`` ``x2`` (f32 or bf16),
    f32: for a CUDA tensor the sums of the forward's statistics launch
    (:func:`bn_forward_stats`'s, with gamma 1 and beta 0), for a CPU one
    :func:`bn_stats_plain`. Each launch adds one to ``bn_stats.launches``."""
    if not on_card(x2):
        return bn_stats_plain(x2)
    c = x2.shape[1]
    ones = torch.ones(c, dtype=torch.float32, device=x2.device)
    out = _stats_launch(x2, ones, torch.zeros_like(ones), 1e-5)
    return out[0], out[1]


def bn_forward_stats_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """``(mean, var, scale, shift, rsqrt)`` of the forward: the plain
    statistics, :func:`batch_moments` and :func:`fold_params`."""
    mean, var = batch_moments(*bn_stats_plain(x2), x2.shape[0])
    scale, shift, rsqrt = fold_params(gamma, beta, mean, var, eps)
    return mean, var, scale, shift, rsqrt


@counted(_stats_work, name="bn_stats")
def bn_forward_stats(x2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """``(mean, var, scale, shift, rsqrt)`` of the forward, each ``(C,)``
    f32: for a CUDA tensor one launch of the statistics kernel whose fold
    computes them from the sums (flushed as :func:`bn_forward_stats_plain`
    computes them; ``csrc/fused_bn.cu``: ``FoldParams``), so the forward
    runs no plain op between its two kernels; for a CPU tensor
    :func:`bn_forward_stats_plain`. Adds one to ``bn_stats.launches``."""
    gamma, beta = gamma.float(), beta.float()
    if not on_card(x2):
        return bn_forward_stats_plain(x2, gamma, beta, eps)
    return tuple(_stats_launch(x2, gamma, beta, eps)[2:])


@counted(_norm_work)
def bn_norm(x2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """``x * scale + shift`` (then relu) in x's dtype: ``csrc/fused_bn.cu``
    for a CUDA tensor, :func:`bn_norm_plain` for a CPU one. ``scale`` and
    ``shift`` are contiguous ``(C,)`` f32. Each launch adds one to
    ``bn_norm.launches``."""
    if not on_card(x2):
        return bn_norm_plain(x2, scale, shift, relu)
    _check_view("x", x2)
    _check_vectors(x2, scale=scale, shift=shift)
    m, c = x2.shape
    y = torch.empty_like(x2)
    rc = _bind("cml_bn_norm", [_P, _I, _LL, _I, _I, _P, _P, _I, _P, _P])(
        x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, _vec(x2, y, scale, shift), scale.data_ptr(),
        shift.data_ptr(), int(relu), y.data_ptr(), _stream(x2),
    )
    _launched(bn_norm, rc)
    return y


@counted(_bwd_work)
def bn_bwd(dy2, x2, scale, shift, mean, rsqrt, relu: bool, *, plan: BwdPlan | None = None):
    """``(dx, dbeta, dgamma)``: the whole backward in one launch of
    ``csrc/fused_bn.cu`` for CUDA tensors (``plan``, by default
    :func:`bn_bwd_plan`'s), :func:`bn_bwd_plain` for CPU ones. ``dy2`` has
    x's shape and dtype; ``dx`` is in x's dtype, the sums f32. Each launch
    adds one to ``bn_bwd.launches``."""
    if not on_card(x2):
        return bn_bwd_plain(dy2, x2, scale, shift, mean, rsqrt, relu)
    _check_view("x", x2)
    _check_view("dy", dy2, like=x2)
    _check_vectors(x2, scale=scale, shift=shift, mean=mean, rsqrt=rsqrt)
    m, c = x2.shape
    dx = torch.empty_like(x2)
    out = torch.empty((2, c), dtype=torch.float32, device=x2.device)
    vec = _vec(x2, dy2, dx, scale, shift, mean, rsqrt)
    p = plan or bn_bwd_plan(m, c, x2.element_size(), vec)
    rc = _bind("cml_bn_bwd", [_P, _P, _I, _LL, _I, _I, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _P, _P, _P])(
        dy2.data_ptr(), x2.data_ptr(), _DTYPE_CODE[x2.dtype], m, c, vec, scale.data_ptr(), shift.data_ptr(),
        mean.data_ptr(), rsqrt.data_ptr(), int(relu), p.cluster, p.tile, p.rows, p.chunk, p.nbuf,
        dx.data_ptr(), out.data_ptr(), _stream(x2),
    )
    _launched(bn_bwd, rc)
    return dx, out[0], out[1]


bn_stats.launches = 0
bn_norm.launches = 0
bn_bwd.launches = 0

_KERNEL_OPS = (bn_forward_stats, bn_norm, bn_bwd)
_PLAIN_OPS = (bn_forward_stats_plain, bn_norm_plain, bn_bwd_plain)


# ---------------------------------------------------------------------------
# functional forward/backward (the reference's custom VJP)
# ---------------------------------------------------------------------------


def fold_params(gamma, beta, mean, var, eps: float):
    """``(scale, shift, rsqrt)``: ``rsqrt(var + eps)``, ``gamma * rsqrt``,
    ``beta - mean * scale``, in f32 (the reference's ``_fold_params``),
    flushed as its compiled program does (``var + eps`` and its rsqrt are
    normal)."""
    rsqrt = torch.rsqrt(ftz(var) + eps)
    scale = ftz(ftz(gamma.float()) * rsqrt)
    shift = ftz(ftz(beta.float()) - ftz(ftz(mean) * scale))
    return scale, shift, rsqrt


def batch_moments(s: torch.Tensor, sq: torch.Tensor, m: int):
    """``(mean, var)`` from the statistics' sums: ``s / m`` and the "fast
    variance" ``max(sq / m - mean**2, 0)``, each division the product with
    ``f32(1/m)`` into which XLA compiles the reference's division by a
    constant (``inv_rows``), every result flushed."""
    inv = inv_rows(m)
    mean = ftz(s * inv)
    var = torch.clamp_min(ftz(ftz(sq * inv) - ftz(mean * mean)), 0.0)
    return mean, var


class _FusedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, relu, plain):
        stats, norm, _bwd = _PLAIN_OPS if plain else _KERNEL_OPS
        mean, var, scale, shift, rsqrt = stats(x2, gamma, beta, eps)
        y = norm(x2, scale, shift, relu)
        ctx.save_for_backward(x2, scale, shift, mean, rsqrt)
        ctx.relu, ctx.plain = relu, plain
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2, scale, shift, mean, rsqrt = ctx.saved_tensors
        _s, _n, bwd = _PLAIN_OPS if ctx.plain else _KERNEL_OPS
        dx, db, dg = bwd(dy.to(x2.dtype).contiguous(), x2, scale, shift, mean, rsqrt, ctx.relu)
        return dx, dg, db, None, None, None


def fused_batch_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
    act: str | None = None,
    impl: str = "auto",
    pack_small: bool = True,
):
    """Training-mode fused BN over the last axis of ``x``: ``(y, mean,
    var)``, ``y`` in x's dtype and shape, ``mean``/``var`` the f32 batch
    statistics (biased variance), detached. Gradients reach ``x``,
    ``gamma`` and ``beta`` through the statistics as in standard BN.

    ``act``: ``None`` or ``"relu"`` (fused into the normalize pass and its
    backward mask). ``impl`` and ``pack_small``: see the module docstring.
    ``x`` must be viewable as ``(M, C)`` without a copy.
    """
    if act not in (None, "relu"):
        raise ValueError(f"unsupported act {act!r}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    c = x.shape[-1]
    x2 = x.view(-1, c)
    y, mean, var = _FusedBatchNorm.apply(x2, gamma, beta, eps, act == "relu", impl == "jnp")
    return y.view(x.shape), mean, var


# ---------------------------------------------------------------------------
# module
# ---------------------------------------------------------------------------


class FusedBatchNorm(nn.Module):
    """BatchNorm(+ReLU) over the feature (last) axis, the reference's
    ``FusedBatchNorm`` state contract: f32 parameters ``scale``/``bias``
    and ``batch_stats`` buffers ``mean``/``var``, updated in place in
    training as ``momentum * old + (1 - momentum) * batch`` (flax's
    momentum, 0.9). ``forward(x, use_running_average=True)`` (the
    reference's field of that name, given per call as the ResNet's
    ``train`` flag is) normalises with the running statistics in plain f32
    ops, as the reference does in jnp."""

    def __init__(self, features: int, *, momentum: float = 0.9, epsilon: float = 1e-5, act: str | None = None,
                 impl: str = "auto", pack_small: bool = True, scale_init: float = 1.0, device=None):
        super().__init__()
        if act not in (None, "relu"):
            raise ValueError(f"unsupported act {act!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}")
        self.momentum, self.epsilon, self.act = momentum, epsilon, act
        self.impl, self.pack_small, self.scale_init = impl, pack_small, scale_init
        f32 = {"dtype": torch.float32, "device": device}
        self.scale = nn.Parameter(torch.full((features,), float(scale_init), **f32))
        self.bias = nn.Parameter(torch.zeros(features, **f32))
        self.register_buffer("mean", torch.zeros(features, **f32))
        self.register_buffer("var", torch.ones(features, **f32))

    def forward(self, x: torch.Tensor, use_running_average: bool = False) -> torch.Tensor:
        if use_running_average:
            scale, shift, _ = fold_params(self.scale, self.bias, self.mean, self.var, self.epsilon)
            y = x.float() * scale + shift
            if self.act == "relu":
                y = torch.relu(y)
            return y.to(x.dtype)
        y, mean, var = fused_batch_norm(x, self.scale, self.bias, eps=self.epsilon, act=self.act,
                                        impl=self.impl, pack_small=self.pack_small)
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        return y
