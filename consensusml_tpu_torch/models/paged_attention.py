"""Fused paged attention for the serving hot path: CUDA kernel + plain version.

Port of ``consensusml_tpu/models/paged_attention.py``. One kernel
(``csrc/paged_attention.cu``) does block-table lookup, paged KV read and
position-masked attention for a ``(S, W)`` grid of query rows — ``W = 1``
is the decode step (:func:`fused_paged_attention`), ``W = k + 1`` the
speculative verify window and ``W`` = the suffix bucket the prefix
cache's suffix prefill (:func:`fused_paged_attention_window`), as the
reference's ``_fused_call`` serves all three. Past 8 rows the kernel cuts
the window into tiles of at most 8 rows on a further grid axis, still one
launch a call (:func:`paged_plan`). Query row ``w`` of slot
``s`` attends cache positions ``<= positions[s, w]``; heads repeat onto
``H // Hkv`` query heads on the read (GQA).

Tiers (``attn_impl``), resolved once by :func:`resolve_attention_impl`:

- ``"torch"``: :func:`paged_attention_plain`, the kernel's function in
  plain PyTorch (what the CPU runs, and the card's comparison baseline);
- ``"cuda"``: :func:`paged_attention`, the kernel wrapper.

``"auto"`` is the kernel tier on a CUDA device and the plain tier on the
CPU. Under a ``workcount`` counter the wrapper reports its work at the
static extent of its call (every key the block table reaches, whatever the
positions), as a compiled program is priced; a fake tensor takes the plain
route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.models.attention import gather_paged_kv
from consensusml_tpu_torch.numerics import ftz
from consensusml_tpu_torch.workcount import counted, on_card

__all__ = [
    "ATTENTION_IMPLS",
    "PagedPlan",
    "paged_plan",
    "paged_block_keys",
    "paged_max_blocks",
    "paged_smem",
    "resolve_attention_impl",
    "fused_paged_attention",
    "fused_paged_attention_window",
    "paged_attention",
    "paged_attention_plain",
]

ATTENTION_IMPLS = ("torch", "cuda")
_NEG_INF = -1e30


def resolve_attention_impl(requested: str = "auto", device=None) -> str:
    """``"auto"`` -> ``"cuda"`` on a CUDA device, ``"torch"`` (the plain
    version) elsewhere; explicit tiers pass through, unknown ones raise."""
    if requested == "auto":
        dev = torch.device(device) if device is not None else torch.device("cpu")
        return "cuda" if dev.type == "cuda" else "torch"
    if requested not in ATTENTION_IMPLS:
        raise ValueError(
            f"unknown attention impl {requested!r} (auto|{'|'.join(ATTENTION_IMPLS)})"
        )
    return requested


def _expand_heads(kg, vg, rep):
    if rep != 1:
        kg = kg.repeat_interleave(rep, dim=2)
        vg = vg.repeat_interleave(rep, dim=2)
    return kg, vg


def paged_attention_plain(
    q: torch.Tensor,  # (S, W, H, D)
    k_pages: torch.Tensor,  # (N, bs, Hkv, D)
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (S, nb) int
    positions: torch.Tensor,  # (S, W) int — last attendable position per row
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, op for op the reference's
    dense recipe: f32 logits scaled by ``1/sqrt(D)``, where-mask
    ``t <= positions[s, w]`` to ``-1e30``, f32 softmax, probabilities
    cast to ``dtype``, f32-accumulated PV, output in ``dtype``. The dot
    products and the softmax's sum are taken in f64 and rounded once to
    f32, as the kernel takes them: the f32 values the reference's
    summation would round to, without its order. Each f32 result (and V,
    an operand of f32 products) is flushed as the reference's compiled
    program flushes it (:func:`~consensusml_tpu_torch.numerics.ftz`)."""
    s, w, h, d = q.shape
    rep = h // k_pages.shape[2]
    kg, vg = _expand_heads(*gather_paged_kv(k_pages, v_pages, block_table), rep)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    # the dot products and the softmax's sum in f64, each rounded once to
    # f32: the same bits in any summation order (the kernel's too), so the
    # bf16-rounded probabilities do not depend on it
    logits = ftz(ftz(torch.einsum("swhd,sthd->shwt", q.double(), kg.double()).float()) * scale.to(q.device))
    t = kg.shape[1]
    keep = torch.arange(t, device=q.device)[None, None, :] <= positions[:, :, None]
    logits = torch.where(keep[:, None], logits, _NEG_INF)
    e = ftz(torch.exp(ftz(logits - logits.amax(-1, keepdim=True))))
    probs = ftz(e / ftz(e.double().sum(-1, keepdim=True).float()))
    out = torch.einsum("shwt,sthd->swhd", probs.to(dtype).float(), ftz(vg.float()))
    return ftz(out).to(dtype)


# ---------------------------------------------------------------------------
# the kernel's launch plan (csrc/paged_attention.cu's header)
# ---------------------------------------------------------------------------

_THREADS = 256
_MAX_W = 8  # window rows a tile (the kernel's template rows, kMaxW)
_MAX_GRID_Z = 65535  # (head group, tile) pairs a slot: the grid's z extent
_MAX_SPLITS = 16  # blocks of a cluster (H100's non-portable most)
_MAX_RING = 8
_RING = 2  # page buffers a block: two let the card hold 14 clusters of 16, not 7 (paged_sweep.py)
_SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory


class PagedPlan(NamedTuple):
    """How :func:`paged_attention` cuts a call: one thread block cluster of
    ``splits`` blocks per (slot, head group, tile of window rows), block
    ``r`` owning the slot's pages ``[r * pages, (r + 1) * pages)`` for the
    ``kv_heads`` kv heads of its group (and their query heads, the tile's
    ``rows`` window rows), streamed through ``ring`` page buffers (K pages,
    then V pages); ``smem`` bytes of dynamic shared memory a block. A slot
    has ``Hkv // kv_heads`` head groups and ``W // rows`` tiles; at
    ``kv_heads == Hkv`` a block holds whole pages, at ``rows == W`` (every
    ``W <= 8``) one tile holds the window."""

    pages: int
    splits: int
    ring: int
    smem: int
    kv_heads: int
    rows: int


def _align128(n: int) -> int:
    return -(-n // 128) * 128


def paged_smem(w: int, h: int, hkv: int, d: int, bs: int, pages: int, ring: int, kv_heads: int | None = None) -> int:
    """A block's dynamic shared memory at ``w`` window rows (a tile's):
    ``csrc/paged_attention.cu:layout``
    (ring of page slices of ``kv_heads`` kv heads, all of them by default;
    q of the group's query heads as f64, the block's logits, the softmax's
    per-(row, head) vectors and fold scratch, its table entries, the
    mbarriers)."""
    g = kv_heads or hkv
    hb = g * (h // hkv)  # the block's query heads
    q_row = d + 2 * (4 if d % 32 == 0 else 2 if d % 16 == 0 else 1)  # q as f64, its D in padded parts
    return (ring * _align128(bs * g * d * 2) + _align128(w * hb * q_row * 8) + _align128(w * pages * bs * hb * 4)
            + _align128((w * hb + _THREADS) * 8 + (2 * w * hb + _MAX_W + pages) * 4) + 8 * ring)


def _window_tiles(w: int) -> list[int]:
    """The rows a tile may hold, most first: ``W`` itself up to 8, past
    8 the divisors of ``W`` that are at most 8 (8 for every suffix bucket,
    a power of two)."""
    if w < 1:
        return []
    return [w] if w <= _MAX_W else [t for t in range(_MAX_W, 0, -1) if w % t == 0]


def _kv_head_groups(w: int, h: int, hkv: int, d: int) -> list[int]:
    """The kv heads a block may own, most first: the divisors ``g`` of
    ``hkv`` whose ``g * rep`` query heads fit the block's threads (``g *
    rep * D <= 4 * 256`` dims for the P V stage's thread a (head, 4 dims),
    ``W * g * rep <= 256`` (row, head) pairs for the softmax's)."""
    rep = h // hkv
    return [g for g in range(hkv, 0, -1)
            if hkv % g == 0 and g * rep * d <= 4 * _THREADS and w * g * rep <= _THREADS]


@functools.lru_cache(maxsize=None)
def paged_plan(nb: int, bs: int, hkv: int, d: int, w: int, h: int, *, pages: int | None = None,
               ring: int | None = None, kv_heads: int | None = None) -> PagedPlan:
    """The plan of :func:`paged_attention` for a ``(S, nb)`` block table of
    ``bs``-token pages of ``(bs, hkv, d)``, ``w`` window rows and ``h``
    query heads.

    Up to 8 rows the window is one tile; past 8 it is cut into tiles of
    the most rows that divide ``w`` and fit (:func:`_window_tiles`), each
    tile a cluster of its own on the grid's third axis beside the head
    groups (at most 65535 of them a slot), so a call is one launch
    whatever its ``w`` (the prefix cache's suffix buckets: 16 to 1024 at
    GPT-2-medium, up to 4096 at Llama-2-7B's heads).

    The fewest pages a block that keep a slot's blocks within one cluster
    (``pages = ceil(nb / 16)``, ``splits = ceil(nb / pages)``: no block
    without a page at full length), so a slot's keys spread over up to 16
    SMs; the most kv heads a block whose query heads fit its threads
    (:func:`_kv_head_groups`: all of them up to H * D = 1024, so
    GPT-2-medium's blocks hold whole pages; 8 of Llama-2-7B's 32), fewer
    where shared memory runs out; a ring of 2 page buffers (1 where shared
    memory runs out): at GPT-2-medium's 32 KB pages a block then takes ~80
    KB at W = 1, two fit an SM and the card holds 14 clusters of 16 at once
    (7 with a ring of 4, whose second wave made the serving check 20%
    slower; ``paged_sweep.py``, PERF.md). ``pages``, ``ring`` and
    ``kv_heads`` pin those choices
    (``consensusml_tpu_torch/tools/paged_sweep.py``). Raises for a shape
    the kernel does not take, and past the longest cache: ``nb <= 16 *
    pages`` with the block's ring, q, logits and scratch in 227 KB of
    shared memory (:func:`paged_max_blocks`)."""
    shape_ok = h % hkv == 0 and d % 8 == 0
    forms = [(t, g) for t in (_window_tiles(w) if shape_ok else []) for g in _kv_head_groups(t, h, hkv, d)
             if (kv_heads is None or g == kv_heads) and (hkv // g) * (w // t) <= _MAX_GRID_Z]
    if not forms:
        raise ValueError(
            f"the CUDA paged attention takes W >= 1 (cut into tiles of T <= {_MAX_W} rows, T dividing W), H a "
            f"multiple of Hkv, D a multiple of 8, and a block of G kv heads (G dividing Hkv) with G * (H / Hkv) * "
            f"D <= {4 * _THREADS}, T * G * (H / Hkv) <= {_THREADS} and (Hkv / G) * (W / T) <= {_MAX_GRID_Z}; got "
            f"W={w}, H={h}, Hkv={hkv}, D={d}" + ("" if kv_heads is None else f", G={kv_heads}")
        )
    p = pages or -(-nb // _MAX_SPLITS)
    splits = -(-nb // p)
    if splits > _MAX_SPLITS or (splits - 1) * p >= nb:
        raise ValueError(f"{nb} pages in blocks of {p} need {splits} blocks a slot (at most {_MAX_SPLITS})")
    rings = [ring] if ring else range(min(_RING, 2 * p), 0, -1)
    for t, g in forms:
        for r in rings:
            if not 1 <= r <= _MAX_RING:
                raise ValueError(f"ring {r} outside 1..{_MAX_RING}")
            smem = paged_smem(t, h, hkv, d, bs, p, r, g)
            if smem <= _SMEM_LIMIT:
                return PagedPlan(p, splits, r, smem, g, t)
    raise ValueError(
        f"{nb} x {bs} cache positions (W={w}, H={h}, Hkv={hkv}, D={d}): a block's {p} pages of logits and its ring "
        f"exceed {_SMEM_LIMIT} bytes of shared memory at every head group"
    )


def paged_block_keys(plan: PagedPlan, bs: int, nb: int, last: list[int],
                     hkv: int) -> list[tuple[int, int, list[tuple[int, int]]]]:
    """What each block of a slot's grid reads, given each window row's last
    attended key (``positions``, clamped to the cache): ``(kv0, kv1,
    [(k0, k1) for each row])`` for the block of window tile ``w0 //
    plan.rows``, head group ``kv0 // plan.kv_heads`` (kv heads ``[kv0,
    kv1)``) and cluster rank ``r``, in the order (tile, group, rank); rows
    outside the block's tile read nothing, ``(k0, k0)``. The kernel's own
    arithmetic (``csrc/paged_attention.cu``: ``n`` pages from ``r * pages``
    up to the last page any row of the tile attends, ``nkeys(w)``); every
    group's blocks read the same keys for their own heads."""
    last = [min(p, nb * bs - 1) for p in last]
    out = []
    for w0 in range(0, len(last), plan.rows):
        tile = last[w0: w0 + plan.rows]
        pages_needed = max(tile) // bs + 1
        ranks = []
        for r in range(plan.splits):
            p0 = r * plan.pages
            n = max(0, min(p0 + plan.pages, pages_needed) - p0)
            k0 = p0 * bs
            rows = [(k0, k0)] * len(last)
            rows[w0: w0 + len(tile)] = [(k0, k0 + max(0, min(lw - k0 + 1, n * bs))) for lw in tile]
            ranks.append(rows)
        g = plan.kv_heads
        out += [(kv0, kv0 + g, rows) for kv0 in range(0, hkv, g) for rows in ranks]
    return out


def paged_max_blocks(bs: int, hkv: int, d: int, w: int, h: int, *, kv_heads: int | None = None) -> int:
    """The most ``nb`` (pages a slot) :func:`paged_plan` takes (with
    ``kv_heads`` kv heads a block, if given)."""
    least = (kv_heads or 1) * (h // hkv)  # the fewest query heads a block may hold
    # a tile holds at least one row: the logits of one row bound nb from above
    lo, hi = 1, _MAX_SPLITS * (_SMEM_LIMIT // max(1, bs * least * 4))
    while lo < hi:  # the plan fits up to some nb and from then on never again
        mid = (lo + hi + 1) // 2
        try:
            paged_plan(mid, bs, hkv, d, w, h, kv_heads=kv_heads)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


def _lib():
    lib = kernels.load("paged_attention")
    fn = lib.cml_paged_attention_bf16
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        lib.cml_paged_attention_smem_bytes.argtypes = [i] * 8
        lib.cml_paged_attention_smem_bytes.restype = ll
        lib.cml_paged_attention_max_active_clusters.argtypes = [i, i, ll, i]
        lib.cml_paged_attention_max_active_clusters.restype = i
    return lib



def _paged_work(q, k_pages, v_pages, block_table, positions, dtype=torch.bfloat16, *, plan=None):
    """Priced at the static extent of the call: every row of a slot may
    attend every key its block table reaches (``nb * bs``), whatever its
    position, as a compiled program is priced. 4 operations a (row, key)
    pair a head dimension (q.k and p.v); reads q, each slot's K and V pages
    once, the block table and positions, writes the output."""
    s, w, h, d = q.shape
    _n, bs, hkv, _d = k_pages.shape
    keys = s * block_table.shape[-1] * bs
    kv = 2 * keys * hkv * d * k_pages.element_size()
    nbytes = kv + q.numel() * (q.element_size() + dtype.itemsize) + 4 * (block_table.numel() + positions.numel())
    return 4.0 * w * keys * h * d, float(nbytes)


@counted(_paged_work)
def paged_attention(
    q: torch.Tensor,  # (S, W, H, D) bf16
    k_pages: torch.Tensor,  # (N, bs, Hkv, D) bf16
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (S, nb) int32
    positions: torch.Tensor,  # (S, W) int32, each >= 0
    dtype: torch.dtype = torch.bfloat16,
    *,
    plan: PagedPlan | None = None,
) -> torch.Tensor:
    """The kernel wrapper. A CPU tensor runs :func:`paged_attention_plain`;
    a CUDA tensor launches ``csrc/paged_attention.cu`` on the current
    stream (``plan``, by default :func:`paged_plan`'s) after checking
    device, dtype, shape, contiguity and alignment (it raises on anything
    the kernel does not take). Each launch adds one to
    ``paged_attention.launches``, one to
    ``paged_attention.grouped_launches`` where the plan splits the kv heads
    over more than one cluster a slot (``plan.kv_heads < Hkv``), and one to
    ``paged_attention.window_launches`` where the window has more than 8
    rows (the tiled form)."""
    if not on_card(q):
        return paged_attention_plain(q, k_pages, v_pages, block_table, positions, dtype)
    s, w, h, d = q.shape
    n, bs, hkv, dk = k_pages.shape
    nb = block_table.shape[-1]
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d:
        raise ValueError(f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != s or tuple(positions.shape) != (s, w):
        raise ValueError(f"block_table must be ({s}, nb) and positions {(s, w)}, got "
                         f"{tuple(block_table.shape)} and {tuple(positions.shape)}")
    if dtype != torch.bfloat16 or not 1 <= s <= 65535:
        raise ValueError(f"the CUDA paged attention writes bf16 for 1..65535 slots, asked for {dtype}, {s} slots")
    # q is read 16 bytes at a time, the pages as bulk copies of whole
    # pages or of a head group's rows: 16-byte aligned
    for name, t, want, align in (
        ("q", q, torch.bfloat16, 16), ("k_pages", k_pages, torch.bfloat16, 16),
        ("v_pages", v_pages, torch.bfloat16, 16), ("block_table", block_table, torch.int32, 4),
        ("positions", positions, torch.int32, 4),
    ):
        if t.dtype != want or not t.is_contiguous() or t.device != q.device or t.data_ptr() % align:
            raise ValueError(
                f"{name} must be a contiguous, {align}-byte aligned {want} tensor on {q.device}, "
                f"got {t.dtype} contiguous={t.is_contiguous()} on {t.device}"
            )
    p = plan or paged_plan(nb, bs, hkv, d, w, h)
    out = torch.empty_like(q)
    rc = _lib().cml_paged_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), n, s, w, h, hkv, d, bs, nb, p.pages, p.splits, p.ring, p.kv_heads,
        p.rows, float(np.float32(1.0) / np.sqrt(np.float32(d))),  # the plain version's f32 scale
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc}")
    paged_attention.launches += 1
    paged_attention.grouped_launches += p.kv_heads < hkv
    paged_attention.window_launches += w > _MAX_W
    return out


paged_attention.launches = 0
paged_attention.grouped_launches = 0
paged_attention.window_launches = 0


def _fused(q, k_pages, v_pages, block_table, positions, dtype, impl):
    impl = resolve_attention_impl(impl, q.device)
    fn = paged_attention if impl == "cuda" else paged_attention_plain
    return fn(
        q.contiguous(), k_pages, v_pages, block_table.to(torch.int32).contiguous(),
        positions.to(torch.int32).contiguous(), dtype,
    )


def fused_paged_attention(
    q: torch.Tensor,  # (S, 1, H, D)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (S, nb)
    *,
    lengths: torch.Tensor,  # (S,) valid tokens per slot (write position + 1)
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
) -> torch.Tensor:
    """Single-token paged decode attention through the chosen tier."""
    # the decode mask `t < lengths` is the window mask `t <= lengths - 1`
    return _fused(q, k_pages, v_pages, block_table, (lengths - 1)[:, None], dtype, impl)


def fused_paged_attention_window(
    q: torch.Tensor,  # (S, W, H, D)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    *,
    positions: torch.Tensor,  # (S, W) absolute position of each query token
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
) -> torch.Tensor:
    """W-token window paged attention: row ``w`` attends cache rows
    ``<= positions[s, w]`` (any ``W``: past 8 rows the kernel's tiled
    form)."""
    return _fused(q, k_pages, v_pages, block_table, positions, dtype, impl)
