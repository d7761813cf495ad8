"""Fused paged attention for the serving hot path: CUDA kernel + plain version.

Port of ``consensusml_tpu/models/paged_attention.py``. One kernel
(``csrc/paged_attention.cu``) does block-table lookup, paged KV read and
position-masked attention for a ``(S, W)`` grid of query rows — ``W = 1``
is the decode step (:func:`fused_paged_attention`), ``W = k + 1`` the
speculative verify window (:func:`fused_paged_attention_window`), exactly
as the reference's ``_fused_call`` serves both. Query row ``w`` of slot
``s`` attends cache positions ``<= positions[s, w]``; heads repeat onto
``H // Hkv`` query heads on the read (GQA).

Tiers (``attn_impl``), resolved once by :func:`resolve_attention_impl`:

- ``"torch"``: :func:`paged_attention_plain`, the kernel's function in
  plain PyTorch (what the CPU runs, and the card's comparison baseline);
- ``"cuda"``: :func:`paged_attention`, the kernel wrapper.

``"auto"`` is the kernel tier on a CUDA device and the plain tier on the
CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.models.attention import gather_paged_kv

__all__ = [
    "ATTENTION_IMPLS",
    "resolve_attention_impl",
    "fused_paged_attention",
    "fused_paged_attention_window",
    "paged_attention",
    "paged_attention_plain",
]

ATTENTION_IMPLS = ("torch", "cuda")
_NEG_INF = -1e30
_SMEM_LIMIT = 48 * 1024  # default dynamic shared memory per block


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
    cast to ``dtype``, f32-accumulated PV, output in ``dtype``."""
    s, w, h, d = q.shape
    rep = h // k_pages.shape[2]
    kg, vg = _expand_heads(*gather_paged_kv(k_pages, v_pages, block_table), rep)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    logits = torch.einsum("swhd,sthd->shwt", q.float(), kg.float()) * scale.to(q.device)
    t = kg.shape[1]
    keep = torch.arange(t, device=q.device)[None, None, :] <= positions[:, :, None]
    logits = torch.where(keep[:, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("shwt,sthd->swhd", probs.to(dtype).float(), vg.float())
    return out.to(dtype)


def _lib():
    lib = kernels.load("paged_attention")
    fn = lib.cml_paged_attention_bf16
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
        lib.cml_paged_attention_smem_bytes.argtypes = [i, i, i]
        lib.cml_paged_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def paged_attention(
    q: torch.Tensor,  # (S, W, H, D) bf16
    k_pages: torch.Tensor,  # (N, bs, Hkv, D) bf16
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (S, nb) int32
    positions: torch.Tensor,  # (S, W) int32, each >= 0
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The kernel wrapper. A CPU tensor runs :func:`paged_attention_plain`;
    a CUDA tensor launches ``csrc/paged_attention.cu`` on the current
    stream after checking device, dtype, shape and contiguity (it raises
    on anything the kernel does not take). Each launch adds one to
    ``paged_attention.launches``."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pages, v_pages, block_table, positions, dtype)
    s, w, h, d = q.shape
    n, bs, hkv, dk = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dk != d:
        raise ValueError(f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != s:
        raise ValueError(f"block_table must be ({s}, nb), got {tuple(block_table.shape)}")
    if tuple(positions.shape) != (s, w):
        raise ValueError(f"positions must be {(s, w)}, got {tuple(positions.shape)}")
    if d % 2 or d > 128:
        raise ValueError(f"head dim {d} must be even and <= 128")
    if dtype != torch.bfloat16:
        raise ValueError(f"the CUDA paged attention writes bf16, asked for {dtype}")
    for name, t, want in (
        ("q", q, torch.bfloat16), ("k_pages", k_pages, torch.bfloat16),
        ("v_pages", v_pages, torch.bfloat16), ("block_table", block_table, torch.int32),
        ("positions", positions, torch.int32),
    ):
        if t.dtype != want or not t.is_contiguous() or t.device != q.device or t.data_ptr() % 4:
            raise ValueError(
                f"{name} must be a contiguous, 4-byte aligned {want} tensor on {q.device}, "
                f"got {t.dtype} contiguous={t.is_contiguous()} on {t.device}"
            )
    if s > 65535:
        raise ValueError(f"{s} slots exceed the grid's y limit 65535")
    nb = block_table.shape[1]
    lib = _lib()
    if lib.cml_paged_attention_smem_bytes(d, bs, nb) > _SMEM_LIMIT:
        raise ValueError(f"{nb} x {bs} cache positions exceed the kernel's shared-memory logits")
    out = torch.empty_like(q)
    rc = lib.cml_paged_attention_bf16(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        positions.data_ptr(), out.data_ptr(), s, w, h, hkv, d, bs, nb,
        float(np.float32(1.0) / np.sqrt(np.float32(d))),  # the plain version's f32 scale
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


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
    ``<= positions[s, w]``."""
    return _fused(q, k_pages, v_pages, block_table, positions, dtype, impl)
