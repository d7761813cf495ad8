"""Attention building blocks (port of ``consensusml_tpu/models/attention.py``).

Same recipe on every path as the reference: logits accumulate in f32
(bf16 operands are promoted, so each product is exact and only the sum
order differs), softmax in f32, probabilities cast to the compute dtype
before the PV product, output in ``dtype``. Masks are applied with
``torch.where`` to ``-1e30``, never as an additive bias, so non-finite
junk in an excluded key cannot survive its own exclusion.

Layouts follow the reference: ``(B, S, H, D)`` activations, paged pools
``(num_blocks, block_size, H, D)`` with block tables ``(S, nb)``.
"""

from __future__ import annotations

import torch

__all__ = [
    "dot_product_attention",
    "blockwise_attention",
    "cached_attention",
    "paged_update_kv_cache",
    "paged_update_kv_cache_window",
    "paged_cow_copy",
    "gather_paged_kv",
    "cached_attention_window",
    "rope_frequencies",
    "apply_rope",
]

_NEG_INF = -1e30

# auto dispatch: above this many logits per (batch, head) the dense S x T
# f32 score matrix dominates activation memory (reference's threshold)
_BLOCKWISE_THRESHOLD = 512 * 512
_DEFAULT_BLOCK_KV = 512


def _scale(d: int) -> torch.Tensor:
    # 1/sqrt(d) computed in f32, as the reference does
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def dot_product_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, H, D)
    v: torch.Tensor,  # (B, T, H, D)
    *,
    causal: bool = False,
    bias: torch.Tensor | None = None,
    kv_mask: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    dtype: torch.dtype = torch.bfloat16,
    impl: str = "auto",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Multi-head attention with f32 logits/softmax.

    ``impl``: "dense" materializes the (B, H, S, T) scores; "blockwise"
    streams KV blocks with an online softmax; "flash" is the CUDA
    flash-attention forward (:mod:`.flash_attention`); "auto" picks
    dense up to S*T = 512^2 and, above it, flash for self-attention
    shapes without a bias on a CUDA tensor, blockwise otherwise — the
    reference's dispatch with the H100 in the TPU's place.

    ``use_kernel=False`` sends "flash" to the kernels' plain PyTorch
    versions instead (the engine's ``attn_impl="torch"`` tier; under
    autograd the reference's backward in plain ops, as on the CPU).

    ``kv_mask`` ((B, T), nonzero = attend) and ``mask`` ((B, S|1, T)
    bool, True = attend; dense only) are where-masks, as in the reference.
    """
    if kv_mask is not None:
        if bias is not None:
            raise ValueError("pass either bias or kv_mask, not both")
        if tuple(kv_mask.shape) != (k.shape[0], k.shape[1]):
            raise ValueError(
                f"kv_mask must be (batch, kv_len) = {(k.shape[0], k.shape[1])}, "
                f"got {tuple(kv_mask.shape)}"
            )
    if impl == "auto":
        if q.shape[1] * k.shape[1] <= _BLOCKWISE_THRESHOLD:
            impl = "dense"
        elif bias is None and q.shape == k.shape == v.shape and q.is_cuda:
            impl = "flash"
        else:
            impl = "blockwise"
    if mask is not None and impl != "dense":
        raise ValueError(f"mask= is dense-only, got impl={impl!r}")
    if impl == "flash":
        if bias is not None:
            raise ValueError("impl='flash' does not support bias")
        from consensusml_tpu_torch.models import flash_attention as fa

        return fa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, dtype=dtype, use_kernel=use_kernel)
    if kv_mask is not None:
        if impl == "dense":
            mask = (kv_mask > 0)[:, None, :]
        else:
            bias = torch.where(
                kv_mask[:, None, None, :] > 0, 0.0, _NEG_INF
            ).to(torch.float32)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=causal, bias=bias, dtype=dtype)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r} (auto|dense|blockwise|flash)")
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * _scale(q.shape[-1]).to(q.device)
    if bias is not None:
        logits = logits + bias.float()
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=q.device)
    if mask is not None:
        logits = torch.where(mask[:, None], logits, neg)
    if causal:
        s, t = logits.shape[-2], logits.shape[-1]
        tri = torch.ones((s, t), dtype=torch.bool, device=q.device).tril(t - s)
        logits = torch.where(tri, logits, neg)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    bias: torch.Tensor | None = None,
    dtype: torch.dtype = torch.bfloat16,
    block_kv: int = _DEFAULT_BLOCK_KV,
) -> torch.Tensor:
    """Exact attention over KV blocks with the online-softmax recurrence
    (running row max / row sum in f32): the reference's ``lax.scan``
    becomes a Python loop over blocks. ``bias`` broadcasts against
    ``(B, H, S, T)``."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scale = _scale(d).to(q.device)
    block_kv = min(block_kv, t)
    if bias is not None:
        bias = torch.broadcast_to(bias.float(), torch.broadcast_shapes(bias.shape, (b, 1, 1, t)))
    pos_q = torch.arange(s, device=q.device) + (t - s if causal else 0)
    qf = q.float()
    out = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, h, s), _NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    for start in range(0, t, block_kv):
        stop = min(start + block_kv, t)
        k_t, v_t = k[:, start:stop], v[:, start:stop]
        logits = torch.einsum("bshd,bthd->bhst", qf, k_t.float()) * scale
        if bias is not None:
            logits = logits + bias[..., start:stop]
        pos_k = torch.arange(start, stop, device=q.device)
        if causal:
            valid = pos_q[:, None] >= pos_k[None, :]
            logits = torch.where(valid[None, None], logits, _NEG_INF)
        new_max = torch.maximum(row_max, logits.amax(-1))
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(logits - new_max[..., None])
        row_sum = row_sum * correction + probs.sum(-1)
        blk = torch.einsum("bhst,bthd->bshd", probs.to(v_t.dtype).float(), v_t.float())
        out = out * correction.transpose(1, 2)[..., None] + blk
        row_max = new_max
    denom = torch.clamp(row_sum, min=1e-30).transpose(1, 2)[..., None]
    return (out / denom).to(dtype)


def paged_update_kv_cache(
    cache: dict[str, torch.Tensor],
    k: torch.Tensor,  # (S, 1, H, D) — the decode step's new key per slot
    v: torch.Tensor,  # (S, 1, H, D)
    block_table: torch.Tensor,  # (S, blocks_per_slot) physical block ids
    positions: torch.Tensor,  # (S,) per-slot token index
) -> torch.Tensor:
    """Write one decode step's K/V into the paged pool IN PLACE (the
    reference returns new arrays and donates the old; here the pages are
    updated where they lie). Slot ``s`` at position ``p`` writes physical
    block ``block_table[s, p // bs]``, row ``p % bs``.

    Free lanes have all-zero table rows and write into the trash block 0;
    several lanes may then write the same row. An index-put with duplicate
    indices is nondeterministic on CUDA (which write lands is unspecified),
    which is harmless here only because the trash block holds garbage that
    every reader masks. Positions must be below ``blocks_per_slot * bs``:
    PyTorch raises (CPU) or device-asserts (CUDA) on an out-of-range index
    where JAX would clamp. Returns ``lengths = positions + 1``.
    """
    bs = cache["k"].shape[1]
    rows = torch.arange(k.shape[0], device=k.device)
    phys = block_table[rows, positions // bs]
    off = positions % bs
    cache["k"][phys, off] = k[:, 0].to(cache["k"].dtype)
    cache["v"][phys, off] = v[:, 0].to(cache["v"].dtype)
    return positions + 1


def paged_update_kv_cache_window(
    cache: dict[str, torch.Tensor],
    k: torch.Tensor,  # (S, W, H, D) — a W-token window a slot
    v: torch.Tensor,  # (S, W, H, D)
    block_table: torch.Tensor,  # (S, cols) physical block ids (trash-padded)
    positions: torch.Tensor,  # (S, W) each window token's position
) -> None:
    """Write a ``W``-token window of K/V into the paged pool IN PLACE: the
    speculative verify's (``W = k + 1``) and the prefix cache's suffix
    prefill's widening of :func:`paged_update_kv_cache`. Window column
    ``w`` of slot ``s`` writes block ``block_table[s, p // bs]``, row ``p %
    bs``, ``p = positions[s, w]``. Positions past a slot's real row index
    the trash-padded columns the engine appends, so those writes land in
    the trash block (several may write one row there: which lands is
    unspecified on CUDA, harmless as every reader masks trash). Rejected
    draft rows are not rolled back: they sit past the committed length,
    masked, and the next window overwrites them."""
    bs = cache["k"].shape[1]
    phys = torch.gather(block_table.long(), 1, positions.long() // bs)
    off = positions.long() % bs
    cache["k"][phys, off] = k.to(cache["k"].dtype)
    cache["v"][phys, off] = v.to(cache["v"].dtype)


def paged_cow_copy(cache: dict[str, torch.Tensor], src: int, dst: int) -> None:
    """Copy physical block ``src``'s K/V rows to block ``dst`` IN PLACE: the
    prefix cache's copy-on-write, run before a window's scatter so the
    diverging slot's fresh block holds the shared rows plus its own writes
    while every other holder keeps reading the untouched source. ``src ==
    dst`` (the trash pair, 0 and 0) copies nothing."""
    if src != dst:
        cache["k"][dst] = cache["k"][src]
        cache["v"][dst] = cache["v"][src]


def gather_paged_kv(
    k_pages: torch.Tensor,  # (N, bs, H, D)
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # (S, nb)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slot's logical ``(S, nb * bs, H, D)`` KV view, one gather per
    tensor — the two-step path's materialized view."""
    s, nb = block_table.shape
    bs, h, d = k_pages.shape[1:]
    k = k_pages[block_table].reshape(s, nb * bs, h, d)
    v = v_pages[block_table].reshape(s, nb * bs, h, d)
    return k, v


def cached_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, T, H, D)
    v_cache: torch.Tensor,
    *,
    lengths: torch.Tensor,  # (B,) valid cache rows per slot
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Decode-step attention over the first ``lengths[b]`` cache rows."""
    t = k_cache.shape[1]
    kv_mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    return dot_product_attention(q, k_cache, v_cache, kv_mask=kv_mask, dtype=dtype, impl="dense")



def cached_attention_window(
    q: torch.Tensor,  # (B, W, H, D) — W query tokens a slot
    k_cache: torch.Tensor,  # (B, T, H, D)
    v_cache: torch.Tensor,
    *,
    positions: torch.Tensor,  # (B, W) each query token's position
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """:func:`cached_attention` widened to a ``W``-token window: query
    ``w`` of slot ``b`` attends cache rows ``<= positions[b, w]``, which is
    both the causality inside the window (its rows are written before the
    read) and the exclusion of stale rows past each slot's length. A
    where-mask, as the reference's, so junk in excluded trash rows cannot
    reach the logits."""
    t = k_cache.shape[1]
    mask = torch.arange(t, device=q.device)[None, None, :] <= positions[:, :, None]
    return dot_product_attention(q, k_cache, v_cache, mask=mask, dtype=dtype, impl="dense")


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """The RoPE cos/sin table ``(max_len, head_dim // 2, 2)`` in f32, as the
    reference computes it: ``inv = 1 / theta ** (arange(0, D, 2) / D)``,
    angles ``t * inv``, then ``[cos, sin]`` on the last axis."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32).to(device), exps)
    freqs = torch.outer(torch.arange(max_len, dtype=torch.float32, device=device), inv)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rope(x: torch.Tensor, table: torch.Tensor, positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary position embedding of ``x`` ``(B, S, H, D)`` (the reference's
    ``apply_rope``): each pair ``(x[2i], x[2i+1])`` rotated by row ``s`` of
    ``table`` (:func:`rope_frequencies`), or, with ``positions`` ``(S,)`` or
    ``(B, S)``, by row ``min(position, max_len - 1)`` (the reference clamps
    the lookup: a position past the table reads its last row, not junk),
    in f32, cast back to ``x``'s dtype."""
    b, s, h, d = x.shape
    if positions is None:
        cs = table[:s]  # (S, D/2, 2)
    else:
        cs = table[torch.clamp(positions, max=table.shape[0] - 1)]  # (S|B, S, D/2, 2)
    cos, sin = cs[..., 0], cs[..., 1]
    if cos.dim() == 2:  # (S, D/2): broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float().reshape(b, s, h, d // 2, 2)
    x1, x2 = xf[..., 0], xf[..., 1]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(b, s, h, d)
    return out.to(x.dtype)
