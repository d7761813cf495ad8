"""Prefill and decode stages over the paged block pool.

Port of ``consensusml_tpu/serve/pool/stages.py``. The reference jits each
stage and donates the pages; here each stage is a plain function under
``torch.inference_mode`` that updates the pages IN PLACE and returns the
sampled tokens (still on the device — the engine's host copy is the
per-step fence) with the logits they were drawn from.
:func:`make_prefix_prefill_fn` is the prefix cache's admission stage: the
unshared suffix only, as a window over the adopted blocks.

:class:`AdmissionScheduler` is the host-side prefill budget per engine
tick, unchanged from the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from consensusml_tpu_torch.models.attention import paged_cow_copy
from consensusml_tpu_torch.serve.sampling import sample_token

__all__ = ["make_paged_prefill_fn", "make_paged_decode_fn", "make_prefix_prefill_fn", "AdmissionScheduler"]


def make_paged_prefill_fn(dm: Any, attn_impl: str = "auto") -> Callable:
    """``prefill(pages, ids (1, L), length, block_row (L // bs,),
    temperature, top_p, seed)`` -> ``(first_token (), last_logits (V,))``.

    The full causal forward over the padded bucket ``L`` (the flash
    kernel runs here once ``L * L > 512**2``), then each ``block_size``
    chunk of every layer's K/V goes to the physical block ``block_row``
    names: GPT-2's heads, Llama's pre-repeat kv heads (GQA's query heads
    read them through the paged-attention kernel). Entries past the
    slot's owned blocks are the trash block, so
    pad chunks may write block 0 several times in one index-put: with
    duplicate indices the winning write is unspecified on CUDA, which is
    harmless only because trash holds garbage that every reader masks.
    The first token samples at position ``length - 1``.
    """
    model = dm.model

    @torch.inference_mode()
    def prefill(pages, ids, length, block_row, temperature, top_p, seed):
        logits, kvs = model(ids, return_kv=True, attn_impl=attn_impl)
        last = logits[0, length - 1]  # the last REAL token's logits
        bs = pages[0]["k"].shape[1]
        nblk = ids.shape[1] // bs
        for pg, (k, v) in zip(pages, kvs):
            pg["k"][block_row] = k[0].to(pg["k"].dtype).reshape(nblk, bs, *k.shape[2:])
            pg["v"][block_row] = v[0].to(pg["v"].dtype).reshape(nblk, bs, *v.shape[2:])
        dev = last.device
        tok = sample_token(
            last[None],
            torch.tensor([temperature], dtype=torch.float32).to(dev),
            torch.tensor([top_p], dtype=torch.float32).to(dev),
            torch.tensor([seed], dtype=torch.int64).to(dev),
            torch.tensor([length - 1], dtype=torch.int64).to(dev),
        )[0]
        return tok, last

    return prefill


def make_prefix_prefill_fn(dm: Any, attn_impl: str = "auto") -> Callable:
    """``prefix_prefill(pages, ids (1, B), suffix_len, start_pos, block_row
    (cols,), cow_src, cow_dst, temperature, top_p, seed)`` ->
    ``(first_token (), last_logits (V,))``.

    The matched prefix already sits in the slot's blocks (adopted from the
    index), so only the suffix, ``ids[0, :suffix_len]`` at positions
    ``start_pos + i`` padded to bucket ``B``, runs: a window of ``B`` rows
    (2-D ``positions``), each row's K/V written to ``block_row[pos // bs]``
    and attending the cache up to its position through the paged-attention
    kernel at ``W = B``, which reads the adopted prefix as the full
    prefill would have recomputed it. ``block_row`` carries ``B // bs``
    trash columns past the slot's row, where pad rows past the cache's end
    land.

    A full-match hit recomputes only the last prompt token, whose write
    lands inside a block other streams share: ``cow_src`` / ``cow_dst``
    (host ints) copy the shared block to the slot's fresh one first, and
    ``block_row`` names the fresh one (:func:`paged_cow_copy`; ``0, 0``, the
    trash pair, copies nothing). The first token samples at position
    ``start_pos + suffix_len - 1``, the full prefill's key.
    """
    model = dm.model

    @torch.inference_mode()
    def prefix_prefill(pages, ids, suffix_len, start_pos, block_row, cow_src, cow_dst, temperature, top_p, seed):
        for pg in pages:
            paged_cow_copy(pg, cow_src, cow_dst)
        pos = start_pos + torch.arange(ids.shape[1], device=ids.device)[None, :]
        logits = model(ids, positions=pos, kv_cache=pages, block_table=block_row[None, :], attn_impl=attn_impl)
        last = logits[0, suffix_len - 1]  # the last real suffix token's logits
        dev = last.device
        tok = sample_token(
            last[None],
            torch.tensor([temperature], dtype=torch.float32).to(dev),
            torch.tensor([top_p], dtype=torch.float32).to(dev),
            torch.tensor([seed], dtype=torch.int64).to(dev),
            torch.tensor([start_pos + suffix_len - 1], dtype=torch.int64).to(dev),
        )[0]
        return tok, last

    return prefix_prefill


def make_paged_decode_fn(dm: Any, attn_impl: str = "auto") -> Callable:
    """``decode(pages, block_table (S, nb), tokens (S,), positions (S,),
    temperature (S,), top_p (S,), seeds (S,))`` -> ``(next_tokens (S,),
    logits (S, V))``.

    One token for every slot: each lane writes its K/V at its own
    position (free lanes into the trash block) and attends its own cache
    through the paged-attention tier ``attn_impl``; each lane samples
    under its own ``(seed, position)``.
    """
    model = dm.model

    @torch.inference_mode()
    def decode(pages, block_table, tokens, positions, temperature, top_p, seeds):
        logits = model(
            tokens[:, None], positions=positions, kv_cache=pages,
            block_table=block_table, attn_impl=attn_impl,
        )[:, 0]
        return sample_token(logits, temperature, top_p, seeds, positions), logits

    return decode


class AdmissionScheduler:
    """Per-tick prefill admission budget (host ints only).

    ``try_admit`` charges a candidate's BUCKET length against the tick:
    the first admission of a tick always fits (a prompt longer than the
    budget must not starve); later ones must fit what is left.
    """

    def __init__(self, prefill_budget: int):
        if prefill_budget < 1:
            raise ValueError(f"prefill_budget must be positive, got {prefill_budget}")
        self.prefill_budget = prefill_budget
        self._remaining = prefill_budget
        self._admitted_this_tick = 0

    def start_tick(self) -> None:
        self._remaining = self.prefill_budget
        self._admitted_this_tick = 0

    def try_admit(self, bucket_tokens: int) -> bool:
        """Charge one prefill of ``bucket_tokens``; False = defer it."""
        if self._admitted_this_tick and bucket_tokens > self._remaining:
            return False
        self._remaining = max(0, self._remaining - bucket_tokens)
        self._admitted_this_tick += 1
        return True
