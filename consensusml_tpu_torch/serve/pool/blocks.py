"""Paged KV-cache block pool: fixed-shape pages + host block accounting.

Port of ``consensusml_tpu/serve/pool/blocks.py``. Per-layer pages
``(num_blocks, block_size, kv_heads, head_dim)`` are shared by every
slot; a slot's logical position ``p`` lives in physical block
``table[slot, p // block_size]``. The host owns the truth — a LIFO free
list and per-slot owned lists — and mirrors the table to the device only
after a mutation. Physical block 0 is the TRASH block: never allocated,
it absorbs the writes of free lanes (all-zero table rows) and of prefill
pad chunks, and every reader masks it.

The refcounted sharing of the reference (``adopt``, pins, prefix hooks,
``shrink``) and its block-second accounting wait for the prefix-cache
slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = [
    "TRASH_BLOCK",
    "BlockPool",
    "NoFreeBlocks",
    "init_pages",
    "blocks_for_tokens",
]

TRASH_BLOCK = 0


class NoFreeBlocks(RuntimeError):
    """The pool cannot satisfy an allocation; callers evict or defer."""


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Physical blocks needed to hold ``tokens`` logical positions."""
    return -(-tokens // block_size)


def init_pages(dm: Any, num_blocks: int, block_size: int) -> list[dict]:
    """Per-layer ``{"k", "v"}`` zero pools on the model's device, in its
    compute dtype (Llama-GQA pages hold the pre-repeat kv heads):
    ``2 * layers * num_blocks * block_size * kv_heads * head_dim *
    itemsize`` bytes in all."""
    shape = (num_blocks, block_size, dm.kv_heads, dm.head_dim)
    return [
        {
            "k": torch.zeros(shape, dtype=dm.cache_dtype, device=dm.device),
            "v": torch.zeros(shape, dtype=dm.cache_dtype, device=dm.device),
        }
        for _ in range(dm.layers)
    ]


class BlockPool:
    """Host-side block accounting for one engine (engine-thread only).

    Every method raises on an invariant violation instead of corrupting
    silently: a double free would hand one physical block to two live
    slots.
    """

    def __init__(self, num_slots: int, max_len: int, block_size: int, num_blocks: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be positive, got {block_size}")
        if max_len % block_size:
            raise ValueError(f"block_size {block_size} must divide max_len {max_len}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = max_len // block_size
        self.num_blocks = num_blocks or num_slots * self.blocks_per_slot + 1
        if self.num_blocks < self.blocks_per_slot + 1:
            raise ValueError(
                f"num_blocks {self.num_blocks} cannot hold even one max-length "
                f"stream ({self.blocks_per_slot} blocks + the trash block)"
            )
        # LIFO stack of free physical ids; block 0 (trash) never enters
        self._free: list[int] = list(range(self.num_blocks - 1, 0, -1))
        self._owned: dict[int, list[int]] = {}
        self._table = np.zeros((num_slots, self.blocks_per_slot), np.int32)
        self._dev_table: torch.Tensor | None = None  # rebuilt after a mutation

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - len(self._free)

    def owned(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, ()))

    def can_admit(self, n_blocks: int) -> bool:
        return len(self._free) >= n_blocks

    def alloc(self, slot: int, n_blocks: int) -> list[int]:
        """Give ``slot`` its first ``n_blocks`` blocks (admission)."""
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already owns blocks (double-alloc)")
        if n_blocks > self.blocks_per_slot:
            raise ValueError(f"slot {slot} asked for {n_blocks} > {self.blocks_per_slot} blocks")
        if len(self._free) < n_blocks:
            raise NoFreeBlocks(f"need {n_blocks} blocks, {len(self._free)} free")
        self._owned[slot] = []
        return self.extend(slot, n_blocks)

    def extend(self, slot: int, n_blocks: int = 1) -> list[int]:
        """Grow ``slot`` by ``n_blocks`` fresh blocks."""
        owned = self._owned.get(slot)
        if owned is None:
            raise RuntimeError(f"slot {slot} owns nothing; alloc first")
        if len(owned) + n_blocks > self.blocks_per_slot:
            raise ValueError(
                f"slot {slot} would exceed blocks_per_slot "
                f"({len(owned)} + {n_blocks} > {self.blocks_per_slot})"
            )
        if len(self._free) < n_blocks:
            raise NoFreeBlocks(f"need {n_blocks} blocks, {len(self._free)} free")
        got = [self._free.pop() for _ in range(n_blocks)]
        self._table[slot, len(owned) : len(owned) + n_blocks] = got
        owned.extend(got)
        if got:
            self._dev_table = None
        return got

    def release(self, slot: int) -> list[int]:
        """Return all of ``slot``'s blocks and reset its row to trash."""
        owned = self._owned.pop(slot, None)
        if owned is None:
            raise RuntimeError(f"slot {slot} owns nothing (double-free)")
        for b in owned:
            if b == TRASH_BLOCK or b in self._free:
                raise RuntimeError(f"corrupt free list: block {b}")
        self._free.extend(owned)
        self._table[slot, :] = TRASH_BLOCK
        self._dev_table = None
        return owned

    def block_row(self, slot: int, width: int) -> np.ndarray:
        """``slot``'s physical ids padded with trash to ``width`` entries
        (the prefill scatter's index vector)."""
        owned = self._owned.get(slot, ())
        row = np.full((width,), TRASH_BLOCK, np.int32)
        n = min(len(owned), width)
        row[:n] = owned[:n]
        return row

    def device_table(self, device) -> torch.Tensor:
        """The block table as an int32 tensor on ``device`` (copied only
        after a mutation, never per decode step)."""
        if self._dev_table is None or self._dev_table.device != torch.device(device):
            self._dev_table = torch.from_numpy(self._table.copy()).to(device)
        return self._dev_table

    def check(self) -> None:
        """Invariant sweep: free and owned partition the non-trash blocks
        exactly (no double allocation, no double free, no leak), and every
        owned list matches its table row."""
        held: list[int] = []
        for slot, blocks in self._owned.items():
            if list(self._table[slot, : len(blocks)]) != blocks:
                raise AssertionError(f"slot {slot} table row disagrees with owned {blocks}")
            if np.any(self._table[slot, len(blocks) :] != TRASH_BLOCK):
                raise AssertionError(f"slot {slot} table row has stale entries")
            held.extend(blocks)
        everything = held + self._free
        if len(set(everything)) != len(everything):
            raise AssertionError("a block is held twice or both held and free")
        if set(everything) != set(range(1, self.num_blocks)):
            raise AssertionError("block leak or trash block allocated")
