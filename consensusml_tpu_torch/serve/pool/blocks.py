"""Paged KV-cache block pool: fixed-shape pages + host block accounting.

Port of ``consensusml_tpu/serve/pool/blocks.py``. Per-layer pages
``(num_blocks, block_size, kv_heads, head_dim)`` are shared by every
slot; a slot's logical position ``p`` lives in physical block
``table[slot, p // block_size]``. The host owns the truth — a LIFO free
list and per-slot owned lists — and mirrors the table to the device only
after a mutation. Physical block 0 is the TRASH block: never allocated,
it absorbs the writes of free lanes (all-zero table rows) and of prefill
pad chunks, and every reader masks it.

Blocks are refcounted, as the reference's: the prefix cache
(:mod:`.prefix`) maps a matched block-aligned prompt prefix into a new
slot's table with :meth:`BlockPool.adopt`, so a physical block may sit in
several slots' owned lists, and returns to the free list only when its
last holder lets go. A block whose bytes the prefix index still names
parks at the BOTTOM of the LIFO free stack (``cached_hook``), so cached
prefixes are recycled last; a fresh pop tells the index first
(``reuse_hook``). Each slot's block-seconds are integrated over its hold
time, the wide event's accounting (:meth:`BlockPool.block_seconds_split`).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Iterable

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

    A LIFO free list, per-slot owned lists, per-block refcounts (slot
    holders plus pins) and the block table, mirrored to the device after a
    mutation. Every method raises on an invariant violation instead of
    corrupting silently: a double free would hand one physical block to
    two live slots.

    ``reuse_hook(block)`` fires when a fresh pop is about to recycle a
    block (the prefix index forgets it); ``cached_hook(block) -> bool`` is
    asked when a block's refcount reaches zero (True: park it at the bottom
    of the free stack).

    Block-seconds (the wide event's accounting, as the reference's): each
    slot's holding integrated over ``clock`` (``time.monotonic`` unless
    injected), the blocks it adopted from the prefix index apart
    (:meth:`block_seconds_split`).
    """

    def __init__(self, num_slots: int, max_len: int, block_size: int, num_blocks: int = 0,
                 clock: Callable[[], float] | None = None):
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
        # holders a block: slot-owned multiplicity + pins; 0 <=> free
        self._refcnt = np.zeros((self.num_blocks,), np.int32)
        self._adopted: dict[int, set[int]] = {}  # per slot: blocks taken by adopt()
        self._pinned: Counter = Counter()  # blocks held alive with no slot owner
        self._table = np.zeros((num_slots, self.blocks_per_slot), np.int32)
        self._dev_tables: dict[tuple, torch.Tensor] = {}  # (device, extra_cols) -> table; cleared on mutation
        self.reuse_hook: Callable[[int], Any] | None = None
        self.cached_hook: Callable[[int], bool] | None = None
        self._clock = clock if clock is not None else time.monotonic
        self._bs_acc: dict[int, float] = {}
        self._bs_sh_acc: dict[int, float] = {}
        self._bs_t: dict[int, float] = {}

    def _integrate(self, slot: int) -> None:
        """Advance ``slot``'s block-second integrals to now at its current
        holding (before any change to the holding)."""
        t = self._bs_t.get(slot)
        if t is None:
            return
        now = self._clock()
        dt = now - t
        self._bs_acc[slot] += len(self._owned.get(slot, ())) * dt
        self._bs_sh_acc[slot] += len(self._adopted.get(slot, ())) * dt
        self._bs_t[slot] = now

    def block_seconds(self, slot: int) -> float:
        """``slot``'s total block-seconds so far (0.0 when it holds
        nothing)."""
        if slot not in self._owned:
            return 0.0
        self._integrate(slot)
        return self._bs_acc.get(slot, 0.0)

    def block_seconds_split(self, slot: int) -> tuple[float, float]:
        """``(unshared, shared)`` block-seconds of ``slot``: ``shared``
        integrates the blocks it adopted from the prefix index, ``unshared``
        the rest (a request is charged the unshared part)."""
        if slot not in self._owned:
            return 0.0, 0.0
        self._integrate(slot)
        total = self._bs_acc.get(slot, 0.0)
        shared = self._bs_sh_acc.get(slot, 0.0)
        return total - shared, shared

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Distinct physical blocks held (a shared block counts once)."""
        return self.usable_blocks - len(self._free)

    @property
    def shared_blocks(self) -> int:
        """Physical blocks held by more than one holder."""
        return int(np.count_nonzero(self._refcnt > 1))

    def owned(self, slot: int) -> list[int]:
        return list(self._owned.get(slot, ()))

    def refcount(self, block: int) -> int:
        return int(self._refcnt[block])

    def can_admit(self, n_blocks: int) -> bool:
        return len(self._free) >= n_blocks

    def begin(self, slot: int) -> None:
        """Open ``slot``'s holding with nothing in it (a prefix hit adopts
        its matched blocks, then extends): :meth:`alloc` is begin + extend."""
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already owns blocks (double-alloc)")
        self._owned[slot] = []
        self._adopted[slot] = set()
        self._bs_acc[slot] = 0.0
        self._bs_sh_acc[slot] = 0.0
        self._bs_t[slot] = self._clock()

    def alloc(self, slot: int, n_blocks: int) -> list[int]:
        """Give ``slot`` its first ``n_blocks`` blocks (admission)."""
        if slot in self._owned:
            raise RuntimeError(f"slot {slot} already owns blocks (double-alloc)")
        if n_blocks > self.blocks_per_slot:
            raise ValueError(f"slot {slot} asked for {n_blocks} > {self.blocks_per_slot} blocks")
        if len(self._free) < n_blocks:
            raise NoFreeBlocks(f"need {n_blocks} blocks, {len(self._free)} free")
        self.begin(slot)
        return self.extend(slot, n_blocks)

    def _changed(self) -> None:
        self._dev_tables = {}

    def _acquire_ref(self, b: int) -> None:
        """One more holder of ``b``, reviving it off the free list if it had
        none (a cached prefix block shared again)."""
        if self._refcnt[b] == 0:
            try:
                self._free.remove(b)
            except ValueError:
                raise RuntimeError(f"corrupt refcount: block {b} has no holder but is not free") from None
        self._refcnt[b] += 1

    def _release_ref(self, b: int) -> None:
        """One holder of ``b`` fewer; the last one puts it back on the free
        list (at the bottom where the prefix index still names it)."""
        if self._refcnt[b] < 1:
            raise RuntimeError(f"corrupt refcount: block {b} released below zero")
        self._refcnt[b] -= 1
        if self._refcnt[b]:
            return
        if b in self._free:
            raise RuntimeError(f"corrupt free list: block {b}")
        if self.cached_hook is not None and self.cached_hook(b):
            self._free.insert(0, b)
        else:
            self._free.append(b)

    def adopt(self, slot: int, blocks: Iterable[int]) -> list[int]:
        """Map already written physical blocks (a prefix match) into
        ``slot``'s table after :meth:`begin`, one more holder each."""
        owned = self._owned.get(slot)
        if owned is None:
            raise RuntimeError(f"slot {slot} owns nothing; begin first")
        blocks = [int(b) for b in blocks]
        if len(owned) + len(blocks) > self.blocks_per_slot:
            raise ValueError(
                f"slot {slot} would exceed blocks_per_slot ({len(owned)} + {len(blocks)} > {self.blocks_per_slot})"
            )
        self._integrate(slot)
        adopted = self._adopted.setdefault(slot, set())
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"cannot adopt physical block {b}")
            if b in adopted or b in owned:
                raise RuntimeError(f"slot {slot} already holds block {b} (double-adopt)")
            self._acquire_ref(b)
            self._table[slot, len(owned)] = b
            owned.append(b)
            adopted.add(b)
        if blocks:
            self._changed()
        return blocks

    def pin(self, block: int) -> None:
        """Hold ``block`` alive with no slot owner: the copy-on-write source
        across one prefill, so an extend cannot hand it out as fresh."""
        b = int(block)
        if not 0 < b < self.num_blocks:
            raise ValueError(f"cannot pin physical block {b}")
        self._acquire_ref(b)
        self._pinned[b] += 1

    def unpin(self, block: int) -> None:
        b = int(block)
        if self._pinned[b] < 1:
            raise RuntimeError(f"block {b} is not pinned")
        self._pinned[b] -= 1
        if not self._pinned[b]:
            del self._pinned[b]
        self._release_ref(b)

    def extend(self, slot: int, n_blocks: int = 1) -> list[int]:
        """Grow ``slot`` by ``n_blocks`` fresh blocks; each pop fires
        ``reuse_hook`` before the slot overwrites the block."""
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
        self._integrate(slot)
        got = []
        for _ in range(n_blocks):
            b = self._free.pop()
            self._refcnt[b] = 1
            if self.reuse_hook is not None:
                self.reuse_hook(b)
            self._table[slot, len(owned)] = b
            owned.append(b)
            got.append(b)
        if got:
            self._changed()
        return got

    def shrink(self, slot: int, keep_blocks: int) -> list[int]:
        """Let go of ``slot``'s blocks past its first ``keep_blocks``
        (speculative decode's rejected window tail); their table entries
        go back to trash. Returns the ids let go."""
        owned = self._owned.get(slot)
        if owned is None:
            raise RuntimeError(f"slot {slot} owns nothing; alloc first")
        if keep_blocks < 1:
            raise ValueError(f"keep_blocks must be >= 1, got {keep_blocks} (release() frees a slot outright)")
        self._integrate(slot)
        adopted = self._adopted.get(slot)
        dropped = []
        while len(owned) > keep_blocks:
            b = owned.pop()
            if adopted:
                adopted.discard(b)
            self._release_ref(b)
            self._table[slot, len(owned)] = TRASH_BLOCK
            dropped.append(b)
        if dropped:
            self._changed()
        return dropped

    def release(self, slot: int) -> list[int]:
        """Drop all of ``slot``'s holds and reset its row to trash; blocks
        shared with other holders stay theirs."""
        owned = self._owned.pop(slot, None)
        if owned is None:
            raise RuntimeError(f"slot {slot} owns nothing (double-free)")
        self._adopted.pop(slot, None)
        self._bs_acc.pop(slot, None)
        self._bs_sh_acc.pop(slot, None)
        self._bs_t.pop(slot, None)
        for b in owned:
            self._release_ref(b)
        self._table[slot, :] = TRASH_BLOCK
        self._changed()
        return owned

    def block_row(self, slot: int, width: int) -> np.ndarray:
        """``slot``'s physical ids padded with trash to ``width`` entries
        (the prefill scatter's index vector)."""
        owned = self._owned.get(slot, ())
        row = np.full((width,), TRASH_BLOCK, np.int32)
        n = min(len(owned), width)
        row[:n] = owned[:n]
        return row

    def device_table(self, device, extra_cols: int = 0) -> torch.Tensor:
        """The block table as an int32 tensor on ``device`` (copied only
        after a mutation, never per decode step), with ``extra_cols`` trash
        columns appended: the verify window's positions past a slot's row
        (a stream within ``k`` of ``max_len``) then resolve to the trash
        block instead of an out-of-range index. Cached per width."""
        key = (torch.device(device), extra_cols)
        if key not in self._dev_tables:
            table = np.concatenate(
                [self._table, np.full((self.num_slots, extra_cols), TRASH_BLOCK, np.int32)], axis=1
            )
            self._dev_tables[key] = torch.from_numpy(table).to(device)
        return self._dev_tables[key]

    def check(self) -> None:
        """Invariant sweep: counting multiplicity, free, owned and pinned
        partition the non-trash blocks exactly (every refcount equals its
        holders, a free block has none, none is lost), and every owned list
        matches its table row."""
        holders: Counter = Counter(self._pinned)
        for slot, blocks in self._owned.items():
            if len(set(blocks)) != len(blocks):
                raise AssertionError(f"slot {slot} holds a block twice: {blocks}")
            holders.update(blocks)
            if list(self._table[slot, : len(blocks)]) != blocks:
                raise AssertionError(f"slot {slot} table row disagrees with owned {blocks}")
            if np.any(self._table[slot, len(blocks):] != TRASH_BLOCK):
                raise AssertionError(f"slot {slot} table row has stale entries")
            if not self._adopted.get(slot, set()) <= set(blocks):
                raise AssertionError(f"slot {slot} adopted set escapes its owned list")
        free = set(self._free)
        if len(free) != len(self._free) or not all(0 < b < self.num_blocks for b in free):
            raise AssertionError("corrupt free list")
        for b in range(self.num_blocks):
            if int(self._refcnt[b]) != holders[b]:
                raise AssertionError(f"block {b} refcount {int(self._refcnt[b])} != {holders[b]} holders")
            if b and (holders[b] == 0) != (b in free):
                raise AssertionError(f"block {b} is both free and held, or neither (a leak)")
        if holders[TRASH_BLOCK]:
            raise AssertionError("trash block allocated")
