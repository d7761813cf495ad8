"""Content-addressed prefix index over paged KV blocks (host side).

Port of ``consensusml_tpu/serve/pool/prefix.py``. Identical block-aligned
prompt prefixes (system prompts, templates, a preempted stream's own
history) prefill once; a later request maps the matched physical blocks
into its slot's table (:meth:`.blocks.BlockPool.adopt`) and prefills only
the unshared suffix.

**Hash scheme.** One digest a FULL block chunk: ``digest_i =
sha256(tokens[0 : (i + 1) * block_size])``, a running hash, so a chunk's
key commits to everything before it. Keys are ``(tenant, generation,
digest)``: tenants never share bytes, and entries minted under old
weights are unreachable after a hot swap (lookups key on the current
generation; :meth:`PrefixIndex.drop_stale` collects them).

**Residency.** An entry names a physical block, not a copy of its bytes:
the pool calls :meth:`PrefixIndex.invalidate_block` (its ``reuse_hook``)
the moment a fresh pop is about to recycle a block, so an id still in the
index holds the bytes its digest names. A free block may stay indexed
(nothing writes free blocks: free lanes write the trash block), and
adoption revives it; :meth:`PrefixIndex.cached` (the ``cached_hook``)
parks such blocks at the bottom of the free stack.

Engine-thread host state, like the pool: dict lookups at admission, no
device work.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["PrefixIndex"]


class PrefixIndex:
    """Maps ``(tenant, generation, chain digest)`` to a physical block."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self._chains: dict[tuple, int] = {}
        self._by_block: dict[int, set[tuple]] = {}
        self.invalidations = 0  # entries dropped by block reuse

    def __len__(self) -> int:
        return len(self._chains)

    @property
    def indexed_blocks(self) -> int:
        """Distinct physical blocks the index names."""
        return len(self._by_block)

    def _digests(self, ids) -> list[bytes]:
        """One running-hash digest a FULL block chunk of ``ids`` (a partial
        tail chunk is never indexed: its bytes change as the stream
        decodes)."""
        bs = self.block_size
        h = hashlib.sha256()
        out = []
        for i in range(len(ids) // bs):
            h.update(np.asarray(ids[i * bs: (i + 1) * bs], np.int64).tobytes())
            out.append(h.digest())
        return out

    def lookup(self, tenant: str, generation: int, ids) -> list[int]:
        """The physical blocks of the longest indexed block-aligned prefix
        of ``ids`` under ``(tenant, generation)``, in order; [] = none."""
        out: list[int] = []
        for d in self._digests(ids):
            b = self._chains.get((tenant, generation, d))
            if b is None:
                break
            out.append(b)
        return out

    def insert(self, tenant: str, generation: int, ids, blocks) -> int:
        """Index ``ids``'s full chunks against the blocks that hold them
        (``blocks[i]`` chunk ``i``). First writer wins. Returns the number
        of new entries."""
        added = 0
        for i, d in enumerate(self._digests(ids)):
            if i >= len(blocks):
                break
            key = (tenant, generation, d)
            if key in self._chains:
                continue
            b = int(blocks[i])
            self._chains[key] = b
            self._by_block.setdefault(b, set()).add(key)
            added += 1
        return added

    def invalidate_block(self, block: int) -> int:
        """Forget every entry naming ``block`` (the pool's ``reuse_hook``:
        its bytes are about to be overwritten). Returns the entries
        dropped."""
        keys = self._by_block.pop(int(block), None)
        if not keys:
            return 0
        for key in keys:
            self._chains.pop(key, None)
        self.invalidations += len(keys)
        return len(keys)

    def cached(self, block: int) -> bool:
        """Whether the index still names ``block`` (the pool's
        ``cached_hook``)."""
        return int(block) in self._by_block

    def drop_stale(self, current_generation: int) -> int:
        """Collect the entries of every other weight generation (hot swap).
        Returns the number dropped."""
        stale = [key for key in self._chains if key[1] != current_generation]
        for key in stale:
            b = self._chains.pop(key)
            keys = self._by_block.get(b)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_block[b]
        return len(stale)
