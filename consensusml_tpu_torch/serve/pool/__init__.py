"""Paged KV pool: block accounting and the prefill/decode stages."""

from consensusml_tpu_torch.serve.pool.blocks import (
    TRASH_BLOCK,
    BlockPool,
    NoFreeBlocks,
    blocks_for_tokens,
    init_pages,
)
from consensusml_tpu_torch.serve.pool.stages import (
    AdmissionScheduler,
    make_paged_decode_fn,
    make_paged_prefill_fn,
)

__all__ = [
    "TRASH_BLOCK",
    "BlockPool",
    "NoFreeBlocks",
    "blocks_for_tokens",
    "init_pages",
    "AdmissionScheduler",
    "make_paged_decode_fn",
    "make_paged_prefill_fn",
]
