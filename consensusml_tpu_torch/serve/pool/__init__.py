"""Paged KV pool: refcounted block accounting, the prefix index, the
prefill/decode stages, speculative decode's stages and the hot swap."""

from consensusml_tpu_torch.serve.pool.blocks import (
    TRASH_BLOCK,
    BlockPool,
    NoFreeBlocks,
    blocks_for_tokens,
    init_pages,
)
from consensusml_tpu_torch.serve.pool.hotswap import GenerationWatcher, StagedSwap
from consensusml_tpu_torch.serve.pool.prefix import PrefixIndex
from consensusml_tpu_torch.serve.pool.spec import (
    SpecConfig,
    make_draft_propose_fn,
    make_verify_fn,
    spec_table_cols,
)
from consensusml_tpu_torch.serve.pool.stages import (
    AdmissionScheduler,
    make_paged_decode_fn,
    make_paged_prefill_fn,
    make_prefix_prefill_fn,
)

__all__ = [
    "TRASH_BLOCK",
    "BlockPool",
    "NoFreeBlocks",
    "blocks_for_tokens",
    "init_pages",
    "PrefixIndex",
    "AdmissionScheduler",
    "make_paged_decode_fn",
    "make_paged_prefill_fn",
    "make_prefix_prefill_fn",
    "GenerationWatcher",
    "StagedSwap",
    "SpecConfig",
    "make_draft_propose_fn",
    "make_verify_fn",
    "spec_table_cols",
]
