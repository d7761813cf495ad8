"""The prefix cache against ``consensusml_tpu.serve.pool``: the suffix
prefill over adopted blocks (a partial match and a full match's
copy-on-write), the refcounted block pool and the prefix index over one
scripted sequence of operations; then the port's prefix-cached engine
against its own uncached one.

- ``make_prefix_prefill_fn``: the first token (exact), the last logits
  and the pages it writes (f32, 2e-5 of max|value|), GPT-2 and
  ``llama_tiny``, from the same numpy pages on both sides;
- ``BlockPool`` and ``PrefixIndex``: after every operation the same
  owned lists, free list (its order too), refcounts, table, shared
  blocks, index entries and lookups, block for block;
- a prefix-cached engine serves the uncached engine's streams, greedy and
  sampled, through hits, a full-match hit's copy-on-write and a draft.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.serve import decode as jdecode
from consensusml_tpu.serve.pool import blocks as jblocks
from consensusml_tpu.serve.pool import prefix as jprefix
from consensusml_tpu.serve.pool import stages as jstages
from consensusml_tpu_torch.serve import Engine, ServeConfig
from consensusml_tpu_torch.serve import pool as P
from consensusml_tpu_torch.serve.decode import DecodeModel
from test_torch_spec_decode import models, random_pages, rel_err

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPT = list(np.random.default_rng(1).integers(0, 256, size=21))


# (prompt length, suffix start, the slot's block row, cow source, cow target):
# a 21-token prompt whose first 16 (two blocks) are cached, and a 16-token
# prompt matched whole, recomputing its last token into a copy of block 2
CASES = {"partial": (21, 16, [1, 2, 3, 0, 0, 0, 0, 0], 0, 0), "cow": (16, 15, [1, 4, 5, 0, 0, 0, 0, 0], 2, 4)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_prefix_prefill_matches_reference(family, case):
    """The suffix prefill from the same pages (the cached prefix in blocks
    1 and 2) on both sides: the same first token, last logits and pages;
    with copy-on-write, the shared block untouched and its copy holding
    the recomputed row."""
    n, start, row, cow_src, cow_dst = CASES[case]
    jmodel, params, tmodel = models(family, "f32", seed=21)
    pages = random_pages(family, 9, 8, seed=22)
    bucket = 8
    block_row = np.array(row + [0] * (bucket // 8), np.int32)  # the bucket's trash columns
    ids = np.zeros((1, bucket), np.int32)
    ids[0, : n - start] = PROMPT[start:n]
    samp = (0.0, 1.0, 0)
    tok_w, last_w, pages_w = jstages.make_prefix_prefill_fn(jdecode.DecodeModel.wrap(jmodel))(
        params, [{k: jnp.asarray(v) for k, v in pg.items()} for pg in pages], jnp.asarray(ids),
        jnp.int32(n - start), jnp.int32(start), jnp.asarray(block_row), jnp.int32(cow_src), jnp.int32(cow_dst),
        jnp.float32(0.0), jnp.float32(1.0), jnp.uint32(0))
    tpages = [{k: torch.from_numpy(v.copy()) for k, v in pg.items()} for pg in pages]
    fn = P.make_prefix_prefill_fn(DecodeModel.wrap(tmodel), attn_impl="torch")
    tok, last = fn(tpages, torch.from_numpy(ids).long(), n - start, start, torch.from_numpy(block_row), cow_src,
                   cow_dst, *samp)
    assert int(tok) == int(tok_w)
    assert rel_err(last, last_w) <= 2e-5
    for tp, wp, src in zip(tpages, pages_w, pages):
        for key in ("k", "v"):
            assert rel_err(tp[key][1:], np.asarray(wp[key])[1:]) <= 2e-5
            if cow_src:
                np.testing.assert_array_equal(tp[key][cow_src].numpy(), src[key][cow_src])
                np.testing.assert_array_equal(tp[key][cow_dst, :7].numpy(), src[key][cow_src, :7])


def _pools():
    """The reference's pool and index and the port's, hooked alike."""
    out = []
    for blocks, prefix in ((jblocks, jprefix), (P.blocks, P.prefix)):
        pool, index = blocks.BlockPool(3, 32, 8, num_blocks=10), prefix.PrefixIndex(8)
        pool.reuse_hook, pool.cached_hook = index.invalidate_block, index.cached
        out.append((pool, index))
    return out


A = list(range(100, 124))  # three blocks
B = A[:16] + [7] * 8  # shares A's first two blocks
SCRIPT = [
    ("alloc", 0, 4), ("insert", "t", 0, A, 0), ("lookup", "t", 0, B), ("lookup", "u", 0, B),
    ("begin", 1), ("adopt", 1, [1, 2]), ("pin", 3), ("extend", 1, 2), ("unpin", 3), ("insert", "t", 0, B, 1),
    ("release", 0), ("lookup", "t", 0, A), ("alloc", 2, 3), ("shrink", 1, 3), ("extend", 1, 1),
    ("release", 1), ("lookup", "t", 0, B), ("begin", 0), ("adopt", 0, [1, 2]), ("extend", 0, 2),
    ("drop_stale", 1), ("release", 2), ("release", 0), ("alloc", 1, 4), ("alloc", 2, 4), ("lookup", "t", 1, A),
]


def _step(pool, index, op):
    name, *args = op
    if name == "insert":
        tenant, gen, ids, slot = args
        return index.insert(tenant, gen, ids, pool.owned(slot))
    if name == "lookup":
        return index.lookup(*args)
    if name == "drop_stale":
        return index.drop_stale(*args)
    return getattr(pool, name)(*args)


def _view(pool, index):
    return {"owned": {s: pool.owned(s) for s in range(3)}, "free": list(pool._free),
            "refcnt": [pool.refcount(b) for b in range(pool.num_blocks)], "table": pool._table.tolist(),
            "shared": pool.shared_blocks, "used": pool.used_blocks, "entries": len(index),
            "indexed": index.indexed_blocks, "invalidations": index.invalidations}


def test_pool_and_index_match_reference_block_for_block():
    """One scripted sequence (alloc, adopt of a prefix match, a pinned
    copy-on-write source, shrink, release down to cached-free blocks
    revived by a hit, a generation's stale entries dropped, recycling that
    invalidates entries) through both packages: every result and every
    state the same, and the invariant sweep passes throughout."""
    (jpool, jindex), (tpool, tindex) = _pools()
    for op in SCRIPT:
        assert _step(tpool, tindex, op) == _step(jpool, jindex, op), op
        assert _view(tpool, tindex) == _view(jpool, jindex), op
        tpool.check()
    for slot in (1, 2):
        tpool.release(slot)
    tpool.check()
    assert tpool.free_blocks == tpool.usable_blocks


def test_pool_refuses_misuse():
    """Double begin, adopting the trash block or a block twice, unpinning
    what is not pinned, shrinking to nothing."""
    pool = P.BlockPool(2, 32, 8)
    pool.alloc(0, 2)
    with pytest.raises(RuntimeError):
        pool.begin(0)
    pool.begin(1)
    for bad in ([P.TRASH_BLOCK], [1, 1]):
        with pytest.raises((ValueError, RuntimeError)):
            pool.adopt(1, bad)
    with pytest.raises(RuntimeError):
        pool.unpin(5)
    with pytest.raises(ValueError):
        pool.shrink(0, 0)
    table = pool.device_table("cpu", 2)
    assert table.shape == (2, 6) and not table[:, 4:].any()


PROMPTS = [list(range(10, 34)), list(range(10, 26)), list(range(10, 26)) + [5, 6, 7], [9] * 5, list(range(10, 26))]


def _streams(model, sampled, spec_k=0, **cfg):
    draft = P.SpecConfig(model=copy.deepcopy(model), k=spec_k) if spec_k else None
    eng = Engine(copy.deepcopy(model), ServeConfig(num_slots=2, block_size=8, **cfg), device="cpu", spec_decode=draft)
    with eng:
        out = []
        for i, p in enumerate(PROMPTS):  # one at a time: each admission sees the earlier ones' entries
            kw = {"temperature": 0.8, "seed": 7 + i} if sampled else {}
            out.append(eng.submit(p, 8, **kw).result(timeout=120).tokens)
        return out, eng.stats()


@pytest.mark.parametrize("family,sampled,spec_k", [("gpt2", False, 0), ("gpt2", True, 0), ("llama", False, 0),
                                                   ("gpt2", True, 2)])
def test_prefix_cached_engine_serves_the_uncached_streams(family, sampled, spec_k):
    """Prompts that share 16 tokens (two blocks), one matched whole (a
    copy-on-write hit, twice) and one that matches nothing: the cached
    engine's streams are the uncached engine's; it hits, copies on write
    and computes fewer prefill tokens."""
    _j, _p, tmodel = models(family, "f32", seed=31)
    want, base = _streams(tmodel, sampled, spec_k)
    got, st = _streams(tmodel, sampled, spec_k, prefix_cache=True)
    assert got == want
    pc = st["prefix_cache"]
    assert pc["hits"] == 3 and pc["misses"] == 2 and pc["cow_copies"] == 2 and pc["hit_blocks"] == 6
    assert st["prefill_tokens_computed"] < base["prefill_tokens_computed"]
