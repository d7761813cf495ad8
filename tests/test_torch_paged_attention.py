"""Fused paged attention: the port's plain version (what the CPU runs)
against the JAX Pallas kernel in interpret mode and against the JAX
gather path, on the same numpy pages, tables and positions.

f32 agrees to 1e-5 (summation order only). In bf16 the probabilities
and the output are rounded to bf16 after f32 sums taken in another order,
so outputs differ by at most about one bf16 ulp: 1.6e-2 absolute on
outputs of order 1.

The CUDA kernel has no CPU mode: ``tests/test_torch_cuda.py`` holds it
against the plain version on the card. Here its launch plan
(``paged_plan``) is held to cover every attended key exactly once for
every kv head (a cluster a slot and head group), to be the plan it was
at GPT-2-medium's heads, and to take Llama-2-7B's (H 32, D 128) at 4096
tokens; and an emulation of its split arithmetic (each block's max and
sum over its pages, the slot's max and sum over the blocks in rank
order, bf16 probabilities from the slot's sum, each block's f32 P V,
folded in rank order) is held to the JAX kernel in interpret mode, in
bf16 at the tolerance above. The head groups do not enter the emulation:
every value the kernel computes belongs to one (row, head) or one output
element, whichever block of its cluster holds the head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models import paged_attention as jpa
from consensusml_tpu_torch.models import paged_attention as tpa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=0.0, atol=1.6e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, s=3, w=1, h=4, hkv=4, d=16, bs=4, nb=5):
    """Pages with non-finite junk in the trash block, a table whose free
    lane is all-trash, and per-row last positions (one row uses its
    whole table)."""
    rng = np.random.default_rng(seed)
    n = s * nb + 1
    k = rng.normal(size=(n, bs, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n, bs, hkv, d)).astype(np.float32)
    k[0] = np.inf  # trash junk must never reach a live row's scores
    perm = rng.permutation(np.arange(1, n))
    table = perm[: s * nb].reshape(s, nb).astype(np.int32)
    table[-1] = 0  # free lane
    last = np.array([nb * bs - 1, 6] + [0] * (s - 2), np.int32)[:s]
    positions = np.maximum(last[:, None] - (w - 1) + np.arange(w)[None, :], 0).astype(np.int32)
    q = rng.normal(size=(s, w, h, d)).astype(np.float32)
    return q, k, v, table, positions


def _jax(q, k, v, table, positions, name, impl):
    jdt = DT[name][0]
    args = (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(table))
    if q.shape[1] == 1:
        out = jpa.fused_paged_attention(
            *args, lengths=jnp.asarray(positions[:, 0] + 1), dtype=jdt, impl=impl
        )
    else:
        out = jpa.fused_paged_attention_window(
            *args, positions=jnp.asarray(positions), dtype=jdt, impl=impl
        )
    return np.asarray(out, np.float32)


def _port(q, k, v, table, positions, name, impl):
    tdt = DT[name][1]
    args = (
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        torch.from_numpy(table),
    )
    if q.shape[1] == 1:
        out = tpa.fused_paged_attention(
            *args, lengths=torch.from_numpy(positions[:, 0] + 1), dtype=tdt, impl=impl
        )
    else:
        out = tpa.fused_paged_attention_window(
            *args, positions=torch.from_numpy(positions), dtype=tdt, impl=impl
        )
    return out.float().numpy()


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize(
    "w,h,hkv", [(1, 4, 4), (4, 4, 4), (1, 4, 2), (4, 4, 2)], ids=["w1", "w4", "w1-gqa2", "w4-gqa2"]
)
def test_plain_matches_jax_interpret_and_gather(name, w, h, hkv):
    case = _case(seed=10 * w + hkv, w=w, h=h, hkv=hkv)
    live = slice(0, 2)  # the free lane's output is garbage by design
    got = _port(*case, name, impl="auto")
    assert np.isfinite(got[live]).all()
    for jimpl in ("interpret", "gather"):
        want = _jax(*case, name, impl=jimpl)
        np.testing.assert_allclose(got[live], want[live], **TOL[name])


# the serving check's lengths (chip_smoke.py): 8 slots, 64 pages of 16
CHECK_LENGTHS = (1, 17, 511, 1024, 100, 300, 700, 64)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("w", [1, 4])
def test_plain_matches_jax_interpret_at_the_check_shapes(name, w):
    """``paged_attention_plain`` (f64 dot products and softmax sum, each
    rounded once to f32: the card's comparison baseline) against the JAX
    kernel in interpret mode (f32 sums) at the serving check's shapes: 8
    slots of 64 pages of 16, 16 heads, head dim 64, its ragged lengths.
    f32 at the file's 1e-5 (the worst error, W = 1 and 4, is 0.03 of it),
    bf16 at one bf16 ulp."""
    s, h, d, bs, nb = 8, 16, 64, 16, 64
    rng = np.random.default_rng(70 + w)
    n = s * nb + 1
    k, v = (rng.normal(size=(n, bs, h, d)).astype(np.float32) for _ in range(2))
    table = (rng.permutation(n - 1)[: s * nb] + 1).reshape(s, nb).astype(np.int32)
    positions = np.maximum(np.array(CHECK_LENGTHS)[:, None] - w + np.arange(w)[None, :], 0).astype(np.int32)
    q = rng.normal(size=(s, w, h, d)).astype(np.float32)
    jdt, tdt = DT[name]
    want = np.asarray(jpa._fused_call(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                      jnp.asarray(table), jnp.asarray(positions), jdt, interpret=True), np.float32)
    got = tpa.paged_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(table),
                                    torch.from_numpy(positions), dtype=tdt).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[name])


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("w", [1, 4])
def test_subnormal_kv_head_flushes_as_the_reference(name, w):
    """The reference's compiled program reads a subnormal operand as zero
    and flushes a subnormal result: with kv head 1's V at 1e-39, the JAX
    kernel (``_fused_call`` in interpret mode, jitted) gives 0 for the
    query heads that read it (unflushed, ~5e-40); the plain version gives
    the same zeros, and the other heads at the file's tolerances."""
    s, h, hkv, d, bs, nb = 3, 4, 2, 16, 4, 5
    q, k, v, table, positions = _case(seed=30 + w, s=s, w=w, h=h, hkv=hkv, d=d, bs=bs, nb=nb)
    k[0] = 0.0  # no junk: every slot's row is live here
    table[-1] = table[0]
    v[:, :, 1] *= np.float32(1e-39)
    jdt, tdt = DT[name]
    want = np.asarray(jax.jit(jpa._fused_call, static_argnums=(5,), static_argnames=("interpret",))(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(table),
        jnp.asarray(positions), jdt, interpret=True), np.float32)
    got = tpa.paged_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(table),
                                    torch.from_numpy(positions), dtype=tdt).float().numpy()
    flushed = slice(h // hkv, h)  # the query heads of kv head 1
    assert not want[:, :, flushed].any() and not got[:, :, flushed].any()
    assert np.abs(got[:, :, : h // hkv]).min() > 0
    np.testing.assert_allclose(got, want, **TOL[name])


def _covered(plan, bs, nb, last, hkv):
    """Per kv head and window row, how many blocks read each key 0 .. nb *
    bs - 1."""
    hits = np.zeros((hkv, len(last), nb * bs), np.int32)
    for kv0, kv1, rows in tpa.paged_block_keys(plan, bs, nb, last, hkv):
        assert kv1 - kv0 == plan.kv_heads
        for w, (k0, k1) in enumerate(rows):
            hits[kv0:kv1, w, k0:k1] += 1
    return hits


def _assert_covered_once(plan, bs, nb, last, hkv):
    hits = _covered(plan, bs, nb, last, hkv)
    for i, lw in enumerate(last):
        assert (hits[:, i, : lw + 1] == 1).all() and not hits[:, i, lw + 1:].any(), (nb, last, i)


@pytest.mark.parametrize("w", [1, 4, 8])
def test_plan_covers_every_attended_key_once(w):
    """At the check's ragged lengths, at length 1 and at the longest cache
    the kernel takes (GPT-2-medium's heads: whole pages a block, and past
    that cache's end, fewer kv heads a block), every key up to each window
    row's position is read for every kv head by exactly one block of its
    slot, and no key past it by any."""
    bs, h, d = 16, 16, 64
    nb_max = tpa.paged_max_blocks(bs, h, d, w, h)
    nb_whole = tpa.paged_max_blocks(bs, h, d, w, h, kv_heads=h)
    assert nb_max >= nb_whole >= 64 and tpa.paged_plan(64, bs, h, d, w, h).splits == 16
    assert tpa.paged_plan(nb_whole, bs, h, d, w, h).kv_heads == h
    assert tpa.paged_plan(nb_whole + 1, bs, h, d, w, h).kv_heads < h
    with pytest.raises(ValueError):
        tpa.paged_plan(nb_max + 1, bs, h, d, w, h)
    cases = [(64, length) for length in CHECK_LENGTHS] + [
        (nb, length) for nb in (nb_whole, nb_max) for length in (1, nb * bs, 4321)]
    for nb, length in cases:
        plan = tpa.paged_plan(nb, bs, h, d, w, h)
        assert plan.splits <= 16 and (plan.splits - 1) * plan.pages < nb <= plan.splits * plan.pages
        _assert_covered_once(plan, bs, nb, [max(0, length - w + i) for i in range(w)], h)


@pytest.mark.parametrize("w", [9, 16, 24, 64, 1024])
def test_window_tiles_cover_every_attended_key_once(w):
    """Past 8 rows the plan cuts the window into tiles of the most rows
    (at most 8) that divide it: every key up to each row's position is
    read for every kv head by exactly one block of the row's tile, no key
    past it by any, and no block of a tile reads a key past the largest
    position of its tile's rows (GPT-2-medium's heads, a 1024-token cache,
    a window starting at 0 and one reaching past the cache's end)."""
    bs, h, d, nb = 16, 16, 64, 64
    plan = tpa.paged_plan(nb, bs, h, d, w, h)
    assert plan.rows == max(t for t in range(1, 9) if w % t == 0) and plan.kv_heads == h
    for start in (0, 500, nb * bs - 3):
        last = [start + i for i in range(w)]
        _assert_covered_once(plan, bs, nb, [min(p, nb * bs - 1) for p in last], h)
        for kv0, _kv1, rows in tpa.paged_block_keys(plan, bs, nb, last, h):
            tiles = {i // plan.rows for i, (k0, k1) in enumerate(rows) if k1 > k0}
            assert len(tiles) <= 1
            for t in tiles:
                top = min(max(last[t * plan.rows: (t + 1) * plan.rows]), nb * bs - 1)
                assert all(k1 <= top + 1 for k0, k1 in rows)


# the serving check's plans at GPT-2-medium's heads (16 of 64, 16-token
# pages, 64 a slot), as they were before head groups: (pages, splits,
# ring, smem) at W = 1 .. 8
GPT2_PLANS = {1: (4, 16, 2, 81296), 2: (4, 16, 2, 94864), 3: (4, 16, 2, 108432), 4: (4, 16, 2, 122000),
              5: (4, 16, 2, 135568), 6: (4, 16, 2, 149136), 7: (4, 16, 2, 162704), 8: (4, 16, 2, 176272)}
# the longest caches before head groups (tokens: paged_max_blocks x 16)
GPT2_LONGEST = {1: 46592, 4: 9728, 8: 3584}


@pytest.mark.parametrize("w", sorted(GPT2_PLANS))
def test_gpt2_medium_plan_is_unchanged(w):
    """At GPT-2-medium's heads a block holds all 16 (whole pages, one copy
    each), and the plan is the one before head groups: the same pages,
    splits, ring and shared memory, the same as the kernel's layout of
    the whole-page block."""
    plan = tpa.paged_plan(64, 16, 16, 64, w, 16)
    assert plan.kv_heads == 16 and plan[:4] == GPT2_PLANS[w]
    assert plan.smem == tpa.paged_smem(w, 16, 16, 64, 16, plan.pages, plan.ring)


@pytest.mark.parametrize("w", sorted(GPT2_LONGEST))
def test_longest_cache_is_no_shorter(w):
    """GPT-2-medium's longest cache: with whole pages a block exactly
    what it was, and with the plan free to give a block fewer kv heads
    longer (the cache past W > 1 that the cluster design had lost)."""
    whole = tpa.paged_max_blocks(16, 16, 64, w, 16, kv_heads=16) * 16
    assert whole == GPT2_LONGEST[w]
    assert tpa.paged_max_blocks(16, 16, 64, w, 16) * 16 >= 4 * whole


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("hkv,g", [(32, 8), (8, 2)], ids=["llama2-7b", "gqa-rep4"])
def test_plan_takes_llama_heads_at_4096_tokens(hkv, g, bs):
    """Llama-2-7B's heads (32 of dim 128; H * D = 4096) and a GQA case (32
    query heads on 8 kv heads) at every W in 1..8: a cache of 4096 tokens
    (512 pages of 8, 256 of 16) in 16 blocks a cluster, each block 8
    query heads (1024 dims: the P V stage's thread a (head, 4 dims)), and
    every attended key read once for every kv head."""
    h, d, nb = 32, 128, 4096 // bs
    for w in range(1, 9):
        plan = tpa.paged_plan(nb, bs, hkv, d, w, h)
        assert (plan.splits, plan.kv_heads, plan.pages) == (16, g, nb // 16)
        assert plan.kv_heads * (h // hkv) * d == 1024 and plan.smem <= 232448
        assert tpa.paged_max_blocks(bs, hkv, d, w, h) * bs >= 4096
        for length in (1, 777, 4096):
            _assert_covered_once(plan, bs, nb, [max(0, length - w + i) for i in range(w)], hkv)


@pytest.mark.parametrize("hkv", [32, 8])
def test_plain_matches_jax_interpret_at_llama_heads(hkv):
    """``paged_attention_plain`` against the JAX kernel (``_fused_call``
    in interpret mode) at Llama's head geometry: 32 query heads of dim
    128 on 32 or 8 kv heads, bf16, a slot at its last key, a short one and
    a free lane; at one bf16 ulp (the file's bf16 tolerance)."""
    s, w, h, d, bs, nb = 3, 1, 32, 128, 8, 3
    q, k, v, table, positions = _case(seed=90 + hkv, s=s, w=w, h=h, hkv=hkv, d=d, bs=bs, nb=nb)
    jdt, tdt = DT["bf16"]
    want = np.asarray(jpa._fused_call(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                                      jnp.asarray(table), jnp.asarray(positions), jdt, interpret=True), np.float32)
    got = tpa.paged_attention_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), torch.from_numpy(table),
                                    torch.from_numpy(positions), dtype=tdt).float().numpy()
    live = slice(0, 2)
    assert np.isfinite(got[live]).all()
    np.testing.assert_allclose(got[live], want[live], **TOL["bf16"])


def _emulate(q, k, v, table, positions, plan):
    """The kernel's arithmetic in torch ops, block by block of each slot's
    cluster: logits (f64 dot products rounded to f32), each block's max,
    the slot's max, exp and each block's f64 sum, the slot's sum in rank
    order rounded to f32, bf16 probabilities, each block's f32 P V, the
    blocks' partials folded in rank order, bf16."""
    s, w, h, d = q.shape
    bs, hkv = k.shape[1], k.shape[2]
    nb = table.shape[1]
    rep = h // hkv
    scale = torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(torch.tensor(float(d)))
    out = torch.empty(s, w, h, d, dtype=torch.bfloat16)
    for slot in range(s):
        rows = (table[slot].long()[:, None] * bs + torch.arange(bs)[None, :]).reshape(-1)
        ks = k.reshape(-1, hkv, d)[rows].float().repeat_interleave(rep, dim=1)  # (T, H, D)
        vs = v.reshape(-1, hkv, d)[rows].float().repeat_interleave(rep, dim=1)
        blocks = [rows for kv0, _kv1, rows in tpa.paged_block_keys(plan, bs, nb, positions[slot].tolist(), hkv)
                  if kv0 == 0]  # every head group's cluster reads these keys for its own heads
        for i in range(w):
            qi = q[slot, i].float()  # (H, D)
            spans = [blk[i] for blk in blocks]
            logits = [torch.einsum("hd,thd->ht", qi.double(), ks[k0:k1].double()).float() * scale
                      for k0, k1 in spans]
            bmax = [lg.max(1).values if lg.shape[1] else torch.full((h,), -np.inf) for lg in logits]
            m = torch.stack(bmax).max(0).values
            e = [torch.exp(lg - m[:, None]) for lg in logits]
            total = torch.zeros(h, dtype=torch.float64)
            for part in e:  # rank order
                total = total + part.double().sum(1)
            total = total.float()
            acc = torch.zeros(h, d)
            for (k0, k1), part in zip(spans, e):
                p = (part / total[:, None]).to(torch.bfloat16).float()
                acc = acc + torch.einsum("ht,thd->hd", p, vs[k0:k1])
            out[slot, i] = acc.to(torch.bfloat16)
    return out


@pytest.mark.parametrize("pages", [None, 3], ids=["plan", "3-pages"])
@pytest.mark.parametrize("w,hkv", [(1, 8), (4, 8), (1, 4), (4, 4), (1, 2), (4, 2), (16, 8), (12, 2)],
                         ids=["w1-rep1", "w4-rep1", "w1-rep2", "w4-rep2", "w1-rep4", "w4-rep4", "w16-rep1",
                              "w12-rep4"])
def test_split_arithmetic_matches_jax_interpret(w, hkv, pages):
    """The emulation of the kernel's split softmax and fold against the JAX
    kernel (``_fused_call`` in interpret mode) in bf16, at W 1 and 4 and
    GQA rep 1, 2 and 4, with the plan's 1 page a block (12 blocks) and
    with 3 (4 blocks); and past 8 rows, where the window is cut into
    tiles (16 rows in tiles of 8, 12 in tiles of 6)."""
    s, h, d, bs, nb = 4, 8, 16, 4, 12
    rng = np.random.default_rng(100 * w + hkv)
    n = s * nb + 1
    k, v = (rng.normal(size=(n, bs, hkv, d)).astype(np.float32) for _ in range(2))
    table = rng.permutation(np.arange(1, n))[: s * nb].reshape(s, nb).astype(np.int32)
    last = np.array([nb * bs - 1, 0, 21, 30], np.int32)
    positions = np.maximum(last[:, None] - (w - 1) + np.arange(w)[None, :], 0).astype(np.int32)
    q = rng.normal(size=(s, w, h, d)).astype(np.float32)
    plan = tpa.paged_plan(nb, bs, hkv, d, w, h, pages=pages)
    assert plan.splits == (12 if pages is None else 4) and plan.rows == (w if w <= 8 else 8 if w % 8 == 0 else 6)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = _emulate(tq, tk, tv, torch.from_numpy(table), torch.from_numpy(positions), plan).float().numpy()
    want = np.asarray(jpa._fused_call(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                                      jnp.asarray(v, jnp.bfloat16), jnp.asarray(table), jnp.asarray(positions),
                                      jnp.bfloat16, interpret=True), np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL["bf16"])


@pytest.mark.parametrize("seed", [6, 9])
@pytest.mark.parametrize("w", [1, 4])
def test_split_arithmetic_is_the_plain_versions_within_one_ulp(w, seed):
    """At the serving check's shapes (8 slots of 64 pages of 16, 16 heads,
    head dim 64, its ragged lengths), the emulation of the kernel's split
    arithmetic against ``paged_attention_plain`` at ``chip_smoke.py``'s
    gate (atol 1e-5, rtol 2**-7: one bf16 ulp). The logits and the
    softmax's sum are f64 sums rounded once on both sides, so the bf16
    probabilities agree and only the P V sums differ in order; with the
    sum taken in f32 in the blocks' order instead, a probability's bf16
    rounding flips now and then, and one flip near 1 moves its output by
    several ulps (it missed the gate on the card; at W = 4 and these two
    seeds, 1.6 and 1.1 of it)."""
    s, h, d, bs, nb = 8, 16, 64, 16, 64
    g = torch.Generator().manual_seed(seed)
    n = s * nb + 1
    k, v = (torch.randn(n, bs, h, d, generator=g).to(torch.bfloat16) for _ in range(2))
    table = (torch.randperm(n - 1, generator=g)[: s * nb] + 1).view(s, nb).to(torch.int32)
    lengths = torch.tensor(CHECK_LENGTHS)
    pos = torch.clamp(lengths[:, None] - w + torch.arange(w)[None, :], min=0).to(torch.int32)
    q = torch.randn(s, w, h, d, generator=g).to(torch.bfloat16)
    want = tpa.paged_attention_plain(q, k, v, table, pos).float()
    got = _emulate(q, k, v, table, pos, tpa.paged_plan(nb, bs, h, d, w, h)).float()
    assert float(((got - want).abs() / (1e-5 + 2.0**-7 * want.abs())).max()) <= 1.0


def test_plan_refuses_what_the_kernel_does_not_take():
    # no window rows; D not a multiple of 8; H not a multiple of Hkv; a
    # kv head whose 16 query heads of 128 dims exceed a block's 1024; a
    # window of 8 * 65536 rows (more tiles than the grid's third axis)
    for args in ((64, 16, 16, 64, 0, 16), (64, 16, 16, 60, 1, 16), (64, 16, 6, 64, 1, 16),
                 (64, 16, 2, 128, 1, 32), (64, 16, 16, 64, 8 * 65536, 16)):
        with pytest.raises(ValueError):
            tpa.paged_plan(*args)
    with pytest.raises(ValueError):  # 3 kv heads a block do not divide 32
        tpa.paged_plan(256, 16, 32, 128, 1, 32, kv_heads=3)
    with pytest.raises(ValueError):  # 64 pages in blocks of 2: 32 blocks, more than a cluster holds
        tpa.paged_plan(64, 16, 16, 64, 1, 16, pages=2)


def test_resolve_attention_impl():
    assert tpa.resolve_attention_impl("auto", "cpu") == "torch"
    assert tpa.resolve_attention_impl("auto", torch.device("cuda", 0)) == "cuda"
    assert tpa.resolve_attention_impl("torch", torch.device("cuda", 0)) == "torch"
    for unknown in ("gather", "pallas"):
        with pytest.raises(ValueError):
            tpa.resolve_attention_impl(unknown)


def test_wrapper_runs_plain_only_for_cpu_tensors():
    q, k, v, table, positions = _case(seed=3)
    args = [torch.from_numpy(x) for x in (q, k, v, table, positions)]
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(*args, dtype=torch.float32)
    want = tpa.paged_attention_plain(*args, dtype=torch.float32)
    torch.testing.assert_close(out, want, equal_nan=True)  # free lane: NaN from trash junk
    assert tpa.paged_attention.launches == before  # nothing was launched
