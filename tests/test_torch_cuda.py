"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU interpret mode)
and skip elsewhere. This file imports no JAX, so it runs on a machine
that has only PyTorch::

    python -m pytest tests/test_torch_cuda.py -q

Tolerances, element by element ``|kernel - plain| <= atol + rtol*|plain|``,
the same as ``chip_smoke.py``'s: both sides sum in f32 in different
orders and round to bf16, so a paged-attention output may land one bf16
ulp away (rtol 2**-7); the flash forward also sums over key tiles against
a running max and multiplies P V on the tensor cores with P in two bf16
halves, so it is allowed two (2**-6). The f32 logsumexp differs in
summation order only. The dq and dk/dv kernels (ds, and for dv p, in two
bf16 halves) are held to ``chip_smoke.py``'s backward gate, atol 3e-3 and
rtol 2**-6. The codec kernels (the
CHOCO encode and decode in the int8, int4 and fp8 formats, int8 and fp8
quantize/dequantize, chunked top-k, chunk scatter) are held bit for bit:
integer selection and one rounding per operation, subnormals flushed at
the same points (a NaN's payload bits aside).
The fused-BN normalize kernel and the backward's dx round every step as
their plain versions do, so they are held equal (dx given the kernel's
own sums); the statistics and the backward's two sums are taken in f32 in
another order, each per-channel sum held to 2e-6 of the sum of its terms'
magnitudes (``chip_smoke.py``'s ``BN_SUM_RTOL``). The int4 codec kernels
are held bit for bit. The fused-LN kernels sum each row in another order
than ``torch.mean`` (and ``rsqrtf`` is within 2 ulp), so y and dx are
held to 1e-5 of their row's largest element plus, in bf16, one bf16 ulp
of the element (``chip_smoke.py``'s ``LN_ROW_RTOL``), dgamma and dbeta
to 2e-6 of the sum of their terms' magnitudes (``LN_SUM_RTOL``).
"""

import pytest
import torch

from consensusml_tpu_torch.models import flash_attention as tfa
from consensusml_tpu_torch.models import paged_attention as tpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda", 0)


def _paged_case(dev, w, s=8, h=16, hkv=16, d=64, bs=16, nb=64, last=(1023, 16, 0, 1, 511, 700, 63, 0),
                free=True):
    gen = torch.Generator(device=dev).manual_seed(w)
    n = s * nb + 1
    k, v = (torch.randn(n, bs, hkv, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    k[0] = float("inf")  # trash junk: only the free lane may see it
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: s * nb] + 1).view(s, nb)
    table = table.to(torch.int32).contiguous()
    if free:
        table[-1] = 0  # the last slot is a free lane
    last = torch.tensor(last, device=dev)[:s]
    pos = torch.clamp(last[:, None] - (w - 1) + torch.arange(w, device=dev)[None, :], min=0)
    q = torch.randn(s, w, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
    return q, k, v, table, pos.to(torch.int32).contiguous()


# the serving check's ragged lengths (chip_smoke.py), one slot a length
CHECK_LAST = (0, 16, 510, 1023, 99, 299, 699, 63)


@pytest.mark.parametrize("w,hkv", [(1, 16), (4, 16), (8, 16), (1, 8), (4, 8), (2, 4), (8, 4)])
@pytest.mark.parametrize("last", [(1023, 16, 0, 1, 511, 700, 63, 0), CHECK_LAST], ids=["free-lane", "check"])
def test_paged_kernel_matches_plain(dev, w, hkv, last):
    """W up to 8 window rows, GQA rep 1, 2 and 4 (hkv 16, 8, 4 of 16 query
    heads), at ragged lengths; the free lane (table all trash, inf keys)
    is left out of the comparison."""
    q, k, v, table, pos = _paged_case(dev, w, hkv=hkv, last=last, free=last != CHECK_LAST)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(q, k, v, table, pos)
    ref = tpa.paged_attention_plain(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before + 1
    live = slice(0, 8 if last == CHECK_LAST else 7)
    assert torch.isfinite(out[live]).all()
    torch.testing.assert_close(out[live].float(), ref[live].float(), rtol=2.0**-7, atol=1e-5)
    assert torch.equal(out[live], tpa.paged_attention(q, k, v, table, pos)[live])  # a fixed-order fold


@pytest.mark.parametrize("w", [1, 4])
def test_paged_kernel_never_reads_past_positions(dev, w):
    """Every key past its row's position, in the attended pages and in
    whole pages past the last one, NaN in K and V: the kernel skips them,
    so its output has the same bits as on the clean pages (the plain
    version, which multiplies their zero probabilities into V, would not
    be finite) and the clean output matches the plain version."""
    q, k, v, table, pos = _paged_case(dev, w, last=CHECK_LAST, free=False)
    clean = tpa.paged_attention(q, k, v, table, pos)
    torch.testing.assert_close(clean.float(), tpa.paged_attention_plain(q, k, v, table, pos).float(),
                               rtol=2.0**-7, atol=1e-5)
    bs, nb = k.shape[1], table.shape[1]
    t = torch.arange(nb * bs, device=dev)
    past = t[None, :] > pos.max(1).values[:, None]  # (S, T): no window row attends these
    rows = table.long()[:, :, None] * bs + torch.arange(bs, device=dev)[None, None, :]
    dirty = rows.reshape(len(table), -1)[past]
    kn, vn = k.clone(), v.clone()
    kn.view(-1, *k.shape[2:])[dirty] = float("nan")
    vn.view(-1, *v.shape[2:])[dirty] = float("nan")
    out = tpa.paged_attention(q, kn, vn, table, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.equal(out, clean)


@pytest.mark.parametrize("w,kv_heads", [(1, 16), (4, 16), (4, None), (8, None)],
                         ids=["w1-whole-pages", "w4-whole-pages", "w4", "w8"])
def test_paged_kernel_at_the_longest_cache(dev, w, kv_heads):
    """The longest cache the plan takes at GPT-2-medium's heads (nb =
    paged_max_blocks), two slots of which one attends every key; one
    block more is refused. With whole pages a block (all 16 kv heads, the
    plan's choice up to that cache), and with the plan free to give a
    block fewer kv heads (it does past it): at W = 4 and 8, where that
    cache is 222,208 and 110,848 tokens (W = 1's, 856,576 tokens, would
    take the plain version ~50 GB)."""
    h, d, bs = 16, 64, 16
    nb = tpa.paged_max_blocks(bs, h, d, w, h, kv_heads=kv_heads)
    gen = torch.Generator(device=dev).manual_seed(5)
    k, v = (torch.randn(2 * nb + 1, bs, h, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    table = torch.arange(1, 2 * nb + 1, dtype=torch.int32, device=dev).view(2, nb)
    pos = torch.tensor([[nb * bs - 1], [37]], device=dev) - torch.arange(w - 1, -1, -1, device=dev)[None, :]
    pos = pos.to(torch.int32).contiguous()
    q = torch.randn(2, w, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
    plan = tpa.paged_plan(nb, bs, h, d, w, h, kv_heads=kv_heads)
    assert (plan.kv_heads == h) == (kv_heads == h)
    out = tpa.paged_attention(q, k, v, table, pos, plan=plan)
    ref = tpa.paged_attention_plain(q, k, v, table, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    del k, v, ref
    wide = torch.zeros(2, nb + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tpa.paged_plan(nb + 1, bs, h, d, w, h, kv_heads=kv_heads)
    if kv_heads is None:
        with pytest.raises(ValueError):
            tpa.paged_attention(q, *(torch.zeros(1, bs, h, d, device=dev, dtype=torch.bfloat16),) * 2, wide, pos)


@pytest.mark.parametrize("w", [1, 4])
def test_paged_kernel_flushes_a_subnormal_kv_head_as_plain(dev, w):
    """kv head 1's V at 1e-39 (bf16 subnormals), GQA rep 2: the kernel's
    .ftz multiply-adds read them as zeros, so the query heads of that kv
    head come out 0, as from the plain version (and the reference); the
    others at the paged gate."""
    q, k, v, table, pos = _paged_case(dev, w, hkv=8, last=CHECK_LAST, free=False)
    v[:, :, 1] = (v[:, :, 1].float() * 1e-39).to(torch.bfloat16)
    out = tpa.paged_attention(q, k, v, table, pos)
    ref = tpa.paged_attention_plain(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert not ref[:, :, 2:4].any() and not out[:, :, 2:4].any()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7, atol=1e-5)


# Llama-2-7B's cache at 4096 tokens, one slot a length: the longest
# attends every key of its 4096, one a whole number of pages, one a key
LLAMA_LAST = (4095, 0, 1, 2047, 3000, 16, 1234, 4000)


def _llama_case(dev, w, hkv, bs):
    """8 slots of 4096 tokens of Llama-2-7B's heads (32 query heads of dim
    128 on ``hkv`` kv heads) in ``bs``-token pages."""
    return _paged_case(dev, w, s=8, h=32, hkv=hkv, d=128, bs=bs, nb=4096 // bs, last=LLAMA_LAST, free=False)


@pytest.mark.parametrize("w,hkv,bs", [(1, 32, 16), (4, 32, 16), (8, 32, 16), (1, 32, 8), (4, 32, 8), (8, 32, 8),
                                      (1, 8, 16), (4, 8, 8), (8, 8, 16)])
def test_paged_kernel_at_llama_heads(dev, w, hkv, bs):
    """Llama-2-7B's heads (H 32, D 128: H * D 4096, so a cluster a head
    group of 8 query heads) and GQA (8 kv heads: 2 a block), W 1, 4 and
    8, 8- and 16-token pages, 4096 tokens a slot (one slot attends every
    one), at the paged gate; a launch counts as grouped, and the fold
    order is fixed."""
    q, k, v, table, pos = _llama_case(dev, w, hkv, bs)
    before, grouped = tpa.paged_attention.launches, tpa.paged_attention.grouped_launches
    out = tpa.paged_attention(q, k, v, table, pos)
    ref = tpa.paged_attention_plain(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert tpa.paged_plan(4096 // bs, bs, hkv, 128, w, 32).kv_heads < hkv
    assert tpa.paged_attention.launches == before + 1 and tpa.paged_attention.grouped_launches == grouped + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    assert torch.equal(out, tpa.paged_attention(q, k, v, table, pos))


@pytest.mark.parametrize("w,hkv", [(1, 32), (4, 8)])
def test_paged_kernel_at_llama_heads_never_reads_past_positions(dev, w, hkv):
    """At Llama's heads, every key past its row's position NaN in K and V
    (in the attended pages and in whole pages past them), and a free lane
    of inf keys: the head groups' row copies read none of them, so the
    live slots' outputs keep their bits."""
    q, k, v, table, pos = _llama_case(dev, w, hkv, 16)
    clean = tpa.paged_attention(q, k, v, table, pos)
    bs, nb = k.shape[1], table.shape[1]
    t = torch.arange(nb * bs, device=dev)
    past = t[None, :] > pos.max(1).values[:, None]
    rows = table.long()[:, :, None] * bs + torch.arange(bs, device=dev)[None, None, :]
    dirty = rows.reshape(len(table), -1)[past]
    kn, vn = k.clone(), v.clone()
    kn.view(-1, *k.shape[2:])[dirty] = float("nan")
    vn.view(-1, *v.shape[2:])[dirty] = float("nan")
    out = tpa.paged_attention(q, kn, vn, table, pos)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.equal(out, clean)


def _window_case(dev, w, hkv, h, d, nb, starts, bs=16, seed=0):
    """One suffix window a slot, as a prefix hit runs it: slot ``i``'s
    ``w`` rows at positions ``starts[i] .. starts[i] + w - 1`` of an
    ``nb``-page cache (rows past the cache read its last key), K/V of
    ``hkv`` heads, q of ``h``; the trash block holds inf."""
    s = len(starts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = s * nb + 1
    k, v = (torch.randn(n, bs, hkv, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(2))
    k[0] = float("inf")
    table = (torch.randperm(n - 1, generator=gen, device=dev)[: s * nb] + 1).view(s, nb).to(torch.int32).contiguous()
    pos = torch.tensor(starts, device=dev)[:, None] + torch.arange(w, device=dev)[None, :]
    q = torch.randn(s, w, h, d, generator=gen, device=dev, dtype=torch.bfloat16)
    return q, k, v, table, pos.to(torch.int32).contiguous()


# the window form's cases: (W, H, Hkv, D, pages a slot, the slots' window starts)
WINDOW_CASES = {
    "gpt2-w16": (16, 16, 16, 64, 64, (0, 512, 1000, 37)),
    "gpt2-w64": (64, 16, 16, 64, 64, (0, 512, 960, 100)),
    "gpt2-w1024": (1024, 16, 16, 64, 64, (0,)),
    "gpt2-w24": (24, 16, 16, 64, 64, (3, 1000)),
    "gqa-w128": (128, 16, 4, 64, 64, (0, 700)),
    "llama-w16": (16, 32, 32, 128, 256, (0, 4080, 2047)),
    "llama-w256": (256, 32, 32, 128, 256, (0, 3840, 1000)),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_paged_kernel_window_past_8_rows_matches_plain(dev, case):
    """The tiled form (W > 8: tiles of at most 8 rows on the grid's third
    axis) against the plain version at the paged gate, one launch a call
    counted as a window launch: GPT-2-medium's heads (whole pages) at the
    suffix buckets 16, 64 and 1024 of a 1024-token cache, a window that is
    not a power of two (tiles of 8), GQA, and Llama-2-7B's heads (head
    groups) at 16 and 256 rows of a 4096-token cache; slots whose windows
    run past the cache's end read its last key there. A fixed-order fold:
    a second call gives the same bits."""
    w, h, hkv, d, nb, starts = WINDOW_CASES[case]
    q, k, v, table, pos = _window_case(dev, w, hkv, h, d, nb, starts)
    plan = tpa.paged_plan(nb, 16, hkv, d, w, h)
    assert plan.rows <= 8 and w % plan.rows == 0 and (plan.kv_heads < hkv) == case.startswith("llama")
    before = dict(tpa.paged_attention.__dict__)
    out = tpa.paged_attention(q, k, v, table, pos)
    ref = tpa.paged_attention_plain(q, k, v, table, pos)
    torch.cuda.synchronize()
    assert tpa.paged_attention.launches == before["launches"] + 1
    assert tpa.paged_attention.window_launches == before["window_launches"] + 1
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    assert torch.equal(out, tpa.paged_attention(q, k, v, table, pos))


@pytest.mark.parametrize("case", ["gpt2-w64", "llama-w16"])
def test_paged_kernel_window_at_the_longest_cache(dev, case):
    """The tiled form at the longest cache its plan takes (nb =
    paged_max_blocks at the window's W), one slot attending every key in
    its last tile; one page more is refused."""
    w, h, hkv, d, _nb, _starts = WINDOW_CASES[case]
    bs = 16
    nb = tpa.paged_max_blocks(bs, hkv, d, w, h)
    q, k, v, table, pos = _window_case(dev, w, hkv, h, d, nb, (nb * bs - w,), seed=3)
    out = tpa.paged_attention(q, k, v, table, pos)
    ref = tpa.paged_attention_plain(q, k, v, table, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-7, atol=1e-5)
    with pytest.raises(ValueError):
        tpa.paged_plan(nb + 1, bs, hkv, d, w, h)


@pytest.mark.parametrize("case", ["gpt2-w64", "llama-w16"])
def test_paged_kernel_window_never_reads_past_a_tiles_positions(dev, case):
    """Every key past the largest position of the window's FIRST tile NaN
    in K and V: the first tile's blocks read none of them, so its rows
    keep their bits (the later tiles, which attend those keys, are not
    compared); and every key past the slot's last position NaN: the whole
    window keeps its bits."""
    w, h, hkv, d, nb, starts = WINDOW_CASES[case]
    q, k, v, table, pos = _window_case(dev, w, hkv, h, d, nb, starts[:2], seed=4)
    clean = tpa.paged_attention(q, k, v, table, pos)
    rows_a_tile = tpa.paged_plan(nb, 16, hkv, d, w, h).rows
    bs = k.shape[1]
    t = torch.arange(nb * bs, device=dev)
    blocks = table.long()[:, :, None] * bs + torch.arange(bs, device=dev)[None, None, :]
    for lim, keep in ((pos[:, :rows_a_tile].max(1).values, slice(0, rows_a_tile)), (pos.max(1).values, slice(None))):
        dirty = blocks.reshape(len(table), -1)[t[None, :] > lim[:, None]]
        kn, vn = k.clone(), v.clone()
        kn.view(-1, *k.shape[2:])[dirty] = float("nan")
        vn.view(-1, *v.shape[2:])[dirty] = float("nan")
        out = tpa.paged_attention(q, kn, vn, table, pos)
        torch.cuda.synchronize()
        assert torch.isfinite(out[:, keep]).all() and torch.equal(out[:, keep], clean[:, keep])


def _random_llama(dev, cfg, seed):
    """A port ``LlamaLM`` on the card with random weights: N(0, 1/fan_in)
    kernels and adapters, N(0, 1/hidden) embedding, unit norm scales."""
    from consensusml_tpu_torch.models.llama import LlamaLM

    model = LlamaLM(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 1.0 / p.shape[-1 if name.endswith(".embedding") else 0] ** 0.5, generator=gen)
    return model.eval().to_compute_dtype()


@pytest.mark.parametrize("scale", ["tiny", "two-layer-7b"])
def test_llama_decode_step_through_the_kernel_matches_plain(dev, scale):
    """One Llama prefill and decode step through the serving stages on the
    kernel tier against the plain tier, same weights and prompt:
    ``llama_tiny`` (GQA rep 2, head dim 16) with adapters, and Llama-2-7B's
    widths cut to 2 layers (32 heads of 128) with a 1000-token prompt, so
    the prefill runs the head-dim-128 flash forward and the step the
    grouped paged kernel. Logits within ``chip_smoke.py``'s serve gate
    (2.5e-2 of max|logit|); the paged kernel launched once a layer."""
    from consensusml_tpu_torch.models.flash_attention import flash_attention
    from consensusml_tpu_torch.models.llama import LlamaConfig
    from consensusml_tpu_torch.serve import pool as P
    from consensusml_tpu_torch.serve.decode import DecodeModel

    if scale == "tiny":
        cfg = LlamaConfig(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=128,
                          lora_rank=4)
        n, bucket = 37, 64
    else:
        cfg = LlamaConfig(layers=2, lora_rank=16)
        n, bucket = 1000, 1024
    dm = DecodeModel.wrap(_random_llama(dev, cfg, seed=1))
    bs = 16
    nb = cfg.max_len // bs
    prompt = torch.randint(0, cfg.vocab_size, (1, bucket), generator=torch.Generator().manual_seed(2)).to(dev)
    table = torch.zeros((2, nb), dtype=torch.int32, device=dev)
    table[0] = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)
    tokens = torch.tensor([7, 0], dtype=torch.int32, device=dev)
    positions = torch.tensor([n, 0], dtype=torch.int32, device=dev)
    samp = (torch.zeros(2, device=dev), torch.ones(2, device=dev), torch.zeros(2, dtype=torch.int64, device=dev))
    out = {}
    for impl in ("cuda", "torch"):
        pages = P.init_pages(dm, nb + 1, bs)
        flash0, paged0 = flash_attention.launches, tpa.paged_attention.launches
        row = table[0, : bucket // bs].long()
        _tok, last = P.make_paged_prefill_fn(dm, attn_impl=impl)(pages, prompt, n, row, 0.0, 1.0, 0)
        _next, logits = P.make_paged_decode_fn(dm, attn_impl=impl)(pages, table, tokens, positions, *samp)
        torch.cuda.synchronize()
        out[impl] = (last, logits[0], flash_attention.launches - flash0, tpa.paged_attention.launches - paged0)
    (gl, gd, gflash, gpaged), (wl, wd, wflash, wpaged) = out["cuda"], out["torch"]
    assert (gpaged, wpaged, wflash) == (cfg.layers, 0, 0)
    assert gflash == (cfg.layers if bucket * bucket > 512 * 512 else 0)
    for got, want in ((gl, wl), (gd, wd)):
        assert torch.isfinite(got).all() and got.shape == (cfg.vocab_size,)
        assert float((got - want).abs().max() / want.abs().max()) <= 2.5e-2


def test_paged_plan_shared_memory_is_the_kernels(dev):
    """The Python plan's shared-memory size is the kernel's own layout,
    whole pages a block (GPT-2-medium's heads) and head groups (Llama's)."""
    lib = tpa._lib()
    for w, h, hkv, d, bs, nb in ((1, 16, 16, 64, 16, 64), (4, 16, 8, 64, 16, 64), (8, 16, 4, 64, 16, 200),
                                 (1, 16, 2, 64, 16, 2), (1, 32, 32, 128, 16, 256), (8, 32, 32, 128, 8, 512),
                                 (4, 32, 8, 128, 16, 256), (4, 16, 16, 64, 16, 5000), (1024, 16, 16, 64, 16, 64),
                                 (256, 32, 32, 128, 16, 256), (24, 16, 4, 64, 16, 64)):
        p = tpa.paged_plan(nb, bs, hkv, d, w, h)
        assert lib.cml_paged_attention_smem_bytes(p.rows, h, hkv, d, bs, p.pages, p.ring, p.kv_heads) == p.smem


def test_paged_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v, table, pos = _paged_case(dev, 1)
    with pytest.raises(ValueError):
        tpa.paged_attention(q.float(), k, v, table, pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q, k, v, table.long(), pos)
    with pytest.raises(ValueError):
        tpa.paged_attention(q.transpose(0, 1), k, v, table, pos)
    with pytest.raises(ValueError):  # no window rows
        tpa.paged_attention(q[:, :0].contiguous(), k, v, table, pos[:, :0].contiguous())
    with pytest.raises(ValueError):  # positions of another window than q's
        tpa.paged_attention(q.expand(-1, 16, -1, -1).contiguous(), k, v, table, pos.expand(-1, 9).contiguous())
    lib = tpa._lib()  # the kernel's own refusals, nothing launched: tiles that do not cut W, a tile past 8 rows
    for w, wt in ((16, 3), (16, 16)):
        assert lib.cml_paged_attention_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(),
                                            pos.data_ptr(), q.data_ptr(), k.shape[0], 8, w, 16, 16, 64, 16, 64, 4,
                                            16, 2, 16, wt, 0.125, None) != 0


FLASH_CASES = [(s, causal) for s in (1, 63, 64, 65, 127, 200, 600, 1000, 1024) for causal in (True, False)]


def _flash_case(dev, s, q_scale, b=2, h=3, d=64):
    """q, k, v, do of shape (b, s, h, d) bf16; q times ``q_scale`` (x4
    sharpens the softmax rows, so the running max moves between key tiles
    and the rescale is exercised). b > 0 exercises the batch row offsets."""
    gen = torch.Generator(device=dev).manual_seed(s + int(q_scale))
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(4))
    return (q.float() * q_scale).to(torch.bfloat16), k, v, do


@pytest.mark.parametrize("s,causal", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, s, causal):
    """The forward kernel against ``flash_attention_plain``: one partial
    tile (S < 64), tile edges (63, 64, 65, 127), ragged tails and full
    tiles, causal and not, q x1 and x4, at chip_smoke.py's gates."""
    for q_scale in (1.0, 4.0):
        q, k, v, _ = _flash_case(dev, s, q_scale)
        before = tfa.flash_attention.launches
        out, lse = tfa.flash_attention(q, k, v, causal=causal, return_lse=True)
        ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == before + 1
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4, msg=f"q x{q_scale}")
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5, msg=f"q x{q_scale}")


@pytest.mark.parametrize("s,causal", FLASH_CASES)
def test_flash_dq_kernel_matches_plain(dev, s, causal):
    """The dq kernel alone against ``_bwd_plain_parts(...)[0]``, both fed the
    plain forward's logsumexp and delta, at chip_smoke.py's backward gate
    (atol 3e-3, rtol 2**-6)."""
    for q_scale in (1.0, 4.0):
        q, k, v, do = _flash_case(dev, s, q_scale)
        out, lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        delta = tfa._delta(out, do)
        before = tfa.flash_attention_bwd_dq.launches
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        ref = tfa._bwd_plain_parts(q, k, v, do, lse, delta, causal)[0]
        torch.cuda.synchronize()
        assert tfa.flash_attention_bwd_dq.launches == before + 1
        torch.testing.assert_close(dq.float(), ref.float(), rtol=2.0**-6, atol=3e-3, msg=f"q x{q_scale}")


@pytest.mark.parametrize("s,causal", FLASH_CASES)
def test_flash_dkv_kernel_matches_plain(dev, s, causal):
    """The dk/dv kernel alone against ``_bwd_plain_parts(...)[1:]``, both fed
    the plain forward's logsumexp and delta, at chip_smoke.py's backward
    gate (atol 3e-3, rtol 2**-6): the transposed products and the causal
    diagonal (keys as rows, queries as columns) at the tile edges."""
    for q_scale in (1.0, 4.0):
        q, k, v, do = _flash_case(dev, s, q_scale)
        out, lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
        delta = tfa._delta(out, do)
        before = tfa.flash_attention_bwd_dkv.launches
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
        ref_dk, ref_dv = tfa._bwd_plain_parts(q, k, v, do, lse, delta, causal)[1:]
        torch.cuda.synchronize()
        assert tfa.flash_attention_bwd_dkv.launches == before + 1
        torch.testing.assert_close(dk.float(), ref_dk.float(), rtol=2.0**-6, atol=3e-3, msg=f"dk, q x{q_scale}")
        torch.testing.assert_close(dv.float(), ref_dv.float(), rtol=2.0**-6, atol=3e-3, msg=f"dv, q x{q_scale}")


@pytest.mark.parametrize("s", [128, 1024])
def test_flash_kernels_flush_a_subnormal_head_as_plain(dev, s):
    """Head 1's V at 1e-39 (bf16 subnormals), causal: the forward, dq and
    dk/dv kernels flush what they store, so that head's out, dq and dk are
    0 as the plain versions' (and the reference's); dv and head 0 at the
    kernels' gates."""
    q, k, v, do = _flash_case(dev, s, 1.0, h=2)
    v[:, :, 1] = (v[:, :, 1].float() * 1e-39).to(torch.bfloat16)
    out, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = tfa._delta(ref, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True)
    want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, True)
    torch.cuda.synchronize()
    for name, got, plain in (("out", out, ref), ("dq", dq, want[0]), ("dk", dk, want[1])):
        assert not plain[:, :, 1].any() and not got[:, :, 1].any(), name
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    for name, got, plain in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        torch.testing.assert_close(got.float(), plain.float(), rtol=2.0**-6, atol=3e-3, msg=name)


@pytest.mark.parametrize("probe", ["q", "do"])
@pytest.mark.parametrize("s", [128, 1000])
def test_flash_kernels_read_subnormal_operands_as_zero(dev, probe, s):
    """bf16 subnormal operands whose products are normal (causal, 2 heads):
    probe ``q``, q at +-1e-39 against k at +-1e38 (logits +-0.1 where the
    tensor cores keep q); probe ``do``, dO at +-1e-38 against V at +-2e36
    (dp ~0.16 where they keep dO). The kernels flush every staged tile, so
    the forward (probe ``q``), dq (probe ``do``; in probe ``q`` dS K
    overflows) and dk/dv (both) match their plain versions, which read the
    subnormal operand as 0 as the reference does, at the kernels' gates.
    The backward kernels take the plain forward's lse and delta."""
    gen = torch.Generator(device=dev).manual_seed(s)
    rnd = lambda: torch.randn(1, s, 2, 64, generator=gen, device=dev)  # noqa: E731
    sign = lambda: torch.where(rnd() >= 0, 1.0, -1.0)  # noqa: E731
    q, k, v, do = (rnd().to(torch.bfloat16) for _ in range(4))
    if probe == "q":
        q, k = (sign() * 1e-39).to(torch.bfloat16), (sign() * 1e38).to(torch.bfloat16)
    else:
        do, v = (sign() * 1e-38).to(torch.bfloat16), (sign() * 2e36).to(torch.bfloat16)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = tfa._delta(ref, do)
    want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True)
    got = {"dk": (dk, want[1]), "dv": (dv, want[2])}
    if probe == "q":
        out, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    else:
        got["dq"] = (tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=True), want[0])
        assert not any(w.any() for w in want), "the plain version reads the subnormal dO as 0"
    torch.cuda.synchronize()
    for name, (g, w) in got.items():
        torch.testing.assert_close(g.float(), w.float(), rtol=2.0**-6, atol=3e-3, msg=name)


def test_flash_wrappers_refuse_misaligned_operands(dev):
    """TMA reads the operands: a view 8 bytes past a 16-byte boundary raises
    ``ValueError`` in the forward, dq and dk/dv wrappers, and launches
    nothing."""
    n = 64 * 2 * 64
    flat = torch.zeros(n + 8, dtype=torch.bfloat16, device=dev)
    bad = flat[4:4 + n].view(1, 64, 2, 64)  # contiguous, data_ptr % 16 == 8
    good = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=dev)
    stats = torch.zeros(1, 2, 64, device=dev)
    counts = (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError):
        tfa.flash_attention(good, bad, good)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(good, good, good, bad, stats, stats)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dkv(good, bad, good, good, stats, stats)
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == counts


def test_flash_refuses_kv_mask_and_other_head_dims(dev):
    """A kv_mask of another shape than (batch, seq) raises ``ValueError``
    (the backward wrappers take it only as a contiguous f32 (B, S) tensor
    on q's device, which the public function makes of any mask), and a head
    dim other than 64 ``NotImplementedError``; nothing launches."""
    q = torch.zeros(1, 64, 1, 64, dtype=torch.bfloat16, device=dev)
    stats = torch.zeros(1, 1, 64, device=dev)
    counts = (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, kv_mask=torch.ones(1, 63, device=dev))
    for bad in (torch.ones(1, 64, device=dev, dtype=torch.int32), torch.ones(1, 64), torch.ones(64, 2, device=dev).T):
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd_dq(q, q, q, q, stats, stats, kv_mask=bad)
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd_dkv(q, q, q, q, stats, stats, kv_mask=bad)
    q32 = torch.zeros(1, 64, 2, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q32, q32, q32)
    assert (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == counts


MASK_CASES = [(s, causal) for s in (1, 63, 65, 200, 513, 600, 1000, 1024) for causal in (True, False)]


def _kv_mask(dev, s, causal):
    """(4, s) f32 key masks: every key; the keys before 2s/3; none (a row
    that attends to no key); and a random half of the keys, or, causal, the
    keys from s/2 on (its queries before s/2 then attend to nothing)."""
    gen = torch.Generator(device=dev).manual_seed(s)
    pos = torch.arange(s, device=dev)
    last = pos >= s // 2 if causal else torch.rand(s, generator=gen, device=dev) < 0.5
    return torch.stack([pos < s, pos < (2 * s) // 3, pos < 0, last]).float()


@pytest.mark.parametrize("s,causal", MASK_CASES)
def test_flash_kernels_with_kv_mask_match_plain(dev, s, causal):
    """The masked form of the forward, dq and dk/dv kernels against their
    plain versions, at the unmasked kernels' gates (forward atol 1e-4, rtol
    2**-6, lse 1e-5; backward atol 3e-3, rtol 2**-6), the backward fed the
    plain forward's lse and delta: partial and full tiles, S not a multiple
    of 64 or 512, causal, a row with every key masked (its out the
    reference's sum over the visited count, its lse -1e30, no gradient).
    Each launch counts once in ``launches`` and once in
    ``masked_launches``."""
    q, k, v, do = _flash_case(dev, s, 4.0, b=4)
    kv_mask = _kv_mask(dev, s, causal)
    before = [(f.launches, f.masked_launches) for f in
              (tfa.flash_attention, tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)]
    out, lse = tfa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, return_lse=True)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=causal, kv_mask=kv_mask, return_lse=True)
    delta = tfa._delta(ref, do)
    dq = tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal, kv_mask=kv_mask)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal, kv_mask=kv_mask)
    want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, causal, kv_mask)
    torch.cuda.synchronize()
    after = [(f.launches, f.masked_launches) for f in
             (tfa.flash_attention, tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)]
    assert after == [(n + 1, m + 1) for n, m in before]
    assert torch.isfinite(out.float()).all() and (ref_lse[2] == -1e30).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    assert not dq[2].any() and not want[0][2].any()
    for name, got, plain in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        torch.testing.assert_close(got.float(), plain.float(), rtol=2.0**-6, atol=3e-3, msg=name)


D128_CASES = [(s, causal, masked) for s in (1, 63, 65, 200, 600, 1024) for causal in (True, False)
              for masked in (False, True)]


@pytest.mark.parametrize("s,causal,masked", D128_CASES)
def test_flash_kernels_head_dim_128_match_plain(dev, s, causal, masked):
    """The head-dim-128 form of the forward, dq and dk/dv kernels (two 64-dim
    atoms a tile; dk/dv one block a half) against their plain versions at
    the head-dim-64 gates (forward atol 1e-4, rtol 2**-6, lse 1e-5;
    backward atol 3e-3, rtol 2**-6), the backward fed the plain forward's
    lse and delta: partial and full tiles, ragged S, causal, without and
    with a ``kv_mask`` (a row with every key masked among them), q x1 and
    x4. Each launch counts once in ``launches`` and once in
    ``d128_launches``."""
    for q_scale in (1.0, 4.0):
        q, k, v, do = _flash_case(dev, s, q_scale, b=4, d=128)
        kv_mask = _kv_mask(dev, s, causal) if masked else None
        fns = (tfa.flash_attention, tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
        before = [(f.launches, f.d128_launches) for f in fns]
        out, lse = tfa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, return_lse=True)
        ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=causal, kv_mask=kv_mask, return_lse=True)
        delta = tfa._delta(ref, do)
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal, kv_mask=kv_mask)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=causal, kv_mask=kv_mask)
        want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, causal, kv_mask)
        torch.cuda.synchronize()
        assert [(f.launches, f.d128_launches) for f in fns] == [(n + 1, m + 1) for n, m in before]
        msg = f"q x{q_scale}"
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4, msg=msg)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5, msg=msg)
        for name, got, plain in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
            torch.testing.assert_close(got.float(), plain.float(), rtol=2.0**-6, atol=3e-3, msg=f"{name}, {msg}")


@pytest.mark.parametrize("probe", ["q", "do"])
def test_flash_kernels_head_dim_128_read_subnormal_operands_as_zero(dev, probe):
    """The subnormal-operand probe of the head-dim-64 test at head dim 128
    (both atoms of every staged tile flushed), causal, S = 600."""
    s = 600
    gen = torch.Generator(device=dev).manual_seed(s)
    rnd = lambda: torch.randn(1, s, 2, 128, generator=gen, device=dev)  # noqa: E731
    sign = lambda: torch.where(rnd() >= 0, 1.0, -1.0)  # noqa: E731
    q, k, v, do = (rnd().to(torch.bfloat16) for _ in range(4))
    if probe == "q":
        q, k = (sign() * 1e-39).to(torch.bfloat16), (sign() * 1e38).to(torch.bfloat16)
    else:
        do, v = (sign() * 1e-38).to(torch.bfloat16), (sign() * 2e36).to(torch.bfloat16)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = tfa._delta(ref, do)
    want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, True)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True)
    got = {"dk": (dk, want[1]), "dv": (dv, want[2])}
    if probe == "q":
        out, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    else:
        got["dq"] = (tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=True), want[0])
        assert not any(w.any() for w in want), "the plain version reads the subnormal dO as 0"
    torch.cuda.synchronize()
    for name, (g, w) in got.items():
        torch.testing.assert_close(g.float(), w.float(), rtol=2.0**-6, atol=3e-3, msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_with_kv_mask_matches_plain_backward(dev, causal):
    """The autograd ``flash_attention`` with ``kv_mask`` on CUDA tensors
    (the masked forward, dq and dk/dv kernels) against
    ``flash_attention_bwd_plain`` with that mask on the plain forward, at
    the backward gate; the mask gets no gradient."""
    s = 1000
    q0, k0, v0, do = _flash_case(dev, s, 1.0, b=4, h=12)
    kv_mask = _kv_mask(dev, s, causal)
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    out = tfa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask)
    out.backward(do)
    o, lse = tfa.flash_attention_plain(q0, k0, v0, causal=causal, kv_mask=kv_mask, return_lse=True)
    ref = tfa.flash_attention_bwd_plain(q0, k0, v0, o, do, lse, causal=causal, kv_mask=kv_mask)
    torch.cuda.synchronize()
    for name, got, want in zip("qkv", (q.grad, k.grad, v.grad), ref):
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-6, atol=3e-3, msg=f"d{name}")


def test_engine_on_card_launches_the_paged_kernel(dev):
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.configs import build_model
    from consensusml_tpu_torch.serve import Engine, ServeConfig

    model = build_model("gpt2_topk", "smoke", device=dev)
    with Engine(model, ServeConfig(num_slots=2, max_new_tokens=6), device=dev) as eng:
        eng.warmup()
        kernels.reset_launch_counts()
        r = eng.submit([1, 2, 3], 6).result(timeout=120)
        stats = eng.stats()
    assert stats["attn_impl"] == "cuda" and len(r.tokens) == 6
    assert stats["kernel_launches"]["paged_attention"] == 2 * stats["decode_steps"] > 0


def _stage_pair(dev, seed=0):
    """GPT-2-medium's widths cut to 2 layers on the card (random weights,
    the compute-dtype cast), a 1024-token block table of 16-token pages a
    slot and pages holding a random history."""
    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM
    from consensusml_tpu_torch.serve import pool as P
    from consensusml_tpu_torch.serve.decode import DecodeModel

    model = GPT2LM(GPT2Config(layers=2, dropout=0.0), device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    dm = DecodeModel.wrap(model.eval().to_compute_dtype())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pages = P.init_pages(dm, 4 * 64 + 1, 16)
    for pg in pages:
        for t in pg.values():
            t.normal_(generator=gen)
    return P, dm, pages


@pytest.mark.parametrize("k", [4, 7])
def test_verify_through_the_kernel_matches_plain(dev, k):
    """``make_verify_fn`` at W = k + 1 on the kernel tier against the plain
    tier (same weights, pages and greedy inputs): the window's logits
    within the serve gate (2.5e-2 of max|logit|) and the paged kernel
    launched once a layer; the decisions equal wherever the plain
    logits' top-2 gap is over the gate."""
    P, dm, pages = _stage_pair(dev)
    s = 4
    table = torch.arange(1, s * 64 + 1, dtype=torch.int32, device=dev).view(s, 64)
    table = torch.cat([table, torch.zeros(s, P.spec_table_cols(64, 16, k) - 64, dtype=torch.int32, device=dev)], 1)
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, 50257, (s,), generator=gen, device=dev, dtype=torch.int32)
    positions = torch.tensor([5, 500, 1023 - k, 1023], dtype=torch.int32, device=dev)
    props = torch.randint(0, 50257, (s, k), generator=gen, device=dev, dtype=torch.int32)
    q_probs = torch.nn.functional.one_hot(props.long(), 50257).float()
    samp = (torch.zeros(s, device=dev), torch.ones(s, device=dev), torch.zeros(s, dtype=torch.int64, device=dev))
    out = {}
    for impl in ("cuda", "torch"):
        copy = [{kk: t.clone() for kk, t in pg.items()} for pg in pages]
        before = tpa.paged_attention.launches
        out[impl] = P.make_verify_fn(dm, k, attn_impl=impl)(copy, table, tokens, props, torch.ones(s, k, device=dev),
                                                            q_probs, positions, *samp)
        torch.cuda.synchronize()
        out[impl] += (tpa.paged_attention.launches - before,)
    (gn, gf, gl, glaunch), (wn, wf, wl, wlaunch) = out["cuda"], out["torch"]
    assert (glaunch, wlaunch) == (2, 0)
    assert torch.isfinite(gl).all() and float((gl - wl).abs().max() / wl.abs().max()) <= 2.5e-2
    top2 = wl.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) / wl.abs().amax(dim=(1, 2))[:, None] > 2.5e-2).all(1)
    assert torch.equal(gn[clear], wn[clear]) and torch.equal(gf[clear], wf[clear])


@pytest.mark.parametrize("n,start,cow", [(700, 512, False), (512, 511, True), (1000, 0, False)],
                         ids=["suffix-188", "cow", "whole-1000"])
def test_prefix_prefill_through_the_kernel_matches_plain(dev, n, start, cow):
    """``make_prefix_prefill_fn`` on the kernel tier (the window form at W =
    the suffix bucket: 256, 16 and 1024 rows) against the plain tier, from
    the same pages: the last logits and the pages it writes within the
    serve gate of their scale (the second layer's K/V carry the first
    layer's attention), the copy-on-write source untouched, and one
    window launch a layer."""
    P, dm, pages = _stage_pair(dev, seed=4)
    bucket = next(b for b in (16, 32, 64, 128, 256, 512, 1024) if b >= n - start)
    row = torch.zeros(64 + bucket // 16, dtype=torch.int32, device=dev)
    row[:64] = torch.arange(1, 65, dtype=torch.int32, device=dev)
    src, dst = (32, 100) if cow else (0, 0)
    if cow:
        row[31] = dst  # the slot's last prompt block is a fresh copy of the shared block 32
    ids = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
    ids[0, : n - start] = torch.randint(0, 50257, (n - start,), generator=torch.Generator(device=dev).manual_seed(5),
                                        device=dev)
    out = {}
    for impl in ("cuda", "torch"):
        copy = [{kk: t.clone() for kk, t in pg.items()} for pg in pages]
        before = tpa.paged_attention.window_launches
        tok, last = P.make_prefix_prefill_fn(dm, attn_impl=impl)(copy, ids, n - start, start, row, src, dst,
                                                                 0.0, 1.0, 0)
        torch.cuda.synchronize()
        out[impl] = (last, copy, tpa.paged_attention.window_launches - before)
    (gl, gp, gw), (wl, wp, ww) = out["cuda"], out["torch"]
    assert (gw, ww) == (2, 0)
    assert torch.isfinite(gl).all() and float((gl - wl).abs().max() / wl.abs().max()) <= 2.5e-2
    for g, w, orig in zip(gp, wp, pages):
        for kk in ("k", "v"):
            assert float((g[kk] - w[kk]).abs().max()) <= 2.5e-2 * float(w[kk].abs().max())
            if cow:
                assert torch.equal(g[kk][src], orig[kk][src])


def test_gpt2_on_card_defaults_to_the_kernels(dev):
    """``GPT2LM`` called with no tier on CUDA tensors launches the flash
    kernel on a flash-sized forward and the paged kernel on a decode step."""
    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

    cfg = GPT2Config(vocab_size=64, hidden=128, layers=2, heads=2, max_len=1024)
    model = GPT2LM(cfg, device=dev).init_weights(torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, 64, (1, 600), device=dev)  # 600 * 600 > 512**2: flash
    pages = [
        {k: torch.zeros(5, 16, 2, 64, dtype=torch.bfloat16, device=dev) for k in ("k", "v")}
        for _ in range(cfg.layers)
    ]
    flash0, paged0 = tfa.flash_attention.launches, tpa.paged_attention.launches
    with torch.inference_mode():
        logits = model(ids)
        step = model(
            torch.tensor([[3], [5]], device=dev), positions=torch.tensor([5, 20], device=dev),
            kv_cache=pages, block_table=torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev),
        )
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == flash0 + cfg.layers
    assert tpa.paged_attention.launches == paged0 + cfg.layers
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("s", [600, 1024])
def test_flash_autograd_matches_plain_autograd(dev, s):
    """The autograd ``flash_attention`` on CUDA tensors (forward kernel,
    then the dq and dk/dv kernels), for one output cotangent, against

    - ``flash_attention_bwd_plain`` on the plain forward's output and
      logsumexp (the reference's backward, delta from the bf16 output),
      at chip_smoke.py's gate (atol 3e-3, rtol 2**-6);
    - autograd through ``flash_attention_plain``. That differentiates the
      f32 output before its bf16 rounding, so its delta moves by up to
      ~|do|·|o|·2**-9 over 64 dims; on short causal rows (|o| ~ 1, few
      keys) that shifts dq and dk by up to ~1.5e-2 (8.3e-3 read at
      S=600), hence atol 2e-2 here.
    """
    gen = torch.Generator(device=dev).manual_seed(s + 1)
    base = [torch.randn(2, s, 16, 64, generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3)]
    do = torch.randn(2, s, 16, 64, generator=gen, device=dev, dtype=torch.bfloat16)
    grads = {}
    counts = (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    for fn in (tfa.flash_attention, tfa.flash_attention_plain):
        q, k, v = (t.clone().requires_grad_() for t in base)
        out = fn(q, k, v, causal=True)
        assert out.grad_fn is not None
        out.backward(do)
        grads[fn] = (q.grad, k.grad, v.grad)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == (
        counts[0] + 1, counts[1] + 1)
    o, lse = tfa.flash_attention_plain(*base, causal=True, return_lse=True)
    ref = tfa.flash_attention_bwd_plain(*base, o, do, lse, causal=True)
    for got, want, auto in zip(grads[tfa.flash_attention], ref, grads[tfa.flash_attention_plain]):
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-6, atol=3e-3)
        torch.testing.assert_close(got.float(), auto.float(), rtol=2.0**-6, atol=2e-2)


def test_gpt2_training_on_card_reaches_every_qkv_weight(dev):
    """A training step of ``GPT2LM`` on CUDA with no tier named: the forward
    and both backward flash kernels launch once per layer, and every qkv
    kernel gets a finite, non-zero gradient (a result without a grad_fn
    would leave attention out of the backward)."""
    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

    cfg = GPT2Config(vocab_size=64, hidden=128, layers=2, heads=2, max_len=1024, dropout=0.1)
    model = GPT2LM(cfg, device=dev).init_weights(torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, 64, (2, 600), device=dev)  # 600 * 600 > 512**2: flash
    n0 = (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
          tfa.flash_attention_bwd_dkv.launches)
    logits = model(ids, deterministic=False, generator=torch.Generator(device=dev).manual_seed(1))
    torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, 64), ids[:, 1:].reshape(-1)).backward()
    torch.cuda.synchronize()
    n1 = (tfa.flash_attention.launches, tfa.flash_attention_bwd_dq.launches,
          tfa.flash_attention_bwd_dkv.launches)
    assert [b - a for a, b in zip(n0, n1)] == [cfg.layers] * 3
    for blk in model.blocks:
        g = blk.qkv.kernel.grad
        assert g is not None and g.dtype == torch.float32
        assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_fused_encode_kernel_bit_equal_to_plain(dev):
    from consensusml_tpu_torch.compress import kernels as tck

    gen = torch.Generator(device=dev).manual_seed(5)
    for rows, chunk in ((1000, 512), (37, 128)):
        x = torch.randn(rows, chunk, generator=gen, device=dev)
        xhat = x + 0.1 * torch.randn(rows, chunk, generator=gen, device=dev)
        x[0] = xhat[0]
        x[1] = 0.0
        xhat[1] = torch.where(torch.arange(chunk, device=dev) % 2 == 1, -0.0, 0.0)
        before = tck.fused_pack_quantize.launches
        got = tck.fused_pack_quantize(x, xhat)
        want = tck.fused_pack_quantize_plain(x, xhat)
        torch.cuda.synchronize()
        assert tck.fused_pack_quantize.launches == before + 1
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
        assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    with pytest.raises(ValueError):
        tck.fused_pack_quantize(torch.zeros(4, 100, device=dev), torch.zeros(4, 100, device=dev))


def _codec_rows(dev, rows, chunk, seed):
    """f32 rows with the codec kernels' hazards: a zero row, a row of
    +0/-0, round-half points (scale 1), a tie of opposite signs among
    fewer non-zeros than k, and a row of equal magnitudes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 3 * torch.randn(rows, chunk, generator=gen, device=dev)
    x[0] = 0.0
    x[1] = torch.where(torch.arange(chunk, device=dev) % 2 == 1, -0.0, 0.0)
    x[2] = torch.randint(-126, 127, (chunk,), generator=gen, device=dev).float() + 0.5
    x[2, 0] = 127.0
    x[3] = 0.0
    x[3, 5], x[3, 9], x[3, 40] = -3.0, 3.0, -0.0
    x[4] = torch.where(torch.arange(chunk, device=dev) % 3 == 0, 2.0, -2.0)
    return x


def _same_bits(a, b):
    view = {torch.float32: torch.int32, torch.int32: torch.int32, torch.int8: torch.int8,
            torch.uint8: torch.uint8, torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}[a.dtype]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("rows,chunk", [(4 * 1571, 512), (37, 128), (9, 1024)])
def test_int8_kernels_bit_equal_to_plain(dev, rows, chunk):
    from consensusml_tpu_torch.compress import kernels as tck

    x = _codec_rows(dev, rows, chunk, rows)
    before = (tck.quantize_int8.launches, tck.dequantize_int8.launches)
    q, s = tck.quantize_int8(x)
    d = tck.dequantize_int8(q, s)
    torch.cuda.synchronize()
    assert (tck.quantize_int8.launches, tck.dequantize_int8.launches) == (before[0] + 1, before[1] + 1)
    qp, sp = tck.quantize_int8_plain(x)
    assert _same_bits(q, qp) and _same_bits(s, sp)
    assert _same_bits(d, tck.dequantize_int8_plain(q, s))
    assert s[0] == 0 and s[2] == 1.0


@pytest.mark.parametrize("chunk", [128, 256, 384, 512, 1024])
@pytest.mark.parametrize("k", [1, 8, 13, 64])
def test_chunked_topk_kernel_bit_equal_to_plain(dev, chunk, k):
    from consensusml_tpu_torch.compress import kernels as tck

    x = _codec_rows(dev, 1000, chunk, chunk + k)
    before = tck.chunked_topk.launches
    v, i = tck.chunked_topk(x, k)
    torch.cuda.synchronize()
    assert tck.chunked_topk.launches == before + 1
    vp, ip = tck.chunked_topk_plain(x, k)
    assert _same_bits(i, ip) and _same_bits(v, vp)
    if k >= 2:
        assert i[3, :2].tolist() == [5, 9]


def test_chunked_topk_kernel_flushes_subnormals_as_plain(dev):
    """Rows of subnormals beside zeros of both signs and normals, at every
    C and k the wrapper takes (C = 128 .. 1024 by 128, k = 1 .. 64): the
    kernel ranks a subnormal |x| as 0 (the lower index wins among the
    zeros) and writes +0.0 for it, bit-equal to the plain version."""
    from consensusml_tpu_torch.compress import kernels as tck

    for chunk in range(128, 1025, 128):
        gen = torch.Generator(device=dev).manual_seed(chunk)
        x = torch.zeros(8, chunk, device=dev)
        x[0, 20] = 1.0
        x[0, [7, 9, 3]] = torch.tensor([-3e-39, 2e-39, 1e-39], device=dev)
        x[1, [50, 60]] = torch.tensor([-1e-40, 5e-41], device=dev)
        x[2, 1::4] = -0.0
        x[2, [0, 5, 11, 64, 78]] = torch.tensor([-1e-38, 3e-39, -5e-45, 1e-39, 2.0**-126], device=dev)
        x[3] = 1e-39 * torch.where(torch.arange(chunk, device=dev) % 2 == 1, -1.0, 1.0)
        x[4:] = torch.randn(4, chunk, generator=gen, device=dev)
        x[4:, ::3] *= 1e-39  # a third of the random rows subnormal
        for k in range(1, 65):
            v, i = tck.chunked_topk(x, k)
            vp, ip = tck.chunked_topk_plain(x, k)
            assert _same_bits(i, ip) and _same_bits(v, vp), (chunk, k)
        assert i[0, :4].tolist() == [20, 0, 1, 2] and i[1, :4].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("with_acc,weight", [(False, 1.0), (True, 1.0), (True, 0.3)])
@pytest.mark.parametrize("chunk,k", [(512, 8), (128, 13), (256, 100)])
def test_chunk_scatter_kernel_bit_equal_to_plain(dev, chunk, k, with_acc, weight):
    from consensusml_tpu_torch.compress import kernels as tck

    gen = torch.Generator(device=dev).manual_seed(chunk + k)
    rows = 3000
    vals = torch.randn(rows, k, generator=gen, device=dev)
    vals[0, 0] = -0.0
    idx = torch.argsort(torch.rand(rows, chunk, generator=gen, device=dev), dim=1)[:, :k].to(torch.int32)
    acc = torch.randn(rows, chunk, generator=gen, device=dev)
    acc[1] = -0.0
    acc[0, idx[0, 0]] = -0.0
    acc = acc if with_acc else None
    before = tck.chunk_scatter.launches
    got = tck.chunk_scatter(vals, idx, chunk, acc, weight=weight)
    torch.cuda.synchronize()
    assert tck.chunk_scatter.launches == before + 1
    assert _same_bits(got, tck.chunk_scatter_plain(vals, idx, chunk, acc, weight=weight))
    assert not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("with_acc", [False, True])
def test_chunk_scatter_kernel_flushes_subnormals_as_plain(dev, with_acc):
    """Subnormal values (a top-k payload past k = 64 keeps them) and
    subnormal acc elements: the kernel's .ftz products and sums write them
    as +0.0, bit-equal to the plain version, as the reference's compiled
    kernel does."""
    from consensusml_tpu_torch.compress import kernels as tck

    gen = torch.Generator(device=dev).manual_seed(65)
    rows, chunk, k = 64, 128, 65
    vals = torch.randn(rows, k, generator=gen, device=dev)
    vals[::2] *= 1e-39
    idx = torch.argsort(torch.rand(rows, chunk, generator=gen, device=dev), dim=1)[:, :k].to(torch.int32)
    acc = torch.randn(rows, chunk, generator=gen, device=dev) if with_acc else None
    if with_acc:
        acc[1::2] *= 1e-39
    got = tck.chunk_scatter(vals, idx, chunk, acc, weight=0.5)
    torch.cuda.synchronize()
    assert _same_bits(got, tck.chunk_scatter_plain(vals, idx, chunk, acc, weight=0.5))
    assert not ((got != 0) & (got.abs() < 2.0**-126)).any() and not torch.signbit(got[got == 0]).any()
    if with_acc:  # row 0: subnormal values on a normal acc add nothing; row 1: a subnormal acc reads as 0
        hit = torch.zeros(chunk, dtype=torch.bool, device=dev).scatter_(0, idx[1].long(), True)
        assert torch.equal(got[0], acc[0]) and not got[1][~hit].any()
    else:
        assert not got[0].any()


def test_topk_int8_codec_on_card_equals_cpu(dev, monkeypatch):
    """The config's codec on a stacked (4, n) CUDA buffer launches each of
    its four kernels once and never reaches a plain version (patched to
    raise here); payload and decode are bit-equal to the same codec on
    the CPU (plain versions)."""
    from consensusml_tpu_torch.compress import kernels as tck
    from consensusml_tpu_torch.compress import topk_int8_compressor

    x = torch.randn(4, 300 * 512, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    comp = topk_int8_compressor(chunk=512, k=8, impl="auto")
    want = comp.compress(x.cpu(), stacked=True)
    want_dec = comp.decompress(want)
    names = ("quantize_int8", "dequantize_int8", "chunked_topk", "chunk_scatter")

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in names:
        monkeypatch.setattr(tck, f"{name}_plain", refuse)
    before = {n: getattr(tck, n).launches for n in names}
    p = comp.compress(x, stacked=True)
    dec = comp.decompress(p)
    torch.cuda.synchronize()
    assert {n: getattr(tck, n).launches - before[n] for n in names} == dict.fromkeys(names, 1)
    assert p.indices.dtype == torch.uint16 and p.indices.shape == (4, 300, 8)
    assert torch.equal(p.indices.cpu().to(torch.int32), want.indices.to(torch.int32))
    assert _same_bits(p.values.data.cpu(), want.values.data) and _same_bits(p.values.scales.cpu(), want.values.scales)
    assert _same_bits(dec.cpu(), want_dec)


def test_codec_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from consensusml_tpu_torch.compress import kernels as tck

    with pytest.raises(ValueError):
        tck.quantize_int8(torch.zeros(4, 100, device=dev))
    with pytest.raises(ValueError):
        tck.chunked_topk(torch.zeros(4, 2048, device=dev), 8)
    with pytest.raises(ValueError):
        tck.chunked_topk(torch.zeros(4, 512, device=dev), 65)
    with pytest.raises(ValueError):
        tck.chunk_scatter(torch.zeros(4, 8, device=dev), torch.zeros(4, 8, dtype=torch.int64, device=dev), 512)
    with pytest.raises(ValueError):
        tck.dequantize_int8(torch.zeros(4, 512, dtype=torch.int8, device=dev), torch.zeros(4, device=dev).double())


BN_SUM_RTOL = 2e-6


def _bn_sum_ok(got, want, terms):
    return bool(((got - want).abs() <= BN_SUM_RTOL * terms + 1e-30).all())


def _bn_case(dev, m, c, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn(m, c, generator=gen, device=dev) + 0.3).to(dtype)
    dy = torch.randn(m, c, generator=gen, device=dev).to(dtype)
    gamma = 1 + 0.5 * torch.randn(c, generator=gen, device=dev)
    beta = 0.1 * torch.randn(c, generator=gen, device=dev)
    return x, dy, gamma, beta


def _bn_vectors(tbn, x, gamma, beta):
    m = x.shape[0]
    sp, sqp = tbn.bn_stats_plain(x)
    mean, var = tbn.batch_moments(sp, sqp, m)
    scale, shift, rsqrt = tbn.fold_params(gamma, beta, mean, var, 1e-5)
    return scale, shift, mean, rsqrt


def _check_bn_bwd(tbn, dy, x, vecs, relu, reruns=1):
    """bn_bwd against its plain versions: dx equal to ``bn_bwd_dx_plain``
    fed the kernel's own sums times f32(1/M) (the compiled reference's
    division), the sums within BN_SUM_RTOL of the plain reduce's, every
    rerun bit-identical."""
    inv = tbn.inv_rows(x.shape[0])
    runs = [tbn.bn_bwd(dy, x, *vecs, relu) for _ in range(reruns)]
    dx, db, dg = runs[0]
    dbp, dgp = tbn.bn_bwd_reduce_plain(dy, x, *vecs, relu)
    want = tbn.bn_bwd_dx_plain(dy, x, *vecs, db * inv, dg * inv, relu)
    scale, shift, mean, rsqrt = vecs
    g = dy.float() * ((x.float() * scale + shift > 0) if relu else 1.0)
    xhat = (x.float() - mean) * rsqrt
    torch.cuda.synchronize()
    assert dx.dtype == x.dtype and db.dtype == dg.dtype == torch.float32
    assert torch.equal(dx, want)
    assert _bn_sum_ok(db, dbp, g.abs().sum(0)) and _bn_sum_ok(dg, dgp, (g * xhat).abs().sum(0))
    assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,c", [(8192, 256), (4096, 64), (512, 2048), (1, 8), (1, 3), (777, 13), (300, 24)])
def test_bn_kernels_match_plain(dev, m, c, dtype):
    """The three fused-BN kernels against their plain versions, fed the
    same per-channel vectors, relu off and on; C not a multiple of the
    vector width (3, 13) and M = 1 included. Each wrapper call counts one
    launch."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    x, dy, gamma, beta = _bn_case(dev, m, c, dtype, m + c)
    names = ("bn_stats", "bn_norm", "bn_bwd")
    before = [getattr(tbn, n).launches for n in names]
    xf = x.float()
    s, sq = tbn.bn_stats(x)
    sp, sqp = tbn.bn_stats_plain(x)
    torch.cuda.synchronize()
    assert _bn_sum_ok(s, sp, xf.abs().sum(0)) and _bn_sum_ok(sq, sqp, (xf * xf).sum(0))
    vecs = _bn_vectors(tbn, x, gamma, beta)
    for relu in (False, True):
        y = tbn.bn_norm(x, vecs[0], vecs[1], relu)
        assert y.dtype == dtype and torch.equal(y.float(), tbn.bn_norm_plain(x, vecs[0], vecs[1], relu).float())
        _check_bn_bwd(tbn, dy, x, vecs, relu)
    assert [getattr(tbn, n).launches - b for n, b in zip(names, before)] == [1, 2, 2]


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("m,c", [(131072, 64), (131072, 128), (131072, 256), (32768, 128), (32768, 256),
                                 (32768, 512), (8192, 256), (8192, 512), (8192, 1024), (2048, 512), (2048, 2048)])
def test_bn_bwd_at_resnet50_views(dev, m, c, relu):
    """bn_bwd at each of ResNet-50's eleven BN views (batch 128 at 32x32,
    16x16, 8x8 and 4x4), bf16: the plan's on-chip and streaming forms
    both, three reruns bit-identical, one launch a call."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    x, dy, gamma, beta = _bn_case(dev, m, c, torch.bfloat16, 6)
    vecs = _bn_vectors(tbn, x, gamma, beta)
    before = tbn.bn_bwd.launches
    _check_bn_bwd(tbn, dy, x, vecs, relu, reruns=3)
    assert tbn.bn_bwd.launches - before == 3


@pytest.mark.parametrize("m,c", [(131072, 64), (131072, 128), (131072, 256), (32768, 128), (32768, 256),
                                 (32768, 512), (8192, 256), (8192, 512), (8192, 1024), (2048, 512), (2048, 2048)])
def test_bn_stats_at_resnet50_views(dev, m, c):
    """The statistics' one launch at each of ResNet-50's eleven BN views,
    bf16: the sums within BN_SUM_RTOL of the plain version's, the five
    per-channel vectors bit-equal to ``batch_moments`` and ``fold_params``
    fed the kernel's own sums, three reruns bit-identical, one launch a
    call."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    x, _dy, gamma, beta = _bn_case(dev, m, c, torch.bfloat16, 7)
    before = tbn.bn_stats.launches
    runs = [tbn._stats_launch(x, gamma, beta, 1e-5) for _ in range(3)]
    torch.cuda.synchronize()
    assert tbn.bn_stats.launches == before + 3
    assert all(_same_bits(r, runs[0]) for r in runs[1:])
    s, sq = runs[0][0], runs[0][1]
    sp, sqp = tbn.bn_stats_plain(x)
    xf = x.float()
    assert _bn_sum_ok(s, sp, xf.abs().sum(0)) and _bn_sum_ok(sq, sqp, (xf * xf).sum(0))
    mean, var = tbn.batch_moments(s, sq, m)
    want = (mean, var, *tbn.fold_params(gamma, beta, mean, var, 1e-5))
    for name, g, w in zip(("mean", "var", "scale", "shift", "rsqrt"), runs[0][2:], want):
        assert _same_bits(g, w), name
    assert not tbn._stats_tickets(x.device, 1).any()  # left zero for the next launch


@pytest.mark.parametrize("splits,staged", [(1, True), (2, True), (4, True), (4, False)])
def test_bn_stats_row_splits_fold_in_order(dev, splits, staged):
    """1, 2 and 4 clusters a channel tile (the last to finish folds the
    clusters' sums in order after an integer ticket), TMA-staged or 16-byte
    loads: the sums within BN_SUM_RTOL, the vectors bit-equal to the fold
    of the kernel's own sums, reruns bit-identical, the tickets left zero."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    m, c = 32768, 256
    x, _dy, gamma, beta = _bn_case(dev, m, c, torch.bfloat16, 8)
    plan = tbn.bn_stats_plan(m, c, 2, 8, cluster=8, splits=splits, staged=staged)
    assert plan.splits == splits and (plan.nbuf > 0) == staged
    runs = [tbn._stats_launch(x, gamma, beta, 1e-5, plan) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(_same_bits(r, runs[0]) for r in runs[1:])
    sp, sqp = tbn.bn_stats_plain(x)
    xf = x.float()
    assert _bn_sum_ok(runs[0][0], sp, xf.abs().sum(0)) and _bn_sum_ok(runs[0][1], sqp, (xf * xf).sum(0))
    mean, var = tbn.batch_moments(runs[0][0], runs[0][1], m)
    want = (mean, var, *tbn.fold_params(gamma, beta, mean, var, 1e-5))
    assert all(_same_bits(g, w) for g, w in zip(runs[0][2:], want))
    assert not tbn._stats_tickets(x.device, 1).any()


def test_bn_bwd_misaligned_pointers_take_the_one_element_path(dev):
    """Operands that are not 16-byte aligned (a view one element into its
    storage) go through the one-element path, with the same results."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    m, c = 4096, 64
    x0, dy0, gamma, beta = _bn_case(dev, m, c, torch.bfloat16, 5)
    x = torch.empty(m * c + 1, dtype=x0.dtype, device=dev)[1:].view(m, c).copy_(x0)
    dy = torch.empty(m * c + 1, dtype=dy0.dtype, device=dev)[1:].view(m, c).copy_(dy0)
    assert x.data_ptr() % 16 and tbn._vec(x, dy) == 1
    vecs = _bn_vectors(tbn, x, gamma, beta)
    for relu in (False, True):
        _check_bn_bwd(tbn, dy, x, vecs, relu, reruns=2)


def test_bn_bwd_flushes_subnormals_as_the_plain_version(dev):
    """f32 rows of subnormals and products that underflow: the kernel's
    .ftz arithmetic gives the plain version's flushed results (a channel of
    subnormal dy sums to exactly 0 and its dx column is all zeros), where
    arithmetic that kept subnormals would sum to a normal number."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    m, c = 256, 8
    x, dy, gamma, beta = _bn_case(dev, m, c, torch.float32, 3)
    # channel 0: subnormal dy, so db = dg = 0 and dx = 0 in the reference;
    # channel 1: a normal dy with the sign of x - mean, so no partial sum
    # cancels, whose products g * xhat underflow where |xhat| < ~0.78
    dy[:, 0] = 1e-39 * torch.where(torch.arange(m, device=dev) % 3 == 0, -1.0, 1.0)
    dy[:, 1] = 1.5e-38 * torch.sign(x[:, 1] - x[:, 1].mean())
    x[7] = 1e-39
    vecs = _bn_vectors(tbn, x, gamma, beta)
    for relu in (False, True):
        _check_bn_bwd(tbn, dy, x, vecs, relu, reruns=2)
        dx, db, dg = tbn.bn_bwd(dy, x, *vecs, relu)
        _, dbp, dgp = tbn.bn_bwd_plain(dy, x, *vecs, relu)
        torch.cuda.synchronize()
        assert float(db[0]) == 0.0 and float(dg[0]) == 0.0 and float(dx[:, 0].abs().max()) == 0.0
        assert not ((dx != 0) & (dx.abs() < 2.0**-126)).any()
        terms = (dy[:, 1] * (x[:, 1] - vecs[2][1]) * vecs[3][1]).abs().sum()
        assert abs(float(dg[1] - dgp[1])) <= 1e-5 * float(terms)
    assert float(dy[:, 0].sum()) != 0.0  # without the flush channel 0 would not sum to 0


@pytest.mark.parametrize("relu", [False, True])
def test_bn_forward_kernels_flush_subnormals_as_plain(dev, relu):
    """f32 x with a channel of subnormals (and a subnormal in another): the
    statistics kernel sums them as zeros (channel 0's sums exactly 0), and
    the normalize kernel, fed the same flushed per-channel vectors, equals
    its plain version with no subnormal output; through
    ``fused_batch_norm`` channel 0's mean, var and y are 0."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    m, c = 777, 8
    x, _dy, gamma, beta = _bn_case(dev, m, c, torch.float32, 4)
    x[:, 0] = 1e-39 * torch.where(torch.arange(m, device=dev) % 3 == 0, -1.0, 1.0)
    x[5, 3] = -2e-39
    beta[0] = 0.0
    s, sq = tbn.bn_stats(x)
    sp, sqp = tbn.bn_stats_plain(x)
    torch.cuda.synchronize()
    assert float(s[0]) == 0.0 and float(sq[0]) == 0.0 and float(sp[0]) == 0.0
    assert _bn_sum_ok(s, sp, _ftz_abs(x).sum(0)) and _bn_sum_ok(sq, sqp, (_ftz_abs(x) ** 2).sum(0))
    mean, var = tbn.batch_moments(sp, sqp, m)
    scale, shift, _ = tbn.fold_params(gamma, beta, mean, var, 1e-5)
    y = tbn.bn_norm(x, scale, shift, relu)
    assert torch.equal(y, tbn.bn_norm_plain(x, scale, shift, relu))
    assert not ((y != 0) & (y.abs() < 2.0**-126)).any() and not y[:, 0].any()
    yf, mf, vf = tbn.fused_batch_norm(x, gamma, beta, act="relu" if relu else None)
    assert float(mf[0]) == 0.0 and float(vf[0]) == 0.0 and not yf[:, 0].any()
    assert float(x[:, 0].sum()) != 0.0  # unflushed, channel 0 would not sum to 0


@pytest.mark.parametrize("m,c", [(8192, 256), (777, 13), (1, 8), (512, 2048)])
def test_bn_forward_vectors_from_the_fold_equal_plain(dev, m, c):
    """The statistics' fold computes the forward's five per-channel vectors
    (mean, var, scale, shift, rsqrt) as ``batch_moments`` and
    ``fold_params`` compute them from the same sums, to the bit; one
    launch of bn_stats."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    x, _dy, gamma, beta = _bn_case(dev, m, c, torch.float32, 5)
    x = x.to(torch.bfloat16)
    before = tbn.bn_stats.launches
    got = tbn.bn_forward_stats(x, gamma, beta, 1e-5)
    assert tbn.bn_stats.launches == before + 1
    s, sq = tbn.bn_stats(x)
    mean, var = tbn.batch_moments(s, sq, m)
    want = (mean, var, *tbn.fold_params(gamma, beta, mean, var, 1e-5))
    torch.cuda.synchronize()
    for name, g, w in zip(("mean", "var", "scale", "shift", "rsqrt"), got, want):
        assert _same_bits(g, w), name


def _ftz_abs(x):
    return torch.where(x.abs() < 2.0**-126, 0.0, x.abs())


def test_bn_reductions_are_deterministic(dev):
    """The fixed-order statistics and backward reductions give the same
    bits on a rerun."""
    from consensusml_tpu_torch.models import fused_bn as tbn

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(131072, 64, generator=gen, device=dev).to(torch.bfloat16)
    runs = [tbn.bn_stats(x) for _ in range(3)]
    assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    dy = torch.randn(131072, 64, generator=gen, device=dev).to(torch.bfloat16)
    vecs = _bn_vectors(tbn, x, torch.ones(64, device=dev), torch.zeros(64, device=dev))
    runs = [tbn.bn_bwd(dy, x, *vecs, True) for _ in range(3)]
    assert all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))


def test_bn_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from consensusml_tpu_torch.models import fused_bn as tbn

    x = torch.randn(64, 32, device=dev)
    v = torch.ones(32, device=dev)
    with pytest.raises(ValueError):  # a non-contiguous (M, C) view is refused, never copied
        tbn.bn_stats(torch.randn(32, 64, device=dev).t())
    with pytest.raises(ValueError):
        tbn.bn_norm(x.half(), v, v, False)
    with pytest.raises(ValueError):
        tbn.bn_norm(x, v[:16], v, False)
    with pytest.raises(ValueError):
        tbn.bn_bwd(x.to(torch.bfloat16), x, v, v, v, v, True)
    with pytest.raises(RuntimeError):  # a plan the kernel does not take
        tbn.bn_bwd(x, x, v, v, v, v, True, plan=tbn.bn_bwd_plan(64, 32, 4, 4)._replace(cluster=17, rows=4))
    with pytest.raises(RuntimeError):
        tbn._stats_launch(x, v, v, 1e-5, tbn.bn_stats_plan(64, 32, 4, 4)._replace(cluster=17, rows=4))
    with pytest.raises(RuntimeError):  # an NCHW-contiguous activation has no (M, C) view
        tbn.fused_batch_norm(torch.randn(2, 32, 4, 4, device=dev).permute(0, 2, 3, 1), v, v)


def test_resnet_worker_step_through_bn_kernels_matches_plain(dev):
    """One worker step of the smoke ResNet (f32) with ``norm_impl="pallas"``
    on the card: every BN layer launches each of the three kernels once, and
    the gradients and new statistics match the same step on the plain
    versions (``"jnp"``, same parameter names) to f32 summation-order noise."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.resnet import resnet_loss_fn

    bundle = configs.build("cifar_resnet50", "smoke", norm_impl="pallas", device=dev)
    params, model_state = bundle.convert(bundle.init_params(0))
    batch = next(iter(bundle.batches(1, 0)))
    micro = {k: v[0, 0].to(dev) for k, v in batch.items()}
    stats = {"batch_stats": {n: t[0].to(dev) for n, t in model_state["batch_stats"].items()}}
    out = {}
    for impl in ("pallas", "jnp"):
        leaves = {n: p[0].to(dev).requires_grad_() for n, p in params.items()}
        kernels.reset_launch_counts()
        loss, new = resnet_loss_fn(configs.resnet_model("smoke", impl))(leaves, stats, micro, None)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        out[impl] = (loss, grads, new, kernels.launch_counts())
    bn = ("bn_stats", "bn_norm", "bn_bwd")
    n_bn = 9  # the stem, and four in each of the two blocks (with the projection)
    assert {k: out["pallas"][3][k] for k in bn} == dict.fromkeys(bn, n_bn)
    assert all(v == 0 for v in out["jnp"][3].values())
    assert abs(float(out["pallas"][0].detach()) - float(out["jnp"][0].detach())) <= 1e-5
    for a, b in zip(out["pallas"][1], out["jnp"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7
    for n, t in out["pallas"][2]["batch_stats"].items():
        torch.testing.assert_close(t, out["jnp"][2]["batch_stats"][n], rtol=1e-5, atol=1e-6)


def test_flax_path_batchnorm_statistics_on_card(dev):
    """``norm_impl="flax"``'s BatchNorm on a bf16 channels_last activation:
    the running statistics it derives from PyTorch's batch norm are flax's
    (batch mean, biased variance, 0.9 old + 0.1 batch)."""
    from consensusml_tpu_torch.models.resnet import BatchNorm

    gen = torch.Generator(device=dev).manual_seed(4)
    x = (3 * torch.randn(128, 64, 8, 8, generator=gen, device=dev) + 1).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    bn = BatchNorm(64, act="relu", device=dev)
    y = bn(x)
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and (y >= 0).all()
    torch.testing.assert_close(bn.mean, 0.1 * mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)


def test_int4_kernels_bit_equal_to_plain(dev):
    """int4 quantize/dequantize against their plain versions, bit for bit,
    on the codec hazards plus a NaN row, an inf row and int4's round-half
    points (scale 1)."""
    from consensusml_tpu_torch.compress import kernels as tck

    for rows, chunk in ((4 * 1571, 128), (37, 512), (9, 1024)):
        x = _codec_rows(dev, rows, chunk, rows + 1)
        x[2] = torch.randint(-7, 7, (chunk,), device=dev).float() + 0.5
        x[2, :5] = torch.tensor([7.0, 3.5, -3.5, 0.5, 1.5], device=dev)
        x[5, 3] = float("nan")
        x[6, 4] = float("inf")
        before = (tck.quantize_int4.launches, tck.dequantize_int4.launches)
        p, s = tck.quantize_int4(x)
        d = tck.dequantize_int4(p, s)
        torch.cuda.synchronize()
        assert (tck.quantize_int4.launches, tck.dequantize_int4.launches) == (before[0] + 1, before[1] + 1)
        pp, sp = tck.quantize_int4_plain(x)
        dp = tck.dequantize_int4_plain(p, s)
        assert _same_bits(p, pp) and torch.equal(torch.isnan(s), torch.isnan(sp)) and torch.equal(torch.isnan(d), torch.isnan(dp))
        # NaN payload bits aside (the NaN row), bit for bit
        assert _same_bits(torch.nan_to_num(s, nan=-1.0), torch.nan_to_num(sp, nan=-1.0))
        assert _same_bits(torch.nan_to_num(d, nan=-1.0), torch.nan_to_num(dp, nan=-1.0))
        assert s[0] == 0 and s[2] == 1.0 and d[2, :5].tolist() == [7.0, 4.0, -4.0, 0.0, 2.0]
        assert not p[[0, 1, 5, 6]].any()
    with pytest.raises(ValueError):
        tck.quantize_int4(torch.zeros(4, 100, device=dev))
    with pytest.raises(ValueError):
        tck.dequantize_int4(torch.zeros(4, 64, dtype=torch.int8, device=dev), torch.zeros(4, device=dev))


def test_topk_int4_codec_on_card_equals_cpu(dev, monkeypatch):
    """The slice's codec on a stacked (4, n) CUDA buffer launches each of
    its four kernels once and never reaches a plain version; payload and
    decode are bit-equal to the same codec on the CPU."""
    from consensusml_tpu_torch.compress import kernels as tck
    from consensusml_tpu_torch.compress import topk_int4_compressor

    x = torch.randn(4, 300 * 512, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
    comp = topk_int4_compressor(chunk=512, k=8, impl="auto")
    want = comp.compress(x.cpu(), stacked=True)
    want_dec = comp.decompress(want)
    names = ("quantize_int4", "dequantize_int4", "chunked_topk", "chunk_scatter")

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for name in names:
        monkeypatch.setattr(tck, f"{name}_plain", refuse)
    before = {n: getattr(tck, n).launches for n in names}
    p = comp.compress(x, stacked=True)
    dec = comp.decompress(p)
    torch.cuda.synchronize()
    assert {n: getattr(tck, n).launches - before[n] for n in names} == dict.fromkeys(names, 1)
    assert torch.equal(p.indices.cpu().to(torch.int32), want.indices.to(torch.int32))
    assert _same_bits(p.values.data.cpu(), want.values.data) and _same_bits(p.values.scales.cpu(), want.values.scales)
    assert _same_bits(dec.cpu(), want_dec)


LN_ROW_RTOL, LN_SUM_RTOL = 1e-5, 2e-6


def _ln_case(dev, m, h, dtype, seed):
    """x with the LayerNorm's hazards in its first rows (a constant row, one
    of large magnitude, one at 1e-3 scale), dy, f32 gamma and beta."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 2 * torch.randn(m, h, generator=gen, device=dev) + 0.5
    x[0] = 0.375
    if m > 2:
        x[1] *= 1e3
        x[2] *= 1e-3
    dy = torch.randn(m, h, generator=gen, device=dev)
    gamma = 1 + 0.1 * torch.randn(h, generator=gen, device=dev)
    beta = 0.1 * torch.randn(h, generator=gen, device=dev)
    return x.to(dtype), dy.to(dtype), gamma, beta


def _ln_rows_ok(got, want):
    ulp = 2.0**-7 if got.dtype == torch.bfloat16 else 0.0
    g, w = got.float(), want.float()
    row = w.abs().amax(dim=1, keepdim=True)
    return bool(((g - w).abs() <= LN_ROW_RTOL * row + ulp * w.abs()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,h", [(8192, 1024), (1, 1024), (333, 136), (64, 2048), (17, 4096), (5, 8)])
def test_ln_kernels_match_plain(dev, m, h, dtype):
    from consensusml_tpu_torch.models import fused_ln as tln

    x, dy, gamma, beta = _ln_case(dev, m, h, dtype, m + h)
    before = (tln.ln_fwd.launches, tln.ln_bwd.launches)
    y = tln.ln_fwd(x, gamma, beta, 1e-6, dtype)
    dx, dg, db = tln.ln_bwd(dy, x, gamma, 1e-6)
    torch.cuda.synchronize()
    assert (tln.ln_fwd.launches, tln.ln_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert y.dtype == dx.dtype == dtype and dg.dtype == db.dtype == torch.float32
    assert _ln_rows_ok(y, tln.ln_fwd_plain(x, gamma, beta, 1e-6, dtype))
    dxp, dgp, dbp = tln.ln_bwd_plain(dy, x, gamma, 1e-6)
    assert _ln_rows_ok(dx, dxp)
    xc = x.float() - x.float().mean(1, keepdim=True)
    xhat = xc * torch.rsqrt((xc * xc).mean(1, keepdim=True) + 1e-6)
    dyf = dy.float()
    assert bool(((dg - dgp).abs() <= LN_SUM_RTOL * (dyf * xhat).abs().sum(0) + 1e-30).all())
    assert bool(((db - dbp).abs() <= LN_SUM_RTOL * dyf.abs().sum(0) + 1e-30).all())
    # mixed dtypes: f32 in, bf16 out, and a bf16 cotangent for f32 x
    if dtype == torch.float32:
        assert _ln_rows_ok(tln.ln_fwd(x, gamma, beta, 1e-6, torch.bfloat16),
                           tln.ln_fwd_plain(x, gamma, beta, 1e-6, torch.bfloat16))
        dyb = dy.to(torch.bfloat16)
        assert _ln_rows_ok(tln.ln_bwd(dyb, x, gamma, 1e-6)[0], tln.ln_bwd_plain(dyb, x, gamma, 1e-6)[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ln_kernels_flush_subnormals_as_plain(dev, dtype):
    """A row of x at 1e-39 normalises to y = beta (0 here) and a row of dy
    at 1e-39 gives dx = 0, from the kernels as from the plain versions
    (and the reference); the rest at the LN gates."""
    from consensusml_tpu_torch.models import fused_ln as tln

    x, dy, gamma, beta = _ln_case(dev, 64, 1024, dtype, 12)
    beta = torch.zeros_like(beta)
    x[5] = (x[5].float() * 1e-39).to(dtype)
    dy[9] = (dy[9].float() * 1e-39).to(dtype)
    y = tln.ln_fwd(x, gamma, beta, 1e-6, dtype)
    dx, dg, db = tln.ln_bwd(dy, x, gamma, 1e-6)
    yp = tln.ln_fwd_plain(x, gamma, beta, 1e-6, dtype)
    dxp, dgp, dbp = tln.ln_bwd_plain(dy, x, gamma, 1e-6)
    torch.cuda.synchronize()
    assert not y[5].any() and not yp[5].any() and not dx[9].any() and not dxp[9].any()
    assert _ln_rows_ok(y, yp) and _ln_rows_ok(dx, dxp)
    xc = x.float() - x.float().mean(1, keepdim=True)
    xhat = xc * torch.rsqrt((xc * xc).mean(1, keepdim=True) + 1e-6)
    dyf = dy.float()
    assert bool(((dg - dgp).abs() <= LN_SUM_RTOL * (dyf * xhat).abs().sum(0) + 1e-30).all())
    assert bool(((db - dbp).abs() <= LN_SUM_RTOL * dyf.abs().sum(0) + 1e-30).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,h", [(8192, 1024), (2048, 1024), (1, 1024), (333, 136), (64, 2048), (17, 4096), (5, 8)])
def test_ln_bwd_is_one_launch_and_reruns_bit_identically(dev, m, h, dtype):
    """The one-launch backward at each LN shape: three reruns give the same
    bits (the partials folded in block order after the ticket, whatever
    order the blocks ran in), one launch a call, and the ticket is left
    zero for the next launch."""
    from consensusml_tpu_torch.models import fused_ln as tln

    x, dy, gamma, _beta = _ln_case(dev, m, h, dtype, 2 * m + h)
    before = tln.ln_bwd.launches
    runs = [tln.ln_bwd(dy, x, gamma, 1e-6) for _ in range(3)]
    torch.cuda.synchronize()
    assert tln.ln_bwd.launches == before + 3
    assert all(_same_bits(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    assert not tln._ticket(x.device).any()
    dxp, dgp, dbp = tln.ln_bwd_plain(dy, x, gamma, 1e-6)
    assert _ln_rows_ok(runs[0][0], dxp)


def test_ln_backward_is_deterministic_and_autograd_keeps_its_graph(dev):
    """The fixed-order fold gives dgamma and dbeta the same bits on a rerun;
    ``fused_layer_norm`` on CUDA tensors has a ``grad_fn`` and its
    gradients come from the kernels."""
    from consensusml_tpu_torch.models import fused_ln as tln

    x, dy, gamma, beta = _ln_case(dev, 8192, 1024, torch.bfloat16, 3)
    runs = [tln.ln_bwd(dy, x, gamma, 1e-6) for _ in range(3)]
    assert all(_same_bits(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    leaves = [t.clone().requires_grad_() for t in (x.view(8, 1024, 1024), gamma, beta)]
    before = (tln.ln_fwd.launches, tln.ln_bwd.launches)
    y = tln.fused_layer_norm(*leaves, out_dtype=torch.bfloat16)
    assert y.grad_fn is not None and y.shape == (8, 1024, 1024)
    grads = torch.autograd.grad(y, leaves, dy.view(8, 1024, 1024))
    torch.cuda.synchronize()
    assert (tln.ln_fwd.launches, tln.ln_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(grads[1], runs[0][1]) and torch.equal(grads[2], runs[0][2])


def test_ln_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from consensusml_tpu_torch.models import fused_ln as tln

    x = torch.randn(64, 256, device=dev)
    v = torch.ones(256, device=dev)
    with pytest.raises(ValueError):  # a non-contiguous (M, H) view is refused, never copied
        tln.ln_fwd(torch.randn(256, 64, device=dev).t(), v, v)
    with pytest.raises(ValueError):
        tln.ln_fwd(torch.randn(64, 100, device=dev), torch.ones(100, device=dev), torch.ones(100, device=dev))
    with pytest.raises(ValueError):
        tln.ln_fwd(torch.randn(4, 8192, device=dev), torch.ones(8192, device=dev), torch.ones(8192, device=dev))
    with pytest.raises(ValueError):
        tln.ln_fwd(x.half(), v, v)
    with pytest.raises(ValueError):
        tln.ln_fwd(x, v[:128], v)
    with pytest.raises(ValueError):
        tln.ln_bwd(x[:32], x, v)
    with pytest.raises(RuntimeError):  # no (M, H) view without a copy
        tln.fused_layer_norm(torch.randn(4, 256, 8, device=dev).transpose(1, 2), v, v)


def test_gpt2_worker_step_through_ln_kernels_matches_plain(dev):
    """One smoke-config worker step at hidden 128 (f32, dropout on) with
    ``norm_impl="pallas"`` on the card: every LayerNorm launches each LN
    kernel once, and the loss and gradients match the same step with
    ``norm_impl="jnp"`` (the plain versions; attention plain in both) to
    f32 summation-order noise."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM, gpt2_loss_fn

    geom = dict(vocab_size=64, hidden=128, layers=2, heads=2, max_len=32, dtype=torch.float32)
    init = GPT2LM(GPT2Config(**geom), device=dev).init_weights(torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, 64, (8, 16), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    out = {}
    for impl in ("pallas", "jnp"):
        model = GPT2LM(GPT2Config(**geom, norm_impl=impl), device="meta")
        leaves = {n: p.detach().clone().requires_grad_() for n, p in init.named_parameters()}
        kernels.reset_launch_counts()
        loss, _ = gpt2_loss_fn(model, attn_impl="torch")(
            leaves, {}, {"input_ids": ids}, torch.Generator(device=dev).manual_seed(2))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        out[impl] = (float(loss.detach()), grads, kernels.launch_counts())
    n_ln = 2 * geom["layers"] + 1
    assert (out["pallas"][2]["ln_fwd"], out["pallas"][2]["ln_bwd"]) == (n_ln, n_ln)
    assert all(v == 0 for v in out["jnp"][2].values())
    assert abs(out["pallas"][0] - out["jnp"][0]) <= 1e-5
    for a, b in zip(out["pallas"][1], out["jnp"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7


def _same_bits_or_nan(a, b):
    """Bit for bit, two NaNs equal whatever their payloads (the card's
    arithmetic returns its canonical NaN)."""
    if a.dtype != torch.float32:
        return _same_bits(a, b)
    both = torch.isnan(a) & torch.isnan(b)
    return _same_bits(torch.where(both, 0.0, a), torch.where(both, 0.0, b))


def _subnormal_rows(x):
    """The subnormal hazards in rows 5-8 of (R, C) f32 rows: all
    subnormal (scale 0), an absmax whose scale would be subnormal (scale
    0), subnormal elements beside a tiny normal absmax, and a NaN."""
    c = x.shape[1]
    sign = torch.where(torch.arange(c, device=x.device) % 2 == 1, 1.0, -1.0)
    tiny = 2.0**-126
    x[5] = 1e-39 * sign
    x[6] = 5e-38 * sign
    x[7] = 0.9 * tiny * sign
    x[7, 0] = 448 * 1.5 * tiny
    x[8, 3] = float("nan")
    return x


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_quantize_kernels_flush_subnormals_as_plain(dev, fmt):
    """The stand-alone quantize/dequantize kernels of every format on the
    codec hazards and the subnormal rows, bit for bit against their plain
    versions (which equal the reference, tests/test_torch_fp8.py)."""
    from consensusml_tpu_torch.compress import kernels as tck

    quant, dequant = getattr(tck, f"quantize_{fmt}"), getattr(tck, f"dequantize_{fmt}")
    for rows, chunk in ((4 * 100_514, 512), (37, 128), (9, 1024)):
        x = _subnormal_rows(_codec_rows(dev, rows, chunk, rows + 3))
        x[3] *= 2.0**-120  # tiny normal values: small codes times small scales give subnormal decodes
        before = (quant.launches, dequant.launches)
        q, s = quant(x)
        d = dequant(q, s)
        torch.cuda.synchronize()
        assert (quant.launches, dequant.launches) == (before[0] + 1, before[1] + 1)
        qp, sp = getattr(tck, f"quantize_{fmt}_plain")(x)
        dp = getattr(tck, f"dequantize_{fmt}_plain")(q, s)
        assert _same_bits(q, qp) and _same_bits_or_nan(s, sp) and _same_bits_or_nan(d, dp)
        assert s[5] == 0 and s[6] == 0 and torch.isnan(s[8])
        codes = q.view(torch.uint8) if fmt == "fp8" else q
        assert not (codes[5].to(torch.int32) & 0x7F).any()


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_fused_encode_formats_kernel_bit_equal_to_plain(dev, fmt):
    """The fused encode in every format at the largest bucket's rows and a
    small shape, with the codec hazards, the subnormal rows and a
    subnormal xhat (read as zero)."""
    from consensusml_tpu_torch.compress import kernels as tck

    gen = torch.Generator(device=dev).manual_seed(15)
    for rows, chunk in ((4 * 100_514, 512), (37, 128)):
        x = _subnormal_rows(_codec_rows(dev, rows, chunk, rows))
        xhat = x + 0.1 * torch.randn(rows, chunk, generator=gen, device=dev)
        xhat[5:9] = 0.0
        xhat[9] = -2e-39
        before = tck.fused_pack_quantize.launches
        got = tck.fused_pack_quantize(x, xhat, fmt=fmt)
        want = tck.fused_pack_quantize_plain(x, xhat, fmt)
        torch.cuda.synchronize()
        assert tck.fused_pack_quantize.launches == before + 1
        assert all(_same_bits_or_nan(g, w) for g, w in zip(got, want))
        assert got[1][5] == 0 and torch.isnan(got[1][8])
        del got, want, x, xhat


@pytest.mark.parametrize("weights", [(0.3,), (1 / 3, 0.7), (1 / 3, 1 / 3, 1 / 3)], ids=["1src", "2src", "3src"])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_fused_decode_kernel_bit_equal_to_plain(dev, fmt, weights):
    """``fused_dequantize_accumulate`` against its plain version: payloads
    of the fused encode (hazard rows in them) at 1-3 sources, an ``s``
    with subnormal, inf and NaN elements."""
    from consensusml_tpu_torch.compress import kernels as tck

    gen = torch.Generator(device=dev).manual_seed(len(weights))
    rows, chunk = 4 * 6160, 512
    s = torch.randn(rows, chunk, generator=gen, device=dev)
    s[0, :4] = torch.tensor([1e-39, -0.0, float("inf"), float("nan")], device=dev)
    sources = []
    for j in range(len(weights)):
        x = _subnormal_rows(_codec_rows(dev, rows, chunk, 40 + j)) * 10.0 ** (-j)
        data, scales, _ = tck.fused_pack_quantize(x, torch.zeros_like(x), fmt=fmt)
        sources.append((data, scales))
    before = tck.fused_dequantize_accumulate.launches
    got = tck.fused_dequantize_accumulate(s, sources, fmt=fmt, weights=weights)
    torch.cuda.synchronize()
    assert tck.fused_dequantize_accumulate.launches == before + 1
    want = tck.fused_dequantize_accumulate_plain(s, sources, fmt=fmt, weights=weights)
    assert _same_bits_or_nan(got, want)


def test_fused_wire_formats_on_card_equal_cpu(dev, monkeypatch):
    """``FusedBucketCodec`` on a stacked (4, n) CUDA bucket in every format:
    encode and decode_accumulate each launch their kernel once and never
    reach a plain version; payload, xhat' and the receive equal the same
    codec on the CPU. ``PallasFp8Compressor`` on the same buffer (the fp8
    two-step wire) launches its two kernels and equals the CPU too."""
    from consensusml_tpu_torch.compress import PallasFp8Compressor
    from consensusml_tpu_torch.compress import kernels as tck

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(4, 300 * 512, generator=gen, device=dev)
    xhat = 0.5 * x + 0.1 * torch.randn(4, 300 * 512, generator=gen, device=dev)
    s = torch.randn(4, 300 * 512, generator=gen, device=dev)

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for fmt in ("int8", "int4", "fp8"):
        codec = tck.FusedBucketCodec(fmt=fmt, chunk=512)
        want_p, want_h = codec.encode(x.cpu(), xhat.cpu())
        want_r = codec.decode_accumulate(s.cpu(), [want_p] * 3, (1 / 3,) * 3)
        with monkeypatch.context() as m:
            m.setattr(tck, "fused_pack_quantize_plain", refuse)
            m.setattr(tck, "fused_dequantize_accumulate_plain", refuse)
            before = (tck.fused_pack_quantize.launches, tck.fused_dequantize_accumulate.launches)
            p, h = codec.encode(x, xhat)
            recv = codec.decode_accumulate(s, [p] * 3, (1 / 3,) * 3)
            torch.cuda.synchronize()
            after = (tck.fused_pack_quantize.launches, tck.fused_dequantize_accumulate.launches)
        assert after == (before[0] + 1, before[1] + 1)
        assert _same_bits(p.data.cpu(), want_p.data) and _same_bits(p.scales.cpu(), want_p.scales)
        assert _same_bits(h.cpu(), want_h) and _same_bits(recv.cpu(), want_r)
    comp = PallasFp8Compressor(chunk=512)
    want = comp.compress(x.cpu() - xhat.cpu(), stacked=True)
    with monkeypatch.context() as m:
        for name in ("quantize_fp8", "dequantize_fp8"):
            m.setattr(tck, f"{name}_plain", refuse)
        before = (tck.quantize_fp8.launches, tck.dequantize_fp8.launches)
        p = comp.compress(x - xhat, stacked=True)
        dec = comp.decompress(p)
        torch.cuda.synchronize()
        assert (tck.quantize_fp8.launches, tck.dequantize_fp8.launches) == (before[0] + 1, before[1] + 1)
    assert _same_bits(p.data.cpu(), want.data) and _same_bits(p.scales.cpu(), want.scales)
    assert _same_bits(dec.cpu(), comp.decompress(want))


def test_new_codec_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from consensusml_tpu_torch.compress import kernels as tck

    with pytest.raises(ValueError):
        tck.quantize_fp8(torch.zeros(4, 100, device=dev))
    with pytest.raises(ValueError):
        tck.dequantize_fp8(torch.zeros(4, 128, dtype=torch.int8, device=dev), torch.zeros(4, device=dev))
    with pytest.raises(ValueError):
        tck.fused_pack_quantize(torch.zeros(4, 100, device=dev), torch.zeros(4, 100, device=dev), fmt="fp8")
    src = (torch.zeros(4, 128, dtype=torch.int8, device=dev), torch.zeros(4, device=dev))
    with pytest.raises(ValueError):
        tck.fused_dequantize_accumulate(torch.zeros(4, 128, device=dev), [src] * 9, fmt="int8", weights=(0.1,) * 9)
    with pytest.raises(ValueError):
        tck.fused_dequantize_accumulate(torch.zeros(4, 128, device=dev), [src], fmt="fp8", weights=(1.0,))


# ---------------------------------------------------------------------------
# the collective backend: gloo ranks on the card, the wire staged through
# pinned host memory
# ---------------------------------------------------------------------------


def _collective_case(wire):
    """A ring of 2 (both shifts to the one peer) over GPT-2 smoke's
    parameters in 3000-byte buckets, one CHOCO round from a seeded state."""
    import numpy as np

    from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
    from consensusml_tpu_torch.configs import gpt2_config, gpt2_init_params
    from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
    from consensusml_tpu_torch.topology import RingTopology

    comp = {"exact": None, "int8": PallasInt8Compressor(chunk=128),
            "topk_int8": topk_int8_compressor(chunk=128, k=13, impl="auto"),
            "topk_int8_per_leaf": topk_int8_compressor(chunk=128, k=13, impl="auto"),
            "global_topk": topk_int8_compressor(ratio=0.1, chunk=128, impl="reference")}[wire]
    bucket_bytes = None if wire == "topk_int8_per_leaf" else 3000
    engine = ConsensusEngine(GossipConfig(topology=RingTopology(2), compressor=comp, gamma=0.3,
                                          bucket_bytes=bucket_bytes))
    params = {n: a * np.float32(50.0) for n, a in gpt2_init_params(gpt2_config("smoke"), 0, 2).items()}
    tree = {"params": params, "model_state": {}}
    state = None
    if comp is not None:
        zero = engine.init_state(T_tree(tree), world_size=2)
        rng = np.random.default_rng(1)
        state = {"xhat": [rng.normal(size=tuple(b.shape)).astype(np.float32) for b in zero.xhat],
                 "s": [rng.normal(size=tuple(b.shape)).astype(np.float32) for b in zero.s]}
    return engine, tree, state


def T_tree(tree):
    from consensusml_tpu_torch.utils import tree as T

    return T.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("wire", ["exact", "int8", "topk_int8", "topk_int8_per_leaf", "global_topk"])
def test_collective_round_on_card_equals_cpu(dev, wire):
    """Two ``gloo`` ranks on the card and two on the CPU, one round from the
    same inputs: bit-equal results (the kernels equal their plain
    versions, the mixing and the CHOCO update are the same f64-exact
    multiply-adds); the kernels launched a bucket a round as the code
    predicts (fused: one encode and one three-source decode; two-step:
    one top-k, quantize and own decode, a dequantize and an accumulating
    scatter a shift), on the per-leaf wire the same a leaf (GPT-2 smoke's
    32-element LayerNorm leaves each one 128-chunk, padded), the global
    top-k none; the bytes sent equal ``wire_bytes_per_round``, and the
    bytes staged are the payload out once and in once a shift."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.comm import check
    from consensusml_tpu_torch.comm.launch import launch
    from consensusml_tpu_torch.utils import tree as T

    kernels.build()
    engine, tree, state = _collective_case(wire)
    cases = [(engine, tree, [1], state)]
    card = launch(check.gossip_cases, 2, cases, "gloo", "cuda", timeout=120.0)
    cpu = launch(check.gossip_cases, 2, cases, "gloo", "cpu", timeout=120.0)
    for got, want in zip(card, cpu):
        got, want = got[0], want[0]
        for (path, g), (_q, w) in zip(T.flatten_with_paths(got["tree"]), T.flatten_with_paths(want["tree"])):
            assert (g.view("uint32") == w.view("uint32")).all(), path
        if state is not None:
            for key in ("xhat", "s"):
                for g, w in zip(got["state"][key], want["state"][key]):
                    assert (g.view("uint32") == w.view("uint32")).all(), key
        per_worker = T.tree_map(lambda a: torch.from_numpy(a[0]), tree)
        wire_bytes = engine.wire_bytes_per_round(per_worker)
        assert got["transport"]["bytes_sent"] == wire_bytes
        assert got["transport"]["bytes_staged"] == wire_bytes // 2 * 3
        plan = engine.bucket_plan(per_worker)
        b = plan.num_buckets if plan is not None else len(T.leaves(per_worker))
        n = got["launches"]
        if wire == "int8":
            assert (n["fused_choco_encode"], n["fused_dequantize_accumulate"]) == (b, b)
        if wire in ("topk_int8", "topk_int8_per_leaf"):
            assert (n["chunked_topk"], n["quantize_int8"], n["dequantize_int8"], n["chunk_scatter"]) == (b, b, 3 * b, 3 * b)
            assert got["forms"]["chunk_scatter"] == {"acc": 2 * b}
        expected = {"int8": 2, "topk_int8": 4, "topk_int8_per_leaf": 4, "exact": 0, "global_topk": 0}[wire]
        assert sum(1 for v in n.values() if v) == expected


# ---------------------------------------------------------------------------
# the per-leaf wire's codec kernels, and the fault-masked and push-sum rounds
# ---------------------------------------------------------------------------

# GPT-2 smoke's per-worker leaf sizes and a few others: leaves shorter than
# a chunk (24, 32), one chunk plus a tail (200), odd sizes past several
PER_LEAF_SHAPES = [(24,), (32,), (200,), (32, 96), (3, 300), (64, 32), (1000,), (2050,)]


@pytest.mark.parametrize("codec", ["int8", "int4", "fp8", "topk_int8", "topk_int4"])
def test_per_leaf_codec_kernels_bit_equal_to_plain(dev, codec, monkeypatch):
    """The codecs leaf by leaf, at the per-leaf wire's shapes (the chunk
    clamped to a short leaf rounded up to 128), four workers stacked: the
    payload, the decode and the accumulating receive on the card
    bit-equal to the CPU's, each kernel launched once a leaf a call and no
    plain version reached by a CUDA tensor."""
    from consensusml_tpu_torch.compress import (
        PallasFp8Compressor,
        PallasInt4Compressor,
        PallasInt8Compressor,
        topk_int4_compressor,
        topk_int8_compressor,
    )
    from consensusml_tpu_torch.compress import kernels as tck

    comp = {"int8": PallasInt8Compressor(chunk=512), "int4": PallasInt4Compressor(chunk=512),
            "fp8": PallasFp8Compressor(chunk=512), "topk_int8": topk_int8_compressor(chunk=512, k=8, impl="auto"),
            "topk_int4": topk_int4_compressor(chunk=512, k=8, impl="auto")}[codec]
    names = [n for n in ("quantize_int8", "dequantize_int8", "quantize_int4", "dequantize_int4", "quantize_fp8",
                         "dequantize_fp8", "chunked_topk", "chunk_scatter")]

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached a plain version")

    gen = torch.Generator(device=dev).manual_seed(11)
    for shape in PER_LEAF_SHAPES:
        x = torch.randn((4,) + shape, generator=gen, device=dev)
        acc = torch.randn((4,) + shape, generator=gen, device=dev)
        want = comp.compress(x.cpu(), stacked=True)
        want_dec = comp.decompress(want)
        want_acc = comp.decompress_accumulate(want, acc.cpu(), 0.3)
        with monkeypatch.context() as m:
            for name in names:
                m.setattr(tck, f"{name}_plain", refuse)
            before = {n: getattr(tck, n).launches for n in names}
            p = comp.compress(x, stacked=True)
            dec = comp.decompress(p)
            got_acc = comp.decompress_accumulate(p, acc, 0.3)
            torch.cuda.synchronize()
            launched = {n: getattr(tck, n).launches - before[n] for n in names if getattr(tck, n).launches > before[n]}
        for g, w in zip(p.wire_tensors(), want.wire_tensors()):
            assert g.dtype == w.dtype and g.shape == w.shape, shape
            assert torch.equal(g.cpu().view(torch.uint8), w.view(torch.uint8)), shape
        assert _same_bits(dec.cpu(), want_dec) and _same_bits(got_acc.cpu(), want_acc), shape
        if codec.startswith("topk"):
            quant = "int4" if codec == "topk_int4" else "int8"
            # compress: top-k and the values' quantize; decompress: dequantize
            # and scatter; the receive: dequantize and the accumulating scatter
            assert launched == {"chunked_topk": 1, f"quantize_{quant}": 1, f"dequantize_{quant}": 2,
                                "chunk_scatter": 2}, (shape, launched)
        else:
            assert launched == {f"quantize_{codec}": 1, f"dequantize_{codec}": 2}, (shape, launched)


def _fault_cases():
    """Four ranks: exact gossip with faults on the ring (bucketed and per
    leaf), push-sum on the one-peer graph (masked and not) and on the dense
    graph (masked), two rounds each under given masks."""
    import numpy as np

    from consensusml_tpu_torch.consensus import ConsensusEngine, FaultConfig, GossipConfig
    from consensusml_tpu_torch.topology import topology_from_name

    rng = np.random.default_rng(3)
    tree = {"params": {"a": rng.normal(size=(4, 40, 37)).astype(np.float32),
                       "b": rng.normal(size=(4, 24)).astype(np.float32)},
            "model_state": {"batch_stats": {"m": rng.normal(size=(4, 48)).astype(np.float32)}}}
    masks = [np.array([1, 0, 1, 1], np.float32), np.array([0, 1, 1, 0], np.float32)]
    eng = lambda topo, **kw: ConsensusEngine(GossipConfig(topology=topology_from_name(topo, 4), **kw))  # noqa: E731
    return [
        (eng("ring", faults=FaultConfig(0.1), bucket_bytes=3000), tree, [0, 1], None, masks),
        (eng("ring", faults=FaultConfig(0.1), bucket_bytes=None), tree, [0, 1], None, masks),
        (eng("onepeer-exp", push_sum=True), tree, [0, 1], {"w": np.array([0.7, 1.2, 1.0, 1.1], np.float32)}, None),
        (eng("onepeer-exp", push_sum=True, faults=FaultConfig(0.1)), tree, [0, 1], None, masks),
        (eng("dense", push_sum=True, faults=FaultConfig(0.1)), tree, [0, 1], None, masks),
    ]


def test_fault_and_pushsum_rounds_on_card_equal_cpu(dev):
    """Four ``gloo`` ranks on the card and four on the CPU, the same masked
    and push-sum rounds from the same inputs: bit-equal trees and masses
    (``collectives.mix_masked``'s chain and push-sum's are f64-exact
    multiply-adds and IEEE products and quotients on both), the same bytes
    sent, no kernel launched."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.comm import check
    from consensusml_tpu_torch.comm.launch import launch
    from consensusml_tpu_torch.utils import tree as T

    kernels.build()
    cases = _fault_cases()
    card = launch(check.gossip_cases, 4, cases, "gloo", "cuda", timeout=180.0)
    cpu = launch(check.gossip_cases, 4, cases, "gloo", "cpu", timeout=180.0)
    for rank, (got_r, want_r) in enumerate(zip(card, cpu)):
        for i, (got, want) in enumerate(zip(got_r, want_r)):
            for (path, g), (_q, w) in zip(T.flatten_with_paths(got["tree"]), T.flatten_with_paths(want["tree"])):
                assert (g.view("uint32") == w.view("uint32")).all(), (rank, i, path)
            if want["state"] is not None:
                assert (got["state"]["w"].view("uint32") == want["state"]["w"].view("uint32")).all(), (rank, i)
            assert got["bytes_by_round"] == want["bytes_by_round"], (rank, i)
            assert not any(got["launches"].values()), (rank, i)


def test_masked_and_pushsum_simulated_rounds_on_card_match_cpu(dev):
    """The simulated backend's masked and push-sum rounds on the card: the
    mixing is a matrix product (f32, no TF32), which the card's library
    sums in its own order, so the trees are held within 1e-6 of the CPU's
    relative to ``|W'| @ |x|``; masked rows and the masses to the same;
    dead workers' rows bit-equal to their input."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.utils import tree as T

    torch.backends.cuda.matmul.allow_tf32 = False
    for engine, tree, steps, state, masks in _fault_cases():
        t_cpu = T_tree(tree)
        t_dev = T.tree_map(lambda v: v.to(dev), t_cpu)
        s_cpu = engine.init_state(t_cpu, world_size=4)
        if state is not None:
            s_cpu = type(s_cpu)(w=torch.from_numpy(state["w"]))
        s_dev = None if s_cpu is None else type(s_cpu)(w=s_cpu.w.to(dev))
        topo = engine.topology
        for i, step in enumerate(steps):
            w = simulated.phase_matrices(topo)[step % topo.period] if topo.is_time_varying else \
                simulated.mixing_matrix(topo)
            alive = None if masks is None else torch.from_numpy(masks[i])
            before = t_dev
            t_cpu, s_cpu = engine.round_simulated(t_cpu, s_cpu, w, step=step, alive=alive)
            t_dev, s_dev = engine.round_simulated(t_dev, s_dev, w.to(dev), step=step,
                                                  alive=None if alive is None else alive.to(dev))
            for (path, g), (_p, c), (_q, b) in zip(T.flatten_with_paths(t_dev), T.flatten_with_paths(t_cpu),
                                                   T.flatten_with_paths(before)):
                scale = simulated.mix_stacked(b.abs().cpu(), w.abs())
                assert bool(((g.cpu() - c).abs() <= 1e-6 * scale + 1e-30).all()), (path, i)
                if masks is not None and not engine.config.push_sum_enabled:
                    dead = torch.from_numpy(masks[i] == 0)
                    assert torch.equal(g.cpu()[dead], b.cpu()[dead]), (path, i)
            if s_dev is not None:
                assert bool(((s_dev.w.cpu() - s_cpu.w).abs() <= 1e-6).all())
                assert abs(float(s_dev.w.double().sum()) - 4.0) <= 1e-5 * 4


# ---------------------------------------------------------------------------
# overlap gossip (the correction's exchange in flight) and the fused codec
# ---------------------------------------------------------------------------

def _overlap_cases():
    """Four ranks on a ring: overlap gossip exact (depth 2), on the fused
    int8 wire (depth 1) and on top-k + int8 (depth 2), GPT-2 smoke's
    parameters and a BN-style statistic in 3000-byte buckets, three
    rounds each."""
    import numpy as np

    from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
    from consensusml_tpu_torch.configs import gpt2_config, gpt2_init_params
    from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
    from consensusml_tpu_torch.topology import RingTopology

    rng = np.random.default_rng(5)
    tree = {"params": gpt2_init_params(gpt2_config("smoke"), 0, 4),
            "model_state": {"batch_stats": {"bn.mean": rng.normal(size=(4, 48)).astype(np.float32)}}}
    eng = lambda depth, comp=None: ConsensusEngine(GossipConfig(  # noqa: E731
        topology=RingTopology(4), compressor=comp, gamma=0.3, bucket_bytes=3000, overlap=True, pipeline_depth=depth))
    return [(eng(2), tree, [0, 1, 2]), (eng(1, PallasInt8Compressor(chunk=128)), tree, [0, 1, 2]),
            (eng(2, topk_int8_compressor(chunk=128, k=13, impl="auto")), tree, [0, 1, 2])]


def test_overlap_collective_rounds_on_card_equal_cpu(dev):
    """Four ``gloo`` ranks on the card and four on the CPU, three overlap
    rounds each (the correction posted, the parameters overwritten in
    place while it is in flight, then finished): every round's ``z`` and
    the final queue and CHOCO state bit-equal; the same bytes sent each
    round; on the card the fused wire's encode and three-source decode
    once a bucket a round, the two-step wire's four kernels as in a
    round."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.comm import check
    from consensusml_tpu_torch.comm.launch import launch
    from consensusml_tpu_torch.utils import tree as T

    kernels.build()
    cases = _overlap_cases()
    card = launch(check.overlap_cases, 4, cases, "gloo", "cuda", timeout=180.0)
    cpu = launch(check.overlap_cases, 4, cases, "gloo", "cpu", timeout=180.0)
    for rank, (got_r, want_r) in enumerate(zip(card, cpu)):
        for i, (got, want) in enumerate(zip(got_r, want_r)):
            for g, w in zip(T.leaves([got["z"], got["state"]]), T.leaves([want["z"], want["state"]])):
                assert (g.view("uint32") == w.view("uint32")).all(), (rank, i)
            assert got["bytes_by_round"] == want["bytes_by_round"], (rank, i)
            engine = cases[i][0]
            per_worker = T.tree_map(lambda a: torch.from_numpy(a[0]), cases[i][1])
            b = engine.bucket_plan(per_worker).num_buckets
            n = {k: v for k, v in got["launches"].items() if v}
            expect = [{}, {"fused_choco_encode": 3 * b, "fused_dequantize_accumulate": 3 * b},
                      {"chunked_topk": 3 * b, "quantize_int8": 3 * b, "dequantize_int8": 9 * b,
                       "chunk_scatter": 9 * b}][i]
            assert n == expect, (rank, i, n)


def test_inflight_exchange_on_card_crosses_barriers(dev):
    """Four ranks sharing the card: an exchange staged on the side stream
    and posted, its send buffer overwritten on the card, three barriers and
    an all-reduce on the mesh's group, then finished: each rank holds its
    neighbours' values as they were staged."""
    from consensusml_tpu_torch.comm import check
    from consensusml_tpu_torch.comm.launch import launch

    for rank, res in enumerate(launch(check.inflight_across_barriers, 4, 3, "gloo", "cuda", timeout=120.0)):
        assert res["received"] == [float((rank - 1) % 4), float((rank + 1) % 4)]
        assert res["uniform"] and res["mean"] == [1.5] * 3


def _swap_plain(monkeypatch, names):
    from consensusml_tpu_torch.compress import kernels as tck

    for name in names:
        monkeypatch.setattr(tck, name, getattr(tck, f"{name}_plain"))


@pytest.mark.parametrize("codec", ["int8", "topk_int8"])
def test_overlap_simulated_correction_kernels_equal_plain(dev, codec, monkeypatch):
    """The simulated compressed correction on the card (four stacked
    workers, depth 2, three rounds) through the codec kernels, then
    through their plain versions on the same device: the queue and the
    CHOCO state bit for bit."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
    from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
    from consensusml_tpu_torch.topology import RingTopology
    from consensusml_tpu_torch.utils import tree as T

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    comp = PallasInt8Compressor(chunk=128) if codec == "int8" else topk_int8_compressor(chunk=128, k=13, impl="auto")
    engine = ConsensusEngine(GossipConfig(topology=RingTopology(4), compressor=comp, gamma=0.3, bucket_bytes=3000,
                                          overlap=True, pipeline_depth=2))
    tree = T.tree_map(lambda a: torch.from_numpy(a).to(dev), _overlap_cases()[0][1])
    w = simulated.mixing_matrix(engine.topology, device=dev)

    def rounds():
        st = engine.init_state(tree, world_size=4)
        x = tree
        for _ in range(3):
            z = engine.apply_correction(x, st)
            st = engine.correction_simulated(z, w, st)
            x = T.tree_map(lambda v: v * 0.99 + 0.01, z)
        torch.cuda.synchronize()
        return T.leaves([st.correction, list(st.pending), st.choco.xhat, st.choco.s])

    got = rounds()
    with monkeypatch.context() as m:
        names = ["fused_pack_quantize"] if codec == "int8" else ["chunked_topk", "quantize_int8", "dequantize_int8",
                                                                  "chunk_scatter"]
        _swap_plain(m, names)
        want = rounds()
    for g, w_ in zip(got, want):
        assert _same_bits(g, w_)


def test_fused_codec_round_kernels_equal_plain(dev, monkeypatch):
    """A fused-codec round on the card (top-k + int8 over each worker's
    whole tree, four stacked workers) through the codec kernels, each
    launched once, then through their plain versions: parameters,
    ``xhat`` and ``s`` bit for bit."""
    import numpy as np

    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.compress import topk_int8_compressor
    from consensusml_tpu_torch.compress import kernels as tck
    from consensusml_tpu_torch.consensus import ChocoState, ConsensusEngine, GossipConfig
    from consensusml_tpu_torch.topology import RingTopology
    from consensusml_tpu_torch.utils import tree as T

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build()
    engine = ConsensusEngine(GossipConfig(topology=RingTopology(4), compressor=topk_int8_compressor(
        chunk=512, k=8, impl="auto"), gamma=0.3, fused_codec=True))
    tree = T.tree_map(lambda a: torch.from_numpy(a).to(dev), _overlap_cases()[0][1])
    zero = engine.init_state(tree, world_size=4)
    rng = np.random.default_rng(2)
    state = ChocoState(xhat=[torch.from_numpy(rng.normal(size=tuple(zero.xhat[0].shape)).astype(np.float32)).to(dev)],
                       s=[torch.from_numpy(rng.normal(size=tuple(zero.s[0].shape)).astype(np.float32)).to(dev)])
    w = simulated.mixing_matrix(engine.topology, device=dev)
    names = ["chunked_topk", "quantize_int8", "dequantize_int8", "chunk_scatter"]
    before = {n: getattr(tck, n).launches for n in names}
    new, st = engine.round_simulated(tree, state, w, step=1)
    torch.cuda.synchronize()
    assert {n: getattr(tck, n).launches - before[n] for n in names} == {
        "chunked_topk": 1, "quantize_int8": 1, "dequantize_int8": 1, "chunk_scatter": 1}
    with monkeypatch.context() as m:
        _swap_plain(m, names)
        want, wst = engine.round_simulated(tree, state, w, step=1)
    for g, w_ in zip(T.leaves([new, st.xhat, st.s]), T.leaves([want, wst.xhat, wst.s])):
        assert _same_bits(g, w_)


def _state_on(dev, config, flags, world=2, **build):
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state

    bundle = configs.build(config, "smoke", world=world, device=dev, **build)
    configs.with_train_flags(bundle, rounds=4, **flags)
    params, model_state = configs.init_on_device(bundle, 0, dev)
    return bundle, init_stacked_state(bundle.cfg, params, world, seed=0, model_state=model_state)


def test_checkpoint_round_trip_keeps_a_card_state(dev, tmp_path):
    """A stacked state on the card (the narrow ResNet through the BN
    kernels, SGD with a cosine schedule, clipping and SlowMo, two rounds)
    saved through ``AsyncSaver`` and restored into a fresh state on the
    card: every tensor comes back on the card, bit for bit, with the
    dropout generators' states and the round; one more round from each is
    bit-equal too."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.train.local_sgd import make_simulated_train_step
    from consensusml_tpu_torch.utils.checkpoint import AsyncSaver, restore_state
    from consensusml_tpu_torch.utils.tree import named_tensors

    kernels.build()
    flags = dict(lr_schedule="cosine", warmup_rounds=1, grad_clip=0.5, slowmo_beta=0.2)
    bundle, state = _state_on(dev, "cifar_resnet50", flags, norm_impl="pallas")
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    batches = list(bundle.batches(3, 0))
    for batch in batches[:2]:
        state, _ = step(state, batch)
    saver = AsyncSaver()
    saver.submit(str(tmp_path), state, step=2)
    saver.wait()
    _, fresh = _state_on(dev, "cifar_resnet50", flags, norm_impl="pallas")
    back = restore_state(saver.last_path, fresh)
    assert back.step == 2
    for (p, a), (q, b) in zip(named_tensors(state), named_tensors(back)):
        assert p == q and a.device == b.device and _same_bits(a, b), p
    assert all(torch.equal(x.get_state(), y.get_state()) for x, y in zip(state.generators, back.generators))
    torch.backends.cudnn.deterministic = True
    try:
        one, _ = step(state, batches[2])
        two, _ = step(back, batches[2])
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(_same_bits(a, b) for (_, a), (_, b) in zip(named_tensors(one), named_tensors(two)))


def test_resnet_clipped_step_through_bn_kernels_matches_plain(dev):
    """One clipped SGD step (clip 0.1, below the norm) of the narrow ResNet
    (f32) with ``norm_impl="pallas"`` on the card, against the same step
    with ``"jnp"`` (the plain versions): each BN kernel launched once a BN
    layer, the same pre-clip norm to 1e-5 relative and the update to 1e-4
    of its norm (f32 summation orders in the statistics)."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.train.local_sgd import worker_step

    kernels.build()
    out = {}
    for impl in ("pallas", "jnp"):
        bundle, state = _state_on(dev, "cifar_resnet50", dict(grad_clip=0.1), norm_impl=impl)
        batch = {k: v[0, 0].to(dev) for k, v in next(iter(bundle.batches(1, 0))).items()}
        before = {n: p.clone() for n, p in state.params.items()}
        kernels.reset_launch_counts()
        worker_step(bundle.cfg, bundle.loss_fn, state, 0, batch)
        torch.cuda.synchronize()
        out[impl] = ({n: state.params[n] - before[n] for n in before}, float(state.opt_state.norm[0]),
                     kernels.launch_counts())
    n_bn = sum(1 for n in state.model_state["batch_stats"] if n.endswith(".mean"))
    assert all(out["pallas"][2][k] == n_bn for k in ("bn_stats", "bn_norm", "bn_bwd"))
    assert abs(out["pallas"][1] - out["jnp"][1]) <= 1e-5 * out["jnp"][1] and out["jnp"][1] > 0.1
    diff = sum(float(((out["pallas"][0][n] - u) ** 2).sum()) for n, u in out["jnp"][0].items()) ** 0.5
    assert diff <= 1e-4 * sum(float((u ** 2).sum()) for u in out["jnp"][0].values()) ** 0.5


def test_gpt2_clipped_adam_step_through_flash_kernels_matches_plain(dev):
    """One clipped Adam step (clip 0.05, below the norm) of a 2-layer
    GPT-2 at hidden 128 (two heads of 64, bf16) on 1024 tokens, whose
    attention takes the flash kernels (``attn_impl="cuda"``), against the
    same step on their plain versions (``"torch"``), from an Adam state
    that has taken one step on another batch (a first Adam step is about
    the gradients' signs, which noise flips where they are small): each
    flash kernel launched once a layer, the pre-clip norms within 2e-2
    relative and the update within ``chip_smoke.py``'s GPT-2 gradient gate
    (3e-2 of its norm)."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM, gpt2_loss_fn
    from consensusml_tpu_torch.train.optim import adam, clip_by_global_norm

    kernels.build()
    cfg = GPT2Config(vocab_size=64, hidden=128, layers=2, heads=2, max_len=1024, dropout=0.0)
    init = GPT2LM(cfg, device=dev).init_weights(torch.Generator(device=dev).manual_seed(0))
    params0 = {n: p.detach().float().clone() for n, p in init.named_parameters()}
    ids = [torch.randint(0, 63, (1, 1024), generator=torch.Generator(device=dev).manual_seed(s), device=dev)
           for s in (1, 2)]
    opt = clip_by_global_norm(0.05, adam(1e-3))

    def grads(impl, batch):
        leaves = {n: p.clone().requires_grad_() for n, p in params0.items()}
        loss, _ = gpt2_loss_fn(GPT2LM(cfg, device="meta"), attn_impl=impl)(leaves, {}, {"input_ids": batch}, None)
        return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    history = grads("torch", ids[1])
    out = {}
    for impl in ("cuda", "torch"):
        stacked = {n: p.unsqueeze(0).clone() for n, p in params0.items()}
        st = opt.init(stacked, 1)
        opt.update_({n: p[0] for n, p in stacked.items()}, history, st, 0)
        before = {n: p[0].clone() for n, p in stacked.items()}
        kernels.reset_launch_counts()
        g = grads(impl, ids[0])
        launched = kernels.launch_counts()
        opt.update_({n: p[0] for n, p in stacked.items()}, g, st, 0)
        torch.cuda.synchronize()
        out[impl] = ({n: stacked[n][0] - before[n] for n in params0}, float(st.norm[0]), launched)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert out["cuda"][2][name] == cfg.layers and out["torch"][2][name] == 0
    nk, np_ = out["cuda"][1], out["torch"][1]
    assert abs(nk - np_) <= 2e-2 * np_ and min(nk, np_) > 0.05
    diff = sum(float(((out["cuda"][0][n] - u) ** 2).sum()) for n, u in out["torch"][0].items()) ** 0.5
    assert diff <= 3e-2 * sum(float((u ** 2).sum()) for u in out["torch"][0].values()) ** 0.5


def _sync_warnings(fn) -> int:
    """How many device synchronizations ``fn()`` makes (PyTorch's sync
    debug mode warns once a synchronizing call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def test_telemetry_on_gossip_round_adds_no_synchronization(dev):
    """A telemetry-on gossip round (spans recorded, the program's first run
    so the trace-time counters count) under sync debug mode "error": the
    exact bucketed ring round has no synchronization at all; the fused
    int8 round makes as many with telemetry on as with it off."""
    from consensusml_tpu_torch.comm import simulated
    from consensusml_tpu_torch.compress import PallasInt8Compressor
    from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
    from consensusml_tpu_torch.obs import get_tracer
    from consensusml_tpu_torch.topology import RingTopology

    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"params": {"a": torch.randn(4, 3000, generator=gen, device=dev),
                       "b": torch.randn(4, 40, 7, generator=gen, device=dev)},
            "model_state": {"bn.mean": torch.randn(4, 24, generator=gen, device=dev)}}
    w = simulated.mixing_matrix(RingTopology(4)).to(dev)
    tracer = get_tracer()
    was = tracer.enabled

    def engine(comp=None):
        return ConsensusEngine(GossipConfig(topology=RingTopology(4), compressor=comp, gamma=0.3, bucket_bytes=3000))

    engine().round_simulated(tree, None, w)  # kernels and allocator warm
    try:
        tracer.enabled = True
        tracer.clear()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = engine().round_simulated(tree, None, w)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert [e["name"] for e in tracer.events()] == ["bucket.pack", "bucket.mix", "bucket.unpack", "gossip.round"]
        counts = {}
        for on in (False, True):
            tracer.enabled = on
            eng = engine(PallasInt8Compressor(chunk=128))
            st = eng.init_state(tree, world_size=4)
            eng.round_simulated(tree, st, w)  # warm
            eng = engine(PallasInt8Compressor(chunk=128))  # a first run again: its counters count
            counts[on] = _sync_warnings(lambda: eng.round_simulated(tree, st, w))
        assert counts[True] == counts[False]
    finally:
        tracer.enabled = was
    assert torch.isfinite(out["params"]["a"]).all()


def test_engine_decode_step_with_telemetry_adds_no_synchronization(dev):
    """One engine decode step, its inputs uploaded and its token fetch
    replaced beforehand, under sync debug mode "error": the span, the
    request trace's tick, the SLO histograms and gauges read nothing from
    the card."""
    from consensusml_tpu_torch.configs import build_model
    from consensusml_tpu_torch.obs import TraceContext, get_tracer
    from consensusml_tpu_torch.serve import Engine, ServeConfig
    from consensusml_tpu_torch.serve.batcher import Request, RequestHandle

    model = build_model("gpt2_topk", "smoke", device=dev)
    eng = Engine(model, ServeConfig(num_slots=2, block_size=16, max_new_tokens=8), device=dev)
    eng.warmup()
    eng.shutdown()  # the loop thread gone: the test thread drives the step
    ids = [1, 2, 3, 4, 5]
    ctx = TraceContext("sync-debug")
    eng._rt.start(ctx, len(ids), tenant="default")
    eng._admit(Request(ids, 8, RequestHandle(len(ids)), ctx=ctx))
    active = eng._table.active
    arrays = eng._slot_arrays(active)
    eng._pool.device_table(dev)  # cached: the step makes no block change
    real = eng._decode_fn
    host_tokens = torch.zeros(2, dtype=torch.int64)
    eng._slot_arrays = lambda active: arrays
    eng._decode_fn = lambda *a: (host_tokens, real(*a)[1])
    tracer = get_tracer()
    was = tracer.enabled
    tracer.enabled = True
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._decode_step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    finally:
        tracer.enabled = was
    torch.cuda.synchronize()
    assert eng._rt.get(ctx.request_id).decode_ticks == 1
    assert eng._m_intertoken.count >= 1


def test_elastic_joiner_rows_are_the_consensus_mean_on_the_card(dev):
    """An elastic grow of a stacked state on the card (the narrow ResNet,
    SGD with momentum, a cosine schedule, clipping and SlowMo, one round
    through the BN kernels, 2 -> 5 workers): the survivors' rows are the
    input's bit for bit, every joiner's row is ``consensus_mean`` of the
    input's rows on the card bit for bit (and within 1e-6 relative of a
    float64 mean on the host), the joiners' momentum and schedule counts
    are zero, SlowMo restarts at ``x = params``, ``u = 0``."""
    from consensusml_tpu_torch import kernels
    from consensusml_tpu_torch.train.local_sgd import make_simulated_train_step
    from consensusml_tpu_torch.utils.elastic import resize_state
    from consensusml_tpu_torch.utils.tree import consensus_mean

    kernels.build()
    flags = dict(lr_schedule="cosine", warmup_rounds=1, grad_clip=0.5, slowmo_beta=0.2)
    bundle, state = _state_on(dev, "cifar_resnet50", flags, norm_impl="pallas")
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    state, _ = step(state, next(iter(bundle.batches(1, 0))))
    big, _ = _state_on(dev, "cifar_resnet50", flags, world=5, norm_impl="pallas")
    grown = resize_state(big.cfg, state, 5, seed=0)
    for part in ("params", "model_state"):
        old, new = getattr(state, part), getattr(grown, part)
        if part == "model_state":
            old, new = old["batch_stats"], new["batch_stats"]
        mean = consensus_mean(old)
        for n, t in new.items():
            assert t.device == dev and _same_bits(t[:2], old[n]), n
            for j in range(2, 5):
                assert _same_bits(t[j], mean[n]), (n, j)
            ref = old[n].double().mean(0).cpu()
            err = float((mean[n].double().cpu() - ref).norm() / max(float(ref.norm()), 1e-30))
            assert err <= 1e-6, (n, err)
    inner = grown.opt_state.inner
    assert all(float(t[2:].abs().max()) == 0.0 for t in inner.trace.values())
    assert inner.sched_count[2:].tolist() == [0, 0, 0]
    for n, p in grown.params.items():
        assert _same_bits(grown.outer["x"][n], p) and float(grown.outer["u"][n].abs().max()) == 0.0, n


def test_link_probe_default_transfer_times_a_fenced_copy_on_the_card(dev):
    """The link prober's default transfer on the card (the simulated
    backend: every rank on one card): each edge a timed copy of its
    payload fenced by ``torch.cuda.synchronize``; no copy is left in flight
    when a sweep returns, and an edge's time with a 256 MiB payload (a copy
    of ~0.16 ms at the card's 3.35 TB/s) is more than twice its time with a
    4 KiB one (launch and fence alone, ~0.03 ms): the fence waits for the
    copy."""
    from consensusml_tpu_torch.obs import LinkProber, MetricsRegistry
    from consensusml_tpu_torch.topology import RingTopology

    small = LinkProber(RingTopology(4), registry=MetricsRegistry(), device=dev, payload_bytes=1 << 12)
    big = LinkProber(RingTopology(4), registry=MetricsRegistry(), device=dev, payload_bytes=1 << 28)
    lat_small = small.probe_round()
    lat_big = big.probe_round()
    assert set(lat_small) == set(small.edges) and len(lat_small) == 8
    assert all(v > 0 for v in lat_small.values())
    assert torch.cuda.current_stream(dev).query()
    assert sorted(lat_big.values())[4] > 2 * sorted(lat_small.values())[4]
    assert all(b.device == dev for b in big._bufs.values())


# ---------------------------------------------------------------------------
# the device feed (data/prefetch.py) and the native ring on the card
# ---------------------------------------------------------------------------


def test_feed_side_stream_copy_and_event(dev):
    """Host batches staged through pinned memory on the side stream arrive
    equal, the consumer's stream waits on their event (no host sync in
    ``__next__``), and the copied bytes are counted."""
    import numpy as np

    from consensusml_tpu_torch.data.prefetch import DevicePrefetcher

    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 255, (8, 1, 64, 32, 32, 3), dtype=np.uint8),
             "label": rng.integers(0, 10, (8, 1, 64), dtype=np.int32)} for _ in range(6)]
    feed = DevicePrefetcher(iter(host), 2, device=dev)
    got = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in feed:
            assert all(t.device == dev for t in batch.values())
            got.append({k: v.clone() for k, v in batch.items()})  # read on the consumer's stream
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, h in zip(got, host):
        for k in h:
            assert torch.equal(g[k].cpu(), torch.from_numpy(h[k]))
    assert feed.batches_out == 6 and feed.h2d_bytes_total == sum(v.nbytes for h in host for v in h.values())


def test_feed_ring_slots_byte_equal_after_release_and_refill(dev):
    """The ring's zero-copy slots through the feed onto the card, over more
    rounds than slots (every slot released and refilled while later
    batches are in flight), byte-equal to a second loader's copies."""
    import time

    from consensusml_tpu_torch.data import SyntheticClassification, native_cls_feed, native_round_batches

    ds = SyntheticClassification(n=256, image_shape=(32, 32, 3), noise=0.25)
    want = list(native_round_batches(ds, 8, 1, 128, 10, seed=4, wire="u8"))
    feed = native_cls_feed(ds, 8, 1, 128, 10, seed=4, wire="u8", prefetch=2, depth=3, device=dev)
    for w in want:
        batch = next(feed)
        time.sleep(0.01)  # let the producers refill the released slots
        for k in w:
            assert torch.equal(batch[k].cpu(), w[k]), k
    assert feed.last_h2d_bytes == 8 * 128 * (32 * 32 * 3 + 4)
    feed.close()


def test_feed_ring_slots_are_page_locked_in_place(dev):
    """In a process with a CUDA context, the first zero-copy hand-out
    page-locks every slot (``cudaHostRegister``, overlapping page spans
    merged), so a ``non_blocking`` copy from each slot view, the
    prefetcher's, lands byte-equal; ``close()`` unlocks what it locked."""
    import numpy as np

    from consensusml_tpu_torch.data.prefetch import _host_tensor
    from consensusml_tpu_torch.native import NativeLoader

    torch.zeros(1, device=dev)  # the context
    protos = np.random.default_rng(0).normal(size=(10, 3072)).astype(np.float32)
    kw = dict(kind="classification", samples_per_slot=256, sample_floats=3072, sample_ints=1, nclasses_or_vocab=10,
              noise=0.25, prototypes=protos, depth=3, wire="u8", seed=2)
    want = NativeLoader(**kw)
    loader = NativeLoader(**kw)
    stream = torch.cuda.Stream(device=dev)
    for _ in range(5):  # every slot, and two handed out again after a refill
        data_w, ints_w = want.next()
        idx, data, ints = loader.acquire_view()
        for view, w in ((data, data_w), (ints, ints_w)):
            host = _host_tensor(view)
            assert host.is_pinned() and host.data_ptr() == view.ctypes.data
            with torch.cuda.stream(stream):
                got = host.to(dev, non_blocking=True)
            stream.synchronize()
            assert torch.equal(got.cpu(), torch.from_numpy(w))
        loader.release_slot(idx)
    assert loader._locked_runs
    loader.close()
    want.close()
    assert not loader._locked_runs


# ---------------------------------------------------------------------------
# the cost plane: work counts and analysis-only registration on the card
# ---------------------------------------------------------------------------


def _count(fn, *args):
    from consensusml_tpu_torch.workcount import WorkCounter

    c = WorkCounter()
    with c:
        fn(*args)
    return c.flops, c.bytes


def _cost_cases(dev):
    """Each kernel wrapper at a small shape its kernel takes: name ->
    (operands on ``dev``, call)."""
    from consensusml_tpu_torch.compress import kernels as tck
    from consensusml_tpu_torch.models import fused_bn as tbn
    from consensusml_tpu_torch.models import fused_ln as tln

    g = torch.Generator(device=dev).manual_seed(3)
    r = lambda *s, dtype=torch.float32: torch.randn(*s, generator=g, device=dev, dtype=dtype)  # noqa: E731
    x = r(37, 256)
    q, k, v, do = (r(2, 128, 2, 64, dtype=torch.bfloat16) for _ in range(4))
    _o, lse = tfa.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = r(2, 2, 128)
    pq, pk, pv, table, pos = _paged_case(dev, 1)
    x2, g2 = r(64, 256, dtype=torch.bfloat16), r(256)
    mean, _var, scale, shift, rsqrt = tbn.bn_forward_stats(x2, g2, r(256), 1e-5)
    data, scales, _h = tck.fused_pack_quantize(x, x * 0.5, fmt="int8")
    return {
        "quantize_int8": ((x,), tck.quantize_int8), "dequantize_int8": (tck.quantize_int8(x), tck.dequantize_int8),
        "quantize_int4": ((x,), tck.quantize_int4), "dequantize_int4": (tck.quantize_int4(x), tck.dequantize_int4),
        "quantize_fp8": ((x,), tck.quantize_fp8), "dequantize_fp8": (tck.quantize_fp8(x), tck.dequantize_fp8),
        "chunked_topk": ((x, 8), tck.chunked_topk),
        "chunk_scatter": ((*tck.chunked_topk(x, 8), 256), tck.chunk_scatter),
        "fused_choco_encode": ((x, x * 0.5), lambda a, b: tck.fused_pack_quantize(a, b, fmt="int8")),
        "fused_dequantize_accumulate": ((x, [(data, scales)] * 2), lambda s, src: tck.fused_dequantize_accumulate(
            s, src, fmt="int8", weights=(0.5, 0.25))),
        "flash_attention_fwd": ((q, k, v), lambda *a: tfa.flash_attention(*a, causal=True, return_lse=True)),
        "flash_attention_bwd_dq": ((q, k, v, do, lse, delta), lambda *a: tfa.flash_attention_bwd_dq(*a, causal=True)),
        "flash_attention_bwd_dkv": ((q, k, v, do, lse, delta),
                                    lambda *a: tfa.flash_attention_bwd_dkv(*a, causal=True)),
        "paged_attention": ((pq, pk, pv, table, pos), tpa.paged_attention),
        "ln_fwd": ((x2, g2, g2), lambda *a: tln.ln_fwd(*a, 1e-6, out_dtype=torch.bfloat16)),
        "ln_bwd": ((x2, x2, g2), tln.ln_bwd),
        "bn_stats": ((x2,), tbn.bn_stats),
        "bn_norm": ((x2, scale, shift, True), tbn.bn_norm),
        "bn_bwd": ((x2, x2, scale, shift, mean, rsqrt, True), tbn.bn_bwd),
    }


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def test_each_kernel_counts_the_same_work_on_its_kernel_and_plain_paths(dev):
    """Every one of the 19 wrappers: the (flops, bytes) it reports when it
    launches its kernel equal the ones it reports on CPU copies (its plain
    version) and in the fake pass; the kernel path launches once."""
    from consensusml_tpu_torch import kernels, workcount

    cases = _cost_cases(dev)
    assert sorted(cases) == sorted(kernels.KERNELS)
    for name, (ops, call) in cases.items():
        before = kernels.launch_counts()[name]
        on_card = _count(call, *ops)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[name] == before + 1, name
        plain = _count(call, *_to(ops, "cpu"))
        launched, alloc = sum(kernels.launch_counts().values()), torch.cuda.memory_allocated(dev)
        fake = workcount.analyze(call, *ops)
        assert sum(kernels.launch_counts().values()) == launched and torch.cuda.memory_allocated(dev) == alloc
        assert on_card == plain == (fake.flops, fake.bytes_accessed), name
        assert on_card[0] > 0 and on_card[1] > 0, name


def test_registration_launches_nothing_allocates_nothing_draws_nothing(dev):
    """``--cost-ledger``'s registration on the card: the train step of
    ``gpt2_topk`` smoke (its workers' generators) and its gossip round,
    and a GPT-2 engine's stages: no kernel launched, no byte allocated, no
    generator advanced, the state's tensors unchanged."""
    from consensusml_tpu_torch import configs, kernels
    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM
    from consensusml_tpu_torch.obs.costs import CostLedger
    from consensusml_tpu_torch.obs.metrics import MetricsRegistry
    from consensusml_tpu_torch.serve import Engine, ServeConfig
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    bundle = configs.build("gpt2_topk", "smoke", device=dev)
    params, model_state = configs.init_on_device(bundle, 0, dev)
    state = init_stacked_state(bundle.cfg, params, bundle.world_size, model_state=model_state)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in next(iter(bundle.batches(1, 0))).items()}
    ledger = CostLedger(registry=MetricsRegistry(), platform=torch.cuda.get_device_name(dev))
    snap = {n: p.clone() for n, p in state.params.items()}
    gens = [g.get_state().clone() for g in state.generators]
    model = GPT2LM(GPT2Config(vocab_size=64, hidden=64, layers=2, heads=1, max_len=64, dropout=0.0), device=dev)
    eng = Engine(model.init_weights(torch.Generator(device=dev).manual_seed(0)), ServeConfig(num_slots=2, block_size=16),
                 device=dev)
    try:
        eng.warmup()
        torch.cuda.synchronize()
        launched, alloc = sum(kernels.launch_counts().values()), torch.cuda.memory_allocated(dev)
        row = ledger.register("train.step", make_simulated_train_step(bundle.cfg, bundle.loss_fn), state, batch)
        grow = bundle.cfg.engine().register_costs(ledger, {"params": state.params,
                                                           "model_state": state.model_state})
        rows = eng.register_costs(ledger)
        torch.cuda.synchronize()
        assert sum(kernels.launch_counts().values()) == launched
        assert torch.cuda.memory_allocated(dev) == alloc
    finally:
        eng.shutdown()
    assert all(torch.equal(g.get_state(), s) for g, s in zip(state.generators, gens))
    assert all(torch.equal(state.params[n], p) for n, p in snap.items())
    assert row.flops > 0 and grow.flops > 0 and state.step == 0
    assert {"serve.decode", "serve.hotswap.stage", *(f"serve.prefill.b{b}" for b in eng.buckets)} == set(rows)


# (q_offset, k_offset) in units of S, as the ring gives them, and two
# shifts that are not whole tiles (the skips' partial tiles)
OFFSET_FORMS = [(1, 0), (1, 1), (2, 1), (0, 1)]
OFFSET_CASES = [(s, d, form) for s in (1, 65, 600, 1024) for d in (64, 128) for form in OFFSET_FORMS] + \
    [(600, 64, (100, 37)), (600, 128, (0, 70)), (1024, 64, (5, 1000))]


@pytest.mark.parametrize("s,d,form", OFFSET_CASES)
def test_flash_kernels_with_offsets_match_plain(dev, s, d, form):
    """The q/k offset form of the forward, dq and dk/dv kernels (the ring's,
    ``chip_smoke.py``'s ``check.flash_offsets``) against their plain
    versions given the same offsets, causal, at the flash gates, the
    backward fed the plain forward's lse and delta: blocks wholly before
    the queries, the diagonal, one wholly after them (every row attends to
    no key: the values' sum over the reference's visited count, lse
    -1e30, no gradient) and shifts that cut tiles; head dim 64 and 128,
    without and with a ``kv_mask``. Each launch counts once in
    ``offset_launches``."""
    qo, ko = (form[0] * s, form[1] * s) if form in OFFSET_FORMS else form
    off = {"q_offset": qo, "k_offset": ko}
    q, k, v, do = _flash_case(dev, s, 1.0, b=2, d=d)
    fns = (tfa.flash_attention, tfa.flash_attention_bwd_dq, tfa.flash_attention_bwd_dkv)
    for kv_mask in (None, _kv_mask(dev, s, True)[:2]):
        before = [f.offset_launches for f in fns]
        out, lse = tfa.flash_attention(q, k, v, causal=True, kv_mask=kv_mask, return_lse=True, **off)
        ref, ref_lse = tfa.flash_attention_plain(q, k, v, causal=True, kv_mask=kv_mask, return_lse=True, **off)
        delta = tfa._delta(ref, do)
        dq = tfa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, causal=True, kv_mask=kv_mask, **off)
        dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, causal=True, kv_mask=kv_mask, **off)
        want = tfa._bwd_plain_parts(q, k, v, do, ref_lse, delta, True, kv_mask, qo, ko)
        torch.cuda.synchronize()
        assert [f.offset_launches for f in fns] == [n + 1 for n in before]
        msg = f"offsets {off}, mask {kv_mask is not None}"
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0**-6, atol=1e-4, msg=msg)
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5, msg=msg)
        for name, got, plain in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
            torch.testing.assert_close(got.float(), plain.float(), rtol=2.0**-6, atol=3e-3, msg=f"{name}, {msg}")
