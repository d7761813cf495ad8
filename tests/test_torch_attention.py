"""Attention building blocks: the port's ``models/attention.py`` against
``consensusml_tpu/models/attention.py`` on the same numpy inputs.

f32 inputs agree to 1e-5 (same ops, different summation order). bf16
inputs differ only where the output is rounded to bf16 after sums taken
in a different order, so by at most one bf16 ulp: 1e-2 absolute on
outputs of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models import attention as ja
from consensusml_tpu_torch.models import attention as ta

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=0.0, atol=1e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(arr, name):
    jdt, tdt = DT[name]
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _qkv(seed, b, s, t, h, d, name):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, h, d)).astype(np.float32)
    v = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return [_both(x, name) for x in (q, k, v)]


def _close(got, want, name):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **TOL[name]
    )


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["dense", "blockwise"])
@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_matches(name, impl, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, 2, 24, 40, 2, 8, name)
    dtype = DT[name]
    want = ja.dot_product_attention(jq, jk, jv, causal=causal, dtype=dtype[0], impl=impl)
    got = ta.dot_product_attention(tq, tk, tv, causal=causal, dtype=dtype[1], impl=impl)
    _close(got, want, name)


def test_blockwise_multi_block_with_kv_mask_matches():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 2, 20, 20, 2, 8, "f32")
    mask = (np.random.default_rng(2).random((2, 20)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    want = ja.blockwise_attention(
        jq, jk, jv, bias=jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0, -1e30),
        dtype=jnp.float32, block_kv=8,
    )
    got = ta.dot_product_attention(
        tq, tk, tv, kv_mask=torch.from_numpy(mask), dtype=torch.float32, impl="blockwise"
    )
    _close(got, want, "f32")


def test_auto_dispatch_on_cpu_mirrors_reference():
    """Below 512^2 logits auto is dense; above it, off the card, blockwise
    (the reference picks blockwise off the TPU) — never the kernel."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(3, 1, 600, 600, 1, 8, "f32")
    want = ja.dot_product_attention(jq, jk, jv, causal=True, dtype=jnp.float32)
    got = ta.dot_product_attention(tq, tk, tv, causal=True, dtype=torch.float32)
    _close(got, want, "f32")


def test_masks_exclude_nonfinite_keys():
    (_, tq), (_, tk), (_, tv) = _qkv(4, 1, 1, 6, 1, 4, "f32")
    tk[0, 4:] = float("inf")
    lengths = torch.tensor([4])
    out = ta.cached_attention(tq, tk, tv, lengths=lengths, dtype=torch.float32)
    ref = ta.cached_attention(tq, tk[:, :4], tv[:, :4], lengths=lengths, dtype=torch.float32)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_paged_update_gather_and_cached_attention_match(name):
    rng = np.random.default_rng(5)
    n, bs, h, d, s = 7, 4, 2, 8, 3
    pages_np = {k: rng.normal(size=(n, bs, h, d)).astype(np.float32) for k in ("k", "v")}
    table = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    positions = np.array([9, 4, 0], np.int32)
    newk = rng.normal(size=(s, 1, h, d)).astype(np.float32)
    newv = rng.normal(size=(s, 1, h, d)).astype(np.float32)
    jdt, tdt = DT[name]
    jcache = {k: jnp.asarray(v, jdt) for k, v in pages_np.items()}
    tcache = {k: torch.from_numpy(v).to(tdt) for k, v in pages_np.items()}
    jk, jv, jlen = ja.paged_update_kv_cache(
        jcache, jnp.asarray(newk, jdt), jnp.asarray(newv, jdt), jnp.asarray(table),
        jnp.asarray(positions),
    )
    tlen = ta.paged_update_kv_cache(
        tcache, torch.from_numpy(newk).to(tdt), torch.from_numpy(newv).to(tdt),
        torch.from_numpy(table), torch.from_numpy(positions),
    )
    assert tlen.tolist() == np.asarray(jlen).tolist()
    # live blocks bit-equal (block 0 took the free lane and slot 2's write)
    np.testing.assert_array_equal(tcache["k"][1:].float().numpy(), np.asarray(jk, np.float32)[1:])
    np.testing.assert_array_equal(tcache["v"][1:].float().numpy(), np.asarray(jv, np.float32)[1:])
    jkg, jvg = ja.gather_paged_kv(jk, jv, jnp.asarray(table))
    tkg, tvg = ta.gather_paged_kv(tcache["k"], tcache["v"], torch.from_numpy(table))
    np.testing.assert_array_equal(tkg[:2].float().numpy(), np.asarray(jkg, np.float32)[:2])
    q = rng.normal(size=(s, 1, h, d)).astype(np.float32)
    want = ja.cached_attention(jnp.asarray(q, jdt), jkg, jvg, lengths=jlen, dtype=jdt)
    got = ta.cached_attention(torch.from_numpy(q).to(tdt), tkg, tvg, lengths=tlen, dtype=tdt)
    _close(got[:2], np.asarray(want, np.float32)[:2], name)
