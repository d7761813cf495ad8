"""Fused paged attention: the port's plain version (what the CPU runs)
against the JAX Pallas kernel in interpret mode and against the JAX
gather path, on the same numpy pages, tables and positions.

f32 agrees to 1e-5 (summation order only). In bf16 the probabilities
and the output are rounded to bf16 after f32 sums taken in another order,
so outputs differ by at most about one bf16 ulp: 1.6e-2 absolute on
outputs of order 1.

The CUDA kernel has no CPU mode: ``tests/test_torch_cuda.py`` holds it
against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models import paged_attention as jpa
from consensusml_tpu_torch.models import paged_attention as tpa

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
