"""The flash kernels' q/k offset form: the port's plain versions of the
forward, dq and dk/dv (what the CPU runs, and what the card holds the
kernels to) against the reference's ``_fwd``, ``_bwd_dq`` and
``_bwd_dkv`` with ``q_offset``/``k_offset``, in the Pallas interpreter.

The offsets are the ring's: (S, 0) a block wholly before the queries,
(S, S) the diagonal block, (2S, S) another before, and (0, S) a block
wholly after them, where every row attends to no key. Such a row gets,
in both, the sum of the values over the reference's visited count (its
whole padded sequence, ``ceil(S / 512) * 512``) and an lse of -1e30, and
no gradient. f32 throughout: out, dq, dk and dv agree to 2e-5, the lse
to 2e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models import flash_attention as jfa
from consensusml_tpu_torch.models import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, s, h=2, d=16, b=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(4)]


def _reference(q, k, v, do, causal, q_offset, k_offset):
    """The reference's three kernels on the folded, padded layout, with
    offsets: (out, lse, dq, dk, dv) as (B, S, H, D) / (B, H, S) numpy."""
    b, s, h, d = q.shape
    scale = 1.0 / float(d) ** 0.5
    block = max(jfa._BQ, jfa._BK)
    q3, k3, v3, do3 = (jfa.fold_pad(jnp.asarray(x), block) for x in (q, k, v, do))
    off = dict(q_offset=q_offset, k_offset=k_offset)
    o3, lse = jfa._fwd(q3, k3, v3, causal, s, scale, True, **off)
    delta = jnp.sum(do3 * o3, axis=-1)
    delta = jnp.broadcast_to(delta[..., None], lse.shape)
    dq3 = jfa._bwd_dq(q3, k3, v3, do3, lse, delta, causal, s, scale, True, **off)
    dk3, dv3 = jfa._bwd_dkv(q3, k3, v3, do3, lse, delta, causal, s, scale, True, **off)

    def unfold(x3):
        return np.moveaxis(np.asarray(x3)[:, :s].reshape(b, h, s, d), 1, 2)

    return unfold(o3), np.asarray(lse)[:, :s, 0].reshape(b, h, s), unfold(dq3), unfold(dk3), unfold(dv3)


def _port(q, k, v, do, causal, q_offset, k_offset):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    off = dict(q_offset=q_offset, k_offset=k_offset)
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, dtype=torch.float32, return_lse=True, **off)
    dq, dk, dv = tfa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, causal=causal, **off)
    return [t.numpy() for t in (out, lse, dq, dk, dv)]


OFFSETS = [(1, 0), (1, 1), (2, 1), (0, 1)]  # in units of S


@pytest.mark.parametrize("qo,ko", OFFSETS, ids=["before", "diagonal", "before2", "after"])
@pytest.mark.parametrize("s", [40, 600])
def test_plain_offsets_match_the_reference(s, qo, ko):
    """S 40 (one block) and 600 (a ragged second block), causal."""
    q, k, v, do = _inputs(seed=s + qo, s=s)
    want = _reference(q, k, v, do, True, qo * s, ko * s)
    got = _port(q, k, v, do, True, qo * s, ko * s)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


def test_fully_masked_block_is_the_references_answer():
    """(0, S): every row attends to no key: out is the values' sum over
    the padded count, lse -1e30, and every gradient 0."""
    s = 40
    q, k, v, do = _inputs(seed=3, s=s)
    out, lse, dq, dk, dv = _port(q, k, v, do, True, 0, s)
    np.testing.assert_allclose(out, np.broadcast_to(v.sum(1, keepdims=True) / 512, out.shape), rtol=1e-5, atol=1e-6)
    assert (lse == np.float32(-1e30)).all()
    assert not dq.any() and not dk.any() and not dv.any()


def test_offsets_without_causal_are_the_aligned_form():
    """Offsets move only the causal mask: non-causal, any offsets give the
    aligned call's out and lse."""
    q, k, v, do = _inputs(seed=4, s=600)
    want = _reference(q, k, v, do, False, 600, 0)
    got = _port(q, k, v, do, False, None, None)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=name)


@pytest.mark.parametrize("shift", [-700, -41, -1, 0, 5, 599, 1200])
def test_pairs_count_the_causal_extent(shift):
    """The work count's pairs (a bound's operations) are the mask's."""
    s = 600
    q = torch.empty((1, s, 2, 16), device="meta")
    valid = tfa._causal_valid(s, shift, "cpu")
    assert tfa._pairs(q, True, shift) == 2 * int(valid.sum())
    assert tfa._pairs(q, False, shift) == 2 * s * s


def test_wrapper_takes_offsets_through_autograd():
    """``flash_attention(..., q_offset=, k_offset=)`` under autograd (the
    ring's per-block call on the CPU): out and the gradients are the
    plain versions', and nothing launches."""
    s = 40
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(seed=5, s=s))
    before = (tfa.flash_attention.offset_launches, tfa.flash_attention_bwd_dq.offset_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=True, dtype=torch.float32, q_offset=2 * s, k_offset=s)
    out.backward(do)
    want = _port(*(x.numpy() for x in (q, k, v, do)), True, 2 * s, s)
    np.testing.assert_allclose(out.detach().numpy(), want[0], **TOL)
    for leaf, w in zip(leaves, want[2:]):
        np.testing.assert_allclose(leaf.grad.numpy(), w, **TOL)
    assert (tfa.flash_attention.offset_launches, tfa.flash_attention_bwd_dq.offset_launches) == before
    jax.clear_caches()
