"""Flash-attention forward: the port's plain version (what the CPU runs)
against the JAX Pallas flash kernel in interpret mode, at S = 600 — a
ragged length that leaves a padded tail in the reference's 512 blocks.

Both compute in f32 throughout (f32 probabilities in the PV product), so
f32 inputs agree to 2e-5; bf16 inputs differ by at most one bf16 ulp of
the rounded output (1.6e-2 absolute on outputs of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models.flash_attention import flash_attention as jax_flash
from consensusml_tpu_torch.models import flash_attention as tfa

TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=0.0, atol=1.6e-2)}
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, b=1, s=600, h=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("name,causal", [("f32", True), ("bf16", True), ("f32", False)])
def test_plain_matches_jax_interpret(name, causal):
    jdt, tdt = DT[name]
    q, k, v = _qkv(seed=1)
    want = jax_flash(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal, dtype=jdt, interpret=True
    )
    got = tfa.flash_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal, dtype=tdt
    )
    assert got.shape == (1, 600, 2, 16) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[name])


def test_logsumexp_is_the_softmax_normalizer():
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=2, s=40))
    before = tfa.flash_attention.launches
    out, lse = tfa.flash_attention(q, k, v, causal=True, dtype=torch.float32, return_lse=True)
    logits = torch.einsum("bshd,bthd->bhst", q, k) / 4.0
    logits = logits.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(), -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), rtol=1e-5, atol=1e-5)
    assert tfa.flash_attention.launches == before  # CPU tensors never launch


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_backward_matches_jax_grad_of_interpret(name):
    """dq, dk, dv of the port's autograd ``flash_attention`` on CPU tensors
    (its plain forward, then ``flash_attention_bwd_plain``) against
    ``jax.grad`` through the Pallas forward and backward kernels in
    interpret mode, causal, S = 600, for the same output cotangent.

    Tolerances: in f32 both recompute the same probabilities from the
    same logsumexp and differ only in summation order (2e-5 on gradients
    of order 1; 2.9e-6 read). In bf16 the gradients are rounded to bf16
    at the end and the forward's bf16 output (which feeds delta) may sit
    one ulp apart: one bf16 ulp of the value (rtol 2**-7) plus 2e-3 for
    elements that are small next to the sums they come from (9.8e-4
    read, on gradients up to 3)."""
    jdt, tdt = DT[name]
    q, k, v = _qkv(seed=4)
    ct = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=True, dtype=jdt, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, dtype=tdt)
    assert out.grad_fn is not None
    (out.float() * torch.from_numpy(ct)).sum().backward()
    tol = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2.0**-7, atol=2e-3)}[name]
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32), **tol)


def test_autograd_backward_is_the_plain_backward_on_cpu():
    """The Function's backward on CPU tensors is ``flash_attention_bwd_plain``
    on the saved tensors, bit for bit, and launches nothing."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(seed=6, s=70))
    do = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 70, 2, 16)).astype(np.float32))
    counts = (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches)
    out = tfa.flash_attention(q, k, v, causal=True, dtype=torch.float32)
    out.backward(do)
    with torch.no_grad():
        o, lse = tfa.flash_attention_plain(q, k, v, causal=True, dtype=torch.float32, return_lse=True)
        want = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert (tfa.flash_attention_bwd_dq.launches, tfa.flash_attention_bwd_dkv.launches) == counts
