"""Flash-attention forward: the port's plain version (what the CPU runs)
against the JAX Pallas flash kernel in interpret mode, at S = 600 — a
ragged length that leaves a padded tail in the reference's 512 blocks.

Both compute in f32 throughout (f32 probabilities in the PV product), so
f32 inputs agree to 2e-5; bf16 inputs differ by at most one bf16 ulp of
the rounded output (1.6e-2 absolute on outputs of order 1).
"""

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
