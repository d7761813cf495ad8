"""Flash-attention forward: the port's plain version (what the CPU runs)
against the JAX Pallas flash kernel in interpret mode, at S = 600 — a
ragged length that leaves a padded tail in the reference's 512 blocks.

Both compute in f32 throughout (f32 probabilities in the PV product), so
f32 inputs agree to 2e-5; bf16 inputs differ by at most one bf16 ulp of
the rounded output (1.6e-2 absolute on outputs of order 1).

The tests at the end hold an f32 emulation of the CUDA forward, dq and
dk/dv kernels' rounding (tensor-core products, p and ds as two bf16 halves) to
the card's gates against the plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models.flash_attention import flash_attention as jax_flash
from consensusml_tpu_torch.models import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("name,causal,s", [("f32", True, 600), ("bf16", True, 600), ("f32", False, 256)])
def test_plain_matches_jax_interpret_at_head_dim_128(name, causal, s):
    """``test_plain_matches_jax_interpret`` at head dim 128 (Llama-2-7B's,
    the kernels' second form): the reference takes any head dim, and the
    plain version, which the card holds the D=128 kernels to, computes
    the same function at the same tolerances, S ragged (600) and whole
    (256)."""
    jdt, tdt = DT[name]
    q, k, v = _qkv(seed=1, s=s, d=128)
    want = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal, dtype=jdt, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal, dtype=tdt)
    assert got.shape == (1, s, 2, 128) and got.dtype == tdt
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


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_plain_backward_matches_jax_grad_of_interpret_at_head_dim_128(name):
    """``test_plain_backward_matches_jax_grad_of_interpret`` at head dim 128,
    causal, S = 256, at its tolerances."""
    jdt, tdt = DT[name]
    q, k, v = _qkv(seed=4, s=256, d=128)
    ct = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=True, dtype=jdt, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(ct))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, causal=True, dtype=tdt).float() * torch.from_numpy(ct)).sum().backward()
    tol = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2.0**-7, atol=2e-3)}[name]
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_subnormal_head_flushes_as_the_reference(name):
    """The reference's compiled program reads a subnormal operand as zero
    and flushes a subnormal result. With head 1's V at 1e-39 (causal, (1,
    128, 2, 64)), ``jax.vjp`` of its jitted interpreted kernels gives that
    head out, dq and dk of 0 (unflushed they are ~2e-39); the port's
    autograd ``flash_attention`` on CPU tensors gives the same zeros, and
    dv and head 0 within :func:`test_plain_backward_matches_jax_grad_of_interpret`'s
    tolerances."""
    jdt, tdt = DT[name]
    q, k, v = _qkv(seed=21, s=128, d=64)
    v[:, :, 1] *= np.float32(1e-39)
    ct = np.random.default_rng(22).normal(size=q.shape).astype(np.float32)

    @jax.jit
    def reference(q_, k_, v_, ct_):
        out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True, dtype=jdt, interpret=True), q_, k_, v_)
        return (out, *vjp(ct_))

    want = [np.asarray(t, np.float32) for t in reference(*(jnp.asarray(x, jdt) for x in (q, k, v, ct)))]
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, dtype=tdt)
    got = [out.detach(), *torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct).to(tdt))]
    got = [t.float().numpy() for t in got]
    for what, w in zip(("out", "dq", "dk"), want[:3]):
        assert not w[:, :, 1].any(), what  # what the reference gives
    tol = TOL["f32"] if name == "f32" else dict(rtol=2.0**-7, atol=2e-3)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        if what != "dv":
            assert not g[:, :, 1].any(), what
        np.testing.assert_allclose(g, w, err_msg=what, **tol)


def _signs(seed, shape):
    return np.where(np.random.default_rng(seed).normal(size=shape) >= 0, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("probe", ["q_subnormal_k_large", "do_subnormal_v_large"])
def test_subnormal_operands_read_as_zero_as_the_reference(probe):
    """Subnormal operands whose products are normal (bf16, causal, (1, 128,
    1, 64)): q at +-1e-39 against k at +-1e38 (logits +-0.1 unflushed),
    and dO at +-1e-39 against V at +-1e36 (dp and delta ~1e-3 unflushed;
    at 1e38 the reference's unnormalised f32 sum of p v overflows).
    ``jax.vjp`` of the jitted interpreted reference reads the subnormal
    operand as 0: uniform probabilities in the first probe, dq = dk = dv =
    0 in the second. The port's autograd ``flash_attention`` on CPU
    tensors gives the same, ``delta`` included (it reads a subnormal dO as
    0). The card test ``test_flash_kernels_read_subnormal_operands_as_zero``
    holds the kernels to these plain versions."""
    s, shape = 128, (1, 128, 1, 64)
    rng = np.random.default_rng(31)
    q, k, v, ct = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    if probe == "q_subnormal_k_large":
        q, k = _signs(32, shape) * np.float32(1e-39), _signs(33, shape) * np.float32(1e38)
    else:
        ct, v = _signs(34, shape) * np.float32(1e-39), _signs(35, shape) * np.float32(1e36)

    @jax.jit
    def reference(q_, k_, v_, ct_):
        out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True, dtype=jnp.bfloat16, interpret=True),
                           q_, k_, v_)
        return (out, *vjp(ct_))

    want = [np.asarray(t, np.float32) for t in reference(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, ct)))]
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    got = [out.detach(), *torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct).to(torch.bfloat16))]
    got = [t.float().numpy() for t in got]
    if probe == "q_subnormal_k_large":
        # q reads as 0: every row's probabilities are uniform over its keys
        uniform = np.cumsum(v.astype(jnp.bfloat16).astype(np.float32), axis=1) / np.arange(1, s + 1)[None, :, None, None]
        np.testing.assert_allclose(want[0], uniform, rtol=2.0**-7, atol=1e-6)
        checked = zip(("out", "dv"), (got[0], got[3]), (want[0], want[3]))
    else:
        assert not any(w.any() for w in want[1:]), "the reference reads the subnormal dO as 0"
        checked = zip(("out", "dq", "dk", "dv"), got, want)
    for what, g, w in checked:
        np.testing.assert_allclose(g, w, rtol=2.0**-7, atol=2e-3, err_msg=what)


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


# --- the CUDA kernels' rounding, emulated in f32 ----------------------------
#
# The flash kernels multiply on the tensor cores, which take bf16 operands
# and sum in f32. q, k, v and do are bf16 already, so the first products
# (q.k and do.v, or their transposes in dk/dv) are exact up to summation
# order. The accumulating products take the f32 probabilities p (forward,
# dk/dv) and ds (dq, dk/dv) as two bf16 halves, hi = bf16(x) and lo =
# bf16(x - hi), into one f32 accumulator. The forward walks 64-key tiles
# with a running max, as the kernel does; dk/dv walks 64-query tiles past
# its resident keys. These tests hold that rounding to chip_smoke.py's
# gates against the plain versions: forward |err| <= 1e-4 + 2**-6 |ref|
# and lse within 1e-5; dq, dk and dv |err| <= 3e-3 + 2**-6 |ref|. Worst
# err/tolerance on these inputs: 0.49 (forward), 0.37 (dq), 0.40 (dk),
# 0.39 (dv). One bf16 rounding of p instead misses the forward gate by
# 2.9-15x here (7-13x at B=1, S=1024, H=4) and the dv gate by up to 2.2x;
# one of ds misses the dq gate by up to 1.7x and the dk gate by up to
# 3.5x.

_BK = 64  # keys of a kernel tile
FWD_GATE, DQ_GATE, LSE_TOL = (1e-4, 2.0**-6), (3e-3, 2.0**-6), 1e-5


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _parts(x, split):
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _emulate_fwd(q, k, v, causal, split=True):
    """(out bf16, lse) as the forward kernel rounds them."""
    s = q.shape[1]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, S, D)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    m = torch.full((*qf.shape[:3], 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(s)[:, None]
    for k0 in range(0, s, _BK):
        kt, vt = kf[:, :, k0:k0 + _BK], vf[:, :, k0:k0 + _BK]
        logits = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            logits = logits.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None] > q_pos, -torch.inf)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)  # masked: exactly 0
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        for part in _parts(p, split):
            acc = acc + part @ vt
        m = m_new
    l_safe = l.clamp(min=1e-30)
    return (acc / l_safe).transpose(1, 2).to(torch.bfloat16), (m + torch.log(l_safe))[..., 0]


def _emulate_dq(q, k, v, dout, lse, delta, causal, split=True):
    """dq (bf16) as the dq kernel rounds it."""
    s = q.shape[1]
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, dout))
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    acc = torch.zeros_like(qf)
    q_pos = torch.arange(s)[:, None]
    for k0 in range(0, s, _BK):
        kt, vt = kf[:, :, k0:k0 + _BK], vf[:, :, k0:k0 + _BK]
        p = torch.exp((qf @ kt.transpose(-1, -2)) * scale - lse[..., None])
        if causal:
            p = p.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None] > q_pos, 0.0)
        ds = p * (dof @ vt.transpose(-1, -2) - delta[..., None])
        for part in _parts(ds, split):
            acc = acc + part @ kt
    return (acc * scale).transpose(1, 2).to(torch.bfloat16)


def _emulate_dkv(q, k, v, dout, lse, delta, causal, split_p=True, split_ds=True):
    """(dk, dv) (bf16) as the dk/dv kernel rounds them: the keys stay, and
    64-query tiles stream past; P^T and dS^T (keys x queries) enter
    dV += P^T dO and dK += dS^T Q as bf16 halves."""
    s = q.shape[1]
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, dout))
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    k_pos = torch.arange(s)[:, None]
    for q0 in range(0, s, _BK):
        qt, dot = qf[:, :, q0:q0 + _BK], dof[:, :, q0:q0 + _BK]
        cols = slice(q0, q0 + qt.shape[2])
        pt = torch.exp((kf @ qt.transpose(-1, -2)) * scale - lse[:, :, None, cols])
        if causal:
            pt = pt.masked_fill(torch.arange(q0, q0 + qt.shape[2])[None] < k_pos, 0.0)
        dst = pt * (vf @ dot.transpose(-1, -2) - delta[:, :, None, cols])
        for part in _parts(pt, split_p):
            dv = dv + part @ dot
        for part in _parts(dst, split_ds):
            dk = dk + part @ qt
    return ((dk * scale).transpose(1, 2).to(torch.bfloat16),
            dv.transpose(1, 2).to(torch.bfloat16))


def _worst(got, want, gate):
    atol, rtol = gate
    return ((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max().item()


def _bf16_case(s, causal, q_scale, h=2, d=64):
    rng = np.random.default_rng(1000 * s + 10 * int(causal) + int(q_scale))
    q, k, v, do = (
        torch.from_numpy(rng.normal(size=(1, s, h, d)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4)
    )
    return (q.float() * q_scale).to(torch.bfloat16), k, v, do


EMULATED = [(s, c, qs) for s in (200, 600) for c in (True, False) for qs in (1.0, 4.0)]


@pytest.mark.parametrize("s,causal,q_scale", EMULATED)
def test_kernel_rounding_meets_the_forward_gate(s, causal, q_scale):
    q, k, v, _ = _bf16_case(s, causal, q_scale)
    want, want_lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got, lse = _emulate_fwd(q, k, v, causal)
    assert _worst(got, want, FWD_GATE) <= 1.0
    assert (lse - want_lse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("s,causal,q_scale", EMULATED)
def test_kernel_rounding_meets_the_dq_gate(s, causal, q_scale):
    q, k, v, do = _bf16_case(s, causal, q_scale)
    out, lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    delta = tfa._delta(out, do)
    want = tfa._bwd_plain_parts(q, k, v, do, lse, delta, causal)[0]
    assert _worst(_emulate_dq(q, k, v, do, lse, delta, causal), want, DQ_GATE) <= 1.0


@pytest.mark.parametrize("s,causal,q_scale", EMULATED)
def test_one_bf16_rounding_of_p_misses_the_forward_gate(s, causal, q_scale):
    """Why the kernels split: the same walk with p rounded once to bf16."""
    q, k, v, _ = _bf16_case(s, causal, q_scale)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert _worst(_emulate_fwd(q, k, v, causal, split=False)[0], want, FWD_GATE) > 1.0


@pytest.mark.parametrize("s,causal,q_scale", EMULATED)
def test_kernel_rounding_meets_the_dkv_gate(s, causal, q_scale):
    q, k, v, do = _bf16_case(s, causal, q_scale)
    out, lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    delta = tfa._delta(out, do)
    want = tfa._bwd_plain_parts(q, k, v, do, lse, delta, causal)[1:]
    got = _emulate_dkv(q, k, v, do, lse, delta, causal)
    for name, g, w in zip(("dk", "dv"), got, want):
        assert _worst(g, w, DQ_GATE) <= 1.0, name


@pytest.mark.parametrize("s,causal", [(600, True), (256, False)])
def test_kernel_rounding_meets_the_gates_at_head_dim_128(s, causal):
    """The head-dim-128 forms round as the head-dim-64 ones (the same
    walk; the reductions over D are twice as long, each product exact in
    f32): the emulated forward, dq and dk/dv meet the card's gates
    against the plain versions, q x4."""
    q, k, v, do = _bf16_case(s, causal, 4.0, d=128)
    want, want_lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got, lse = _emulate_fwd(q, k, v, causal)
    assert _worst(got, want, FWD_GATE) <= 1.0
    assert (lse - want_lse).abs().max().item() <= LSE_TOL
    delta = tfa._delta(want, do)
    plain = tfa._bwd_plain_parts(q, k, v, do, want_lse, delta, causal)
    assert _worst(_emulate_dq(q, k, v, do, want_lse, delta, causal), plain[0], DQ_GATE) <= 1.0
    for name, g, w in zip(("dk", "dv"), _emulate_dkv(q, k, v, do, want_lse, delta, causal), plain[1:]):
        assert _worst(g, w, DQ_GATE) <= 1.0, name


@pytest.mark.parametrize("unsplit", ["p", "ds"])
@pytest.mark.parametrize("s,causal,q_scale", [c for c in EMULATED if c[2] == 4.0])
def test_one_bf16_rounding_of_p_or_ds_misses_the_dkv_gate(s, causal, q_scale, unsplit):
    """Why the dk/dv kernel splits both: P rounded once to bf16 moves dv
    past the gate, dS rounded once moves dk past it (on sharp rows, q x4;
    at q x1 an unsplit dS can stay under)."""
    q, k, v, do = _bf16_case(s, causal, q_scale)
    out, lse = tfa.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    delta = tfa._delta(out, do)
    dk, dv = tfa._bwd_plain_parts(q, k, v, do, lse, delta, causal)[1:]
    got_dk, got_dv = _emulate_dkv(q, k, v, do, lse, delta, causal,
                                  split_p=unsplit != "p", split_ds=unsplit != "ds")
    got, want = (got_dv, dv) if unsplit == "p" else (got_dk, dk)
    assert _worst(got, want, DQ_GATE) > 1.0


# --- the per-key padding mask (kv_mask), against the reference -------------


def _masks(s, causal, b=3):
    """(b, s) f32 key masks: every key; the keys before ``s // 3``; no key
    (a row that attends to nothing). Causal, the second row keeps only the
    keys from ``s // 2`` on, so its queries before ``s // 2`` attend to
    nothing either."""
    rows = [np.arange(s) < s, np.arange(s) >= s // 2 if causal else np.arange(s) < s // 3, np.zeros(s, bool)]
    return np.stack(rows[:b]).astype(np.float32)


@pytest.mark.parametrize("s", [128, 200, 600])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_kv_mask_matches_jax_interpret(s, causal):
    """``flash_attention_plain`` with ``kv_mask`` against the reference's
    ``flash_attention(..., kv_mask=, interpret=True)``, f32, every row: one
    unmasked, one masked from (or, causal, before) a position, one with
    every key masked. A row that attends to no key gets the sum of the
    values it visits over the reference's count of visited keys, padding
    included (0.25 x the mean of V at S = 128; a parent that gave such a
    row 0 fails here). f32 at 1e-5 (3.9e-7 read)."""
    q, k, v = _qkv(seed=40 + s, b=3, s=s)
    kv_mask = _masks(s, causal)
    want = jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=causal, kv_mask=jnp.asarray(kv_mask),
                     dtype=jnp.float32, interpret=True)
    got = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                              kv_mask=torch.from_numpy(kv_mask), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(want)[2]).max() > 1e-3  # the empty row is not 0 in the reference


def test_plain_kv_mask_empty_row_is_the_visited_mean():
    """The count of a row that attends to nothing, derived from the
    reference: ``sum_{t < S} v_t / (ceil(S / 512) * 512)``, and under causal
    ``sum_{t < min(S, 512 (row // 512 + 1))} v_t / (512 (row // 512 + 1))``;
    its lse is -1e30."""
    s = 600
    q, k, v = (torch.from_numpy(x) for x in _qkv(seed=47, b=1, s=s))
    none = torch.zeros(1, s)
    out, lse = tfa.flash_attention_plain(q, k, v, kv_mask=none, dtype=torch.float32, return_lse=True)
    torch.testing.assert_close(out[0], v[0].sum(0, keepdim=True).expand(s, -1, -1) / 1024, rtol=1e-5, atol=1e-6)
    assert (lse == -1e30).all()
    out = tfa.flash_attention_plain(q, k, v, causal=True, kv_mask=none, dtype=torch.float32)
    torch.testing.assert_close(out[0, :512], v[0, :512].sum(0, keepdim=True).expand(512, -1, -1) / 512,
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(out[0, 512:], v[0].sum(0, keepdim=True).expand(s - 512, -1, -1) / 1024,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s", [128, 200, 600])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_kv_mask_backward_matches_jax_grad_of_interpret(s, causal):
    """dq, dk, dv of the port's autograd ``flash_attention`` with ``kv_mask``
    on CPU tensors (its plain forward, then ``flash_attention_bwd_plain``)
    against ``jax.grad`` through the reference's interpreted kernels
    (jitted), the
    masks of :func:`test_plain_kv_mask_matches_jax_interpret`: a row that
    attends to nothing gets p = 0 at every key, so no gradient, in both.
    f32 at 2e-5, as the unmasked backward."""
    q, k, v = _qkv(seed=50 + s, b=3, s=s)
    kv_mask = _masks(s, causal)
    ct = np.random.default_rng(51 + s).normal(size=q.shape).astype(np.float32)

    def jloss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, causal=causal, kv_mask=jnp.asarray(kv_mask), dtype=jnp.float32,
                        interpret=True)
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, kv_mask=torch.from_numpy(kv_mask), dtype=torch.float32)
    (out * torch.from_numpy(ct)).sum().backward()
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5, err_msg=f"d{name}")
    assert not tq.grad[2].any()  # the empty batch row: no gradient


@pytest.mark.parametrize("causal,s", [(False, 128), (True, 100)])
def test_flash_kv_mask_matches_dense_bias(causal, s):
    """The reference's test of that name on the port: the per-key padding
    mask through ``flash_attention`` (its plain versions on the CPU, with
    the Function's backward) against the dense path's additive -1e30 bias,
    forward and gradients (f32 at 2e-5, gradients at 2e-4)."""
    from consensusml_tpu_torch.models.attention import dot_product_attention

    rng = np.random.default_rng(6)
    base = [rng.normal(size=(2, s, 2, 64)).astype(np.float32) for _ in range(3)]
    kv_mask = torch.from_numpy(np.stack([np.arange(s) < s, np.arange(s) < (3 * s // 5)]).astype(np.float32))
    bias = torch.where(kv_mask[:, None, None, :] > 0, 0.0, -1e30)
    results = []
    for fn in (lambda q, k, v: tfa.flash_attention(q, k, v, causal=causal, kv_mask=kv_mask, dtype=torch.float32),
               lambda q, k, v: dot_product_attention(q, k, v, causal=causal, bias=bias, dtype=torch.float32,
                                                     impl="dense")):
        q, k, v = (torch.from_numpy(x).requires_grad_() for x in base)
        o = fn(q, k, v)
        (o ** 2).sum().backward()
        results.append((o.detach(), q.grad, k.grad, v.grad))
    (got, *gf), (want, *gd) = results
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", gf, gd):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4, msg=f"d{name}")


def test_kv_mask_batch_rows_are_independent():
    """The reference's test of that name on the port: each batch row of a
    masked call equals its own single-batch masked call."""
    rng = np.random.default_rng(7)
    b, s, h, d = 3, 64, 2, 64
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32)) for _ in range(3))
    lens = [64, 40, 17]
    kv_mask = torch.from_numpy(np.stack([np.arange(s) < n for n in lens]).astype(np.float32))
    got = tfa.flash_attention(q, k, v, kv_mask=kv_mask, dtype=torch.float32)
    for i, n in enumerate(lens):
        want = tfa.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_mask=kv_mask[i:i + 1], dtype=torch.float32)
        torch.testing.assert_close(got[i], want[0], rtol=2e-5, atol=2e-5, msg=f"batch {i} (len {n})")


def test_dot_product_attention_kv_mask_across_impls():
    """The reference's test of that name on the port: ``kv_mask`` through
    the dense, blockwise and flash paths of ``dot_product_attention`` gives
    one answer (f32 at 2e-5; no row is empty), and the argument errors."""
    from consensusml_tpu_torch.models.attention import dot_product_attention

    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 96, 2, 64)).astype(np.float32)) for _ in range(3))
    kv_mask = torch.from_numpy(np.stack([np.arange(96) < 70, np.arange(96) < 33]).astype(np.float32))
    dense = dot_product_attention(q, k, v, kv_mask=kv_mask, dtype=torch.float32, impl="dense")
    for impl in ("blockwise", "flash"):
        got = dot_product_attention(q, k, v, kv_mask=kv_mask, dtype=torch.float32, impl=impl)
        torch.testing.assert_close(got, dense, rtol=2e-5, atol=2e-5, msg=impl)
    with pytest.raises(ValueError, match="not both"):
        dot_product_attention(q, k, v, kv_mask=kv_mask, bias=torch.zeros(2, 1, 1, 96))
    with pytest.raises(ValueError, match="kv_mask must be"):
        dot_product_attention(q, k, v, kv_mask=kv_mask[:, :10])
