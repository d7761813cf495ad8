"""The fused LayerNorm of the port against the JAX package's.

The JAX side runs ``fused_layer_norm(impl="interpret")`` (its Pallas
kernels under the interpreter, the TPU kernel path) and GPT-2 with
``norm_impl="interpret"``; the port's side runs the kernels' plain
versions (CPU tensors never launch). Inputs come from numpy seeds and
carry the LayerNorm's hazards: a constant row (variance 0, so ``rsig =
1/sqrt(eps)``; its value 0.375 sums exactly, so both sides see ``xc = 0``),
a row of large magnitude (x 1e3) and a row at 1e-3 scale (variance near
eps).

Tolerances. Both sides compute the same f32 formula and differ only in
the order of the row and column sums. In f32 each output row is held to
1e-6 of its largest element (the readings: 2.7e-7 for y, 2.9e-7 for dx;
a constant row at an inexact value such as 0.3 would read ~1e-4, its
mean's rounding amplified by ``1/sqrt(eps)``), dgamma and dbeta to 1e-6
of their largest element (1.6e-7, 1.8e-7 read). In bf16 (input and
output), y and dx are held to one bf16 ulp (2**-7 of the value: a sum in
another order may flip the last rounding; read 0 for y, 2.4e-9 absolute
for dx), the f32 dgamma and dbeta to 1e-6 of their largest element.

GPT-2 with the fused LayerNorm is held at hidden 128, the smallest width
where the reference's LayerNorm takes its Pallas kernels (at the smoke
width, 32, its ``_plan`` takes its jnp path: H % 128 != 0), 2 layers, 2
heads, f32: logits within 2e-5 (the f32 tolerance of
tests/test_torch_gpt2.py; read 1.6e-5 on logits up to 9.4) and each
parameter's gradient within 5e-5 of its largest element (worst read
1.3e-5, ``h_0.qkv.kernel``: the backward's sums over 32 positions and two
layers in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models.fused_ln import FusedLayerNorm as JaxFusedLayerNorm
from consensusml_tpu.models.fused_ln import fused_layer_norm as jax_fused_layer_norm
from consensusml_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu_torch.models import fused_ln as tln
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, m=64, h=256):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, h)) * 2 + 0.5).astype(np.float32)
    x[0] = 0.375
    x[1] *= 1e3
    x[2] *= 1e-3
    gamma = (1 + 0.1 * rng.normal(size=h)).astype(np.float32)
    beta = (0.1 * rng.normal(size=h)).astype(np.float32)
    dy = rng.normal(size=(m, h)).astype(np.float32)
    return x, gamma, beta, dy


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _assert_rows_close(got, want, rel, what):
    """Every row within ``rel`` of its largest element."""
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    assert (err <= rel * scale).all(), (what, float((err / np.maximum(scale, 1e-30)).max()))


def _assert_ulp_close(got, want, what):
    """Within one bf16 ulp (2**-7 of the value) element by element."""
    got, want = _np(got), _np(want)
    assert (np.abs(got - want) <= 2.0**-7 * np.abs(want)).all(), (what, float(np.abs(got - want).max()))


def _reference(x, gamma, beta, dy, jdt):
    jx = jnp.asarray(x).astype(jdt)
    f = lambda a, g, b: jax_fused_layer_norm(a, g, b, 1e-6, jdt, "interpret")  # noqa: E731
    y, vjp = jax.vjp(f, jx, jnp.asarray(gamma), jnp.asarray(beta))
    return (y, *vjp(jnp.asarray(dy).astype(jdt)))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("entry", ["plain", "autograd", "autograd_jnp"])
def test_layer_norm_matches_reference(dtype_name, entry):
    """``ln_fwd_plain``/``ln_bwd_plain`` and the autograd
    ``fused_layer_norm`` (x in ``dtype``, out_dtype the same; its wrappers,
    or ``impl="jnp"``, the plain versions by name) against the reference's
    interpreted kernels: y, dx, dgamma, dbeta."""
    jdt, tdt = DTYPES[dtype_name]
    x, gamma, beta, dy = _case(3)
    want = _reference(x, gamma, beta, dy, jdt)
    tx = torch.from_numpy(x).to(tdt)
    tdy = torch.from_numpy(dy).to(tdt)
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    before = (tln.ln_fwd.launches, tln.ln_bwd.launches)
    if entry == "plain":
        y = tln.ln_fwd_plain(tx, tg, tb, 1e-6, tdt)
        dx, dg, db = tln.ln_bwd_plain(tdy, tx, tg, 1e-6)
    else:
        leaves = [t.clone().requires_grad_() for t in (tx, tg, tb)]
        y = tln.fused_layer_norm(*leaves, eps=1e-6, out_dtype=tdt,
                                 impl="jnp" if entry == "autograd_jnp" else "auto")
        assert y.grad_fn is not None
        dx, dg, db = torch.autograd.grad(y, leaves, tdy)
    assert (tln.ln_fwd.launches, tln.ln_bwd.launches) == before  # CPU tensors never launch
    assert y.dtype == dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
    if dtype_name == "f32":
        _assert_rows_close(y, want[0], 1e-6, "y")
        _assert_rows_close(dx, want[1], 1e-6, "dx")
    else:
        _assert_ulp_close(y, want[0], "y")
        _assert_ulp_close(dx, want[1], "dx")
    for name, g, w in (("dgamma", dg, want[2]), ("dbeta", db, want[3])):
        _assert_rows_close(g, w, 1e-6, name)
    # the constant row: xc = 0, so y is beta (to its output rounding)
    np.testing.assert_array_equal(_np(y)[0], _np(torch.from_numpy(beta).to(tdt)))


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_layer_norm_flushes_subnormals_as_the_reference(dtype_name, impl):
    """The reference's compiled program reads a subnormal operand as zero
    and flushes a subnormal result. A row of x at 1e-39 normalises to
    y = beta (0 here; unflushed, its deviations scaled by ``1/sqrt(eps)``
    come out as normal numbers near 1e-36), and a row of dy at 1e-39 gives
    dx = 0; the other rows, dgamma and dbeta as the jitted reference's
    (``impl="interpret"``: its Pallas kernels; ``"jnp"``: its plain path),
    at :func:`test_layer_norm_matches_reference`'s tolerances."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    x[3] = rng.normal(size=128) * 1e-39
    dy = rng.normal(size=(8, 128)).astype(np.float32)
    dy[5] = rng.normal(size=128) * 1e-39
    gamma = (1 + 0.1 * rng.normal(size=128)).astype(np.float32)
    beta = np.zeros(128, np.float32)

    @jax.jit
    def reference(a, g, b, d):
        f = lambda a, g, b: jax_fused_layer_norm(a, g, b, 1e-6, jdt, impl)  # noqa: E731
        y, vjp = jax.vjp(f, a, g, b)
        return (y, *vjp(d))

    want = reference(jnp.asarray(x).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(dy).astype(jdt))
    tx, tdy = torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt)
    y = tln.ln_fwd_plain(tx, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-6, tdt)
    dx, dg, db = tln.ln_bwd_plain(tdy, tx, torch.from_numpy(gamma), 1e-6)
    assert not _np(want[0])[3].any() and not _np(want[1])[5].any()  # what the reference gives
    assert not _np(y)[3].any() and not _np(dx)[5].any()
    close = (lambda g, w, what: _assert_rows_close(g, w, 1e-6, what)) if dtype_name == "f32" else _assert_ulp_close
    close(y, want[0], "y")
    close(dx, want[1], "dx")
    for name, g, w in (("dgamma", dg, want[2]), ("dbeta", db, want[3])):
        _assert_rows_close(g, w, 1e-6, name)


@pytest.mark.parametrize("xe,de", [(2, 2), (4, 4), (4, 2)], ids=["bf16", "f32", "f32-bf16dy"])
def test_ln_bwd_plan_is_one_the_kernel_takes(xe, de):
    """The backward's launch plan on a card of 132 SMs: one warp a row up
    to H = 1024, two to 2048, four to 4096; one block an SM, none whose row
    groups all go without rows; a ring of 1 or 2 rows that, with the
    reduction words, fits a block's shared memory, and the block's column
    partials fit there too."""
    for m, h in [(8192, 1024), (2048, 1024), (1, 1024), (333, 136), (64, 2048), (17, 4096), (5, 8), (9, 4096)]:
        p = tln.ln_bwd_plan(m, h, xe, de, 132)
        groups = 8 // p.group
        assert p.group == (1 if h <= 1024 else 2 if h <= 2048 else 4) and h <= 1024 * p.group
        assert 1 <= p.blocks <= 132 and (p.blocks - 1) * groups < m and (p.blocks == 132 or p.blocks * groups >= m)
        assert 1 <= p.slots <= 2 and p.smem <= 232448 - 1024
        assert p.smem >= max(p.slots * groups * h * (xe + de), groups * 2 * h * 4) + groups * 4 * p.group * 4
    assert tln.ln_bwd_plan(8192, 1024, 2, 2, 132) == tln.BwdPlan(1, 132, 2, 65664)
    assert tln.ln_bwd_plan(2048, 1024, 4, 4, 132, slots=3).smem == 196736
    with pytest.raises(ValueError):
        tln.ln_bwd_plan(17, 4096, 4, 4, 132, slots=4)


@pytest.mark.parametrize("h", [96, 777, 1000, 1024])
def test_compiled_mean_is_the_row_sum_times_its_reciprocal(h):
    """The reference's ``jnp.mean`` over a row, as XLA compiles it, is the
    row's sum times f32(1/H) to the bit, not the sum divided by H (which
    differs in some rows wherever 1/H is inexact): the LN plain versions and
    kernels take the product."""
    x = np.random.default_rng(h).normal(size=(4096, h)).astype(np.float32)
    mean = np.asarray(jax.jit(lambda a: jnp.mean(a, axis=1))(x))
    total = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=1))(x))
    inv = np.float32(tln.inv_rows(h))
    np.testing.assert_array_equal(mean, total * inv)
    assert h == 1024 or (mean != total / np.float32(h)).any()


def test_module_matches_reference_module_and_names_its_parameters_as_flax():
    """``FusedLayerNorm`` (f32 in, bf16 out) against the reference's flax
    module with the same parameters; its parameters are flax's ``scale``
    and ``bias``, f32."""
    x, gamma, beta, _ = _case(5, m=24, h=128)
    jmod = JaxFusedLayerNorm(out_dtype=jnp.bfloat16, impl="interpret")
    want = jmod.apply({"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}},
                      jnp.asarray(x).reshape(2, 12, 128))
    mod = tln.FusedLayerNorm(128, out_dtype=torch.bfloat16)
    assert [(n, p.dtype) for n, p in mod.named_parameters()] == [("scale", torch.float32), ("bias", torch.float32)]
    mod.load_state_dict({"scale": torch.from_numpy(gamma), "bias": torch.from_numpy(beta)})
    got = mod(torch.from_numpy(x).reshape(2, 12, 128))
    assert got.shape == (2, 12, 128) and got.dtype == torch.bfloat16
    _assert_ulp_close(got, want, "module")


GEOM = dict(vocab_size=64, hidden=128, layers=2, heads=2, max_len=32)


def _flax_params(jmodel, seed):
    tree = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.normal(0.0, 0.2, size=leaf.shape).astype(np.float32)
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def test_gpt2_with_fused_ln_matches_reference_logits_and_gradients():
    """f32 GPT-2 at hidden 128, ``norm_impl="pallas"`` (the fused LN's
    plain versions on the CPU) against the reference's
    ``norm_impl="interpret"`` (its Pallas LN kernels interpreted), the same
    parameters: logits, then every parameter's gradient of ``sum(logits *
    w)`` for a fixed numpy ``w``."""
    jmodel = JaxGPT2LM(config=JaxGPT2Config(**GEOM, dropout=0.0, dtype=jnp.float32, norm_impl="interpret"))
    params = _flax_params(jmodel, 7)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 64, size=(2, 16))
    w = rng.normal(size=(2, 16, 64)).astype(np.float32)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids), deterministic=True)
        return jnp.sum(logits * w), logits

    (_, want_logits), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tmodel = GPT2LM(GPT2Config(**GEOM, dropout=0.0, dtype=torch.float32, norm_impl="pallas"), device="cpu")
    assert isinstance(tmodel.h_0.ln_1, tln.FusedLayerNorm) and isinstance(tmodel.ln_f, tln.FusedLayerNorm)
    tmodel.load_state_dict(gpt2_from_flax(params))
    logits = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), rtol=2e-5, atol=2e-5)
    names = [n for n, _ in tmodel.named_parameters()]
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(), list(tmodel.parameters()))
    want = gpt2_from_flax(jax.tree.map(np.asarray, want_grads))
    assert sorted(want) == sorted(names)
    for name, g in zip(names, grads):
        err = (g - want[name]).abs().max()
        assert err <= 5e-5 * want[name].abs().max(), (name, float(err))


def test_norm_impl_keeps_the_parameter_tree():
    """Both LayerNorms carry the same names, shapes and dtypes, so the
    converted tree, the bucket plan and the gossip are the same; an
    unknown ``norm_impl`` is refused."""
    flax = GPT2LM(GPT2Config(**GEOM), device="meta")
    fused = GPT2LM(dataclasses.replace(GPT2Config(**GEOM), norm_impl="pallas"), device="meta")
    shapes = lambda m: [(n, tuple(p.shape), p.dtype) for n, p in m.named_parameters()]  # noqa: E731
    assert shapes(flax) == shapes(fused)
    with pytest.raises(ValueError):
        GPT2Config(norm_impl="interpret")
