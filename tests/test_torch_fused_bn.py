"""The port's fused BatchNorm(+ReLU) against the JAX package's, on the CPU.

The kernels' plain versions (which the wrappers run for CPU tensors), the
autograd ``fused_batch_norm`` and the ``FusedBatchNorm`` module are held
against ``consensusml_tpu/models/fused_bn.py`` in ``impl="interpret"`` (its
Pallas kernels in interpret mode; M = 256 is a shape its ``_plan`` takes
at C = 8, 64 and 256, so no case falls back to its jnp path) and, for the
backward, ``impl="jnp"``; the port's ``norm_impl="flax"`` BatchNorm
against flax's ``nn.BatchNorm``. Inputs are made with numpy and handed to
both.

Tolerances: both sides compute in f32 from the same inputs, in other
summation orders. f32 outputs (y, dx) and the statistics agree to ~1e-6
(read: at most 1.4e-6), hence atol 1e-5; the per-channel sums dgamma and
dbeta over 256 rows to ~1e-5 (read: at most 1.1e-5), hence atol 1e-4. A
bf16 output is rounded from f32 values that may differ in the last f32
bits, so it may land one bf16 ulp away: rtol 2**-7 (read: 4.9e-4 on
values in [0.0625, 0.125)). A wrong formula (a missing mean term in dx,
an unbiased variance, a mask not recomputed) moves them by 1e-2 or more.

Subnormals: the reference's compiled program (jitted on the CPU) reads a
subnormal operand as zero and flushes a subnormal result; the backward's
plain version does the same, which a tolerance would hide, so those
cases are checked value by value.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models import fused_bn as jbn
from consensusml_tpu_torch.models import fused_bn as tbn
from consensusml_tpu_torch.models.resnet import BatchNorm

M = 256
F32_TOL = dict(atol=1e-5, rtol=1e-5)
SUM_TOL = dict(atol=1e-4, rtol=1e-5)
BF16_TOL = dict(atol=1e-5, rtol=2.0**-7)
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _case(c, seed, m=M):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, c)) * 2 + 0.3).astype(np.float32)
    gamma = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(m, c)).astype(np.float32)
    return x, gamma, beta, dy


def _out_tol(dtype):
    return F32_TOL if dtype == torch.float32 else BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("c", [8, 64, 256])
def test_plain_versions_match_reference_kernels(c, relu, dtype):
    """The plain versions of the statistics, normalize and the backward's two
    bodies, and the one-launch backward ``bn_bwd_plain`` (and each wrapper,
    which runs its plain version for CPU tensors without counting a
    launch), against the reference's kernels in interpret mode, fed the
    same per-channel vectors."""
    x, gamma, beta, dy = _case(c, c + relu)
    jd = JAX_DTYPE[dtype]
    jx, jdy = jnp.asarray(x, jd), jnp.asarray(dy, jd)
    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    launches = [f.launches for f in (tbn.bn_stats, tbn.bn_norm, tbn.bn_bwd)]

    s, sq = jbn._stats(jx, "interpret", True)
    for fn in (tbn.bn_stats_plain, tbn.bn_stats):
        ts, tsq = fn(tx)
        assert ts.dtype == tsq.dtype == torch.float32
        _close(ts, s, SUM_TOL)
        _close(tsq, sq, SUM_TOL)

    mean = np.asarray(s) / M
    var = np.maximum(np.asarray(sq) / M - mean * mean, 0.0)
    scale, shift, rsqrt = (np.asarray(a) for a in jbn._fold_params(gamma, beta, mean, var, 1e-5))
    tv = {n: torch.tensor(np.asarray(a, np.float32)) for n, a in
          (("scale", scale), ("shift", shift), ("mean", mean), ("rsqrt", rsqrt))}

    y = jbn._normalize(jx, scale, shift, relu, jd, "interpret", True)
    for fn in (tbn.bn_norm_plain, tbn.bn_norm):
        ty = fn(tx, tv["scale"], tv["shift"], relu)
        assert ty.dtype == dtype
        _close(ty, y, _out_tol(dtype))

    vecs = (tv["scale"], tv["shift"], tv["mean"], tv["rsqrt"])
    db, dg = jbn._bwd_reduce(jdy, jx, scale, shift, mean, rsqrt, relu, "interpret", True)
    tdb, tdg = tbn.bn_bwd_reduce_plain(tdy, tx, *vecs, relu)
    _close(tdb, db, SUM_TOL)
    _close(tdg, dg, SUM_TOL)

    c1, c2 = np.asarray(db) / M, np.asarray(dg) / M
    dx = jbn._bwd_dx(jdy, jx, scale, shift, mean, rsqrt, c1, c2, relu, "interpret", True)
    tdx = tbn.bn_bwd_dx_plain(tdy, tx, *vecs, torch.from_numpy(c1), torch.from_numpy(c2), relu)
    assert tdx.dtype == dtype
    _close(tdx, dx, _out_tol(dtype))
    # the one-launch backward (its plain version for CPU tensors), with its
    # own sums over M between the two bodies
    for fn in (tbn.bn_bwd_plain, tbn.bn_bwd):
        tdx, tdb, tdg = fn(tdy, tx, *vecs, relu)
        assert tdx.dtype == dtype and tdb.dtype == tdg.dtype == torch.float32
        _close(tdb, db, SUM_TOL)
        _close(tdg, dg, SUM_TOL)
        _close(tdx, dx, _out_tol(dtype))
    assert launches == [f.launches for f in (tbn.bn_stats, tbn.bn_norm, tbn.bn_bwd)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("c", [8, 64, 256])
def test_fused_batch_norm_matches_reference(c, relu, dtype):
    """y, mean, var and the gradients dx, dgamma, dbeta of one output
    cotangent, through the autograd Function, against the reference's
    custom VJP in interpret mode; ``impl="jnp"`` (the plain versions by
    name) gives the same bits as ``"auto"`` on the CPU."""
    x, gamma, beta, dy = _case(c, 100 + c + relu, m=4 * M)
    x, dy = x.reshape(4, 16, 16, c), dy.reshape(4, 16, 16, c)  # an NHWC activation
    jd, act = JAX_DTYPE[dtype], "relu" if relu else None
    args = (jnp.asarray(x, jd), jnp.asarray(gamma), jnp.asarray(beta))
    (y, mean, var), pull = jax.vjp(lambda *a: jbn.fused_batch_norm(*a, act=act, impl="interpret"), *args)
    dx, dgamma, dbeta = pull((jnp.asarray(dy, jd), jnp.zeros_like(mean), jnp.zeros_like(var)))

    got = {}
    for impl in ("auto", "jnp"):
        tx = torch.from_numpy(x).to(dtype).requires_grad_()
        tg, tb = (torch.from_numpy(a).requires_grad_() for a in (gamma, beta))
        ty, tmean, tvar = tbn.fused_batch_norm(tx, tg, tb, act=act, impl=impl)
        assert ty.shape == tx.shape and ty.dtype == dtype
        assert not tmean.requires_grad and not tvar.requires_grad
        ty.backward(torch.from_numpy(dy).to(dtype))
        got[impl] = (ty, tmean, tvar, tx.grad, tg.grad, tb.grad)
    for a, b in zip(got["auto"], got["jnp"]):
        assert torch.equal(a, b)
    ty, tmean, tvar, tdx, tdg, tdb = got["auto"]
    _close(ty, y, _out_tol(dtype))
    _close(tmean, mean, F32_TOL)
    _close(tvar, var, F32_TOL)
    _close(tdx, dx, _out_tol(dtype))
    _close(tdg, dgamma, SUM_TOL)
    _close(tdb, dbeta, SUM_TOL)


def _saved(x, gamma, beta, relu):
    """The port's forward residuals ``(scale, shift, mean, rsqrt)`` of f32
    ``(M, C)`` ``x``, as ``_FusedBatchNorm.forward`` saves them."""
    tx = torch.from_numpy(x)
    s, sq = tbn.bn_stats_plain(tx)
    mean, var = tbn.batch_moments(s, sq, x.shape[0])
    scale, shift, rsqrt = tbn.fold_params(torch.from_numpy(gamma), torch.from_numpy(beta), mean, var, 1e-5)
    return scale, shift, mean, rsqrt


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("c", [8, 256, 24])
def test_bn_bwd_plain_matches_reference_vjp(c, relu, dtype, impl):
    """``bn_bwd_plain`` (and ``bn_bwd`` on CPU tensors, which takes it and
    counts no launch) against the reference's VJP: ``jax.vjp`` of
    ``fused_batch_norm(impl=...)`` pulled back through one output
    cotangent. M = 256 at C = 8 and 256 is a view the reference's ``_plan``
    tiles (its Pallas bodies run in interpret mode); C = 24 takes its jnp
    path."""
    x, gamma, beta, dy = _case(c, 200 + c + relu)
    jd, act = JAX_DTYPE[dtype], "relu" if relu else None
    args = (jnp.asarray(x, jd), jnp.asarray(gamma), jnp.asarray(beta))
    (y, mean, var), pull = jax.vjp(lambda *a: jbn.fused_batch_norm(*a, act=act, impl=impl), *args)
    dx, dgamma, dbeta = pull((jnp.asarray(dy, jd), jnp.zeros_like(mean), jnp.zeros_like(var)))

    tx, tdy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    vecs = _saved(tx.float().numpy(), gamma, beta, relu)
    before = tbn.bn_bwd.launches
    got = [fn(tdy, tx, *vecs, relu) for fn in (tbn.bn_bwd_plain, tbn.bn_bwd)]
    assert tbn.bn_bwd.launches == before
    assert all(torch.equal(a, b) for a, b in zip(*got))
    tdx, tdb, tdg = got[0]
    assert tdx.dtype == dtype and tdx.shape == tx.shape
    _close(tdx, dx, _out_tol(dtype))
    _close(tdg, dgamma, SUM_TOL)
    _close(tdb, dbeta, SUM_TOL)


def _subnormal_case(m=256, c=8):
    """f32 rows and columns where the reference's flush decides the result:
    channel 0's dy all subnormal (the reference sums it to 0, dx 0);
    channel 1's dy a normal 1.5e-38 with the sign of x - mean, so every
    product g * xhat is >= 0 (no partial sum cancels into the subnormal
    range, where the two summation orders would flush differently) and
    those with |xhat| < ~0.78 underflow; one row of subnormal x."""
    x, gamma, beta, dy = _case(c, 17, m=m)
    dy[:, 0] = np.float32(1e-39) * np.where(np.arange(m) % 3 == 0, -1.0, 1.0)
    dy[:, 1] = np.float32(1.5e-38) * np.sign(x[:, 1] - x[:, 1].mean())
    x[7] = np.float32(1e-39)
    return x, gamma, beta, dy


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_bn_bwd_flushes_subnormals_as_the_reference(relu, impl):
    """The reference's compiled backward (``_bn_train_bwd`` jitted on the
    CPU) flushes f32 subnormals; ``bn_bwd_plain`` does so at the same
    points. Channel 0 (subnormal dy) sums to exactly 0 with an all-zero dx
    column, and no output is subnormal. Channel 1's dgamma, on the jnp
    path, counts only the products that stay normal (to 1e-5 of its terms'
    magnitudes; keeping the subnormal products moves it by ~25%), as the
    TPU, which has no f32 subnormals, does. The interpret path's CPU
    program contracts some of those products into fused multiply-adds with
    the running sum, so it keeps a share of them: its dgamma is held only
    to the f32 tolerance there."""
    x, gamma, beta, dy = _subnormal_case()
    m = x.shape[0]
    scale, shift, mean, rsqrt = _saved(x, gamma, beta, relu)
    res = tuple(jnp.asarray(a.numpy()) for a in (scale, shift, mean, rsqrt))
    fn = jax.jit(lambda dy2, x2, sc, sh, mu, rs: jbn._bn_train_bwd(
        1e-5, relu, impl, True, (x2, sc, sh, mu, rs), (dy2, None, None)))
    dx, dg, db = (np.asarray(a) for a in fn(jnp.asarray(dy), jnp.asarray(x), *res))
    assert db[0] == 0.0 and dg[0] == 0.0 and not dx[:, 0].any()  # the reference flushes

    tdx, tdb, tdg = tbn.bn_bwd_plain(torch.from_numpy(dy), torch.from_numpy(x), scale, shift, mean, rsqrt, relu)
    tdx, tdb, tdg = tdx.numpy(), tdb.numpy(), tdg.numpy()
    assert tdb[0] == 0.0 and tdg[0] == 0.0 and not tdx[:, 0].any()
    for out in (tdx, tdb, tdg):
        assert not ((out != 0) & (np.abs(out) < 2.0**-126)).any()
    # channel 1: dgamma over the normal products only, as the reference
    xf = torch.from_numpy(x)
    g = torch.from_numpy(dy)
    if relu:
        g = torch.where(xf * scale + shift > 0, g, 0.0)
    prods = (g * ((xf - mean) * rsqrt))[:, 1].double().numpy()
    assert (np.abs(prods[prods != 0]) < 2.0**-126).sum() > 10  # the case underflows
    terms = np.abs(prods).sum()
    if impl == "jnp":
        assert abs(tdg[1] - dg[1]) <= 1e-5 * terms and abs(prods.sum() - dg[1]) > 1e-2 * terms
    _close(tdx, dx, F32_TOL)
    _close(tdb, db, SUM_TOL)
    _close(tdg, dg, SUM_TOL)


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_bn_forward_flushes_subnormals_as_the_reference(relu, impl):
    """The reference's compiled forward (``_bn_train_fwd`` jitted on the
    CPU) reads a subnormal x as zero: a channel of subnormal x (channel 0,
    beta 0) has mean 0, var 0 and y 0, where arithmetic that kept the
    subnormals gives a subnormal mean and a y of ~1e-37. The port's forward
    (plain kernels and the plain ops between them, through
    ``fused_batch_norm``) gives the same, and no output is subnormal; the
    normal channels agree within the f32 tolerance, and the mean is the
    compiled program's ``s * f32(1/m)``: given the reference's own sums,
    the reference's mean bit for bit."""
    x, gamma, beta, _dy = _case(8, 31, m=777)
    x[:, 0] = np.float32(1e-39) * np.where(np.arange(777) % 3 == 0, -1.0, 1.0)
    x[5, 3] = np.float32(-2e-39)
    beta[0] = 0.0
    fn = jax.jit(lambda x2, g, b: jbn._bn_train_fwd(x2, g, b, 1e-5, relu, impl, True)[0])
    y, mean, var = (np.asarray(a) for a in fn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta)))
    assert mean[0] == 0.0 and var[0] == 0.0 and not y[:, 0].any()  # the reference flushes

    ty, tmean, tvar = tbn.fused_batch_norm(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                                           act="relu" if relu else None, impl="auto")
    ty, tmean, tvar = ty.numpy(), tmean.numpy(), tvar.numpy()
    assert tmean[0] == 0.0 and tvar[0] == 0.0 and not ty[:, 0].any()
    for out in (ty, tmean, tvar):
        assert not ((out != 0) & (np.abs(out) < 2.0**-126)).any()
    # given the reference's own sums, batch_moments gives its mean bit for bit
    sums = (torch.from_numpy(np.array(a)) for a in jax.jit(lambda x2: jbn._stats(x2, impl, True))(jnp.asarray(x)))
    assert np.array_equal(tbn.batch_moments(*sums, 777)[0].numpy(), mean)
    _close(ty, y, F32_TOL)
    _close(tvar, var, F32_TOL)
    # without the flush, channel 0's mean would be a subnormal
    assert float(torch.from_numpy(x[:, 0]).sum()) != 0.0


def test_fused_module_running_stats_and_eval():
    """Two training steps of ``FusedBatchNorm`` update the running
    statistics as the reference module does (0.9 old + 0.1 batch, biased
    variance), then the eval branch normalises with them."""
    c = 64
    rng = np.random.default_rng(7)
    xs = [(rng.normal(size=(16, 4, 4, c)) * 3 + 1).astype(np.float32) for _ in range(3)]
    jmod = jbn.FusedBatchNorm(act="relu", impl="interpret")
    variables = jmod.init(jax.random.key(0), jnp.asarray(xs[0]))
    tmod = tbn.FusedBatchNorm(c, act="relu", impl="auto")
    with torch.no_grad():
        tmod.scale.copy_(torch.linspace(0.5, 1.5, c))
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, c), "bias": variables["params"]["bias"]},
                 "batch_stats": variables["batch_stats"]}
    for x in xs[:2]:
        y, upd = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, **upd}
        ty = tmod(torch.from_numpy(x))
        _close(ty, y, F32_TOL)
        _close(tmod.mean, variables["batch_stats"]["mean"], F32_TOL)
        _close(tmod.var, variables["batch_stats"]["var"], F32_TOL)
    y_eval = jbn.FusedBatchNorm(use_running_average=True, act="relu").apply(variables, jnp.asarray(xs[2]))
    mean0 = tmod.mean.clone()
    _close(tmod(torch.from_numpy(xs[2]), use_running_average=True), y_eval, F32_TOL)
    assert torch.equal(tmod.mean, mean0)  # eval leaves the statistics alone


def _flax_bn(x, gamma, beta, stats, train, dtype):
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5, dtype=dtype)
    variables = {"params": {"scale": gamma, "bias": beta}, "batch_stats": stats}
    if not train:
        return bn.apply(variables, x), stats
    y, upd = bn.apply(variables, x, mutable=["batch_stats"])
    return y, upd["batch_stats"]


@pytest.mark.parametrize("shape", [(8, 4, 4, 16), (4, 8, 8, 32)])
def test_flax_path_batchnorm_matches_nn_batchnorm(shape):
    """``norm_impl="flax"``'s BatchNorm against flax ``nn.BatchNorm`` (f32):
    the output, the gradients through the batch statistics, the updated
    running mean and var, and eval mode. At 8 x 4 x 4 = 128 rows the
    unbiased variance PyTorch keeps by default is 128/127 = 1.008 times
    the biased one flax keeps: over 100x the tolerance apart."""
    c = shape[-1]
    x, gamma, beta, dy = _case(c, sum(shape), m=int(np.prod(shape[:-1])))
    x, dy = x.reshape(shape), dy.reshape(shape)
    stats = {"mean": np.full(c, 0.2, np.float32), "var": np.full(c, 1.5, np.float32)}
    fn = lambda x, g, b: _flax_bn(x, g, b, stats, True, jnp.float32)  # noqa: E731
    y, pull, new = jax.vjp(fn, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), has_aux=True)
    dx, dgamma, dbeta = pull(jnp.asarray(dy))

    bn = BatchNorm(c)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.mean.copy_(torch.from_numpy(stats["mean"]))
        bn.var.copy_(torch.from_numpy(stats["var"]))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()  # channels_last NCHW, as in the ResNet
    ty = bn(tx)
    ty.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    _close(ty.permute(0, 2, 3, 1), y, F32_TOL)
    _close(tx.grad.permute(0, 2, 3, 1), dx, F32_TOL)
    _close(bn.scale.grad, dgamma, SUM_TOL)
    _close(bn.bias.grad, dbeta, SUM_TOL)
    _close(bn.mean, new["mean"], F32_TOL)
    _close(bn.var, new["var"], F32_TOL)
    n = x.size // c
    if n == 128:  # PyTorch's default update would be far outside the tolerance
        unbiased = 0.9 * stats["var"] + 0.1 * x.reshape(-1, c).var(axis=0, ddof=1)
        assert np.abs(unbiased - np.asarray(new["var"])).max() > 100 * F32_TOL["atol"]

    y_eval, _ = _flax_bn(jnp.asarray(x), gamma, beta, new, False, jnp.float32)
    with torch.no_grad():
        _close(bn(torch.from_numpy(x).permute(0, 3, 1, 2), use_running_average=True).permute(0, 2, 3, 1),
               y_eval, F32_TOL)


def test_flax_path_bf16_output_and_relu():
    """bf16 activations through the flax-path BatchNorm: f32 statistics,
    the output rounded to bf16, ReLU after the rounding (flax's order)."""
    c = 32
    x, gamma, beta, _ = _case(c, 3, m=8 * 8 * 8)
    x = x.reshape(8, 8, 8, c)
    stats = {"mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}
    y, new = _flax_bn(jnp.asarray(x, jnp.bfloat16), gamma, beta, stats, True, jnp.bfloat16)
    y = jax.nn.relu(y)
    bn = BatchNorm(c, act="relu")
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    ty = bn(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert ty.dtype == torch.bfloat16
    _close(ty.permute(0, 2, 3, 1), y, BF16_TOL)
    _close(bn.mean, new["mean"], F32_TOL)
    _close(bn.var, new["var"], F32_TOL)


RESNET50_BN_VIEWS = [(131072, 64), (131072, 128), (131072, 256), (32768, 128), (32768, 256), (32768, 512),
                     (8192, 256), (8192, 512), (8192, 1024), (2048, 512), (2048, 2048)]


@pytest.mark.parametrize("elem,vec", [(2, 8), (4, 4)], ids=["bf16", "f32"])
def test_bn_bwd_plan_is_one_the_kernel_takes(elem, vec):
    """The backward's launch plan at ResNet-50's BN views and at odd ones:
    clusters of at most 16 blocks, no block without rows, a tile that is a
    power of two of 16-byte vectors up to a 128-byte row, >= 64 blocks
    where C allows, staged chunks within TMA's 256-row box, shared memory
    within a block's 227 KB, and the on-chip form only where the whole
    stripe is staged. At bf16 the stripes of the (2048, C) and (8192, 256)
    views stay on chip and the others stream."""
    views = RESNET50_BN_VIEWS + [(1, 8), (300, 24), (4096, 64), (512, 2048), (100, 1024)]
    for m, c in views:
        p = tbn.bn_bwd_plan(m, c, elem, vec)
        blocks = p.cluster * -(-c // p.tile)
        assert 1 <= p.cluster <= 16 and p.cluster * p.rows >= m and (p.cluster - 1) * p.rows < m
        assert p.tile % vec == 0 and (p.tile // vec) & (p.tile // vec - 1) == 0 and p.tile * elem <= 128
        assert blocks >= 64 or p.tile == vec or p.cluster * p.rows < 128 * 16
        assert 1 <= p.chunk <= 256 and 1 <= p.nbuf <= 64 and p.smem <= 232448
        if p.onchip:
            assert p.nbuf * p.chunk >= p.rows
    if elem == 2:
        onchip = {v for v in RESNET50_BN_VIEWS if tbn.bn_bwd_plan(*v, 2, 8).onchip}
        assert onchip == {(2048, 512), (2048, 2048), (8192, 256)}
        p = tbn.bn_bwd_plan(131072, 256, 2, 8)
        assert (p.cluster, p.tile, p.rows, p.chunk, p.nbuf) == (16, 64, 8192, 128, 3)
    for m, c in [(1, 1), (7, 3), (777, 13), (1000, 24)]:  # the one-element path
        p = tbn.bn_bwd_plan(m, c, elem, 1)
        assert p.chunk == p.nbuf == 0 and not p.onchip and p.tile <= 32 and p.cluster * p.rows >= m
    with pytest.raises(ValueError):
        tbn.bn_bwd_plan(131072, 256, 2, 8, onchip=True)


@pytest.mark.parametrize("elem,vec", [(2, 8), (4, 4)], ids=["bf16", "f32"])
def test_bn_stats_plan_is_one_the_kernel_takes(elem, vec):
    """The statistics' one-launch plan at ResNet-50's BN views and at odd
    ones: 1 to 4 clusters of at most 16 blocks per channel tile over all
    rows (16 blocks from M = 32768 on; more clusters only where a block
    would walk 4096 rows, and no more than 128 blocks then), no block
    without rows, a tile that is a power of two of 16-byte vectors up to a
    128-byte row, TMA chunks within the 256-row box and a ring of two
    within the block's shared memory where the stripe is long, 16-byte
    loads (no ring) for M <= 2048 or a narrow C; the one-element path
    stages nothing."""
    views = RESNET50_BN_VIEWS + [(1, 8), (300, 24), (4096, 64), (512, 2048), (100, 1024)]
    for m, c in views:
        p = tbn.bn_stats_plan(m, c, elem, vec)
        along = p.cluster * p.splits
        assert 1 <= p.cluster <= 16 and along * p.rows >= m and (along - 1) * p.rows < m
        assert p.cluster == min(16 if m >= 32768 else 8, -(-m // 128))
        assert 1 <= p.splits <= 4 and (p.splits == 1 or (m // p.cluster >= 4096 and along * -(-c // p.tile) <= 128))
        assert p.tile % vec == 0 and (p.tile // vec) & (p.tile // vec - 1) == 0 and p.tile * elem <= 128
        assert p.smem <= 232448
        if p.nbuf:  # staged by TMA
            assert (c * elem > 128 or p.splits > 1) and m > 2048 and p.tile * elem <= 64
            assert 1 <= p.chunk <= 256 and p.nbuf <= 2 and (p.nbuf - 1) * p.chunk < p.rows
        else:
            assert p.chunk == 0 and (c * elem <= 128 or m <= 2048)
    if elem == 2:
        assert tbn.bn_stats_plan(131072, 256, 2, 8) == tbn.StatsPlan(16, 1, 32, 8192, 256, 2, 49280)
        assert tbn.bn_stats_plan(131072, 64, 2, 8)[:6] == (16, 4, 32, 2048, 256, 2)
        assert tbn.bn_stats_plan(2048, 2048, 2, 8)[:6] == (8, 1, 64, 256, 0, 0)
    for m, c in [(1, 1), (7, 3), (777, 13), (1000, 24)]:  # the one-element path
        p = tbn.bn_stats_plan(m, c, elem, 1)
        assert p.chunk == p.nbuf == 0 and p.splits == 1 and p.tile <= 32 and p.cluster * p.rows >= m


def test_fused_batch_norm_refuses_what_it_does_not_take():
    x = torch.zeros(4, 4, 8)
    g, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError):
        tbn.fused_batch_norm(x, g, b, act="gelu")
    with pytest.raises(ValueError):
        tbn.fused_batch_norm(x, g, b, impl="triton")
    with pytest.raises(RuntimeError):  # no (M, C) view of a transposed tensor: never a silent copy
        tbn.fused_batch_norm(x.transpose(0, 2), torch.ones(4), torch.zeros(4))


def test_one_row_batch():
    """M = 1: the fused path gives flax's zero variance (y = beta, dx = 0)
    as the reference does; the flax path's PyTorch batch norm refuses a
    training batch of one value per channel (ROADMAP Queue C)."""
    x, gamma, beta, dy = _case(16, 11, m=1)
    args = (jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    (y, mean, var), pull = jax.vjp(lambda *a: jbn.fused_batch_norm(*a, impl="interpret"), *args)
    dx, dgamma, dbeta = pull((jnp.asarray(dy), jnp.zeros_like(mean), jnp.zeros_like(var)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta))
    ty, tmean, tvar = tbn.fused_batch_norm(tx, tg, tb)
    ty.backward(torch.from_numpy(dy))
    for got, want, tol in ((ty, y, F32_TOL), (tvar, var, F32_TOL), (tx.grad, dx, F32_TOL),
                           (tg.grad, dgamma, SUM_TOL), (tb.grad, dbeta, SUM_TOL)):
        _close(got, want, tol)
    assert float(tvar.abs().max()) == 0.0
    with pytest.raises(ValueError):
        BatchNorm(16)(torch.from_numpy(x).view(1, 16, 1, 1))
