"""The port's LR schedules, clipping and optimizer rebuild
(``consensusml_tpu_torch/train/schedules.py``, ``train/optim.py``) against
the reference's (``consensusml_tpu/train/schedules.py``) and optax.

Schedules: every count of three horizons (24 steps with 2 of warmup, 777
with 13, 20,000 with 500; each kind with and without warmup) against the
reference's schedule compiled by ``jax.jit`` at one scalar int32 count,
as the train step evaluates it, bit for bit (the cosine through the C
library's ``cosf``, which the compiled program calls). The 20,000-step
horizon is read at every count through ``jax.vmap`` of the same function
(the same elementwise program) and at every 97th through the scalar one.

Updates: SGD with momentum, Adam and ``lora_optimizer`` against optax's
updates run op by op (not jitted) on the same numpy-seeded parameters and
gradients, two steps, without clipping and with clipping at a norm
above and below the threshold. Without a clip each step is bit-equal
(parameters and state). With one, the global norm is a sum of squares,
which torch and XLA reduce in other orders: parameters and moments within
2e-6 relative of optax's (a few f32 roundings of the norm carried into the
scaled gradient), the counts equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from consensusml_tpu.models.lora import lora_optimizer as jax_lora_optimizer
from consensusml_tpu.train.schedules import build_optimizer as jax_build_optimizer
from consensusml_tpu.train.schedules import lr_schedule as jax_lr_schedule
from consensusml_tpu_torch.train.optim import (
    AdamState,
    ClipByGlobalNorm,
    ClipState,
    SGDState,
    adam,
    clip_norms,
    latest_lr,
    lora_optimizer,
    sgd,
)
from consensusml_tpu_torch.train.schedules import Schedule, build_optimizer, lr_schedule
from consensusml_tpu_torch.utils.tree import named_tensors

HORIZONS = [(24, 2, 0.05), (777, 13, 0.1), (20000, 500, 1e-4)]
CLIP_RTOL = 2e-6


def _values(sched, n):
    return np.array([sched.value(c) for c in range(n)], np.float32)


@pytest.mark.parametrize("kind", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("total,warmup,peak", HORIZONS)
def test_schedules_equal_the_compiled_reference_bit_for_bit(kind, total, warmup, peak):
    for w in (0, warmup):
        got, want = lr_schedule(kind, peak, total, w), jax_lr_schedule(kind, peak, total, w)
        if not callable(want):
            assert got == want == peak and not isinstance(got, Schedule)
            continue
        assert isinstance(got, Schedule)
        n = total + 5  # past the horizon too
        mine = _values(got, n)
        scalar = jax.jit(want)
        stride = 1 if total < 1000 else 97
        counts = list(range(0, n, stride))
        ref = np.array([np.asarray(scalar(jnp.int32(c))) for c in counts], np.float32)
        np.testing.assert_array_equal(mine[counts].view(np.int32), ref.view(np.int32), err_msg=f"{kind} w={w}")
        if stride > 1:
            every = np.asarray(jax.vmap(jax.jit(want))(jnp.arange(n, dtype=jnp.int32)), np.float32)
            np.testing.assert_array_equal(mine.view(np.int32), every.view(np.int32))
        assert got(3) == float(mine[3])


def test_schedule_checks_match_the_reference():
    for kind, peak, total, warm in [("cosine", 0.1, 0, 0), ("linear", 0.1, -1, 0), ("cosine", 0.1, 10, 10),
                                    ("constant", 0.1, 5, 7), ("bogus", 0.1, 10, 0)]:
        with pytest.raises(ValueError) as mine:
            lr_schedule(kind, peak, total, warm)
        with pytest.raises(ValueError) as ref:
            jax_lr_schedule(kind, peak, total, warm)
        assert str(mine.value) == str(ref.value)
    # a pure-warmup constant schedule needs no horizon
    assert lr_schedule("constant", 0.1, 0, 3).value(3) == np.float32(0.1)


def test_build_optimizer_reads_clip_support_off_the_signature():
    seen = {}

    def aware(lr, grad_clip=0.0):
        seen["clip"] = grad_clip
        return sgd(lr, 0.9)

    assert build_optimizer(aware, peak_lr=0.1, grad_clip=1.5) == sgd(0.1, 0.9) and seen["clip"] == 1.5
    tx = build_optimizer(adam, peak_lr=0.1, kind="cosine", total_steps=10, warmup_steps=2, grad_clip=1.0)
    assert isinstance(tx, ClipByGlobalNorm) and tx.max_norm == 1.0 and tx.lr == Schedule("cosine", 0.1, 10, 2)
    assert build_optimizer(adam, peak_lr=0.1) == adam(0.1)

    def broken(lr, grad_clip=0.0):
        raise TypeError("inside the factory")

    with pytest.raises(TypeError, match="inside the factory"):
        build_optimizer(broken, peak_lr=0.1, grad_clip=1.0)
    assert "grad_clip" in inspect.signature(jax_build_optimizer).parameters


def _tree(rng, lora=False):
    """A flax-like nested tree of f32 leaves (names sort as flax's do)."""
    leaves = {"Dense_0": {"bias": (6,), "kernel": (5, 6)}, "h_1": {"attn": {"qkv": {"kernel": (6, 4, 3)}}},
              "h_10": {"scale": (6,)}}
    if lora:
        leaves = {"layer_0": {"q_proj": {"base": {"kernel": (6, 6)}, "lora_a": (6, 2), "lora_b": (2, 6)}},
                  "norm": {"scale": (6,)}, "layer_1": {"v_proj": {"base": {"kernel": (6, 6)}, "lora_a": (6, 2),
                                                                   "lora_b": (2, 6)}}}

    def draw(node):
        return {k: draw(v) for k, v in node.items()} if isinstance(node, dict) else rng.normal(
            size=node).astype(np.float32)

    return draw(leaves)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    return {".".join(prefix): np.asarray(tree)}


def _port_opt(kind, sched, clip):
    if kind == "sgd":
        tx = sgd(sched, 0.9)
    elif kind == "adam":
        tx = adam(sched)
    else:
        return lora_optimizer(adam(sched), grad_clip=clip)
    return ClipByGlobalNorm(clip, tx) if clip > 0 else tx


def _ref_opt(kind, sched, clip):
    if kind == "lora":
        inner = optax.adam(sched)
        return jax_lora_optimizer(optax.chain(optax.clip_by_global_norm(clip), inner) if clip > 0 else inner)
    factory = (lambda lr: optax.sgd(lr, momentum=0.9)) if kind == "sgd" else optax.adam
    return jax_build_optimizer(factory, peak_lr=0.05, kind="linear", total_steps=8, warmup_steps=2, grad_clip=clip)


@pytest.mark.parametrize("kind", ["sgd", "adam", "lora"])
@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3])
def test_updates_match_optax(kind, clip):
    """Two steps of one worker (row 1 of a stack of three) against optax:
    parameters, moments or trace, counts and the schedule's count; with a
    clip of 0.5 every step clips (norms ~10), with 1e3 none does."""
    rng = np.random.default_rng(5)
    params = _tree(rng, lora=kind == "lora")
    sched = lr_schedule("linear", 0.05, 8, 2)
    tx, opt = _ref_opt(kind, jax_lr_schedule("linear", 0.05, 8, 2), clip), _port_opt(kind, sched, clip)
    flat = _flat(params)
    stacked = {n: torch.from_numpy(np.stack([a * 0.5, a, a * 2.0])) for n, a in flat.items()}
    state = opt.init(stacked, 3)
    ref_params = jax.tree.map(jnp.asarray, params)
    ref_state = tx.init(ref_params)
    norms = []
    for _ in range(2):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), params)
        updates, ref_state = tx.update(jax.tree.map(jnp.asarray, grads), ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        g = {n: torch.from_numpy(a) for n, a in _flat(grads).items() if opt.trains(n)}
        opt.update_({n: p[1] for n, p in stacked.items()}, g, state, 1)
        if clip:
            norms.append(float(clip_norms(opt, state)[1]))
    want = _flat(jax.tree.map(np.asarray, ref_params))
    exact = clip == 0.0
    for n, a in want.items():
        got = stacked[n][1].numpy()
        if exact:
            np.testing.assert_array_equal(got, a, err_msg=n)
        else:
            np.testing.assert_allclose(got, a, rtol=CLIP_RTOL, atol=1e-7, err_msg=n)
    # the state, leaf by leaf in optax's flatten order (the clip's norms aside)
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref_state)]
    mine = [t for _, t in named_tensors(state) if not (isinstance(state, ClipState) and t is state.norm)]
    assert len(mine) == len(ref_leaves)
    for t, r in zip(mine, ref_leaves):
        got = t[1].numpy()
        if r.dtype.kind == "i" or exact:
            np.testing.assert_array_equal(got, r)
        else:
            np.testing.assert_allclose(got, r, rtol=CLIP_RTOL, atol=1e-7)
    base = state.inner if isinstance(state, ClipState) else state
    assert isinstance(base, AdamState if kind != "sgd" else SGDState)
    assert base.sched_count.tolist() == [0, 2, 0] and latest_lr(opt, state, 1) == sched(1)
    if clip == 0.5:
        assert min(norms) > 5.0
    elif clip:
        assert max(norms) < 1e3
    if kind == "lora":  # the clip's norm covers the adapters only
        assert all(opt.trains(n) == ("lora" in n) for n in flat)
