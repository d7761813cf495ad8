"""Ring attention (dense, and on the flash kernels' q/k offsets): the
port's ``parallel.ring_attention`` on 8 ``gloo`` ranks of the CPU
against the reference's on the 8-device host mesh, on the same numpy
inputs.

The port's ranks run every case in one launch (a rank target of
``consensusml_tpu_torch/parallel/check.py``); a case's ring is the first
``n`` ranks. ``ring_flash_attention`` is held to the reference's with its
kernel blocks cut to 16 rows (``_BQ = _BK = 16``, as the reference's own
tests cut them), in the Pallas interpreter: outputs to 3e-5, the
gradients of the local ``sum(o^2)`` to 5e-4, as the reference holds its
ring to dense attention. The dense ring agrees to 2e-5, and to 1e-4 on
the long-sequence case's large logits, as in the reference's tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from consensusml_tpu.models import flash_attention as fa_mod
from consensusml_tpu.parallel import ring_attention as jax_ring, ring_flash_attention as jax_ring_flash
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.parallel import ring_flash_attention
from consensusml_tpu_torch.parallel.check import run_cases

WORLD = 8


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _qkv(seed, shape, scale=1.0):
    q, k = (_normal((seed, i), shape, scale) for i in range(2))
    return q, k, _normal((seed, 2), shape)


DENSE = [(n, causal) for n in (2, 4, 8) for causal in (False, True)]
FLASH = [(causal, grad) for causal in (False, True) for grad in (False, True)]


def _cases():
    cases = []
    for n, causal in DENSE:
        q, k, v = _qkv(0, (2, 32, 4, 16))
        cases.append(dict(kind="ring", n=n, causal=causal, q=q, k=k, v=v))
    q, k, v = _qkv(2, (1, 64, 2, 8), scale=6.0)  # the long-sequence case's large logits
    cases.append(dict(kind="ring", n=8, causal=False, q=q, k=k, v=v))
    for causal, grad in FLASH:
        q, k, v = _qkv(1, (1, 64, 1 if grad else 2, 64))
        cases.append(dict(kind="ring_flash", n=4, causal=causal, grad=grad, q=q, k=k, v=v))
    for grad in (False, True):  # blocks of 12 rows: not a multiple of the blocks
        q, k, v = _qkv(6, (1, 48, 1, 64))
        cases.append(dict(kind="ring_flash", n=4, causal=True, grad=grad, q=q, k=k, v=v))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    return launch(run_cases, WORLD, CASES, "cpu", timeout=600)


def _gathered(port, i, key):
    n = CASES[i]["n"]
    return np.concatenate([port[r][i][key] for r in range(n)], axis=1)


def _shard_map(fn, n, out_specs):
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("sp",))
    return mesh, jax.jit(functools.partial(jax.shard_map, mesh=mesh, in_specs=P(None, "sp"), out_specs=out_specs,
                                           check_vma=False)(fn))


def _reference(case):
    n, causal = case["n"], case["causal"]
    if case["kind"] == "ring":
        body = lambda q, k, v: jax_ring(q, k, v, "sp", causal=causal)  # noqa: E731
    else:
        body = lambda q, k, v: jax_ring_flash(q, k, v, "sp", causal=causal, interpret=True)  # noqa: E731
    if case.get("grad"):
        def grads(q, k, v):
            g = jax.grad(lambda *a: jnp.sum(body(*a) ** 2), argnums=(0, 1, 2))(q, k, v)
            return jax.tree.map(lambda x: jax.lax.all_gather(x, "sp", axis=1, tiled=True), g)

        mesh, f = _shard_map(grads, n, P())
    else:
        mesh, f = _shard_map(body, n, P(None, "sp"))
    shard = NamedSharding(mesh, P(None, "sp"))
    return jax.tree.map(np.asarray, f(*(jax.device_put(jnp.asarray(case[x]), shard) for x in "qkv")))


@pytest.mark.parametrize("i", range(len(DENSE) + 1),
                         ids=[f"n{n}-{'causal' if c else 'full'}" for n, c in DENSE] + ["long-sequence"])
def test_ring_attention_matches_the_reference(port, i):
    tol = 2e-5 if i < len(DENSE) else 1e-4
    got = _gathered(port, i, "out")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _reference(CASES[i]), rtol=tol, atol=tol)


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(fa_mod, "_BQ", 16)
    monkeypatch.setattr(fa_mod, "_BK", 16)


FLASH_IDS = [f"{'causal' if c else 'full'}-{'grads' if g else 'out'}" for c, g in FLASH] + ["padded-out",
                                                                                              "padded-grads"]


@pytest.mark.parametrize("j", range(len(FLASH) + 2), ids=FLASH_IDS)
def test_ring_flash_matches_the_reference(port, small_blocks, j):
    i = len(DENSE) + 1 + j
    case = CASES[i]
    want = _reference(case)
    if not case["grad"]:
        np.testing.assert_allclose(_gathered(port, i, "out"), want, rtol=3e-5, atol=3e-5)
        return
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(_gathered(port, i, name), w, rtol=5e-4, atol=5e-4, err_msg=name)


def test_ring_flash_refuses_unequal_blocks():
    q, k = torch.zeros((1, 16, 1, 64)), torch.zeros((1, 32, 1, 64))
    with pytest.raises(ValueError, match="equal block shapes"):
        ring_flash_attention(q, k, k, None)
    jax.clear_caches()
