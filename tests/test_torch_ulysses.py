"""Ulysses attention: the port's ``parallel.ulysses_attention`` on
``gloo`` ranks of the CPU against the reference's on the host mesh, on
the same numpy inputs (the reference's cases: dense agreement at 2 and
4 ranks, full and causal, at 2e-5; agreement with ring attention at 8;
bf16 within 0.05; the refusal of heads that do not divide)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from consensusml_tpu.parallel import ulysses_attention as jax_ulysses
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.parallel.check import run_cases


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


DENSE = [(n, causal) for n in (2, 4) for causal in (False, True)]


def _cases():
    cases = [dict(kind="ulysses", n=n, causal=c, **dict(zip("qkv", _qkv(0, (2, 32, 4, 16))))) for n, c in DENSE]
    both = dict(zip("qkv", _qkv(1, (1, 64, 8, 8))))
    cases += [dict(kind="ulysses", n=8, causal=True, **both), dict(kind="ring", n=8, causal=True, **both)]
    cases.append(dict(kind="ulysses", n=4, causal=True, dtype="bfloat16", **dict(zip("qkv", _qkv(2, (1, 16, 4, 8))))))
    cases.append(dict(kind="ulysses", n=4, causal=False, **dict(zip("qkv", _qkv(3, (1, 16, 2, 8))))))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    return launch(run_cases, 8, CASES, "cpu", timeout=600)


def _gathered(port, i):
    return np.concatenate([port[r][i]["out"] for r in range(CASES[i]["n"])], axis=1)


def _reference(case, dtype=jnp.float32):
    n = case["n"]
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("sp",))
    shard = NamedSharding(mesh, P(None, "sp"))
    f = jax.jit(functools.partial(jax.shard_map, mesh=mesh, in_specs=P(None, "sp"), out_specs=P(None, "sp"))(
        lambda q, k, v: jax_ulysses(q, k, v, "sp", causal=case["causal"])))
    return np.asarray(f(*(jax.device_put(jnp.asarray(case[x], dtype), shard) for x in "qkv")), np.float32)


@pytest.mark.parametrize("i", range(len(DENSE)), ids=[f"n{n}-{'causal' if c else 'full'}" for n, c in DENSE])
def test_ulysses_matches_the_reference(port, i):
    np.testing.assert_allclose(_gathered(port, i), _reference(CASES[i]), rtol=2e-5, atol=2e-5)


def test_ulysses_matches_ring(port):
    i = len(DENSE)
    np.testing.assert_allclose(_gathered(port, i), _gathered(port, i + 1), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_gathered(port, i), _reference(CASES[i]), rtol=2e-5, atol=2e-5)


def test_ulysses_bf16(port):
    i = len(DENSE) + 2
    np.testing.assert_allclose(_gathered(port, i), _reference(CASES[i], jnp.bfloat16), rtol=0.05, atol=0.05)


def test_ulysses_refuses_indivisible_heads(port):
    i = len(DENSE) + 3
    for r in range(4):
        assert "divisible" in port[r][i]["error"]
    with pytest.raises(ValueError, match="divisible"):
        _reference(CASES[i])
    jax.clear_caches()
