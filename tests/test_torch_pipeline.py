"""GPipe pipelining: the port's ``parallel.pipeline_apply`` on ``gloo``
ranks of the CPU against the reference's on the host mesh (the
reference's cases): the forward at (P, M) = (2, 4), (4, 8), (8, 8), to
the port's own sequential stack at the reference's 1e-5 / 1e-6 and to
the reference's pipeline at 1e-5 (two frameworks' f32 products); the
gradients of the last stage's loss at P = 4 to 1e-4 (the backward is the
hops' own autograd functions); 80 plain gradient steps
that fit a random mapping; and the refusal of a stage that changes the
activation's shape."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from consensusml_tpu.parallel import pipeline_apply as jax_pipeline, pipeline_last_stage_mean as jax_last
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.parallel.check import run_cases

FORWARD = [(2, 4), (4, 8), (8, 8)]


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _cases():
    cases = []
    for p, m in FORWARD:
        cases.append(dict(kind="pipeline_fwd", n=p, w=_normal((0, p), (8, 16, 16), 0.5),
                          mb=_normal((1, p), (m, 4, 16))))
    cases.append(dict(kind="pipeline_grad", n=4, w=_normal(10, (8, 8, 8), 0.5), mb=_normal(11, (8, 2, 8)),
                      tgt=_normal(12, (8, 2, 8))))
    cases.append(dict(kind="pipeline_train", n=4, w=_normal(20, (4, 8, 8), 0.3), mb=_normal(21, (8, 4, 8)),
                      tgt=np.tanh(_normal(22, (8, 4, 8))), steps=80, lr=0.3))
    cases.append(dict(kind="pipeline_bad", n=2, w=_normal(30, (2, 4, 4)), mb=_normal(31, (2, 1, 4))))
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def port():
    return launch(run_cases, 8, CASES, "cpu", timeout=600)


def _stage_fn(stage_params, x):
    y, _ = jax.lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, stage_params)
    return y


def _sequential(all_w, mb):
    return jax.vmap(lambda x: _stage_fn(all_w, x))(mb)


def _mesh(p):
    return Mesh(np.array(jax.devices("cpu")[:p]), ("pp",))


@pytest.mark.parametrize("i", range(len(FORWARD)), ids=[f"p{p}-m{m}" for p, m in FORWARD])
def test_pipeline_forward_matches_the_reference(port, i):
    case = CASES[i]
    mesh = _mesh(case["n"])
    f = jax.jit(functools.partial(jax.shard_map, mesh=mesh, in_specs=(P("pp"), P()), out_specs=P())(
        lambda w, mb: jax_last(jax_pipeline(_stage_fn, w, mb, "pp"), "pp")))
    want = np.asarray(f(jax.device_put(jnp.asarray(case["w"]), NamedSharding(mesh, P("pp"))), jnp.asarray(case["mb"])))
    seq = torch.from_numpy(case["mb"])
    for w in torch.from_numpy(case["w"]):
        seq = torch.tanh(seq @ w)
    for r in range(case["n"]):  # the last stage's outputs, on every stage
        np.testing.assert_allclose(port[r][i]["out"], seq.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port[r][i]["out"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(want, np.asarray(_sequential(case["w"], case["mb"])), rtol=1e-5, atol=1e-6)


def test_pipeline_gradients_match_the_reference(port):
    i = len(FORWARD)
    case = CASES[i]
    mesh = _mesh(4)

    def pp_grad(w):
        def loss(w):
            return jax_last(jnp.mean((jax_pipeline(_stage_fn, w, case["mb"], "pp") - case["tgt"]) ** 2), "pp")

        return jax.grad(loss)(w)

    f = jax.jit(functools.partial(jax.shard_map, mesh=mesh, in_specs=P("pp"), out_specs=P("pp"))(pp_grad))
    want = np.asarray(f(jax.device_put(jnp.asarray(case["w"]), NamedSharding(mesh, P("pp")))))
    got = np.concatenate([port[r][i]["grad"] for r in range(4)], axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_pipeline_trains(port):
    losses = port[3][len(FORWARD) + 1]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.75, (losses[0], losses[-1])
    assert port[0][len(FORWARD) + 1]["losses"] == losses  # every stage reads the last stage's loss


def test_pipeline_refuses_a_shape_changing_stage(port):
    i = len(FORWARD) + 2
    for r in range(2):
        assert "preserve the activation shape" in port[r][i]["error"]
    jax.clear_caches()
