"""``GossipConfig.fused_codec`` (one codec call over the whole compressed
tree laid end to end) against the JAX package's ``_ravel_tree``,
``init_state`` and rounds.

- The boundary: ``_ravel`` lays the leaves out in flatten order as the
  reference's ``_ravel_tree``, ``(n,)`` a worker or ``(W, n)`` stacked,
  bit for bit, and gives them back; ``init_state`` holds the CHOCO state
  as that one vector, ``(n,)`` or ``(W, n // W)``, zero.
- The simulated round, four rounds from a seeded nonzero state on a tree
  with a BN-style ``model_state`` leaf (mixed exactly, not raveled):
  the config's chunked top-k + int8 (JAX ``impl="interpret"``) through a
  warm-up round, CHOCO rounds and a dense refresh, and the int8 codec (its
  two-step calls: ``fused_wire`` "auto" stays off on this path). Bit for
  bit: the parameters, ``xhat`` and ``s``.
- The collective round (4 ``gloo`` ranks, one spawn) from the same
  inputs: against the reference's ``round_collective`` under
  ``shard_map`` bit for bit (ring, top-k), and against the port's
  simulated round within rtol 1e-5, atol 1e-6 (a matrix product against
  a chain of multiply-adds), ``xhat`` bit-equal, on the ring and the
  dense graph; the transport's bytes are ``wire_bytes_per_round`` (one
  payload over the tree), which equals the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu.analysis.jaxpr_contracts import _shard_map_no_check
from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import simulated as jsim
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.consensus.engine import _ravel_tree
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
from consensusml_tpu_torch.consensus import ChocoState, ConsensusEngine, GossipConfig
from consensusml_tpu_torch.consensus.engine import _ravel
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.utils import tree as T

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT = 120.0


def _engines(codec, topo="ring", **kw):
    if codec == "topk":
        jcomp, tcomp = jax_topk_int8(chunk=128, k=13, impl="interpret"), topk_int8_compressor(chunk=128, k=13,
                                                                                              impl="auto")
    else:
        jcomp, tcomp = JaxInt8(chunk=128, impl="interpret"), PallasInt8Compressor(chunk=128)
    common = dict(fused_codec=True, gamma=0.5, **kw)
    return (JaxEngine(JaxGossip(topology=jax_topology(topo, WORLD), compressor=jcomp, **common)),
            ConsensusEngine(GossipConfig(topology=topology_from_name(topo, WORLD), compressor=tcomp, **common)))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"a": rng.normal(size=(WORLD, 5, 7)).astype(np.float32),
                       "b": rng.normal(size=(WORLD, 300)).astype(np.float32),
                       "c": rng.normal(size=(WORLD, 129)).astype(np.float32)},
            "model_state": {"batch_stats": {"bn.mean": rng.normal(size=(WORLD, 6)).astype(np.float32)}}}


def _port(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _seeded_state(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 0.5, size=(WORLD, n)).astype(np.float32) for _ in range(2)]


N = 5 * 7 + 300 + 129  # the compressed leaves' elements a worker (the BN leaf mixes exactly)


@pytest.mark.parametrize("stacked", [False, True])
def test_ravel_and_init_state_match_reference(stacked):
    params = _tree(1)["params"]
    if not stacked:
        params = jax.tree.map(lambda a: a[0], params)
    want, unravel = _ravel_tree(params, stacked=stacked)
    leaves = T.leaves(_port(params))
    got, tunravel = _ravel(leaves, stacked)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert got.shape == ((WORLD, N) if stacked else (N,))
    for g, w in zip(tunravel(got), jax.tree.leaves(unravel(want))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jeng, teng = _engines("topk")
    tree = _tree(2) if stacked else jax.tree.map(lambda a: a[0], _tree(2))
    world = WORLD if stacked else None
    jstate, tstate = jeng.init_state(tree, world_size=world), teng.init_state(_port(tree), world_size=world)
    assert len(tstate.xhat) == len(tstate.s) == 1
    for g, w in ((tstate.xhat[0], jstate.xhat), (tstate.s[0], jstate.s)):
        assert tuple(g.shape) == tuple(np.shape(w)) == ((WORLD, N) if stacked else (N,))
        assert g.dtype == torch.float32 and not g.any()


# name -> (codec, topology, engine kwargs, round counters)
SIM_CASES = {
    "topk_warm_refresh": ("topk", "ring", {"codec_warmup_rounds": 1, "codec_refresh_every": 3}, [0, 1, 2, 3]),
    "int8": ("int8", "ring", {}, [0, 1, 2]),
}


@pytest.mark.parametrize("name", list(SIM_CASES))
def test_simulated_round_matches_reference(name):
    codec, topo, kw, steps = SIM_CASES[name]
    jeng, teng = _engines(codec, topo, **kw)
    assert not teng.bucketed and not teng.fused_wire_active and not jeng.fused_wire_active
    tree = _tree(3)
    xhat, s = _seeded_state(N, 4)
    jstate = type(jeng.init_state(tree, world_size=WORLD))(xhat=jnp.asarray(xhat), s=jnp.asarray(s))
    tstate = ChocoState(xhat=[torch.from_numpy(xhat.copy())], s=[torch.from_numpy(s.copy())])
    w = jsim.mixing_matrix(jeng.topology)
    jround = jax.jit(lambda t, st, step: jeng.round_simulated(t, st, w, step=step))
    jt, tt = tree, _port(tree)
    for step in steps:
        jt, jstate = jround(jt, jstate, jnp.int32(step))
        tt, tstate = teng.round_simulated(tt, tstate, simulated.mixing_matrix(teng.topology), step=step)
        for i, (g, wnt) in enumerate(zip(T.leaves((tt, tstate.xhat, tstate.s)),
                                         jax.tree.leaves((jt, [jstate.xhat], [jstate.s])))):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(wnt), err_msg=f"{name} round {step} leaf {i}")


COLL_CASES = {"topk_ring": ("topk", "ring"), "int8_ring": ("int8", "ring"), "topk_dense": ("topk", "dense")}
_PORT: dict = {}


def _collective(name):
    """Every case's collective round (step 1) from the same seeded inputs,
    in one spawn of WORLD ranks (cached)."""
    if not _PORT:
        cases = []
        for i, case in enumerate(COLL_CASES):
            xhat, s = _seeded_state(N, 10 + i)
            cases.append((_engines(*COLL_CASES[case])[1], _tree(10 + i), [1], {"xhat": [xhat], "s": [s]}))
        per_rank = launch(check.gossip_cases, WORLD, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
        _PORT.update({case: [r[i] for r in per_rank] for i, case in enumerate(COLL_CASES)})
    return _PORT[name]


@pytest.mark.parametrize("name", list(COLL_CASES))
def test_collective_round_matches_simulated_and_wire_bytes(name):
    got = _collective(name)
    i = list(COLL_CASES).index(name)
    jeng, teng = _engines(*COLL_CASES[name])
    xhat, s = _seeded_state(N, 10 + i)
    want, st = teng.round_simulated(_port(_tree(10 + i)), ChocoState(xhat=[torch.from_numpy(xhat)],
                                                                     s=[torch.from_numpy(s)]),
                                    simulated.mixing_matrix(teng.topology), step=1)
    mine = T.tree_map(lambda *xs: np.stack(xs), *[r["tree"] for r in got])
    for g, w in zip(T.leaves(mine), T.leaves(want)):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(_bits(np.stack([r["state"]["xhat"][0] for r in got])), _bits(st.xhat[0].numpy()))
    np.testing.assert_allclose(np.stack([r["state"]["s"][0] for r in got]), st.s[0].numpy(), rtol=RTOL, atol=ATOL)
    per_worker = jax.tree.map(lambda a: a[0], _tree(10 + i))
    expect = teng.wire_bytes_per_round(_port(per_worker))
    assert expect == jeng.wire_bytes_per_round(per_worker)
    if teng.topology.uses_psum:
        expect = 4 * N + 4 * 6  # the decoded f32 innovation and the BN leaf, all-reduced
    assert {r["bytes_by_round"][0] for r in got} == {expect}


def test_collective_round_matches_reference():
    """``topk_ring``: the reference's ``round_collective`` under
    ``shard_map`` from the same inputs, bit for bit."""
    got = _collective("topk_ring")
    jeng, _teng = _engines(*COLL_CASES["topk_ring"])
    topo = jeng.topology
    wm = JaxMesh.create(topo, platform="cpu")
    spec = P(*topo.axis_names)

    @jax.jit
    @functools.partial(_shard_map_no_check, mesh=wm.mesh, in_specs=(spec, spec, spec), out_specs=spec)
    def one_round(tree, xhat, s):
        tree = jax.tree.map(lambda v: v[0], tree)
        st = type(jeng.init_state(tree))(xhat=xhat[0], s=s[0])
        tree, st = jeng.round_collective(tree, st, step=jnp.int32(1))
        return jax.tree.map(lambda v: v[None], (tree, st.xhat, st.s))

    put = lambda t: jax.device_put(t, wm.worker_sharding())  # noqa: E731
    xhat, s = _seeded_state(N, 10)
    want = jax.tree.map(np.asarray, one_round(put(_tree(10)), put(xhat), put(s)))
    mine = (T.tree_map(lambda *xs: np.stack(xs), *[r["tree"] for r in got]),
            np.stack([r["state"]["xhat"][0] for r in got]), np.stack([r["state"]["s"][0] for r in got]))
    for g, w in zip(T.leaves(mine[0]) + [mine[1], mine[2]], jax.tree.leaves(want[0]) + [want[1], want[2]]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
