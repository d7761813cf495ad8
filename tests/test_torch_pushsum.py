"""Push-sum (``consensusml_tpu_torch/consensus/pushsum.py``) against the
JAX package's ``consensus/pushsum.py``.

- ``pushsum_matrix``: bit-equal over ring, torus, exponential, dense and
  one-peer phases at 4, 8 and 16 workers, for random masks and the
  all-alive and all-dead ones; its columns sum to 1.
- The simulated round (``pushsum_round_simulated``, and the engine's
  round with and without a ``path_filter``), on the one-peer exponential
  graph and the exponential graph, with and without masks: the mass
  ``C' @ w`` is a matrix-vector product that XLA's CPU dot sums in eight
  lanes of multiply-adds folded pairwise from 8 workers up, and PyTorch's
  ``mv`` in another order, so the mass and the de-biased parameters are
  held within 2 ulps (the numerator ``C' @ (z w)`` is bit-equal at these
  widths, as ``tests/test_torch_perleaf.py`` says).
- The collective round: the port's 8 ``gloo`` ranks (one spawn) against
  the reference's ``round_collective`` under ``shard_map``, every
  one-peer phase, the exponential graph, the ring and the torus, with and
  without masks: bit-equal, but for the masked 2 x 4 torus (both shifts
  of its 2-row axis reach one peer, and XLA merges their identical terms
  and contracts around them): within 2**-21 of the largest value. The
  port mirrors the compiled program: the masked mass mix ``keep x + sum_s (w_s a_s) x_s`` as ``keep x`` then one
  multiply-add a shift, and, where every weight equals the self-weight
  and is a power of two (the one-peer graphs' halves), XLA's factoring
  ``(z w + x_1) / 2`` with ``z w + x_1`` one multiply-add. The dense
  graph's all-reduce sums in another order: within the rounding of an
  8-term sum.
- Mass conservation: over rounds with masks, ``sum_i w_i = n`` and ``sum_i
  w_i z_i`` of every leaf stay what they were, to 1e-5 relative.
- Training: ``mnist_mlp`` smoke on ``onepeer-exp --push-sum``, 10 rounds
  with given masks and a NaN batch in round 4, against the reference's
  ``external_alive`` step: loss and consensus error to rtol 1e-5, the
  alive mask equal.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import simulated as jsim
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import FaultConfig as JaxFaults
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.consensus import PushSumState as JaxPushSumState
from consensusml_tpu.consensus.pushsum import pushsum_matrix as jax_pushsum_matrix
from consensusml_tpu.consensus.pushsum import pushsum_round_simulated as jax_round_simulated
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.consensus import (
    ConsensusEngine,
    FaultConfig,
    GossipConfig,
    PushSumState,
    pushsum_matrix,
    pushsum_round_simulated,
)
from consensusml_tpu_torch.topology import topology_from_name
from test_torch_faults import _assert_curves, _bits, _masks, _matrices, fault_curves

SPAWN_TIMEOUT = 120.0


def _ulps(got, want):
    return np.abs(_bits(got).astype(np.int64) - _bits(want).astype(np.int64)).max()


@pytest.mark.parametrize("world", [4, 8, 16])
@pytest.mark.parametrize("name", ["ring", "torus", "exp", "dense", "onepeer-exp"])
def test_pushsum_matrix_bit_equal(name, world):
    fn = jax.jit(jax_pushsum_matrix)
    for m in _matrices(name, world):
        for alive in _masks(world, world + 1):
            want = np.asarray(fn(jnp.asarray(m), jnp.asarray(alive)))
            got = pushsum_matrix(torch.from_numpy(m), torch.from_numpy(alive)).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(want))
            np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-6)  # column-stochastic
    m = torch.from_numpy(_matrices(name, world)[0])
    assert pushsum_matrix(m, None) is m


WORLD = 8


def _stacked_tree(seed, world=WORLD):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(world, 5, 7)).astype(np.float32),
            "b": {"c": rng.normal(size=(world, 300)).astype(np.float32)}}


def _torch_tree(tree):
    return {"a": torch.from_numpy(tree["a"].copy()), "b": {"c": torch.from_numpy(tree["b"]["c"].copy())}}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["onepeer-exp", "exp"])
def test_simulated_round_within_two_ulps(name, masked):
    jt = jax_topology(name, WORLD)
    mats = _matrices(name, WORLD)
    rng = np.random.default_rng(5)
    tree = _stacked_tree(1)
    w = (rng.random(WORLD) + 0.5).astype(np.float32)
    jtree, jw = jax.tree.map(jnp.asarray, tree), jnp.asarray(w)
    ttree, tw = _torch_tree(tree), torch.from_numpy(w.copy())
    fn = jax.jit(lambda t, w, c, a: jax_round_simulated(t, JaxPushSumState(w=w), c, a))
    for r in range(2 * len(mats)):
        alive = (rng.random(WORLD) > 0.3).astype(np.float32) if masked else None
        c = mats[r % len(mats)]
        jtree, jstate = fn(jtree, jw, jnp.asarray(c), None if alive is None else jnp.asarray(alive))
        jw = jstate.w
        ttree, tstate = pushsum_round_simulated(ttree, PushSumState(w=tw), torch.from_numpy(c),
                                                None if alive is None else torch.from_numpy(alive))
        tw = tstate.w
        assert _ulps(tw.numpy(), np.asarray(jw)) <= 2, r
        for got, want in ((ttree["a"], jtree["a"]), (ttree["b"]["c"], jtree["b"]["c"])):
            assert _ulps(got.numpy(), np.asarray(want)) <= 2, r
            # carry the reference's values on, so each round is held alone
        ttree, tw = _torch_tree(jax.tree.map(np.asarray, jtree)), torch.from_numpy(np.array(jw))
    assert jt.is_time_varying == (name == "onepeer-exp")


@pytest.mark.parametrize("path_filter", [False, True])
def test_engine_simulated_round_with_path_filter(path_filter):
    """The engine's push-sum round: the selected leaves (``b`` only, with a
    filter) mix with the mass; the others pass through as they were."""
    jflt = (lambda p: p[0].key == "b") if path_filter else None
    tflt = (lambda p: p[0] == "b") if path_filter else None
    jeng = JaxEngine(JaxGossip(topology=jax_topology("onepeer-exp", WORLD), push_sum=True, path_filter=jflt))
    teng = ConsensusEngine(GossipConfig(topology=topology_from_name("onepeer-exp", WORLD), push_sum=True,
                                        path_filter=tflt))
    assert not teng.bucketed and teng.bucket_plan({"a": torch.zeros(3)}) is None
    tree = _stacked_tree(2)
    jstate = jeng.init_state(tree, world_size=WORLD)
    tstate = teng.init_state(_torch_tree(tree), world_size=WORLD)
    np.testing.assert_array_equal(tstate.w.numpy(), np.asarray(jstate.w))
    alive = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    phases = jsim.phase_matrices(jeng.topology)
    tphases = simulated.phase_matrices(teng.topology)
    jtree, jstate = jax.jit(lambda t, s, a: jeng.round_simulated(t, s, phases[1], a))(tree, jstate, alive)
    ttree, tstate = teng.round_simulated(_torch_tree(tree), tstate, tphases[1], alive=torch.from_numpy(alive))
    assert _ulps(tstate.w.numpy(), np.asarray(jstate.w)) <= 2
    assert _ulps(ttree["b"]["c"].numpy(), np.asarray(jtree["b"]["c"])) <= 2
    if path_filter:
        np.testing.assert_array_equal(ttree["a"].numpy(), tree["a"])
    assert _ulps(ttree["a"].numpy(), np.asarray(jtree["a"])) <= 2


def test_mass_is_conserved_under_masks():
    """Column stochasticity: ``sum w`` and ``sum w z`` are kept by every
    round, whatever the mask, on a directed graph."""
    teng = ConsensusEngine(GossipConfig(topology=topology_from_name("onepeer-exp", WORLD), push_sum=True,
                                        faults=FaultConfig(0.2)))
    tree = _torch_tree(_stacked_tree(3))
    state = teng.init_state(tree, world_size=WORLD)
    mats = simulated.phase_matrices(teng.topology)
    rng = np.random.default_rng(9)
    def mass(t, w):
        return [(w.reshape(-1, *[1] * (x.dim() - 1)) * x).double().sum(0) for x in (t["a"], t["b"]["c"])]

    before = mass(tree, state.w)
    for r in range(9):
        alive = torch.from_numpy((rng.random(WORLD) > 0.3).astype(np.float32))
        tree, state = teng.round_simulated(tree, state, mats[r % 3], alive=alive)
        assert abs(float(state.w.double().sum()) - WORLD) <= 1e-5 * WORLD
        for b, a in zip(before, mass(tree, state.w)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
    assert float(state.w.min()) < 1.0 < float(state.w.max())  # the masses really moved


# ---- the collective round against the reference's --------------------------

COLL = ["onepeer-exp:0", "onepeer-exp:1", "onepeer-exp:2", "exp", "ring", "torus", "dense"]


def _coll(name, pkg):
    family, _, phase = name.partition(":")
    mk = jax_topology if pkg == "jax" else topology_from_name
    topo = mk(family, WORLD)
    step = int(phase) if phase else 0
    return topo, step


def _coll_inputs(name, masked):
    rng = np.random.default_rng(COLL.index(name) + 20 + masked)
    tree = _stacked_tree(COLL.index(name) + 30)
    w = (rng.random(WORLD) + 0.5).astype(np.float32)
    alive = (rng.random(WORLD) > 0.35).astype(np.float32)
    alive[COLL.index(name)] = 0.0
    return tree, w, (alive if masked else None)


_PORT: dict = {}


def _port_rounds():
    """Every case's port round, from one spawn of 8 gloo ranks (cached)."""
    if not _PORT:
        cases, keys = [], []
        for name in COLL:
            for masked in (False, True):
                topo, step = _coll(name, "port")
                eng = ConsensusEngine(GossipConfig(topology=topo, push_sum=True, faults=FaultConfig(0.1)))
                tree, w, alive = _coll_inputs(name, masked)
                cases.append((eng, tree, [step], {"w": w}, None if alive is None else [alive]))
                keys.append((name, masked))
        per_rank = launch(check.gossip_cases, WORLD, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
        for i, key in enumerate(keys):
            _PORT[key] = [r[i] for r in per_rank]
    return _PORT


def _jax_round(name, masked):
    jt, step = _coll(name, "jax")
    jeng = JaxEngine(JaxGossip(topology=jt, push_sum=True, faults=JaxFaults(0.1)))
    tree, w, alive = _coll_inputs(name, masked)
    wm = JaxMesh.create(jt, platform="cpu")
    spec = P(*jt.axis_names)
    lead = (1,) * len(jt.mesh_shape)

    def fn(a, c, w, flag):
        out, st = jeng.round_collective({"a": a.reshape(a.shape[len(lead):]), "b": {"c": c.reshape(-1)}},
                                        JaxPushSumState(w=w.reshape(())),
                                        None if alive is None else flag.reshape(()), step=jnp.int32(step))
        return out["a"].reshape(lead + out["a"].shape), out["b"]["c"].reshape(lead + (-1,)), st.w.reshape(lead)

    run = jax.jit(jax.shard_map(fn, mesh=wm.mesh, in_specs=(spec,) * 4, out_specs=spec))
    flags = np.ones(WORLD, np.float32) if alive is None else alive
    to_mesh = lambda x: jax.device_put(jnp.asarray(x).reshape(*jt.mesh_shape, *x.shape[1:]),  # noqa: E731
                                       wm.worker_sharding())
    out = run(to_mesh(tree["a"]), to_mesh(tree["b"]["c"]), to_mesh(w), to_mesh(flags))
    return [np.asarray(o).reshape(WORLD, *o.shape[len(lead):]) for o in out]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", COLL)
def test_collective_round_matches_reference(name, masked):
    got = _port_rounds()[(name, masked)]
    want_a, want_c, want_w = _jax_round(name, masked)
    mine_a = np.stack([r["tree"]["a"] for r in got])
    mine_c = np.stack([r["tree"]["b"]["c"] for r in got])
    mine_w = np.stack([r["state"]["w"] for r in got]).reshape(-1)
    if name == "dense":
        # all-reduce means: an 8-term f32 sum in another order
        for mine, want in ((mine_a, want_a), (mine_c, want_c), (mine_w, want_w)):
            np.testing.assert_allclose(mine, want, rtol=8 * 2.0**-23, atol=1e-6)
        return
    np.testing.assert_array_equal(_bits(mine_w), _bits(want_w))
    if name == "torus" and masked:
        # the 2 x 4 torus sends both shifts of its 2-row axis to one peer:
        # XLA merges the two identical terms of the masked chain and
        # contracts the rest around them in an order the port does not
        # mirror; a few elements (of 280 and 2400) differ in the last bits
        for mine, want in ((mine_a, want_a), (mine_c, want_c)):
            np.testing.assert_allclose(mine, want, rtol=0, atol=2.0**-21 * np.abs(want).max())
        return
    np.testing.assert_array_equal(_bits(mine_a), _bits(want_a))
    np.testing.assert_array_equal(_bits(mine_c), _bits(want_c))
    if masked:
        _tree, w, alive = _coll_inputs(name, masked)
        np.testing.assert_array_equal(mine_w[alive == 0], w[alive == 0])  # a dead worker keeps its mass


# ---- training ----------------------------------------------------------------

def test_mnist_pushsum_curve_matches_reference():
    got, want, _snaps = fault_curves("onepeer-exp", push_sum=True)
    _assert_curves(got, want)
    assert got[-1][0] < got[0][0]
