"""The port's topology layer against the JAX package's, bit for bit.

Every family of ``topology_from_name`` (ring, torus squarest and with
``rows``/``cols``, dense, exp, onepeer-exp, hierarchical with several
``slices``/``outer_every``), at every world from 1 to 16, is built from the
same spec on both sides: the port's topology must be the reference's
(mixing matrix or phase matrices and effective matrix as float64 arrays,
edges, neighbours, shifts, spectral gap, ``symmetric``, ``uses_psum``,
``is_time_varying``, the period), or both must refuse the world with the
same error. ``rederive`` is held the same way at every new world. The
simulated backend's per-phase matrices, the alive-masked consensus error
and worker mean, and the engine's wire accounting (``_sends_per_round``:
one send for dense, the period's average for a time-varying graph) are
held against the reference too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.comm import simulated as jax_simulated
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress.reference import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossipConfig
from consensusml_tpu.topology import rederive as jax_rederive
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.utils.tree import consensus_mean as jax_consensus_mean
from consensusml_tpu.utils.tree import masked_worker_mean as jax_masked_worker_mean
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.topology import rederive, topology_from_name
from consensusml_tpu_torch.utils.tree import consensus_mean, masked_worker_mean

WORLDS = range(1, 17)
SPECS = [
    "ring", "torus", "torus:rows=2", "torus:cols=2", "torus:rows=3", "dense", "exp", "exponential",
    "onepeer-exp", "one-peer-exp", "hierarchical:slices=1", "hierarchical:slices=2",
    "hierarchical:slices=2,outer_every=2", "hierarchical:slices=4,outer_every=3", "hier:slices=2,outer_every=1",
    "ring-of-rings:slices=3,outer_every=5",
]


def _parse(spec):
    name, _, argstr = spec.partition(":")
    return name, dict((kv.split("=")[0], int(kv.split("=")[1])) for kv in argstr.split(",") if kv)


def _build(fn, spec, world):
    name, kwargs = _parse(spec)
    try:
        return fn(name, world, **kwargs), None
    except (ValueError, NotImplementedError) as e:
        return None, (type(e), str(e))


def _assert_same(got, want):
    """Every observable of the port's topology equals the reference's."""
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.mesh_shape, got.axis_names, got.world_size) == (
        want.name, want.mesh_shape, want.axis_names, want.world_size)
    assert (got.is_time_varying, got.uses_psum, got.symmetric) == (
        want.is_time_varying, want.uses_psum, want.symmetric)
    assert got.spectral_gap() == want.spectral_gap()
    assert got.edges() == want.edges()
    if want.is_time_varying:
        assert got.period == want.period
        np.testing.assert_array_equal(got.phase_matrices(), want.phase_matrices())
        np.testing.assert_array_equal(got.effective_matrix(), want.effective_matrix())
        with pytest.raises(ValueError) as w:
            want.mixing_matrix()
        with pytest.raises(ValueError) as g:
            got.mixing_matrix()
        assert str(g.value) == str(w.value)
        for gp, wp in zip(got.phases, want.phases):
            _assert_same(gp, wp)
        w32 = simulated.phase_matrices(got).numpy()
        np.testing.assert_array_equal(w32, np.asarray(jax_simulated.phase_matrices(want)))
        return
    np.testing.assert_array_equal(got.mixing_matrix(), want.mixing_matrix())
    assert [(s.axis, s.offset, s.weight) for s in got.shifts] == [
        (s.axis, s.offset, s.weight) for s in want.shifts]
    assert got.self_weight == want.self_weight
    assert all(got.neighbors(r) == want.neighbors(r) for r in range(want.world_size))
    np.testing.assert_array_equal(simulated.mixing_matrix(got).numpy(), np.asarray(jax_simulated.mixing_matrix(want)))


@pytest.mark.parametrize("world", range(1, 9))
def test_ring_matches_reference(world):
    got, want = topology_from_name("ring", world), jax_topology("ring", world)
    np.testing.assert_array_equal(got.mixing_matrix(), want.mixing_matrix())
    assert got.spectral_gap() == want.spectral_gap()
    assert [(s.axis, s.offset, s.weight) for s in got.shifts] == [
        (s.axis, s.offset, s.weight) for s in want.shifts
    ]
    assert got.self_weight == want.self_weight
    assert all(got.neighbors(r) == want.neighbors(r) for r in range(world))
    assert got.symmetric and got.world_size == world
    w32 = simulated.mixing_matrix(got).numpy()
    assert w32.dtype == np.float32
    np.testing.assert_array_equal(w32, want.mixing_matrix().astype(np.float32))


@pytest.mark.parametrize("spec", SPECS)
def test_family_matches_reference_at_every_world(spec):
    """Worlds 1-16: the same topology, or the same refusal."""
    hosted = 0
    for world in WORLDS:
        (got, gerr), (want, werr) = _build(topology_from_name, spec, world), _build(jax_topology, spec, world)
        assert gerr == werr, (spec, world)
        if want is not None:
            _assert_same(got, want)
            hosted += 1
    assert hosted > 0


@pytest.mark.parametrize("spec", SPECS)
def test_rederive_matches_reference(spec):
    """Each hosted topology rebuilt at every other world of 1-16: the same
    family at the new size, or the same refusal."""
    for world in (4, 6, 8, 12):
        got, _ = _build(topology_from_name, spec, world)
        want, _ = _build(jax_topology, spec, world)
        if want is None:
            continue
        for new in WORLDS:
            try:
                w_new, werr = jax_rederive(want, new), None
            except ValueError as e:
                w_new, werr = None, str(e)
            try:
                g_new, gerr = rederive(got, new), None
            except ValueError as e:
                g_new, gerr = None, str(e)
            assert gerr == werr, (spec, world, new)
            if w_new is not None:
                _assert_same(g_new, w_new)


@pytest.mark.parametrize("name,world,kwargs", [
    ("ring", 4, {"k": 1}),
    ("dense", 4, {"rows": 2}),
    ("no-such-graph", 4, {}),
    ("ring", 0, {}),
    ("torus", 6, {"rows": 4}),
    ("torus", 6, {"cols": 4}),
    ("torus", 6, {"rows": 2, "cols": 2}),
    ("torus", 4, {"depth": 2}),
    ("hierarchical", 4, {}),
    ("hierarchical", 4, {"slices": 0}),
    ("hierarchical", 6, {"slices": 4}),
    ("hierarchical", 4, {"slices": 2, "outer_every": 0}),
    ("hierarchical", 4, {"slices": 2, "outer_every": 1}),
    ("hierarchical", 4, {"slices": 2, "inner": 2}),
])
def test_topology_from_name_errors_match_reference(name, world, kwargs):
    with pytest.raises(ValueError) as want:
        jax_topology(name, world, **kwargs)
    with pytest.raises(ValueError) as got:
        topology_from_name(name, world, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,world", [("hierarchical:slices", 4), ("torus:rows=x", 4), ("hier:slices=3", 4)])
def test_cli_topology_spec_errors(spec, world):
    """``configs.topology_from_spec`` parses ``--topology`` as ``train.py``
    does and raises what it catches (``IndexError`` or ``ValueError``)."""
    with pytest.raises((IndexError, ValueError)):
        configs.topology_from_spec(spec, world)


def test_onepeer_exp_reaches_exact_consensus_in_one_period():
    """The reference's finite-time guarantee at n = 2^tau: one period of
    one-peer phases is exactly ``11^T / n`` (f64), and through the
    simulated backend's f32 phases the disagreement falls to f32 rounding."""
    for n in (2, 4, 8, 16):
        topo = topology_from_name("onepeer-exp", n)
        np.testing.assert_allclose(topo.effective_matrix(), np.full((n, n), 1.0 / n), rtol=0, atol=1e-15)
        x = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 33)).astype(np.float32))
        e0 = simulated.consensus_error_stacked({"x": x}, n)
        for w in simulated.phase_matrices(topo):
            x = simulated.mix_stacked(x, w)
        assert simulated.consensus_error_stacked({"x": x}, n) <= 1e-6 * e0


@pytest.mark.parametrize("alive", [[1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 0], [0, 0, 0, 0]])
def test_masked_consensus_error_and_worker_mean_match_reference(alive):
    """f32 accumulation, the ``max(sum(alive), 1)`` guard (the everyone-dead
    row gives 0, not NaN), the consensus mean with and without a mask."""
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(size=(4, 3, 5)).astype(np.float32), "b": {"c": rng.normal(size=(4, 7)).astype(np.float32)}}
    a = np.asarray(alive, np.float32)
    want = float(jax_simulated.consensus_error_masked(tree, jnp.asarray(a)))
    tt = {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    got = float(simulated.consensus_error_masked(tt, torch.from_numpy(a)))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-6, abs=0)
    for leaf, tleaf in ((tree["a"], tt["a"]), (tree["b"]["c"], tt["b"]["c"])):
        np.testing.assert_allclose(masked_worker_mean(tleaf, a).numpy(),
                                   np.asarray(jax_masked_worker_mean(leaf, jnp.asarray(a))), rtol=1e-6, atol=1e-7)
    for mask in (None, a):
        w = jax_consensus_mean(tree, None if mask is None else jnp.asarray(mask))
        g = consensus_mean(tt, mask)
        np.testing.assert_allclose(g["a"].numpy(), np.asarray(w["a"]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g["b"]["c"].numpy(), np.asarray(w["b"]["c"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("spec", ["ring", "dense", "onepeer-exp", "hierarchical:slices=2,outer_every=3", "torus", "exp"])
@pytest.mark.parametrize("codec", [None, "int8", "topk_int8"])
def test_wire_bytes_per_round_match_reference(spec, codec):
    """Bytes one worker sends a steady-state round, exact and CHOCO (the
    fused int8 wire, top-k + int8 on the two-step wire), over 8 workers:
    one payload per shift, one for dense, the period's average for a
    time-varying graph."""
    shapes = {"w": (300, 64), "b": (64,), "h": {"k": (1000,)}}
    tree_np = {"w": np.zeros(shapes["w"], np.float32), "b": np.zeros(64, np.float32),
               "h": {"k": np.zeros(1000, np.float32)}}
    jtree = {"w": jnp.zeros(shapes["w"]), "b": jnp.zeros(64), "h": {"k": jnp.zeros(1000)}}
    ttree = {"w": torch.from_numpy(tree_np["w"]), "b": torch.from_numpy(tree_np["b"]),
             "h": {"k": torch.from_numpy(tree_np["h"]["k"])}}
    jcomp = {None: None, "int8": lambda: JaxInt8(chunk=128, impl="interpret"),
             "topk_int8": lambda: jax_topk_int8(ratio=0.1, chunk=128, impl="interpret")}[codec]
    tcomp = {None: None, "int8": lambda: PallasInt8Compressor(chunk=128),
             "topk_int8": lambda: topk_int8_compressor(ratio=0.1, chunk=128, impl="auto")}[codec]
    name, kwargs = _parse(spec)
    want_engine = JaxEngine(JaxGossipConfig(topology=jax_topology(name, 8, **kwargs),
                                            compressor=jcomp() if jcomp else None))
    got_engine = ConsensusEngine(GossipConfig(topology=topology_from_name(name, 8, **kwargs),
                                              compressor=tcomp() if tcomp else None))
    assert got_engine._sends_per_round() == want_engine._sends_per_round()
    assert got_engine.wire_bytes_per_round(ttree) == want_engine.wire_bytes_per_round(jtree)
