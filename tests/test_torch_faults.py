"""Fault-tolerant gossip (``consensusml_tpu_torch/consensus/faults.py``,
the masked collectives, the engine's masked round, the trainer's
rollback) against the JAX package.

- ``masked_mixing_matrix``: bit-equal to the reference's over ring,
  torus, exponential, dense and one-peer phases at 4, 8 and 16 workers,
  for random masks and the all-alive and all-dead ones.
- ``collectives.mix_masked`` and ``mix_buckets`` with a flag: the port's
  ``gloo`` ranks on the CPU (one spawn of 8) against the reference's
  ``mix_masked`` / ``mix_buckets`` under ``shard_map`` on the 8 virtual
  CPU devices, in f32 and bf16: bit-equal on shift topologies (a 0/1
  flag makes each bracket exactly the neighbour's value or the worker's
  own, and the chain then contracts as the reference's f32 chain), the
  dense masked mean within the rounding of an n-term sum in another
  order (gloo and XLA sum the ranks differently).
- The engine's masked round on the simulated backend, bucketed (3000-byte
  buckets) and per-leaf, on ring, torus and exponential graphs: bit-equal
  (the leaf widths keep XLA's CPU dot in index order, as
  ``tests/test_torch_perleaf.py`` says).
- The refusals: every ``GossipConfig`` combination of faults, push-sum,
  compressors, overlap, gossip steps and the fused wire that the
  reference refuses, the port refuses with the same exception type, and
  what it takes the port takes (``push_sum_enabled`` equal).
- Training: ``mnist_mlp`` smoke on a ring, 10 rounds with given alive
  masks and a NaN batch for worker 1 in round 4, against the reference's
  ``external_alive`` step from its init: loss and consensus error to
  rtol 1e-5 (the f32 drift of ``tests/test_torch_mnist.py``'s curves over
  10 rounds; in the NaN round both report a NaN loss, the reference's
  ``sum(keep * losses)`` taking 0 x NaN), the alive mask equal (worker 1 dead in round 4 however its
  flag was given), every parameter finite after the NaN round and
  worker 1's rows rolled back to their values before it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import collectives as jcoll
from consensusml_tpu.comm import simulated as jsim
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import FaultConfig as JaxFaults
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.consensus.faults import masked_mixing_matrix as jax_masked
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import PallasInt8Compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, FaultConfig, GossipConfig, masked_mixing_matrix
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

SPAWN_TIMEOUT = 120.0


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _matrices(name, world):
    topo = jax_topology(name, world)
    if topo.is_time_varying:
        return list(np.asarray(topo.phase_matrices(), np.float32))
    return [np.asarray(topo.mixing_matrix(), np.float32)]


def _masks(world, seed):
    rng = np.random.default_rng(seed)
    return [np.ones(world, np.float32), np.zeros(world, np.float32),
            *[(rng.random(world) > 0.3).astype(np.float32) for _ in range(4)]]


@pytest.mark.parametrize("world", [4, 8, 16])
@pytest.mark.parametrize("name", ["ring", "torus", "exp", "dense", "onepeer-exp"])
def test_masked_mixing_matrix_bit_equal(name, world):
    fn = jax.jit(jax_masked)
    for m in _matrices(name, world):
        for alive in _masks(world, world):
            want = np.asarray(fn(jnp.asarray(m), jnp.asarray(alive)))
            got = masked_mixing_matrix(torch.from_numpy(m), torch.from_numpy(alive)).numpy()
            np.testing.assert_array_equal(_bits(got), _bits(want))
            # rows stay stochastic (dead workers' are e_i); on a symmetric
            # graph the columns too, so the mean is kept
            np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-6)
            if jax_topology(name, world).symmetric:
                np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-6)


# ---- the collectives, against the reference's under shard_map --------------

COLL = ["ring", "torus", "exp", "dense", "onepeer-exp:0", "onepeer-exp:1", "onepeer-exp:2"]
WORLD_C = 8


def _coll_topo(name, pkg):
    family, _, phase = name.partition(":")
    topo = (jax_topology if pkg == "jax" else topology_from_name)(family, WORLD_C)
    return topo.phases[int(phase)] if phase else topo


def _coll_inputs(name):
    rng = np.random.default_rng(COLL.index(name) + 10)
    alive = (rng.random(WORLD_C) > 0.35).astype(np.float32)
    alive[COLL.index(name) % WORLD_C] = 0.0  # at least one dead worker
    return {
        "f32": rng.normal(size=(WORLD_C, 5, 7)).astype(np.float32),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(WORLD_C, 64)), jnp.bfloat16).astype(jnp.float32)),
        "buckets": [rng.normal(size=(WORLD_C, n)).astype(np.float32) for n in (33, 20)],
        "alive": alive,
    }


_PORT: dict = {}


def _port_masked():
    """Every case's port results, from one spawn of 8 gloo ranks (cached)."""
    if not _PORT:
        cases = []
        for name in COLL:
            x, topo = _coll_inputs(name), _coll_topo(name, "port")
            cases += [(topo, x["f32"], "float32", x["alive"]), (topo, x["bf16"], "bfloat16", x["alive"]),
                      (topo, x["buckets"], "float32", x["alive"])]
        per_rank = launch(check.masked_ops, WORLD_C, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
        for i, name in enumerate(COLL):
            _PORT[name] = [[r[3 * i + j] for r in per_rank] for j in range(3)]
    return _PORT


def _shard(topo, fn, *xs):
    wm = JaxMesh.create(topo, platform="cpu")
    spec = P(*topo.axis_names)
    to_mesh = lambda x: x.reshape(*topo.mesh_shape, *x.shape[1:])  # noqa: E731
    run = jax.jit(jax.shard_map(fn, mesh=wm.mesh, in_specs=(spec,) * len(xs), out_specs=spec))
    out = run(*[jax.device_put(to_mesh(jnp.asarray(x)), wm.worker_sharding()) for x in xs])
    return jax.tree.map(lambda o: np.asarray(o).reshape(topo.world_size, *o.shape[len(topo.mesh_shape):]), out)


def _flag(a):
    return a.reshape(())


def _dense_bound(x, alive):
    """Per-element bound of the masked dense mean, summed in another order."""
    n = x.shape[0]
    return (n + 1) * 2.0**-23 * (np.abs(x).sum(0) / n + np.abs(x))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", COLL)
def test_mix_masked_matches_reference(name, dtype):
    jt = _coll_topo(name, "jax")
    x = _coll_inputs(name)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    alive = x["alive"].reshape((WORLD_C,) + (1,) * (x[dtype].ndim - 1))
    want = _shard(jt, lambda b, a: jcoll.mix_masked(b, jt, _flag(a.reshape(-1)[:1])).astype(jnp.float32),
                  x[dtype].astype(jdtype), np.broadcast_to(alive, x[dtype].shape).copy())
    got = np.stack([r["mix_masked"] for r in _port_masked()[name][0 if dtype == "f32" else 1]])
    dead = x["alive"] == 0
    np.testing.assert_array_equal(got[dead], x[dtype][dead])  # a dead worker keeps its value
    if not jt.uses_psum:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    elif dtype == "f32":
        assert np.all(np.abs(got - want) <= _dense_bound(x[dtype], x["alive"]))
    else:
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("name", COLL)
def test_mix_buckets_with_flag_matches_reference(name):
    """Two buffers in one exchange, the flags exchanged once."""
    jt = _coll_topo(name, "jax")
    x = _coll_inputs(name)
    a, b = x["buckets"]
    alive = np.broadcast_to(x["alive"][:, None], a.shape).copy()
    want = _shard(jt, lambda p, q, f: tuple(jcoll.mix_buckets([p, q], jt, _flag(f.reshape(-1)[:1]))), a, b, alive)
    got = _port_masked()[name][2]
    for i, w in enumerate(want):
        mine = np.stack([r["mix_buckets"][i] for r in got])
        if jt.uses_psum:
            assert np.all(np.abs(mine - w) <= _dense_bound(x["buckets"][i], x["alive"]))
        else:
            np.testing.assert_array_equal(_bits(mine), _bits(w))


# ---- the engine's masked round (simulated) ----------------------------------

WORLD = 4
SHAPES = {"attn": (40, 37), "emb": (1000,), "conv": (3, 300), "bias": (24,)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=(WORLD,) + s).astype(np.float32) for k, s in SHAPES.items()}
    stats = {"mean": rng.normal(size=(WORLD, 48)).astype(np.float32)}
    return params, stats


@pytest.mark.parametrize("bucket_bytes", [3000, None])
@pytest.mark.parametrize("name", ["ring", "torus", "exp"])
def test_masked_engine_round_bit_equal(name, bucket_bytes):
    """Three rounds, each under its own mask (one with every worker dead
    but one), the statistics gossiped beside the weights."""
    jeng = JaxEngine(JaxGossip(topology=jax_topology(name, WORLD), faults=JaxFaults(0.1), bucket_bytes=bucket_bytes))
    teng = ConsensusEngine(GossipConfig(topology=topology_from_name(name, WORLD), faults=FaultConfig(0.1),
                                        bucket_bytes=bucket_bytes))
    params, stats = _tree(3)
    jtree = {"params": params, "model_state": {"batch_stats": stats}}
    ttree = {"params": {k: torch.from_numpy(v) for k, v in params.items()},
             "model_state": {"batch_stats": {k: torch.from_numpy(v) for k, v in stats.items()}}}
    jw, tw = jsim.mixing_matrix(jeng.topology), simulated.mixing_matrix(teng.topology)
    jround = jax.jit(lambda t, a: jeng.round_simulated(t, None, jw, a))
    masks = [np.array([1, 0, 1, 1], np.float32), np.array([0, 0, 1, 0], np.float32),
             np.array([1, 1, 0, 1], np.float32)]
    for alive in masks:
        before = {k: v.clone() for k, v in ttree["params"].items()}
        jtree, _ = jround(jtree, jnp.asarray(alive))
        ttree, state = teng.round_simulated(ttree, None, tw, alive=torch.from_numpy(alive))
        assert state is None
        for k, got in ttree["params"].items():
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(jtree["params"][k])), err_msg=k)
            np.testing.assert_array_equal(got[alive == 0].numpy(), before[k][alive == 0].numpy())
        np.testing.assert_array_equal(_bits(ttree["model_state"]["batch_stats"]["mean"].numpy()),
                                      _bits(np.asarray(jtree["model_state"]["batch_stats"]["mean"])))


# ---- the refusals -----------------------------------------------------------

def _refusal_cases():
    f = 0.1
    return [
        dict(faults=f), dict(faults=f, topology="onepeer-exp"), dict(faults=f, topology="onepeer-exp", push_sum=True),
        dict(faults=f, topology="onepeer-exp", push_sum="auto"), dict(faults=f, push_sum="auto"),
        dict(push_sum=True), dict(push_sum="auto"), dict(push_sum="yes"), dict(push_sum=True, topology="onepeer-exp"),
        dict(faults=f, codec=True), dict(push_sum=True, codec=True), dict(push_sum="auto", codec=True, faults=f),
        dict(push_sum="auto", codec=True), dict(faults=f, topology="dense"), dict(faults=f, topology="torus"),
        dict(push_sum=True, gossip_steps=2), dict(push_sum="auto", gossip_steps=2, faults=f, topology="onepeer-exp"),
        dict(faults=f, gossip_steps=2), dict(push_sum=True, bucket_bytes=None),
        dict(codec=True, fused_wire=True, bucket_bytes=None), dict(codec=True, fused_wire=True, push_sum=True),
        dict(codec=True, bucket_bytes=None), dict(bucket_bytes=0), dict(bucket_bytes=-1),
        dict(overlap=True, faults=f), dict(overlap=True, push_sum=True), dict(codec=True, codec_refresh_every=-1),
        dict(faults=f, codec_warmup_rounds=1),
    ]


def _build(pkg, kw):
    kw = dict(kw)
    topo = (jax_topology if pkg == "jax" else topology_from_name)(kw.pop("topology", "ring"), WORLD)
    faults = kw.pop("faults", None)
    codec = kw.pop("codec", False)
    if faults is not None:
        kw["faults"] = (JaxFaults if pkg == "jax" else FaultConfig)(faults)
    if codec:
        kw["compressor"] = JaxInt8(chunk=128, impl="interpret") if pkg == "jax" else PallasInt8Compressor(chunk=128)
    cls = JaxGossip if pkg == "jax" else GossipConfig
    return cls(topology=topo, **kw)


@pytest.mark.parametrize("case", range(len(_refusal_cases())))
def test_refusals_match_reference(case):
    kw = _refusal_cases()[case]
    outcome = {}
    for pkg in ("jax", "port"):
        try:
            cfg = _build(pkg, kw)
            outcome[pkg] = ("ok", cfg.push_sum_enabled)
        except (ValueError, NotImplementedError) as e:
            outcome[pkg] = (type(e).__name__, None)
    assert outcome["port"] == outcome["jax"], (kw, outcome)


def test_fault_config_bounds():
    for p in (-0.1, 1.0, 1.5):
        with pytest.raises(ValueError):
            JaxFaults(p)
        with pytest.raises(ValueError):
            FaultConfig(p)
    assert FaultConfig(0.0).detect_nonfinite and FaultConfig(0.99).drop_prob == 0.99


# ---- training: given masks and a NaN batch ---------------------------------

ROUNDS, NAN_ROUND, NAN_WORKER = 10, 4, 1


def _fault_masks():
    rng = np.random.default_rng(7)
    masks = (rng.random((ROUNDS, 4)) > 0.25).astype(np.float32)
    masks[NAN_ROUND, NAN_WORKER] = 1.0  # alive by its flag: the finite check must kill it
    return masks


def _nan_batches(batches):
    out = []
    for r, b in enumerate(batches):
        b = {k: np.array(v) for k, v in b.items()}
        if r == NAN_ROUND:
            b["image"][NAN_WORKER] = np.nan
        out.append(b)
    return out


def fault_curves(spec, push_sum=False, rounds=ROUNDS):
    """The reference's ``external_alive`` step and the port's ``alive=``
    step on ``mnist_mlp`` smoke over ``spec``, from the reference's init,
    under :func:`_fault_masks` and with a NaN batch for worker 1 in round
    4. Returns per round ``(loss, consensus error, alive mask)`` of each
    side, and the port's parameters before and after the NaN round."""
    bundle = jax_configs.build("mnist_mlp", "smoke")
    gossip = dataclasses.replace(bundle.cfg.gossip, topology=jax_topology(spec, bundle.world_size),
                                 push_sum=push_sum, faults=JaxFaults(0.0))
    cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(0), bundle.world_size)
    init = {"params": jax.tree.map(np.asarray, state.params)}
    step = jax_train_step(cfg, bundle.loss_fn, external_alive=True)
    masks = _fault_masks()
    batches = _nan_batches(list(bundle.batches(rounds, 0)))
    want = []
    zeros = jnp.zeros((bundle.world_size,), jnp.float32)
    for r, batch in enumerate(batches):
        state, m = step(state, batch, jnp.asarray(masks[r]), zeros)
        want.append((float(m["loss"]), float(m["consensus_error"]), np.asarray(m["alive_mask"])))
    port = configs.build("mnist_mlp", "smoke", topology=spec, device="cpu")
    port.cfg = dataclasses.replace(port.cfg, gossip=dataclasses.replace(
        port.cfg.gossip, push_sum=push_sum, faults=FaultConfig(0.0)))
    params, model_state = port.convert(init)
    pstate = init_stacked_state(port.cfg, params, port.world_size, model_state=model_state)
    pstep = make_simulated_train_step(port.cfg, port.loss_fn)
    got, snaps = [], {}
    for r, batch in enumerate(batches):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if r == NAN_ROUND:
            snaps["before"] = {k: v.clone() for k, v in pstate.params.items()}
        pstate, m = pstep(pstate, batch, alive=torch.from_numpy(masks[r]))
        if r == NAN_ROUND:
            snaps["after"] = {k: v.clone() for k, v in pstate.params.items()}
            snaps["gossip"] = pstate.gossip
        got.append((float(m["loss"]), float(m["consensus_error"]), m["alive_mask"].numpy()))
    return got, want, snaps


def _assert_curves(got, want):
    for r, ((gl, ge, ga), (wl, we, wa)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(ga, wa, err_msg=f"round {r}")
        if np.isnan(wl):
            assert np.isnan(gl), (r, gl)
        else:
            assert abs(gl - wl) <= 1e-5 * abs(wl), (r, got[r], want[r])
        assert abs(ge - we) <= 1e-5 * we, (r, got[r], want[r])


def test_mnist_faults_curve_matches_reference():
    got, want, snaps = fault_curves("ring")
    _assert_curves(got, want)
    # the reference's kept mean is sum(keep * losses): worker 1's NaN loss
    # times 0 is NaN, so both report NaN for the NaN round and a finite
    # loss again the round after
    assert np.isnan(want[NAN_ROUND][0]) and np.isfinite(got[NAN_ROUND + 1][0])
    assert got[NAN_ROUND][2][NAN_WORKER] == 0.0
    # the NaN never left worker 1: every row finite, and worker 1 (dead)
    # keeps the rows it held before the round
    for k, v in snaps["after"].items():
        assert torch.isfinite(v).all(), k
        torch.testing.assert_close(v[NAN_WORKER], snaps["before"][k][NAN_WORKER], rtol=0, atol=0)
    assert got[-1][0] < got[0][0]
