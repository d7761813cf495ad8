"""Overlap gossip on the port's collective backend (one ``gloo`` rank a
worker on the CPU, one spawn for the whole file): the correction's
exchange started before the local steps and finished after them
(``ConsensusEngine.correction_collective_start``), against the
reference's ``correction_collective`` under ``shard_map`` and against the
port's simulated correction; the collective train step against the
simulated one; the CLI.

- Rounds: from each worker's row of one stacked tree (weights and a
  BN-style statistic), three or four rounds of: the queued correction
  applied (``z``), the next one started on ``z``, ``z`` overwritten in
  place (``0.99 z + 0.01``, what the local steps do) while the exchange
  is in flight, the correction finished. Cases: exact mixing on the ring
  at depths 1 and 3 (depth 3 on the per-leaf wire), on the one-peer
  exponential graph (phase ``step % period``) and the dense graph (an
  all-reduce); compressed on the top-k + int8 two-step wire, the int8
  fused wire (its receive ``fused_dequantize_accumulate``'s plain
  version) and the fused wire on the dense graph.
- Against the reference (ring: exact depth 2, top-k depth 2, int8 fused
  depth 1): every round's ``z`` and the final state bit-equal on the
  exact and two-step wires; on the fused wire ``xhat`` bit-equal and the
  corrections and ``s`` within rtol 1e-5, atol 1e-6 (the reference's
  compiled receive contracts its chain in another order,
  ``tests/test_torch_collective_engine.py``).
- Against the simulated correction, round by round from the ranks' own
  inputs to the round (after a round the backends' values differ by the
  rounding of their sums, which a codec may amplify): ``z`` bit-equal,
  the new state within rtol 1e-5, atol 1e-6 (the matrix product against
  the chain of multiply-adds), ``xhat`` bit-equal; the transport's bytes
  each round equal
  ``wire_bytes_per_round`` (the dense graph's compressed round
  all-reduces the decoded f32 innovations: 4 bytes an element of its
  buckets).
- The in-flight exchange rides a process group of its own: posted, its
  send buffer overwritten, three barriers and an all-reduce on the mesh's
  group, then finished: each rank has its neighbours' values as staged.
- The train step: ``mnist_mlp`` smoke on a ring of 4 with overlap at depth
  2, three rounds against the port's simulated step from the same init:
  loss within rtol 1e-5, atol 1e-6, consensus error within 1e-4
  relative, parameters within rtol 1e-5, atol 1e-5 (the tolerances of
  ``tests/test_torch_collective_engine.py``); the metrics add
  ``gossip_issue_ms`` and ``gossip_wait_ms``.
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
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.__main__ import main
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.utils import tree as T

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
STEP_ATOL = 1e-5
SPAWN_TIMEOUT = 180.0

# name -> (topology, codec, pipeline depth, bucket_bytes, rounds)
CASES = {
    "exact_ring_d1": ("ring", None, 1, 1000, 4),
    "exact_ring_d2": ("ring", None, 2, 1000, 4),
    "exact_perleaf_d3": ("ring", None, 3, None, 4),
    "exact_onepeer_d2": ("onepeer-exp", None, 2, 1000, 4),
    "exact_dense_d1": ("dense", None, 1, 1000, 3),
    "topk_ring_d2": ("ring", "topk", 2, 1000, 4),
    "int8_ring_d1": ("ring", "int8", 1, 1000, 3),
    "int8_dense_d1": ("dense", "int8", 1, 1000, 3),
}
# the cases also held against the reference's collective correction
REFERENCE = ("exact_ring_d2", "topk_ring_d2", "int8_ring_d1")


def _engines(name):
    topo, codec, depth, bucket_bytes, _rounds = CASES[name]
    jcomp = tcomp = None
    if codec == "topk":
        jcomp, tcomp = jax_topk_int8(chunk=128, k=13, impl="interpret"), topk_int8_compressor(chunk=128, k=13,
                                                                                              impl="auto")
    elif codec == "int8":
        jcomp, tcomp = JaxInt8(chunk=128, impl="interpret"), PallasInt8Compressor(chunk=128)
    common = dict(overlap=True, pipeline_depth=depth, gamma=0.5, bucket_bytes=bucket_bytes)
    return (JaxEngine(JaxGossip(topology=jax_topology(topo, WORLD), compressor=jcomp, **common)),
            ConsensusEngine(GossipConfig(topology=topology_from_name(topo, WORLD), compressor=tcomp, **common)))


def _tree(name):
    rng = np.random.default_rng(list(CASES).index(name) + 40)
    return {"params": {"a": rng.normal(size=(WORLD, 5, 7)).astype(np.float32),
                       "b": rng.normal(size=(WORLD, 300)).astype(np.float32)},
            "model_state": {"batch_stats": {"bn.mean": rng.normal(size=(WORLD, 6)).astype(np.float32)}}}


def _spec(**kw):
    return {"config": "mnist_mlp", "scale": "smoke", "workers": WORLD, "codec": None, "gamma": None,
            "codec_warmup": None, "norm_impl": "flax", "topology": "ring", "seed": 0, "device": "cpu",
            "dist_backend": "gloo", "log_every": 0, "return_params": True, "rounds": 3, "overlap_gossip": True,
            "gossip_pipeline": 2, **kw}


_SPAWN: dict = {}


def _spawned():
    """Every case's rounds, the barrier check and the train step, from one
    spawn of WORLD ranks (cached)."""
    if not _SPAWN:
        cases = [(_engines(name)[1], _tree(name), list(range(CASES[name][4]))) for name in CASES]
        per_rank = launch(check.in_turn, WORLD, [(check.overlap_cases, (cases, "gloo", "cpu")),
                                                 (check.inflight_across_barriers, (3, "gloo", "cpu")),
                                                 (collective.train_rank, (_spec(),))],
                          timeout=SPAWN_TIMEOUT)
        _SPAWN["cases"] = {name: [r[0][i] for r in per_rank] for i, name in enumerate(CASES)}
        _SPAWN["barriers"] = [r[1] for r in per_rank]
        _SPAWN["train"] = [r[2] for r in per_rank]
    return _SPAWN


def _stack(per_rank, get):
    return T.tree_map(lambda *xs: np.stack(xs), *[get(r) for r in per_rank])


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _overlap_state(stacked):
    """A stacked numpy state as the port's ``OverlapState`` of tensors."""
    from consensusml_tpu_torch.consensus import ChocoState, OverlapState

    tensors = lambda t: T.tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), t)  # noqa: E731
    choco = stacked["choco"]
    return OverlapState(correction=tensors(stacked["correction"]),
                        pending=tuple(tensors(p) for p in stacked["pending"]),
                        choco=None if choco is None else ChocoState(xhat=tensors(choco["xhat"]),
                                                                    s=tensors(choco["s"])))


def _simulated_rounds(name, got):
    """Per round: the port's simulated ``z`` and state from the ranks' own
    inputs to that round (their previous round's ``z`` moved as they
    moved it, and their state)."""
    _jeng, teng = _engines(name)
    topo = teng.topology
    x = T.tree_map(lambda a: torch.from_numpy(a.copy()), _tree(name))
    state = teng.init_state(x, world_size=WORLD)
    out = []
    for step in range(CASES[name][4]):
        w = (simulated.phase_matrices(topo)[step % topo.period] if topo.is_time_varying
             else simulated.mixing_matrix(topo))
        z = teng.apply_correction(x, state)
        out.append((T.tree_map(lambda t: t.numpy().copy(), z), teng.correction_simulated(z, w, state)))
        x = T.tree_map(lambda a: torch.from_numpy(a).mul_(0.99).add_(0.01), _stack(got, lambda r: r["z"][step]))
        state = _overlap_state(_stack(got, lambda r: r["states"][step]))
    return out


def _reference(name):
    """The reference's collective rounds under ``shard_map``, one jitted
    round at a time with the same update between them."""
    jeng, _teng = _engines(name)
    topo = jeng.topology
    wm = JaxMesh.create(topo, platform="cpu")
    spec = P(*topo.axis_names)

    @jax.jit
    @functools.partial(_shard_map_no_check, mesh=wm.mesh, in_specs=(spec, spec, P()), out_specs=spec)
    def one_round(tree, st, step):
        tree, st = jax.tree.map(lambda v: v[0], (tree, st))
        z = jeng.apply_correction(tree, st)
        st = jeng.correction_collective(z, st, step=step)
        return jax.tree.map(lambda v: v[None], (z, st))

    put = lambda t: jax.device_put(t, wm.worker_sharding())  # noqa: E731
    x = _tree(name)
    state = jax.tree.map(np.asarray, jeng.init_state(jax.tree.map(lambda a: a[0], x)))
    state = jax.tree.map(lambda a: np.stack([a] * WORLD), state)
    zs = []
    for step in range(CASES[name][4]):
        z, state = jax.tree.map(np.asarray, one_round(put(x), put(state), jnp.int32(step)))
        zs.append(z)
        x = jax.tree.map(lambda v: v * np.float32(0.99) + np.float32(0.01), z)
    return zs, state


def _port_state_leaves(got):
    """The ranks' final OverlapState, stacked, in the reference's leaf
    order (correction, choco, pending)."""
    st = _stack(got, lambda r: r["state"])
    return T.leaves(st["correction"]) + ([] if st["choco"] is None else T.leaves(st["choco"]["xhat"]) +
                                         T.leaves(st["choco"]["s"])) + T.leaves(st["pending"])


@pytest.mark.parametrize("name", REFERENCE)
def test_collective_correction_matches_reference(name):
    got = _spawned()["cases"][name]
    want_z, want_state = _reference(name)
    fused = CASES[name][1] == "int8"
    for r, wz in enumerate(want_z):
        for g, w in zip(T.leaves(_stack(got, lambda res: res["z"][r])), jax.tree.leaves(wz)):
            if fused:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{name} z round {r}")
            else:
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{name} z round {r}")
    mine, want = _port_state_leaves(got), jax.tree.leaves(want_state)
    assert len(mine) == len(want)
    st = _stack(got, lambda res: res["state"])
    n_hat = 0 if st["choco"] is None else len(st["choco"]["xhat"])
    n_corr = len(T.leaves(st["correction"]))
    for i, (g, w) in enumerate(zip(mine, want)):
        if not fused or n_corr <= i < n_corr + n_hat:  # xhat: the encode, bit-equal
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{name} state leaf {i}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{name} state leaf {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_collective_correction_matches_simulated_and_wire_bytes(name):
    got = _spawned()["cases"][name]
    for step, (want_z, want) in enumerate(_simulated_rounds(name, got)):
        for g, w in zip(T.leaves(_stack(got, lambda r: r["z"][step])), T.leaves(want_z)):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{name} z round {step}")
        st = _stack(got, lambda r: r["states"][step])
        assert len(st["pending"]) == CASES[name][2] - 1
        for g, w in zip(T.leaves(st["correction"]) + T.leaves(st["pending"]),
                        T.leaves(want.correction) + T.leaves(want.pending)):
            np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{name} round {step}")
        if want.choco is not None:
            for g, w in zip(st["choco"]["xhat"], want.choco.xhat):
                np.testing.assert_array_equal(_bits(g), _bits(w.numpy()), err_msg=f"{name} xhat round {step}")
            for g, w in zip(st["choco"]["s"], want.choco.s):
                np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL, err_msg=f"{name} s round {step}")
    _jeng, teng = _engines(name)
    per_worker = T.tree_map(lambda a: torch.from_numpy(a[0]), _tree(name))
    expect = teng.wire_bytes_per_round(per_worker)
    if teng.compressed and teng.topology.uses_psum:
        # the decoded f32 innovations of every bucket, and the BN leaf, all-reduced
        expect = 4 * sum(b.total for b in teng.bucket_plan(per_worker).buckets) + 4 * 6
    for res in got:
        assert res["bytes_by_round"] == [expect] * CASES[name][4], (name, res["bytes_by_round"], expect)


def test_inflight_exchange_rides_its_own_group():
    for rank, res in enumerate(_spawned()["barriers"]):
        assert res["received"] == [float((rank - 1) % WORLD), float((rank + 1) % WORLD)]
        assert res["uniform"] and res["mean"] == [1.5] * 3


def test_collective_overlap_step_matches_simulated():
    got = _spawned()["train"]
    spec = _spec()
    bundle = configs.build("mnist_mlp", "smoke", world=WORLD, topology="ring", device="cpu")
    configs.with_gossip_flags(bundle, overlap=True, pipeline=2)
    params, model_state = bundle.convert(bundle.init_params(0))
    state = init_stacked_state(bundle.cfg, params, WORLD, model_state=model_state)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    for r, batch in enumerate(bundle.batches(spec["rounds"], 0)):
        state, m = step(state, batch)
        losses = {g["rounds"][r]["loss"] for g in got}
        errs = {g["rounds"][r]["consensus_error"] for g in got}
        assert len(losses) == len(errs) == 1, "every rank gets the all-reduced values"
        assert losses.pop() == pytest.approx(float(m["loss"]), rel=RTOL, abs=ATOL)
        assert errs.pop() == pytest.approx(float(m["consensus_error"]), rel=1e-4)
        for g in got:
            rd = g["rounds"][r]
            assert rd["gossip_wait_ms"] >= 0 and rd["gossip_issue_ms"] >= 0
            assert rd["gossip_ms"] == pytest.approx(rd["gossip_issue_ms"] + rd["gossip_wait_ms"])
            assert rd["wire_bytes"] == g["wire_bytes_per_round"]
    for name, p in state.params.items():
        np.testing.assert_allclose(np.stack([g["params"][name] for g in got]), p.numpy(), rtol=RTOL,
                                   atol=STEP_ATOL, err_msg=name)


def test_cli_collective_overlap(capfd):
    argv = ["--device", "cpu", "--config", "mnist_mlp", "--rounds", "2", "--backend", "collective", "--workers", "4",
            "--topology", "ring", "--overlap-gossip", "--gossip-pipeline", "2"]
    assert main(argv) == 0
    out = capfd.readouterr().out  # rank 0 prints from its own process
    assert "overlap gossip (pipeline depth 2)" in out
    assert len([line for line in out.splitlines() if line.startswith("round ")]) == 2
