"""The collective backend's masked, push-sum and per-leaf rounds against
the port's simulated ones, and the two backends' training under drawn
fault masks.

One spawn of 4 ``gloo`` ranks on the CPU runs every gossip case
(:func:`consensusml_tpu_torch.comm.check.gossip_cases`), each from the
same stacked inputs the simulated round takes, with the same masks:

- exact gossip with faults on the ring, bucketed (3000-byte buckets, the
  BN-style statistics beside the weights) and per-leaf, two rounds;
- push-sum on the one-peer exponential graph (its first two phases),
  masked and not, and on the dense graph masked;
- CHOCO on the per-leaf wire: the chunked top-k + int8 codec through a
  warm round and a CHOCO round, and the global top-k.

Held within rtol 1e-5, atol 1e-6 of the simulated round (the reference's
own cross-backend tolerance: the matrix product sums in another order
than the shift chain, and the second round compresses what the first
left, so the CHOCO state carries that drift too;
``tests/test_torch_faults.py`` holds a dead worker's rows to what it
had, bit for bit), the push-sum masses summing to the world size. The transport
sends ``wire_bytes_per_round`` in a steady-state round, plus 4 bytes a
flag message in masked rounds (the neighbours' flags, once a round, and
for push-sum its out-neighbours' too).

Training: ``mnist_mlp`` smoke with ``--drop-prob 0.3`` on the ring, 3
rounds, on both backends from the same init: each worker draws its
flags from its own fault generator, so both backends drop the same
workers in the same rounds (the alive masks are equal), and the losses
and consensus errors agree within the cross-backend tolerances of
``tests/test_torch_collective_engine.py``.
"""

import numpy as np
import pytest
import torch

from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import topk_int8_compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, FaultConfig, GossipConfig, PushSumState
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.utils import tree as T

WORLD = 4
RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT = 180.0
MASKS = [np.array([1, 0, 1, 1], np.float32), np.array([0, 1, 1, 0], np.float32)]


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"attn": rng.normal(size=(WORLD, 40, 37)).astype(np.float32),
                       "emb": rng.normal(size=(WORLD, 1000)).astype(np.float32),
                       "bias": rng.normal(size=(WORLD, 24)).astype(np.float32)},
            "model_state": {"batch_stats": {"mean": rng.normal(size=(WORLD, 48)).astype(np.float32)}}}


def _engine(name, topology="ring", **kw):
    return ConsensusEngine(GossipConfig(topology=topology_from_name(topology, WORLD), **kw))


CASES = {
    # name: (engine, steps, masks or None, state given or None)
    "faults_bucketed": (_engine("f", faults=FaultConfig(0.1), bucket_bytes=3000), [0, 1], MASKS),
    "faults_per_leaf": (_engine("f", faults=FaultConfig(0.1), bucket_bytes=None), [0, 1], MASKS),
    "pushsum_onepeer": (_engine("p", "onepeer-exp", push_sum=True), [0, 1], None),
    "pushsum_onepeer_masked": (_engine("p", "onepeer-exp", push_sum=True, faults=FaultConfig(0.1)), [0, 1], MASKS),
    "pushsum_dense_masked": (_engine("p", "dense", push_sum=True, faults=FaultConfig(0.1)), [0, 1], MASKS),
    "choco_topk_per_leaf": (_engine("c", compressor=topk_int8_compressor(ratio=0.1, chunk=128, impl="auto"),
                                     bucket_bytes=None, gamma=0.3, codec_warmup_rounds=1), [0, 1], None),
    "choco_global_topk": (_engine("c", compressor=topk_int8_compressor(ratio=0.1, chunk=128, impl="reference"),
                                  gamma=0.3), [0, 1], None),
}
NAMES = list(CASES)
_PORT: dict = {}


def _port():
    """Every case's collective rounds, from one spawn (cached)."""
    if not _PORT:
        cases = [(eng, _tree(i), steps, None, masks) for i, (eng, steps, masks) in enumerate(CASES.values())]
        per_rank = launch(check.gossip_cases, WORLD, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
        for i, name in enumerate(NAMES):
            _PORT[name] = [r[i] for r in per_rank]
    return _PORT


def _simulated(name):
    eng, steps, masks = CASES[name]
    tree = _tree(NAMES.index(name))
    t = T.tree_map(torch.from_numpy, tree)
    state = eng.init_state(t, world_size=WORLD)
    topo = eng.topology
    mats = simulated.phase_matrices(topo) if topo.is_time_varying else None
    for i, step in enumerate(steps):
        w = mats[step % topo.period] if mats is not None else simulated.mixing_matrix(topo)
        alive = None if masks is None else torch.from_numpy(masks[i])
        t, state = eng.round_simulated(t, state, w, step=step, alive=alive)
    return t, state


def _stack(results, fn):
    return T.tree_map(lambda *xs: np.stack(xs), *[fn(r) for r in results])


def _leaves(tree):
    return T.flatten_with_paths(tree)


@pytest.mark.parametrize("name", NAMES)
def test_collective_round_matches_simulated(name):
    eng, steps, masks = CASES[name]
    got = _port()[name]
    want_tree, want_state = _simulated(name)
    mine = _stack(got, lambda r: r["tree"])
    for (path, g), (_, w) in zip(_leaves(mine), _leaves(want_tree)):
        np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL, err_msg=str(path))
    if isinstance(want_state, PushSumState):
        w = np.stack([r["state"]["w"] for r in got]).reshape(-1)
        np.testing.assert_allclose(w, want_state.w.numpy(), rtol=RTOL, atol=ATOL)
        assert abs(float(w.astype(np.float64).sum()) - WORLD) <= 1e-5 * WORLD
    elif want_state is not None:
        for key in ("xhat", "s"):
            mine_state = [np.stack(xs) for xs in zip(*[r["state"][key] for r in got])]
            for g, w in zip(mine_state, getattr(want_state, key)):
                np.testing.assert_allclose(g, w.numpy(), rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_collective_round_sends_its_wire_bytes(name):
    """``wire_bytes_per_round`` in each steady-state round (a warm round
    ships the dense parameters besides), plus in a masked round the flags:
    4 bytes a shift (push-sum: its in- and out-neighbours'), or the alive
    count beside a dense graph's all-reduce. Every phase of the one-peer
    graph at 4 workers sends once, so its average is each round's."""
    eng, steps, masks = CASES[name]
    tree = _tree(NAMES.index(name))
    per_worker = T.tree_map(lambda v: torch.from_numpy(v[0]), tree)
    want = eng.wire_bytes_per_round(per_worker)
    topo = eng.topology
    for r in _port()[name]:
        for i, step in enumerate(steps):
            if step < eng.config.codec_warmup_rounds:
                continue
            phase = topo.phases[step % topo.period] if topo.is_time_varying else topo
            flags = 0
            if masks is not None:
                flags = 4 if phase.uses_psum else 4 * len(phase.shifts) * (2 if eng.config.push_sum_enabled else 1)
            assert r["bytes_by_round"][i] == want + flags, (name, i, r["bytes_by_round"][i], want, flags)


def _faults_spec(backend_world):
    return {"config": "mnist_mlp", "scale": "smoke", "workers": backend_world, "codec": None, "gamma": None,
            "codec_warmup": None, "norm_impl": "flax", "topology": "ring", "seed": 0, "device": "cpu",
            "dist_backend": "gloo", "rounds": 3, "log_every": 0, "drop_prob": 0.3}


def test_training_under_drawn_faults_matches_across_backends():
    spec = _faults_spec(WORLD)
    results = launch(collective.train_rank, WORLD, spec, dist_backend="gloo", timeout=SPAWN_TIMEOUT)
    bundle = configs.build("mnist_mlp", "smoke", world=WORLD, topology="ring", device="cpu")
    configs.with_gossip_flags(bundle, drop_prob=0.3)
    params, model_state = bundle.convert(bundle.init_params(0))
    state = init_stacked_state(bundle.cfg, params, WORLD, seed=0, model_state=model_state)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    dropped = 0
    for r, batch in enumerate(bundle.batches(3, 0)):
        state, m = step(state, batch)
        got = results[0]["rounds"][r]
        np.testing.assert_array_equal(np.asarray(got["alive_mask"]), m["alive_mask"].numpy())
        assert got["alive_frac"] == pytest.approx(float(m["alive_frac"]))
        assert abs(got["loss"] - float(m["loss"])) <= 1e-5 * abs(float(m["loss"])) + 1e-6
        assert abs(got["consensus_error"] - float(m["consensus_error"])) <= 1e-4 * float(m["consensus_error"])
        dropped += int((m["alive_mask"] == 0).sum())
    assert dropped > 0  # drop_prob 0.3 over 12 worker-rounds: some drop
