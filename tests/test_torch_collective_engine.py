"""The port's collective gossip round and collective train step
(``ConsensusEngine.round_collective``, ``make_collective_train_step``)
against the JAX package's ``round_collective`` under ``shard_map`` on the
virtual CPU devices, and against the port's own simulated backend.

The port's side spawns one ``gloo`` rank a worker on the CPU; each takes
its row of the same stacked numpy inputs. Each reference round runs
jitted under ``shard_map``, one round at a time, and the port runs that
round from the reference's input to it (all rounds in one spawn), so
every round is held on its own. The cases (GPT-2 smoke's parameter tree,
4 workers, buckets capped at 3000 bytes so that the tree spans many, a
seeded nonzero CHOCO state):

- exact bucketed gossip of the weights and BN-style statistics
  (``model_state``), on the ring and on the time-varying one-peer
  exponential graph (period 2);
- the fused int8 wire (JAX: its Pallas kernels in interpret mode, the
  kernel path's layout) through a warm-up round, CHOCO rounds and a dense
  refresh round, and on the one-peer graph; its receive is
  ``decode_accumulate`` (``fused_dequantize_accumulate``'s plain version);
- the top-k + int8 two-step wire (``impl="interpret"``) through a warm-up
  round and CHOCO rounds with ``gossip_steps=2``, and on the dense graph
  (an all-reduce mean of the decoded innovations); its receive is the
  chunked top-k's ``decompress_accumulate`` (``chunk_scatter``'s
  accumulating form).

Held against the reference's round: bit-equal on the exact and two-step
wires (the port mirrors the compiled program's contractions); on the
fused wire ``xhat'`` bit-equal and ``s`` within rtol 1e-5, atol 1e-6 (see
the test); on the dense graph the same (an all-reduce's order). Against
the port's simulated round from the same inputs: within rtol 1e-5, atol
1e-6 (the reference's own cross-backend tolerance, the matrix product
summing in another order), ``xhat'`` bit-equal (the same encode on the
same rows); and the transport's bytes equal ``wire_bytes_per_round``,
with the additions the test names.

The train step: ``mnist_mlp`` smoke on a ring of 4 against the
reference's ``make_collective_train_step`` for 3 rounds (loss to 1e-6,
consensus error to 1e-4 relative, the tolerances of
``tests/test_torch_mnist.py``); ``gpt2_topk`` smoke on its own codec and
on ``--codec int8``, and ``cifar_resnet50`` smoke (exact gossip with its
BN statistics, 8 workers), against the port's simulated step for 2 rounds:
loss within rtol 1e-5, atol 1e-6, consensus error within 1e-4 relative,
the final parameters within rtol 1e-5, atol 1e-5 (both sides run the same
kernels' plain versions on the same rows; only the gossip's sums differ
in order, and training carries an ulp on).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.analysis.jaxpr_contracts import _shard_map_no_check
from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress.reference import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train.local_sgd import make_collective_train_step as jax_collective_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
from consensusml_tpu_torch.consensus import ChocoState, ConsensusEngine, GossipConfig
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.utils import tree as T

WORLD = 4
SMOKE = dict(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32, dropout=0.0)
RTOL, ATOL = 1e-5, 1e-6
LOSS_ATOL, ERR_RTOL = 1e-6, 1e-4
# the train step's parameters after two rounds: the first gossip round
# differs from the simulated one by an ulp here and there (another sum
# order), and a round of training carries that into the parameters, up to
# 1.4e-6 absolute in the ResNet's BN biases (values ~1e-4)
STEP_ATOL = 1e-5
SPAWN_TIMEOUT = 120.0


def _codecs(codec):
    if codec is None:
        return None, None
    if codec == "int8":
        return JaxInt8(chunk=128, impl="interpret"), PallasInt8Compressor(chunk=128)
    return jax_topk_int8(chunk=128, k=13, impl="interpret"), topk_int8_compressor(chunk=128, k=13, impl="auto")


# name -> (topology, codec, engine kwargs, round counters)
CASES = {
    "exact_ring": ("ring", None, {}, [0, 1]),
    # round 0 warm-up, 1 CHOCO, 2 a dense refresh, 3 CHOCO
    "int8_warm_refresh": ("ring", "int8", {"codec_warmup_rounds": 1, "codec_refresh_every": 2}, [0, 1, 2, 3]),
    # round 0 warm-up, then CHOCO; two exchanges a round
    "topk_warm_steps2": ("ring", "topk_int8", {"codec_warmup_rounds": 1, "gossip_steps": 2}, [0, 1, 2]),
    "int8_onepeer": ("onepeer-exp", "int8", {}, [0, 1, 2]),
    "exact_onepeer": ("onepeer-exp", None, {}, [0, 1, 2]),
    "topk_dense": ("dense", "topk_int8", {}, [0, 1]),
}
ROUNDS = [(name, i) for name in CASES for i in range(len(CASES[name][3]))]


def _engines(name):
    topo, codec, kwargs, _steps = CASES[name]
    jcomp, tcomp = _codecs(codec)
    common = dict(gamma=0.5, bucket_bytes=3000, **kwargs)
    return (JaxEngine(JaxGossip(topology=jax_topology(topo, WORLD), compressor=jcomp, **common)),
            ConsensusEngine(GossipConfig(topology=topology_from_name(topo, WORLD), compressor=tcomp, **common)))


def _flax_shapes():
    model = JaxGPT2LM(config=JaxGPT2Config(**SMOKE))
    return jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _inputs(name):
    """The stacked gossiped tree (JAX's nested layout) and, for a codec,
    a seeded stacked per-bucket CHOCO state (a mid-run state: nonzero)."""
    _topo, codec, _kw, _steps = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    params = jax.tree.map(lambda s: rng.normal(0.0, 0.5, size=(WORLD,) + s.shape).astype(np.float32),
                          _flax_shapes())
    tree = {"params": params, "model_state": {}}
    if codec is None:
        tree["model_state"] = {"batch_stats": {"bn": {
            "mean": rng.normal(size=(WORLD, 24)).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, size=(WORLD, 24)).astype(np.float32)}}}
        return tree, None
    _jeng, teng = _engines(name)
    zero = teng.init_state(_port_tree(tree, torch.from_numpy), world_size=WORLD)
    state = ([rng.normal(0.0, 0.5, size=tuple(b.shape)).astype(np.float32) for b in zero.xhat],
             [rng.normal(0.0, 0.5, size=tuple(b.shape)).astype(np.float32) for b in zero.s])
    return tree, state


def _port_tree(tree, leaf=lambda a: a):
    """JAX's nested gossiped tree in the port's layout (flat flax-path keys)."""
    conv = lambda d: {k: leaf(np.asarray(v)) for k, v in gpt2_from_flax(d).items()}  # noqa: E731
    ms = tree["model_state"]
    return {"params": conv(tree["params"]),
            "model_state": {"batch_stats": conv(ms["batch_stats"])} if ms else {}}


_JAX: dict = {}


def _jax_rounds(name):
    """The reference's collective rounds under ``shard_map``, one jitted
    round at a time: per round ``(tree, state, step)`` before it and
    ``(tree, state)`` after it, stacked numpy (cached)."""
    if name in _JAX:
        return _JAX[name]
    jeng, _teng = _engines(name)
    topo = jeng.topology
    wm = JaxMesh.create(topo, platform="cpu")
    spec = P(*topo.axis_names)

    @jax.jit
    @functools.partial(_shard_map_no_check, mesh=wm.mesh, in_specs=(spec, spec, P()), out_specs=spec)
    def one_round(tree, st, step):
        # each worker sees its slice with a leading axis of one
        tree = jax.tree.map(lambda x: x[0], tree)
        if st is not None:
            st = type(jeng.init_state(tree))(xhat=[x[0] for x in st[0]], s=[x[0] for x in st[1]])
        tree, st = jeng.round_collective(tree, st, step=step)
        return jax.tree.map(lambda x: x[None], (tree, None if st is None else (list(st.xhat), list(st.s))))

    put = lambda t: jax.device_put(t, wm.worker_sharding())  # noqa: E731
    tree, state = _inputs(name)
    rounds = []
    for step in CASES[name][3]:
        out_tree, out_state = one_round(put(tree), None if state is None else put(state), jnp.int32(step))
        out_tree, out_state = jax.tree.map(np.asarray, (out_tree, out_state))
        rounds.append(((tree, state, step), (out_tree, out_state)))
        tree, state = out_tree, out_state
    _JAX[name] = rounds
    return rounds


_PORT: dict = {}


def _port_results():
    """Every reference round's port counterpart, from the reference's
    input to that round, in one spawn of WORLD ranks."""
    if not _PORT:
        cases = []
        for name, i in ROUNDS:
            _jeng, teng = _engines(name)
            (tree, state, step), _out = _jax_rounds(name)[i]
            st = None if state is None else {"xhat": list(state[0]), "s": list(state[1])}
            cases.append((teng, _port_tree(tree), [step], st))
        results = launch(check.gossip_cases, WORLD, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
        _PORT.update({key: [r[j] for r in results] for j, key in enumerate(ROUNDS)})
    return _PORT


def _stack(per_rank, get):
    return T.tree_map(lambda *xs: np.stack(xs), *[get(r) for r in per_rank])


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_leaves(got, want, bit_equal, what):
    for (path, g), (_q, w) in zip(T.flatten_with_paths(got), T.flatten_with_paths(want)):
        if bit_equal:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=f"{what} {path}")


@pytest.mark.parametrize("name,index", ROUNDS)
def test_collective_round_matches_reference(name, index):
    """Bit-equal on the exact and two-step wires. On the fused wire
    ``xhat'`` (the encode) is bit-equal and ``s`` (and the parameters it
    moves) within rtol 1e-5, atol 1e-6: the reference's compiled
    collective program contracts the receive's chain as ``fma(w_1, d_1,
    w_0 d_0)``, where its standalone kernel, which the port's kernel and
    plain version match bit for bit, computes ``fma(w_0, d_0, w_1 d_1)``.
    On the dense graph the means are all-reduces that ``gloo`` and XLA sum
    in different orders: the same tolerance, ``xhat'`` bit-equal."""
    got = _port_results()[(name, index)]
    _inp, (want_tree, want_state) = _jax_rounds(name)[index]
    fused = CASES[name][1] == "int8"
    dense = CASES[name][0] == "dense"
    exact = not fused and not dense
    _assert_leaves(_stack(got, lambda r: r["tree"]), _port_tree(want_tree), exact, "tree")
    if want_state is not None:
        xhat, s = _stack(got, lambda r: r["state"]["xhat"]), _stack(got, lambda r: r["state"]["s"])
        assert len(xhat) == len(want_state[0]) > 1
        _assert_leaves(xhat, list(want_state[0]), True, "xhat")
        _assert_leaves(s, list(want_state[1]), exact, "s")
    assert len({r["consensus_error"] for r in got}) == 1, "every rank gets the all-reduced value"


@pytest.mark.parametrize("name,index", ROUNDS)
def test_collective_round_matches_simulated_and_its_wire_bytes(name, index):
    """One round from the same inputs: within rtol 1e-5, atol 1e-6 of the
    port's simulated round, ``xhat'`` bit-equal; the transport's bytes are
    the engine's ``wire_bytes_per_round`` (a time-varying topology's is
    the period's average, so this phase's own sends are counted) except
    where the reference's model leaves out what its round ships: a warm-up
    or refresh round adds the dense mixing, and the dense topology's CHOCO
    round all-reduces the DECODED f32 innovations (4 bytes an element of
    the buckets) where the model counts one codec payload."""
    _jeng, teng = _engines(name)
    (tree, state, step), _out = _jax_rounds(name)[index]
    got = _port_results()[(name, index)]
    ttree = _port_tree(tree, torch.from_numpy)
    st = None if state is None else ChocoState(xhat=[torch.from_numpy(a) for a in state[0]],
                                               s=[torch.from_numpy(a) for a in state[1]])
    topo = teng.topology
    w = simulated.phase_matrices(topo)[step % topo.period] if topo.is_time_varying else simulated.mixing_matrix(topo)
    want, st = teng.round_simulated(ttree, st, w, step=step)
    _assert_leaves(_stack(got, lambda r: r["tree"]), T.tree_map(lambda t: t.numpy(), want), False, "tree")
    if st is not None:
        _assert_leaves(_stack(got, lambda r: r["state"]["xhat"]), [b.numpy() for b in st.xhat], True, "xhat")
        _assert_leaves(_stack(got, lambda r: r["state"]["s"]), [b.numpy() for b in st.s], False, "s")
    cfg = teng.config
    per_worker = T.tree_map(lambda t: t[0], ttree)
    phase = topo.phases[step % topo.period] if topo.is_time_varying else topo
    sends = 1 if phase.uses_psum else len(phase.shifts)
    dense_bytes = 4 * sum(b.total for b in teng.bucket_plan(per_worker).buckets)
    # one exchange's payload on this phase, as the engine's model counts it
    exchange = teng.wire_bytes_per_round(per_worker) / (teng._sends_per_round() * cfg.gossip_steps) * sends
    if cfg.compressor is not None and phase.uses_psum:
        exchange = dense_bytes
    dense_round = step < cfg.codec_warmup_rounds or (cfg.codec_refresh_every and step % cfg.codec_refresh_every == 0)
    # a warm-up or refresh round: one innovation exchange, then gossip_steps dense mixes
    expect = exchange + dense_bytes * sends * cfg.gossip_steps if dense_round else exchange * cfg.gossip_steps
    assert {r["bytes_by_round"][0] for r in got} == {expect}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _spec(config, scale="smoke", **kw):
    return {"config": config, "scale": scale, "workers": None, "codec": None, "gamma": None, "codec_warmup": None,
            "norm_impl": "flax", "topology": None, "seed": 0, "device": "cpu", "dist_backend": "gloo",
            "log_every": 1, "return_params": True, **kw}


def test_mnist_collective_step_matches_reference():
    """``mnist_mlp`` smoke on a ring of 4: the reference's collective step
    under ``shard_map`` and the port's ranks, from the reference's init."""
    rounds = 3
    bundle = jax_configs.build("mnist_mlp", "smoke")
    cfg = dataclasses.replace(bundle.cfg, gossip=dataclasses.replace(bundle.cfg.gossip,
                                                                     topology=jax_topology("ring", WORLD)))
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(0), bundle.world_size)
    init = {"params": jax.tree.map(np.asarray, state.params)}
    step = jax_collective_step(cfg, bundle.loss_fn, JaxMesh.create(cfg.gossip.topology, platform="cpu"))
    want = []
    for batch in bundle.batches(rounds, 0):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["consensus_error"])))
    got = launch(collective.train_rank, WORLD, _spec("mnist_mlp", topology="ring", rounds=rounds, init=init),
                 timeout=SPAWN_TIMEOUT)
    for r, (wl, we) in enumerate(want):
        for rank in got:
            gl, ge = rank["rounds"][r]["loss"], rank["rounds"][r]["consensus_error"]
            assert abs(gl - wl) <= LOSS_ATOL, (r, gl, wl)
            assert abs(ge - we) <= ERR_RTOL * we, (r, ge, we)


def _simulated(spec):
    bundle = configs.build(spec["config"], spec["scale"], codec=spec["codec"], device="cpu")
    params, model_state = bundle.convert(bundle.init_params(0))
    state = init_stacked_state(bundle.cfg, params, bundle.world_size, model_state=model_state)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    metrics = []
    for batch in bundle.batches(spec["rounds"], 0):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["consensus_error"])))
    return bundle.world_size, metrics, state


@pytest.mark.parametrize("config,codec", [("gpt2_topk", None), ("gpt2_topk", "int8"), ("cifar_resnet50", None)])
def test_collective_step_matches_simulated(config, codec):
    """Two rounds from the same per-worker init and batches: the same
    losses, consensus errors and parameters as the simulated step."""
    spec = _spec(config, codec=codec, rounds=2)
    world, want, state = _simulated(spec)
    got = launch(collective.train_rank, world, spec, timeout=SPAWN_TIMEOUT)
    for r, (wl, we) in enumerate(want):
        losses = {g["rounds"][r]["loss"] for g in got}
        errs = {g["rounds"][r]["consensus_error"] for g in got}
        assert len(losses) == len(errs) == 1, "every rank gets the all-reduced values"
        assert losses.pop() == pytest.approx(wl, rel=RTOL, abs=ATOL)
        assert errs.pop() == pytest.approx(we, rel=1e-4)
    for name, p in state.params.items():
        np.testing.assert_allclose(np.stack([g["params"][name] for g in got]), p.numpy(), rtol=RTOL,
                                   atol=STEP_ATOL, err_msg=name)
    for (path, m) in T.flatten_with_paths(state.model_state):
        mine = np.stack([dict(T.flatten_with_paths(g["model_state"]))[path] for g in got])
        np.testing.assert_allclose(mine, m.numpy(), rtol=RTOL, atol=STEP_ATOL, err_msg=str(path))
