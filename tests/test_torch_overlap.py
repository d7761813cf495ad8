"""Overlap gossip (combine-then-adapt) on the port's simulated backend
against the JAX package: ``ConsensusEngine.apply_correction`` and
``correction_simulated``, the pipeline queue, the refusals, the simulated
train step and the CLI.

- The correction, round by round: 4 workers, a gossiped tree with a
  BN-style ``model_state`` leaf (mixed exactly beside CHOCO), buckets
  capped at 1000 bytes (several buckets), four rounds in which ``z`` moves
  as local steps would move it (``0.99 z + 0.01``), at pipeline depths 1,
  2 and 3: exact mixing (``(W - I) z_hat``), and compressed on the
  config's chunked top-k + int8 (two-step wire, JAX
  ``impl="interpret"``), on the int8 codec's fused wire and on its
  two-step wire (``fused_wire=False``), and on the one-peer exponential
  graph (time-varying: the caller passes phase ``step % period``). Held
  bit for bit: ``z``, the correction, the queue and the CHOCO state. At
  these widths XLA's CPU matrix product and PyTorch's sum ``W @ x`` in
  one order (ROADMAP Queue C, "CPU matrix products"), and the port
  mirrors the compiled program's roundings.
- The queue: with no local steps, depth D's ``z`` after round r is
  ``W^(r - D + 1) z_0`` (nothing lands before round D - 1), to the
  rounding of the products (rtol 1e-5 of ``|W|^k |z_0|``); depth 1 is
  overlap alone, the same state bit for bit.
- Every queued correction sums to zero over the workers (the mixing
  matrix is doubly stochastic; CHOCO's ``sum_i s_i = sum_i xhat_i``):
  within 1e-5 of the magnitudes it is computed from (``sum_i |z_i| +
  |c_i|``, each ``c_i`` an f32 difference of values of ``z``'s size), in
  f64.
- The refusals: every config the reference refuses
  (``tests/test_overlap.py:125`` and ``GossipConfig``'s overlap checks),
  the port refuses with the same exception type.
- The simulated train step: ``mnist_mlp`` smoke on a ring of 4 with
  ``overlap=True`` at depths 1 and 2, six rounds against the reference's
  ``make_simulated_train_step``: loss to 1e-6 and consensus error to
  1e-4 relative (``tests/test_torch_mnist.py``'s tolerances: two f32
  matmul orders through Adam).
- The CLI: ``--overlap-gossip --gossip-pipeline 2`` on ``mnist_mlp``
  smoke, and exit code 2 with the reference's message on what it refuses.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.comm import simulated as jsim
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import FaultConfig as JaxFaults
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.compress import PallasInt8Compressor, topk_int8_compressor
from consensusml_tpu_torch.consensus import ConsensusEngine, FaultConfig, GossipConfig, OverlapState
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train.__main__ import main
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.utils import tree as T

WORLD = 4
LOSS_ATOL, ERR_RTOL = 1e-6, 1e-4
SUM_RTOL = 1e-5


def _codecs(codec):
    if codec is None:
        return None, None, {}
    if codec == "topk":
        return jax_topk_int8(chunk=128, k=13, impl="interpret"), topk_int8_compressor(chunk=128, k=13, impl="auto"), {}
    wire = {"fused_wire": False} if codec == "int8_two_step" else {}
    return JaxInt8(chunk=128, impl="interpret"), PallasInt8Compressor(chunk=128), wire


def _engines(codec, depth, topo="ring"):
    jcomp, tcomp, wire = _codecs(codec)
    common = dict(overlap=True, pipeline_depth=depth, gamma=0.5, bucket_bytes=1000, **wire)
    return (JaxEngine(JaxGossip(topology=jax_topology(topo, WORLD), compressor=jcomp, **common)),
            ConsensusEngine(GossipConfig(topology=topology_from_name(topo, WORLD), compressor=tcomp, **common)))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"a": rng.normal(size=(WORLD, 5, 7)).astype(np.float32),
                       "b": rng.normal(size=(WORLD, 300)).astype(np.float32),
                       "c": rng.normal(size=(WORLD, 40)).astype(np.float32)},
            "model_state": {"batch_stats": {"bn.mean": rng.normal(size=(WORLD, 6)).astype(np.float32)}}}


def _port(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _w(topo, step, pkg):
    sim = jsim if pkg == "jax" else simulated
    if topo.is_time_varying:
        return sim.phase_matrices(topo)[step % topo.period]
    return sim.mixing_matrix(topo)


CORRECTION_CASES = [
    ("exact", None, 1, "ring"), ("exact", None, 2, "ring"), ("exact", None, 3, "ring"),
    ("topk", "topk", 1, "ring"), ("topk", "topk", 2, "ring"), ("topk", "topk", 3, "ring"),
    ("int8_fused", "int8", 2, "ring"), ("int8_two_step", "int8_two_step", 2, "ring"),
    ("exact_onepeer", None, 2, "onepeer-exp"), ("topk_onepeer", "topk", 1, "onepeer-exp"),
]


@pytest.mark.parametrize("name,codec,depth,topo", CORRECTION_CASES, ids=[f"{c[0]}-d{c[2]}" for c in CORRECTION_CASES])
def test_correction_matches_reference(name, codec, depth, topo):
    jeng, teng = _engines(codec, depth, topo)
    assert teng.fused_wire_active == jeng.fused_wire_active == (name == "int8_fused")
    tree = _tree(CORRECTION_CASES.index((name, codec, depth, topo)))
    jstate = jeng.init_state(tree, world_size=WORLD)
    tstate = teng.init_state(_port(tree), world_size=WORLD)
    assert isinstance(tstate, OverlapState) and len(tstate.pending) == depth - 1
    assert (tstate.choco is None) == (codec is None)

    @jax.jit
    def jround(x, st, w):
        z = jeng.apply_correction(x, st)
        return z, jeng.correction_simulated(z, w, st)

    jx, tx = tree, _port(tree)
    for step in range(4):
        jz, jstate = jround(jx, jstate, _w(jeng.topology, step, "jax"))
        tz = teng.apply_correction(tx, tstate)
        tstate = teng.correction_simulated(tz, _w(teng.topology, step, "port"), tstate)
        want, got = jax.tree.leaves((jz, jstate)), T.leaves((tz, tstate))
        assert len(want) == len(got)
        for i, (g, wnt) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(wnt), err_msg=f"{name} round {step} leaf {i}")
        jx = jax.tree.map(lambda v: v * 0.99 + 0.01, jz)
        tx = _port(jax.tree.map(np.asarray, jx))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_is_plain_gossip_without_local_steps(depth):
    """No local steps: ``z`` after round r is ``W^(r - D + 1) z_0``; the
    first D - 1 rounds apply nothing (the queue fills). A naive delayed
    correction (no anticipation of the queue) diverges on a ring for D >= 2."""
    _jeng, teng = _engines(None, depth)
    tree = _port(_tree(11))
    w = simulated.mixing_matrix(teng.topology).double()
    state = teng.init_state(tree, world_size=WORLD)
    x = tree
    for r in range(8):
        z = teng.apply_correction(x, state)
        state = teng.correction_simulated(z, simulated.mixing_matrix(teng.topology), state)
        k = max(0, r - depth + 1)
        power = torch.linalg.matrix_power(w, k)
        for got, x0 in zip(T.leaves(z), T.leaves(tree)):
            flat = x0.double().reshape(WORLD, -1)
            want = (power @ flat).reshape(x0.shape)
            scale = (power.abs() @ flat.abs()).reshape(x0.shape)
            assert float(((got.double() - want).abs() - 1e-5 * scale).max()) <= 1e-6, (depth, r)
            if r < depth - 1:
                assert torch.equal(got, x0)
        x = z
    if depth == 1:
        base = ConsensusEngine(GossipConfig(topology=teng.topology, overlap=True, bucket_bytes=1000))
        s1 = base.init_state(tree, world_size=WORLD)
        s2 = teng.init_state(tree, world_size=WORLD)
        for _ in range(3):
            s1 = base.correction_simulated(base.apply_correction(tree, s1), simulated.mixing_matrix(base.topology), s1)
            s2 = teng.correction_simulated(teng.apply_correction(tree, s2), simulated.mixing_matrix(teng.topology), s2)
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(s1), T.leaves(s2))) and s2.pending == ()


@pytest.mark.parametrize("codec,depth", [(None, 3), ("topk", 2), ("int8", 2)])
def test_corrections_sum_to_zero(codec, depth):
    _jeng, teng = _engines(codec, depth)
    x = _port(_tree(21))
    state = teng.init_state(x, world_size=WORLD)
    w = simulated.mixing_matrix(teng.topology)
    for _ in range(4):
        z = teng.apply_correction(x, state)
        state = teng.correction_simulated(z, w, state)
        for corr in (state.correction,) + state.pending:
            for leaf, zl in zip(T.leaves(corr), T.leaves(z)):
                c, zd = leaf.double().reshape(WORLD, -1), zl.double().reshape(WORLD, -1)
                scale = c.abs().sum(0) + zd.abs().sum(0)
                assert float((c.sum(0).abs() - SUM_RTOL * scale).max()) <= 0.0
        x = T.tree_map(lambda v: v * 0.99 + 0.01, z)
    assert any(float(leaf.abs().max()) > 1e-3 for leaf in T.leaves(state.correction))


def _refused(pkg):
    """The configs the reference refuses, built in package ``pkg``."""
    if pkg == "jax":
        topo, faults, int8 = jax_topology, JaxFaults, lambda: JaxInt8(chunk=128, impl="interpret")
        topk = lambda **kw: jax_topk_int8(**kw)  # noqa: E731
        gossip = JaxGossip
    else:
        topo, faults, int8 = topology_from_name, FaultConfig, lambda: PallasInt8Compressor(chunk=128)
        topk = lambda **kw: topk_int8_compressor(**kw)  # noqa: E731
        gossip = GossipConfig
    ring = topo("ring", WORLD)
    chunked = lambda: topk(chunk=128, k=13, impl="auto" if pkg == "port" else "interpret")  # noqa: E731
    return {
        "global_topk": lambda: gossip(topology=ring, overlap=True, compressor=topk(ratio=0.1, chunk=128)),
        "push_sum": lambda: gossip(topology=ring, overlap=True, push_sum=True),
        "faults": lambda: gossip(topology=ring, overlap=True, faults=faults(drop_prob=0.1)),
        "gossip_steps": lambda: gossip(topology=ring, overlap=True, gossip_steps=2),
        "per_leaf_wire": lambda: gossip(topology=ring, overlap=True, compressor=chunked(), bucket_bytes=None),
        "fused_codec": lambda: gossip(topology=ring, overlap=True, compressor=int8(), fused_codec=True),
        "path_filter": lambda: gossip(topology=ring, overlap=True, compressor=chunked(),
                                      path_filter=lambda p: True),
        "codec_warmup": lambda: gossip(topology=ring, overlap=True, compressor=chunked(), codec_warmup_rounds=1),
        "codec_refresh": lambda: gossip(topology=ring, overlap=True, compressor=int8(), codec_refresh_every=5),
        "depth_without_overlap": lambda: gossip(topology=ring, pipeline_depth=2),
        "depth_zero": lambda: gossip(topology=ring, overlap=True, pipeline_depth=0),
        "fused_codec_exact": lambda: gossip(topology=ring, fused_codec=True),
        "fused_codec_fused_wire": lambda: gossip(topology=ring, compressor=int8(), fused_codec=True, fused_wire=True),
    }


@pytest.mark.parametrize("case", list(_refused("port")))
def test_both_packages_refuse(case):
    errors = []
    for pkg in ("jax", "port"):
        with pytest.raises((NotImplementedError, ValueError)) as info:
            _refused(pkg)[case]()
        errors.append(type(info.value))
    assert errors[0] is errors[1], (case, errors)


def test_accepted_overlap_and_fused_codec_configs_build():
    """What the reference accepts, the port builds too (nothing left in a
    not-ported list): overlap on exact and on the bucketed codecs at any
    depth, and the fused codec."""
    ring = topology_from_name("ring", WORLD)
    for kw in (dict(overlap=True, pipeline_depth=3), dict(overlap=True, compressor=PallasInt8Compressor(chunk=128)),
               dict(overlap=True, pipeline_depth=2, compressor=topk_int8_compressor(chunk=128, k=13, impl="auto")),
               dict(fused_codec=True, compressor=topk_int8_compressor(chunk=128, k=13, impl="auto"))):
        engine = ConsensusEngine(GossipConfig(topology=ring, **kw))
        assert engine.config.overlap == kw.get("overlap", False)
        if kw.get("fused_codec"):
            assert not engine.bucketed and not engine.fused_wire_active


@pytest.mark.parametrize("depth", [1, 2])
def test_simulated_step_matches_reference(depth):
    """``mnist_mlp`` smoke, ring of 4, overlap at ``depth``: six rounds from
    the reference's init against its ``make_simulated_train_step``."""
    rounds = 6
    bundle = jax_configs.build("mnist_mlp", "smoke")
    gossip = dataclasses.replace(bundle.cfg.gossip, topology=jax_topology("ring", WORLD), overlap=True,
                                 pipeline_depth=depth)
    cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(0), bundle.world_size)
    init = {"params": jax.tree.map(np.asarray, state.params)}
    step = jax_train_step(cfg, bundle.loss_fn)
    want = []
    for batch in bundle.batches(rounds, 0):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["consensus_error"])))
    port = configs.build("mnist_mlp", "smoke", topology="ring", device="cpu")
    configs.with_gossip_flags(port, overlap=True, pipeline=depth)
    params, model_state = port.convert(init)
    pstate = init_stacked_state(port.cfg, params, port.world_size, model_state=model_state)
    pstep = make_simulated_train_step(port.cfg, port.loss_fn)
    got = []
    for batch in port.batches(rounds, 0):
        pstate, m = pstep(pstate, batch)
        assert set(m) == {"loss", "consensus_error", "inner_ms", "gossip_ms", "imgs_per_s"}
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= LOSS_ATOL, (r, got[r], want[r])
        assert abs(ge - we) <= ERR_RTOL * we, (r, got[r], want[r])
    assert isinstance(pstate.gossip, OverlapState) and len(pstate.gossip.pending) == depth - 1
    assert got[-1][0] < got[0][0]


MNIST = ["--device", "cpu", "--config", "mnist_mlp"]


def test_cli_overlap_pipeline_on_mnist(capsys):
    assert main(MNIST + ["--rounds", "2", "--overlap-gossip", "--gossip-pipeline", "2", "--topology", "ring"]) == 0
    out = capsys.readouterr().out
    assert "overlap gossip (pipeline depth 2)" in out
    lines = [line for line in out.splitlines() if line.startswith("round ")]
    assert len(lines) == 2 and "nan" not in out


@pytest.mark.parametrize("flags,message", [
    (["--gossip-pipeline", "2"], "error: --gossip-pipeline: pipeline_depth > 1 is overlap-mode pipelining"),
    (["--overlap-gossip", "--gossip-pipeline", "0"], "error: --gossip-pipeline: pipeline_depth must be >= 1"),
    (["--overlap-gossip", "--push-sum"], "error: --overlap-gossip: overlap + push-sum is not supported"),
    (["--overlap-gossip", "--gossip-steps", "2"], "error: --overlap-gossip: gossip_steps > 1 with overlap gossip"),
    (["--config", "gpt2_topk", "--overlap-gossip", "--codec-refresh", "5"],
     "error: --overlap-gossip: overlap + compression does not compose with codec_warmup_rounds"),
    (["--config", "gpt2_topk", "--overlap-gossip", "--bucket-bytes", "0"],
     "error: --overlap-gossip: overlap + compression is only supported on the bucketed gossip path"),
])
def test_cli_refusals_exit_2(capsys, flags, message):
    assert main(MNIST + ["--rounds", "1"] + flags) == 2
    assert message in capsys.readouterr().err
