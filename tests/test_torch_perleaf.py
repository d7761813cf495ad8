"""The per-leaf wire (``GossipConfig(bucket_bytes=None)``, a codec without
a ``bucket_alignment``, and every push-sum round) against the JAX
package's per-leaf round, on the simulated backend.

- Rounds: a tree of five parameter leaves of 1480, 1000, 900, 600 and 24
  elements (the last shorter than a chunk), 4 stacked workers on a ring,
  from the same values: exact mixing, then for each codec one warm round
  (dense mixing plus the innovation exchange) and two CHOCO rounds, each
  leaf compressed, decoded and mixed on its own. The quantizers (int8,
  int4, fp8) and the chunked top-k codecs run on their plain versions
  here and on the JAX side on ``impl="interpret"`` (its Pallas kernels
  interpreted); the global top-k (``impl="reference"``: ``lax.top_k`` on
  the JAX side, a stable sort here) has no kernel. Every parameter and
  the per-leaf ``xhat``/``s`` state is held BIT FOR BIT: the chunk is
  clamped to each leaf's size as the reference clamps it (the 24-element
  leaf takes one 128-chunk, padded), which a bucket of one leaf would not
  do, and the CHOCO update ``x + gamma (s - xhat)`` is one multiply-add,
  as the reference's compiled program computes it (gamma 0.3 and 0.5).
- The mixing product ``W @ x``: XLA's CPU dot sums the four workers'
  products in index order, as PyTorch's, for rows of 17 to about 8000
  elements; below (1, 8-16) and past about 16000 it takes other orders
  (a few ulps apart). The trees here stay inside, and the bucketed cases
  cap buckets at 3000 bytes, as ``tests/test_torch_consensus.py`` does.
- ``compress_filter="auto"`` on a tree with ``model_state``: CHOCO on the
  parameters, the ``model_state`` leaves (BatchNorm-like statistics)
  mixed exactly beside them, on both wires; ``None`` compresses both; a
  callable decides per leaf.
- ``wire_bytes_per_round`` equals the reference's for each case: the
  per-leaf payloads, the exact-mixed leaves' dense bytes and push-sum's
  4 bytes of mass a send.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.comm import simulated as jsim
from consensusml_tpu.compress import PallasFp8Compressor as JaxFp8
from consensusml_tpu.compress import PallasInt4Compressor as JaxInt4
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress.reference import topk_int4_compressor as jax_topk_int4
from consensusml_tpu.compress.reference import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import FaultConfig as JaxFaults
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.compress import (
    PallasFp8Compressor,
    PallasInt4Compressor,
    PallasInt8Compressor,
    topk_int4_compressor,
    topk_int8_compressor,
)
from consensusml_tpu_torch.consensus import ConsensusEngine, FaultConfig, GossipConfig
from consensusml_tpu_torch.topology import topology_from_name

WORLD = 4
CODECS = ["int8", "int4", "fp8", "topk_int8", "topk_int4", "global_topk"]


def _codecs(codec, chunk=128):
    """(JAX codec, port codec) on their per-leaf paths."""
    quantizers = {"int8": (JaxInt8, PallasInt8Compressor), "int4": (JaxInt4, PallasInt4Compressor),
                  "fp8": (JaxFp8, PallasFp8Compressor)}
    if codec in quantizers:
        jax_make, make = quantizers[codec]
        return jax_make(chunk=chunk, impl="interpret"), make(chunk=chunk)
    if codec == "global_topk":
        return (jax_topk_int8(ratio=0.1, chunk=chunk, impl="reference"),
                topk_int8_compressor(ratio=0.1, chunk=chunk, impl="reference"))
    jax_make, make = {"topk_int8": (jax_topk_int8, topk_int8_compressor),
                      "topk_int4": (jax_topk_int4, topk_int4_compressor)}[codec]
    return jax_make(chunk=chunk, k=13, impl="interpret"), make(chunk=chunk, k=13, impl="auto")


def _engines(topology="ring", **kw):
    """(JAX engine, port engine) on the same config; ``codec`` names a
    :func:`_codecs` pair, ``faults`` a drop probability."""
    codec = kw.pop("codec", None)
    faults = kw.pop("faults", None)
    jcomp, tcomp = _codecs(codec) if codec else (None, None)
    jeng = JaxEngine(JaxGossip(topology=jax_topology(topology, WORLD), compressor=jcomp,
                               faults=None if faults is None else JaxFaults(faults), **kw))
    teng = ConsensusEngine(GossipConfig(topology=topology_from_name(topology, WORLD), compressor=tcomp,
                                        faults=None if faults is None else FaultConfig(faults), **kw))
    return jeng, teng


SHAPES = {"attn": (40, 37), "emb": (1000,), "conv": (3, 300), "mlp": (20, 30), "scale": (24,)}


def _stacked(seed, lead=(WORLD,)):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0.0, 0.5, size=lead + shape).astype(np.float32) for k, shape in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _bn_state(seed):
    """BatchNorm-like ``model_state`` leaves (a mean and a variance of 48
    channels, and one of 40): stacked f32."""
    rng = np.random.default_rng(seed)
    return {"batch_stats": {"bn0": {"mean": rng.normal(size=(WORLD, 48)).astype(np.float32),
                                    "var": rng.random((WORLD, 48)).astype(np.float32) + 0.5},
                            "bn1": {"mean": rng.normal(size=(WORLD, 40)).astype(np.float32)}}}


def _port_state(ms):
    return {"batch_stats": {f"{k}.{n}": torch.from_numpy(np.array(v)) for k, d in ms["batch_stats"].items()
                            for n, v in d.items()}}


def _assert_rounds(jeng, teng, steps, model_state=False):
    """From the same stacked tree, ``steps`` rounds on both engines; after
    each, every parameter, ``model_state`` leaf and state leaf bit-equal."""
    params = _stacked(0)
    ms = _bn_state(1) if model_state else {}
    jtree = {"params": jax.tree.map(jnp.asarray, params), "model_state": jax.tree.map(jnp.asarray, ms)}
    ttree = {"params": _torch(params), "model_state": _port_state(ms) if model_state else {}}
    jstate = jeng.init_state(jtree, world_size=WORLD)
    tstate = teng.init_state(ttree, world_size=WORLD)
    jw = jsim.mixing_matrix(jeng.topology)
    tw = simulated.mixing_matrix(teng.topology)
    jround = jax.jit(lambda p, s, step: jeng.round_simulated(p, s, jw, step=step))
    for step in steps:
        jtree, jstate = jround(jtree, jstate, jnp.int32(step))
        ttree, tstate = teng.round_simulated(ttree, tstate, tw, step=step)
        want = jax.tree.map(np.asarray, jtree["params"])
        for name, got in ttree["params"].items():
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want[name]), err_msg=f"{step} {name}")
        if model_state:
            want_ms = _port_state(jax.tree.map(np.asarray, jtree["model_state"]))["batch_stats"]
            for name, got in ttree["model_state"]["batch_stats"].items():
                np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_ms[name].numpy()), err_msg=name)
        if tstate is not None:
            jleaves = jax.tree.leaves(jstate.xhat) + jax.tree.leaves(jstate.s)
            assert [tuple(t.shape) for t in tstate.xhat + tstate.s] == [x.shape for x in jleaves]
            for got, want_b in zip(tstate.xhat + tstate.s, jleaves):
                np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_b), err_msg=f"state, round {step}")
    return ttree, tstate


def test_exact_per_leaf_round_bit_equal():
    jeng, teng = _engines(bucket_bytes=None)
    assert not teng.bucketed and not jeng.bucketed
    assert teng.bucket_plan({"params": _torch(_stacked(0)), "model_state": {}}) is None
    _assert_rounds(jeng, teng, range(2))


@pytest.mark.parametrize("codec", CODECS)
def test_choco_per_leaf_rounds_bit_equal(codec):
    """One warm round, then two CHOCO rounds, every leaf on its own."""
    bucket_bytes = 4 * 2**20 if codec == "global_topk" else None
    jeng, teng = _engines(codec=codec, codec_warmup_rounds=1, gamma=0.3, bucket_bytes=bucket_bytes)
    assert not teng.bucketed and not jeng.bucketed and not teng.fused_wire_active
    _, state = _assert_rounds(jeng, teng, range(3))
    # the state is per leaf: one f32 buffer a parameter, at its stacked shape
    assert [tuple(x.shape) for x in state.xhat] == [(WORLD,) + SHAPES[k] for k in sorted(SHAPES)]


def test_choco_per_leaf_two_consensus_steps_bit_equal():
    jeng, teng = _engines(codec="topk_int8", bucket_bytes=None, gossip_steps=2, gamma=0.3)
    _assert_rounds(jeng, teng, range(2))


@pytest.mark.parametrize("bucket_bytes", [3000, None])
def test_compress_filter_auto_mixes_model_state_exactly(bucket_bytes):
    """CHOCO on the parameters, the BN statistics mixed exactly beside
    them (the reference's ``compress_filter="auto"``), on both wires."""
    jeng, teng = _engines(codec="int8", bucket_bytes=bucket_bytes, gamma=0.5)
    tree, state = _assert_rounds(jeng, teng, range(2), model_state=True)
    # the statistics carry no CHOCO state: every buffer covers parameters only
    n_params = sum(p[0].numel() for p in tree["params"].values())
    if bucket_bytes is None:
        assert sum(x[0].numel() for x in state.xhat) == n_params


@pytest.mark.parametrize("compress_filter", [None, "callable"])
def test_compress_filter_none_and_callable(compress_filter):
    """``None`` compresses the statistics too; a callable picks leaves by
    path (here: every parameter but ``scale``, and no statistic)."""
    if compress_filter is None:
        jcf = tcf = None
    else:
        jcf = lambda p: p[0].key == "params" and p[1].key != "scale"  # noqa: E731
        tcf = lambda p: p[0] == "params" and p[1] != "scale"  # noqa: E731
    jcomp, tcomp = _codecs("int8")
    jeng = JaxEngine(JaxGossip(topology=jax_topology("ring", WORLD), compressor=jcomp, gamma=0.5,
                               bucket_bytes=None, compress_filter=jcf))
    teng = ConsensusEngine(GossipConfig(topology=topology_from_name("ring", WORLD), compressor=tcomp, gamma=0.5,
                                        bucket_bytes=None, compress_filter=tcf))
    _assert_rounds(jeng, teng, range(2), model_state=True)
    jtree, ttree = _unstacked_trees(True)
    assert teng.wire_bytes_per_round(ttree) == jeng.wire_bytes_per_round(jtree)


def _unstacked_trees(model_state: bool):
    params = _stacked(0, lead=())
    ms = jax.tree.map(lambda a: a[0], _bn_state(1)) if model_state else {}
    jtree = {"params": params, "model_state": ms}
    ttree = {"params": _torch(params), "model_state": _port_state(_bn_state(1)) if model_state else {}}
    if model_state:
        ttree["model_state"] = {"batch_stats": {k: v[0] for k, v in ttree["model_state"]["batch_stats"].items()}}
    return jtree, ttree


WIRE_CASES = [
    dict(bucket_bytes=None),
    dict(bucket_bytes=None, topology="onepeer-exp"),
    dict(push_sum=True, topology="onepeer-exp"),
    dict(push_sum=True, topology="exp"),
    dict(push_sum="auto", faults=0.1, topology="onepeer-exp"),
    dict(push_sum=True, topology="dense"),
    dict(faults=0.1),
    *[dict(codec=c, bucket_bytes=None) for c in CODECS],
    dict(codec="global_topk"),
    dict(codec="topk_int8", bucket_bytes=None, gossip_steps=2),
    dict(codec="int8", bucket_bytes=None, topology="onepeer-exp"),
]


@pytest.mark.parametrize("model_state", [False, True])
@pytest.mark.parametrize("case", range(len(WIRE_CASES)))
def test_wire_bytes_per_round_matches_reference(case, model_state):
    kw = dict(WIRE_CASES[case])
    jeng, teng = _engines(**kw)
    assert teng.bucketed == jeng.bucketed
    assert teng.config.push_sum_enabled == jeng.config.push_sum_enabled
    jtree, ttree = _unstacked_trees(model_state)
    assert teng.wire_bytes_per_round(ttree) == jeng.wire_bytes_per_round(jtree)
    if kw.get("push_sum") is True and kw.get("topology") == "onepeer-exp":
        # one send a round: the dense parameters and the 4-byte mass
        dense = 4 * sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
        assert teng.wire_bytes_per_round(ttree) == dense + 4
