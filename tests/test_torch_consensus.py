"""The port's bucketed CHOCO round (simulated backend) against the JAX
package's.

- Bucket layout: the port's plan over its GPT-2 parameters (flax paths,
  flax shapes, the reference's flatten order) equals the reference's plan
  over the flax tree, at the smoke size and at GPT-2-medium (shapes only).
- Rounds: from the same stacked parameters, one warm round (dense mixing
  plus the innovation exchange) then one CHOCO round, through the fused
  int8 wire (JAX: its Pallas kernel in interpret mode). The parameters
  and the per-bucket ``xhat``/``s`` state are held BIT FOR BIT: the
  mixing product ``W @ x`` of a 4x4 matrix sums the same four products
  in the same order in both, and the port computes the reference's fused
  multiply-adds with one rounding (``compress/reference.py:fma_f32``).
- The two-step wire: the config's own codec (chunked top-k + int8, JAX
  ``impl="interpret"``, the TPU kernel path), the same top-k with int4
  values (``--codec topk_int4``), and the int8 and fp8 codecs with
  ``fused_wire=False``: the bucket layout (25 buckets at GPT-2-medium for
  top-k + int8, 14 for top-k + int4) and the same warm and CHOCO rounds,
  bit for bit.
- The fused wire's other formats (``--codec int4``, ``--codec fp8``): the
  plans at GPT-2-medium (int4 50 buckets and 360,367,280 wire bytes, fp8
  123 and 715,190,448) and the same rounds, bit for bit.
- The periodic dense refresh (``codec_refresh_every``): rounds that cross
  refresh rounds, on the fused int8 and fp8 wires, bit for bit.
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
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu.topology import RingTopology as JaxRing
from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.compress import (
    PallasFp8Compressor,
    PallasInt4Compressor,
    PallasInt8Compressor,
    topk_int4_compressor,
    topk_int8_compressor,
)
from consensusml_tpu_torch.configs import gpt2_config
from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2LM
from consensusml_tpu_torch.topology import RingTopology

SMOKE = dict(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32, dropout=0.0)
WORLD = 4


def _flax_shapes(geom):
    model = JaxGPT2LM(config=JaxGPT2Config(**geom))
    return jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _codecs(codec, chunk):
    """(JAX codec, port codec): ``"int8"``, ``"int4"``, ``"fp8"``, the
    config's ``"topk_int8"`` or ``"topk_int4"`` (k 8 at chunk 512, 13 at
    128, as ``gpt2_topk`` full and smoke)."""
    quantizers = {"int8": (JaxInt8, PallasInt8Compressor), "int4": (JaxInt4, PallasInt4Compressor),
                  "fp8": (JaxFp8, PallasFp8Compressor)}
    if codec in quantizers:
        jax_make, make = quantizers[codec]
        return jax_make(chunk=chunk, impl="interpret"), make(chunk=chunk)
    k = 8 if chunk == 512 else 13
    jax_make, make = {"topk_int8": (jax_topk_int8, topk_int8_compressor),
                      "topk_int4": (jax_topk_int4, topk_int4_compressor)}[codec]
    return jax_make(chunk=chunk, k=k, impl="interpret"), make(chunk=chunk, k=k, impl="auto")


def _engines(chunk=128, bucket_bytes=4 * 2**20, warm=0, gamma=0.5, steps=1, codec="int8", fused_wire="auto",
             refresh=0):
    jcomp, tcomp = _codecs(codec, chunk)
    jeng = JaxEngine(JaxGossip(
        topology=JaxRing(WORLD), compressor=jcomp, gamma=gamma, codec_warmup_rounds=warm,
        bucket_bytes=bucket_bytes, gossip_steps=steps, fused_wire=fused_wire, codec_refresh_every=refresh,
    ))
    teng = ConsensusEngine(GossipConfig(
        topology=RingTopology(WORLD), compressor=tcomp, gamma=gamma, codec_warmup_rounds=warm,
        bucket_bytes=bucket_bytes, gossip_steps=steps, fused_wire=fused_wire, codec_refresh_every=refresh,
    ))
    return jeng, teng


def _layout(plan):
    return [
        (b.total, [(bl.index, tuple(bl.shape), bl.size, bl.padded, bl.offset) for bl in b.leaves])
        for b in plan.buckets
    ]


@pytest.mark.parametrize("codec", ["int8", "topk_int8", "topk_int4", "int4", "fp8"])
@pytest.mark.parametrize("scale,bucket_bytes", [("smoke", 4 * 2**20), ("smoke", 3000), ("full", 4 * 2**20)])
def test_bucket_plan_matches_reference(scale, bucket_bytes, codec):
    geom = SMOKE if scale == "smoke" else {}
    chunk = 128 if scale == "smoke" else 512
    jeng, teng = _engines(chunk=chunk, bucket_bytes=bucket_bytes, codec=codec)
    jtree = {"params": _flax_shapes(geom), "model_state": {}}
    meta = GPT2LM(gpt2_config(scale), device="meta")
    ttree = {"params": dict(meta.named_parameters()), "model_state": {}}
    jplan, tplan = jeng.bucket_plan(jtree), teng.bucket_plan(ttree)
    assert _layout(tplan) == _layout(jplan)
    assert teng.wire_bytes_per_round(ttree) == jeng.wire_bytes_per_round(jtree)
    assert teng.fused_wire_active == jeng.fused_wire_active == (codec in ("int8", "int4", "fp8"))
    if scale == "full" and codec in ("int8", "fp8"):
        # the encode launches per round on the card (one per bucket); fp8
        # ships int8's bytes (a byte an element, one f32 scale a chunk)
        assert tplan.num_buckets == jplan.num_buckets == 123
        assert teng.wire_bytes_per_round(ttree) == 715_190_448
    if scale == "full" and codec == "int4":
        # half the value bytes: 260 wire bytes a 512-chunk, 50 buckets
        assert tplan.num_buckets == jplan.num_buckets == 50
        assert teng.wire_bytes_per_round(ttree) == 360_367_280
    if scale == "full" and codec == "topk_int8":
        # 148 wire bytes a 512-chunk (the kernel path's layout): each of
        # the four codec kernels launches once a bucket per exchange
        assert tplan.num_buckets == jplan.num_buckets == 25
        assert teng.wire_bytes_per_round(ttree) == 33_366_424
    if scale == "full" and codec == "topk_int4":
        # 84 wire bytes a 512-chunk (64 packed + 4 scale + 16 index bytes):
        # the kernel path's layout, 14 buckets (its jnp path packs 5)
        assert tplan.num_buckets == jplan.num_buckets == 14
        assert teng.wire_bytes_per_round(ttree) == 27_809_088
    if scale == "smoke" and bucket_bytes > 3000:
        assert tplan.num_buckets == 1


def _stacked_params(seed):
    """Stacked (W, ...) flax-layout parameters, numpy-seeded per worker."""
    rng = np.random.default_rng(seed)
    shapes = _flax_shapes(SMOKE)
    return jax.tree.map(
        lambda s: rng.normal(0.0, 0.5, size=(WORLD,) + s.shape).astype(np.float32), shapes
    )


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("codec,fused_wire", [("int8", "auto"), ("topk_int8", "auto"), ("topk_int4", "auto"),
                                              ("int8", False), ("int4", "auto"), ("fp8", "auto"), ("fp8", False)])
@pytest.mark.parametrize("steps", [1, 2])
def test_warm_then_choco_rounds_bit_equal(steps, codec, fused_wire):
    jeng, teng = _engines(warm=1, bucket_bytes=3000, steps=steps, codec=codec, fused_wire=fused_wire)
    fuses = codec in ("int8", "int4", "fp8")
    assert teng.fused_wire_active == jeng.fused_wire_active == (fuses and fused_wire == "auto")
    _assert_rounds_bit_equal(jeng, teng, range(3))  # 0: warm (dense mixing), then CHOCO


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_rounds_across_dense_refresh_bit_equal(codec):
    """``codec_refresh_every=2`` on the fused wire: rounds 0, 2 and 4 mix
    densely (the innovation exchange keeping xhat/s warm), 1 and 3 run
    CHOCO; every round bit-equal to the reference's ``lax.cond`` on the
    round counter. The JAX package's own refresh test holds its refresh
    rounds to exact mixing at a tolerance; this one pins them bit for bit."""
    jeng, teng = _engines(bucket_bytes=3000, codec=codec, refresh=2)
    assert teng.fused_wire_active and jeng.fused_wire_active
    _assert_rounds_bit_equal(jeng, teng, range(5))


def _assert_rounds_bit_equal(jeng, teng, steps):
    """From the same stacked parameters, run ``steps`` rounds on both
    engines; after each, the parameters and the per-bucket state must be
    bit-equal."""
    params = _stacked_params(0)
    jtree = {"params": jax.tree.map(jnp.asarray, params), "model_state": {}}
    ttree = {"params": gpt2_from_flax(params), "model_state": {}}
    jstate = jeng.init_state(jtree, world_size=WORLD)
    tstate = teng.init_state(ttree, world_size=WORLD)
    assert [tuple(x.shape) for x in tstate.xhat] == [x.shape for x in jstate.xhat]
    assert len(tstate.xhat) > 1
    jw = jsim.mixing_matrix(jeng.topology)
    tw = simulated.mixing_matrix(teng.topology)
    jround = jax.jit(lambda p, s, step: jeng.round_simulated(p, s, jw, step=step))
    for step in steps:
        jtree, jstate = jround(jtree, jstate, jnp.int32(step))
        ttree, tstate = teng.round_simulated(ttree, tstate, tw, step=step)
        want = gpt2_from_flax(jax.tree.map(np.asarray, jtree["params"]))
        for name, got in ttree["params"].items():
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want[name]), err_msg=f"{step} {name}")
        for got, want_b in zip(tstate.xhat + tstate.s, list(jstate.xhat) + list(jstate.s)):
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want_b), err_msg=f"state, round {step}")
    err = teng.consensus_error_simulated(ttree["params"])
    want_err = float(jeng.consensus_error_simulated(jtree["params"]))
    # f32 sums over all leaves, reduced in different orders: a few ulps
    assert abs(float(err) - want_err) <= 1e-6 * want_err


def test_fused_wire_plan_encode_bit_equal():
    """The reference's all-buckets encode/decode of ``FusedWirePlan`` (the
    simulated round drives the codec bucket by bucket instead)."""
    from consensusml_tpu.consensus.bucketing import build_fused_plan as jax_build_fused_plan
    from consensusml_tpu_torch.consensus.bucketing import build_fused_plan

    jeng, teng = _engines(bucket_bytes=3000)
    params = _stacked_params(2)
    ttree = {"params": gpt2_from_flax(params), "model_state": {}}
    jtree = {"params": params, "model_state": {}}
    tplan = teng.bucket_plan(ttree, stacked=True)
    jplan = jeng.bucket_plan(jtree, stacked=True)
    tf = build_fused_plan(tplan, teng.config.compressor)
    jf = jax_build_fused_plan(jplan, JaxInt8(chunk=128, impl="interpret"))
    tx = tplan.pack([t for t in ttree["params"].values()], stacked=True)
    jx = jplan.pack(jax.tree.leaves(jax.tree.map(jnp.asarray, jtree)), stacked=True)
    th = [torch.full_like(b, 0.25) for b in tx]
    tq, tnew = tf.encode(tx, th)
    jq, jnew = jf.encode(jx, [jnp.full_like(b, 0.25) for b in jx])
    for a, b in zip(tnew + tf.decode(tq), list(jnew) + list(jf.decode(jq))):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


def test_exact_mixing_round_bit_equal():
    jeng = JaxEngine(JaxGossip(topology=JaxRing(WORLD), bucket_bytes=3000))
    teng = ConsensusEngine(GossipConfig(topology=RingTopology(WORLD), bucket_bytes=3000))
    params = _stacked_params(1)
    jw, tw = jsim.mixing_matrix(jeng.topology), simulated.mixing_matrix(teng.topology)
    jout, jstate = jax.jit(lambda p: jeng.round_simulated(p, None, jw))({"params": params, "model_state": {}})
    tout, tstate = teng.round_simulated({"params": gpt2_from_flax(params), "model_state": {}}, None, tw)
    assert tstate is None and jstate is None
    want = gpt2_from_flax(jax.tree.map(np.asarray, jout["params"]))
    for name, got in tout["params"].items():
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want[name]), err_msg=name)


def test_unported_options_refuse():
    """What stays refused (the reference's own refusals): faults or
    push-sum with a compressor, overlap gossip off the bucketed wire or
    with the fused codec, pipelining without overlap, faults on a directed
    graph without push-sum, and the fused wire off the bucketed transport.
    The per-leaf wire, the global top-k, push-sum, faults on exact gossip,
    CHOCO beside exact-mixed ``model_state``, overlap gossip and its
    pipelining, and ``fused_codec`` are ported: ``tests/test_torch_perleaf.py``,
    ``tests/test_torch_faults.py``, ``tests/test_torch_pushsum.py``,
    ``tests/test_torch_overlap.py`` and ``tests/test_torch_fused_codec.py``
    hold them to the reference."""
    from consensusml_tpu_torch.consensus import FaultConfig
    from consensusml_tpu_torch.topology import OnePeerExponentialTopology

    topo = RingTopology(WORLD)
    comp = PallasInt8Compressor(chunk=128)
    for kwargs in ({"overlap": True, "bucket_bytes": None}, {"overlap": True, "fused_codec": True},
                   {"push_sum": True}, {"faults": FaultConfig(0.1)},
                   {"push_sum": "auto", "faults": FaultConfig(0.1)}):
        with pytest.raises(NotImplementedError):
            GossipConfig(topology=topo, compressor=comp, **kwargs)
    for kwargs in ({"overlap": True, "gossip_steps": 2}, {"pipeline_depth": 2}):
        with pytest.raises(NotImplementedError):
            GossipConfig(topology=topo, **kwargs)
    for kwargs in ({"overlap": True}, {"overlap": True, "pipeline_depth": 2}):
        assert GossipConfig(topology=topo, **kwargs).overlap
        assert GossipConfig(topology=topo, compressor=comp, **kwargs).overlap
    assert GossipConfig(topology=topo, compressor=comp, fused_codec=True).fused_codec
    with pytest.raises(NotImplementedError):
        GossipConfig(topology=OnePeerExponentialTopology(WORLD), faults=FaultConfig(0.1))
    with pytest.raises(NotImplementedError):
        GossipConfig(topology=topo, compressor=comp, fused_wire=True, bucket_bytes=None)
    # path_filter is ported, with CHOCO on the selected leaves as the
    # reference's (tests/test_torch_llama.py holds its rounds)
    GossipConfig(topology=topo, compressor=comp, path_filter=lambda p: True)
    # the two-step wire is ported; the fused one needs a codec that fuses
    assert not ConsensusEngine(GossipConfig(topology=topo, compressor=comp, fused_wire=False)).fused_wire_active
    with pytest.raises(NotImplementedError):
        GossipConfig(topology=topo, compressor=topk_int8_compressor(chunk=128, k=8, impl="auto"), fused_wire=True)
    with pytest.raises(NotImplementedError):
        GossipConfig(topology=topo, codec_warmup_rounds=1)
    # lifted: the global top-k and the per-leaf wire, push-sum and faults
    # on exact gossip, CHOCO state beside model_state
    assert not ConsensusEngine(GossipConfig(
        topology=topo, compressor=topk_int8_compressor(chunk=128, k=8, impl="reference"))).bucketed
    assert not ConsensusEngine(GossipConfig(topology=topo, compressor=comp, bucket_bytes=None)).bucketed
    assert GossipConfig(topology=OnePeerExponentialTopology(WORLD), faults=FaultConfig(0.1),
                        push_sum="auto").push_sum_enabled
    eng = ConsensusEngine(GossipConfig(topology=topo, compressor=comp))
    state = eng.init_state({"params": {"w": torch.zeros(4, 3)}, "model_state": {"bn": torch.zeros(4, 2)}},
                           world_size=WORLD)
    assert [tuple(x.shape) for x in state.xhat] == [(WORLD, 128)]


@pytest.mark.parametrize("codec", ["int8", "topk_int8"])
def test_choco_update_is_one_multiply_add(codec):
    """``x + gamma * (s - xhat)`` at a gamma whose product rounds (0.3, and
    the full config's 0.1): the reference's compiled program computes it
    as one multiply-add, and so does the port, bit for bit (a product
    rounded apart from the sum differs in the last bit)."""
    for gamma in (0.3, 0.1):
        jeng, teng = _engines(bucket_bytes=3000, codec=codec, gamma=gamma)
        _assert_rounds_bit_equal(jeng, teng, range(2))
