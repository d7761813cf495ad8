"""``llama_lora`` on the port against the JAX package: the model
(``LlamaLM`` at ``llama_tiny`` with grouped-query attention, carried
across by ``llama_from_flax``), RoPE, RMSNorm, the LoRA partition (mask,
gossip filter, merge, optimizer), the micro-batched gradient, the
engine's ``path_filter`` on both backends, the run bundle and its
full-scale plan, and the smoke training rounds with the base held once.

Parameters, token ids and gradients come from numpy seeds and feed both
sides.

Tolerances. f32: the same ops on the same values in other summation
orders: logits to 1e-5 of the largest |logit|, the loss to 1e-5 and
each adapter gradient to 2e-5 of its leaf's largest element.
bf16: the two frameworks round at slightly different places (XLA
rounds every op of ``silu`` and of the fused elementwise chains, ATen
rounds each op's result once), so logits to 3.5e-2 of the largest
|logit|: 2.8e-2 read against the jitted reference, whose own eager and
jitted programs differ by 4.1e-2 (0.25 on logits up to 6.2); the loss to
1e-2; the adapter gradients, which carry those roundings back through
both layers, to 0.15 of their leaf's largest element: 0.105 read, where
the reference's eager and jitted gradients differ by 0.126 (f32 holds
them to 2e-5). RoPE's table: f32 cos/sin of angles up to 127 rad,
within 2e-6 absolute; its rotation and RMSNorm within rtol 1e-6, atol
1e-7 (f32) or one bf16 ulp (rtol 2**-7), a row of subnormals exactly 0
on both sides. The LoRA merge within rtol 1e-6. The LoRA optimizer:
frozen leaves bit-unchanged, adapters within rtol 1e-6, atol 1e-9 of
optax's ``multi_transform`` (the port's Adam is optax's op for op). The
micro-batched gradient in f32 within 5e-5 of each leaf's largest element
of the reference's one-batch gradient (3.4e-5 read, as for the port's
one-batch gradient) and within 2e-6 of the port's one-batch gradient
(9.5e-7 read), the loss within 1e-6. Gossip
rounds with ``path_filter``: exact mixing bit-equal on the simulated
backend; the fused int8 wire's ``xhat`` bit-equal and ``s`` and the
parameters within rtol 1e-5, atol 1e-6
(``tests/test_torch_collective_engine.py``'s), and so is the collective
torus's exact round, whose four shifts are summed in another order (1.2e-7
read, as far as the reference's own collective and simulated rounds are
apart); the unselected leaves untouched, bit for bit. Training rounds (bf16 model, Adam 1e-2):
loss within 1e-2 and consensus error within 1e-3 relative every round,
``tests/test_torch_bert.py``'s bf16 limits; the reference's consensus
error also sums the base's W identical rows, a rounding residue of their
mean, which the port never stacks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.analysis.jaxpr_contracts import _shard_map_no_check
from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import simulated as jax_simulated
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.consensus import ConsensusEngine as JaxEngine
from consensusml_tpu.consensus import GossipConfig as JaxGossip
from consensusml_tpu.models import lora as jax_lora
from consensusml_tpu.models.attention import apply_rope as jax_apply_rope
from consensusml_tpu.models.attention import rope_frequencies as jax_rope_frequencies
from consensusml_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from consensusml_tpu.models.llama import LlamaLM as JaxLlamaLM
from consensusml_tpu.models.llama import RMSNorm as JaxRMSNorm
from consensusml_tpu.models.llama import llama_loss_fn as jax_llama_loss_fn
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm import check, simulated
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.compress import PallasInt8Compressor
from consensusml_tpu_torch.consensus import ChocoState, ConsensusEngine, GossipConfig
from consensusml_tpu_torch.models import lora
from consensusml_tpu_torch.models.attention import apply_rope, rope_frequencies
from consensusml_tpu_torch.models.convert import llama_from_flax, llama_frozen
from consensusml_tpu_torch.models.llama import LlamaConfig, LlamaLM, RMSNorm, llama_loss_fn
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.local_sgd import (
    LocalSGDConfig,
    init_stacked_state,
    make_simulated_train_step,
    worker_grads,
)
from consensusml_tpu_torch.train.optim import adam, lora_optimizer
from consensusml_tpu_torch.utils import tree as T

GEOM = dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=128, lora_rank=4)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
WORLD = 4
ROUNDS = 3
SPAWN_TIMEOUT = 120.0


def _flat(tree) -> dict:
    """A nested flax tree (numpy leaves) as the port's dotted dict."""
    return {n: t.numpy() for n, t in llama_from_flax(tree).items()}


def random_flax_params(seed, seq=8):
    """The tiny model's flax tree with every leaf redrawn from numpy: norm
    scales near 1, every other leaf (``lora_b`` too) N(0, 0.2)."""
    tree = jax.eval_shape(JaxLlamaLM(config=JaxLlamaConfig(**GEOM)).init, jax.random.key(0),
                          jnp.zeros((1, seq), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.normal(0.0, 0.2, size=leaf.shape).astype(np.float32)
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def _ids(seed, b=4, s=16):
    return np.random.default_rng(seed).integers(0, GEOM["vocab_size"], size=(b, s)).astype(np.int32)


def _adapters(flat: dict) -> list[str]:
    return [n for n in flat if lora.is_lora_path((n,))]


@functools.lru_cache(maxsize=None)
def _reference_model(dtype_name):
    """The reference's logits, loss and adapter gradients at ``llama_tiny``
    (kv_heads 2) on a masked batch (module-cached)."""
    jdt, _ = DTYPES[dtype_name]
    jmodel = JaxLlamaLM(config=JaxLlamaConfig(**GEOM, dtype=jdt))
    params = random_flax_params(0)
    ids = _ids(1)
    mask = (np.random.default_rng(2).random(ids.shape) < 0.8).astype(np.float32)
    batch = {"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)}
    logits = np.asarray(jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, batch["input_ids"]))
    loss_fn = jax_llama_loss_fn(jmodel)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, {}, batch, None)[0]))(params)
    return params, ids, mask, logits, float(loss), _flat(jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_llama_logits_loss_and_adapter_grads_match_reference(dtype_name):
    """``LlamaLM`` with rank-4 adapters on q, k, v and o and 2 kv heads for
    4 heads, the reference's parameters carried by ``llama_from_flax``:
    logits, the masked next-token loss and every adapter's gradient at the
    module docstring's tolerances. In bf16 the base held once in bf16
    (``llama_frozen``, as the trainer holds it) gives the f32 base's
    logits bit for bit (the reference casts each leaf before its product)."""
    params, ids, mask, want_logits, want_loss, want_grads = _reference_model(dtype_name)
    _, tdt = DTYPES[dtype_name]
    model = LlamaLM(LlamaConfig(**GEOM, dtype=tdt), device="cpu")
    full = llama_from_flax(jax.tree.map(np.asarray, params))
    x = torch.from_numpy(ids)
    with torch.no_grad():
        logits = torch.func.functional_call(model, full, (x,)).numpy()
    scale = float(np.abs(want_logits).max())
    if dtype_name == "f32":
        np.testing.assert_allclose(logits, want_logits, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(logits, want_logits, rtol=0, atol=3.5e-2 * scale)
        held = {**llama_frozen(full, torch.bfloat16), **{n: full[n] for n in _adapters(full)}}
        with torch.no_grad():
            np.testing.assert_array_equal(torch.func.functional_call(model, held, (x,)).numpy(), logits)
    names = _adapters(full)
    leaves = {n: (t.clone().requires_grad_(True) if n in names else t) for n, t in full.items()}
    loss_fn = llama_loss_fn(model)
    loss, _ = loss_fn(leaves, {}, {"input_ids": x, "loss_mask": torch.from_numpy(mask)}, None)
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    assert loss.dtype == torch.float32 and len(names) == 4 * 2 * GEOM["layers"]
    assert abs(float(loss.detach()) - want_loss) <= (1e-5 if dtype_name == "f32" else 1e-2)
    gtol = 2e-5 if dtype_name == "f32" else 0.15
    for n, g in zip(names, grads):
        w = want_grads[n]
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=gtol * float(np.abs(w).max()), err_msg=n)


@pytest.mark.parametrize("positions", ["none", "1d", "2d_clamped"])
def test_rope_matches_reference(positions):
    """``rope_frequencies`` against the reference's table, and
    ``apply_rope`` (f32 and bf16) on the reference's table without
    positions, with ``(S,)`` positions, and with ``(B, S)`` positions some
    past ``max_len`` (the clamped lookup)."""
    table = np.array(jax_rope_frequencies(16, 128))
    np.testing.assert_allclose(rope_frequencies(16, 128).numpy(), table, rtol=0, atol=2e-6)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = {"none": None, "1d": rng.integers(0, 128, size=12).astype(np.int32),
           "2d_clamped": rng.integers(100, 200, size=(2, 12)).astype(np.int32)}[positions]
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 2.0**-7)):
        want = np.asarray(jax.jit(jax_apply_rope)(jnp.asarray(x, jdt), jnp.asarray(table),
                                                  None if pos is None else jnp.asarray(pos)), np.float32)
        got = apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(table),
                         None if pos is None else torch.from_numpy(pos).long())
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=1e-7)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_rmsnorm_matches_reference_and_flushes_a_subnormal_row(dtype_name):
    """``RMSNorm`` against the jitted reference (whose compiled program
    flushes subnormals): normal rows within the docstring's tolerance, a
    row of subnormal inputs 0 on both sides, and its gradient through the
    port's backward finite and zero on that row."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    x[1, 2] = 1e-39 * np.sign(rng.normal(size=64)).astype(np.float32)  # subnormal in f32 and bf16
    scale = (1.0 + 0.2 * rng.normal(size=64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: JaxRMSNorm(1e-5).apply({"params": {"scale": scale}}, v))(
        jnp.asarray(x, jdt)), np.float32)
    norm = RMSNorm(64, 1e-5, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = norm(xt)
    tol = 1e-6 if dtype_name == "f32" else 2.0**-7
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol, atol=1e-7)
    assert not want[1, 2].any() and not got[1, 2].any()
    (dx,) = torch.autograd.grad(got.float().square().sum(), xt)
    assert torch.isfinite(dx.float()).all() and not dx[1, 2].any()


def test_lora_mask_filter_merge_match_reference():
    """``lora_mask`` marks the reference's adapter leaves, ``lora_gossip_filter``
    selects them on the port's paths (``("params", name)``), and
    ``merge_lora`` folds them into the base kernels as the reference's."""
    params = random_flax_params(5)
    flat = _flat(params)
    want_mask = _flat(jax.tree.map(lambda b: np.float32(b), jax_lora.lora_mask(params)))
    got_mask = lora.lora_mask({n: torch.from_numpy(a) for n, a in flat.items()})
    assert {n: bool(v) for n, v in want_mask.items()} == got_mask
    assert [n for n in flat if lora.lora_gossip_filter(("params", n))] == [n for n, v in got_mask.items() if v]
    assert not lora.lora_gossip_filter(("params", "layer_0.q_proj.base.kernel"))
    want = _flat(jax.tree.map(np.asarray, jax_lora.merge_lora(params, 4.0)))
    got = lora.merge_lora({n: torch.from_numpy(a) for n, a in flat.items()}, 4.0)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=1e-6, atol=1e-7, err_msg=n)


def test_lora_optimizer_matches_multi_transform():
    """``lora_optimizer(adam(1e-2))`` against optax's ``lora_optimizer(adam(1e-2))``
    for three steps of seeded gradients: the frozen leaves bit-unchanged
    (and never in the optimizer's state), the adapters at the docstring's
    tolerance."""
    params = random_flax_params(6)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), params) for _ in range(3)]
    opt = jax_lora.lora_optimizer(optax.adam(1e-2))
    state, want = opt.init(params), params
    for g in grads:
        upd, state = opt.update(g, state, want)
        want = optax.apply_updates(want, upd)
    flat = _flat(params)
    stacked = {n: torch.from_numpy(a[None].copy()) for n, a in flat.items()}
    before = {n: t.clone() for n, t in stacked.items()}
    topt = lora_optimizer(adam(1e-2))
    tstate = topt.init(stacked, 1)
    assert sorted(tstate.mu) == sorted(_adapters(flat))
    for g in grads:
        gflat = _flat(g)
        topt.update_({n: t[0] for n, t in stacked.items()},
                     {n: torch.from_numpy(gflat[n]) for n in _adapters(flat)}, tstate, 0)
    want = _flat(jax.tree.map(np.asarray, want))
    for n, t in stacked.items():
        if lora.is_lora_path((n,)):
            np.testing.assert_allclose(t[0].numpy(), want[n], rtol=1e-6, atol=1e-9, err_msg=n)
        else:
            assert torch.equal(t, before[n]) and np.array_equal(want[n], flat[n]), n


def test_micro_batched_gradient_matches_one_batch():
    """``worker_grads`` at ``micro_batch=2`` on a batch of 8 whose loss mask
    counts differ by micro-batch (one all zero): the loss and every
    adapter gradient of the reference's one-batch ``value_and_grad``
    (f32 model), the base taking no gradient; and the whole batch at once
    gives them too."""
    jmodel = JaxLlamaLM(config=JaxLlamaConfig(**GEOM, dtype=jnp.float32))
    params = random_flax_params(8)
    ids = _ids(9, b=8)
    mask = (np.random.default_rng(10).random(ids.shape) < 0.7).astype(np.float32)
    mask[2:4] = 0.0
    loss_fn = jax_llama_loss_fn(jmodel)
    batch = {"input_ids": jnp.asarray(ids), "loss_mask": jnp.asarray(mask)}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, {}, batch, None)[0]))(params)
    want = _flat(jax.tree.map(np.asarray, grads))
    model = LlamaLM(LlamaConfig(**GEOM, dtype=torch.float32), device="meta")
    full = llama_from_flax(jax.tree.map(np.asarray, params))
    adapters = {n: full[n][None] for n in _adapters(full)}
    frozen = llama_frozen(full, torch.float32)
    topo = topology_from_name("torus", 1)
    got = {}
    for micro in (2, 0):
        cfg = LocalSGDConfig(gossip=GossipConfig(topology=topo), optimizer=lora_optimizer(adam(1e-3)),
                             micro_batch=micro)
        state = init_stacked_state(cfg, adapters, 1, frozen=frozen)
        got_loss, got[micro], _ = worker_grads(
            cfg, llama_loss_fn(model), state, 0, {"input_ids": torch.from_numpy(ids), "loss_mask": torch.from_numpy(mask)})
        assert abs(float(got_loss) - float(loss)) <= 1e-6
        assert sorted(got[micro]) == sorted(adapters)
    for n, g in got[2].items():
        np.testing.assert_allclose(g.numpy(), want[n], rtol=0, atol=5e-5 * float(np.abs(want[n]).max()), err_msg=n)
        np.testing.assert_allclose(g.numpy(), got[0][n].numpy(), rtol=0,
                                   atol=2e-6 * float(got[0][n].abs().max()), err_msg=n)


# ---------------------------------------------------------------------------
# path_filter rounds
# ---------------------------------------------------------------------------

# name -> (codec, round counters)
FILTER_CASES = {"exact": (None, [0, 1]), "int8": ("int8", [0, 1])}


def _filter_engines(name):
    codec, _ = FILTER_CASES[name]
    common = dict(bucket_bytes=2000, gamma=0.5)
    jcomp = None if codec is None else JaxInt8(chunk=128, impl="interpret")
    tcomp = None if codec is None else PallasInt8Compressor(chunk=128)
    return (JaxEngine(JaxGossip(topology=jax_topology("torus", WORLD), compressor=jcomp,
                                path_filter=jax_lora.lora_gossip_filter, **common)),
            ConsensusEngine(GossipConfig(topology=topology_from_name("torus", WORLD), compressor=tcomp,
                                         path_filter=lora.lora_gossip_filter, **common)))


@functools.lru_cache(maxsize=None)
def _filter_inputs(name):
    """A stacked llama_tiny tree (adapters and base disagreeing across
    workers, so a round that touched the base would show) and, for the
    codec, a seeded nonzero CHOCO state over the adapters' buckets."""
    rng = np.random.default_rng(list(FILTER_CASES).index(name) + 20)
    shapes = jax.eval_shape(JaxLlamaLM(config=JaxLlamaConfig(**GEOM)).init, jax.random.key(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree.map(lambda s: rng.normal(0.0, 0.5, size=(WORLD,) + s.shape).astype(np.float32), shapes)
    tree = {"params": params, "model_state": {}}
    if FILTER_CASES[name][0] is None:
        return tree, None
    zero = _filter_engines(name)[1].init_state(_port_tree(tree), world_size=WORLD)
    return tree, ([rng.normal(0.0, 0.5, size=tuple(b.shape)).astype(np.float32) for b in zero.xhat],
                  [rng.normal(0.0, 0.5, size=tuple(b.shape)).astype(np.float32) for b in zero.s])


def _port_tree(tree, leaf=torch.from_numpy):
    return {"params": {n: leaf(np.asarray(t)) for n, t in _flat(tree["params"]).items()}, "model_state": {}}


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@functools.lru_cache(maxsize=None)
def _reference_filter_rounds(name, backend):
    """The reference's rounds (simulated: every round counter of the case;
    collective under ``shard_map`` on the virtual CPU devices: the first),
    each from the previous one's output: per round ``(tree, state, step)``
    before and ``(tree, state)`` after."""
    jeng, _ = _filter_engines(name)
    tree, state = _filter_inputs(name)
    if backend == "simulated":
        w = jax_simulated.mixing_matrix(jeng.topology)

        def one_round(t, st, step):
            st = None if st is None else type(jeng.init_state(t, world_size=WORLD))(xhat=list(st[0]), s=list(st[1]))
            t, st = jeng.round_simulated(t, st, w, step=step)
            return t, None if st is None else (list(st.xhat), list(st.s))

        one_round = jax.jit(one_round)
        put = lambda t: t  # noqa: E731
    else:
        topo = jeng.topology
        wm = JaxMesh.create(topo, platform="cpu")
        spec = P(tuple(topo.axis_names))  # the stacked worker axis over every mesh axis

        @jax.jit
        @functools.partial(_shard_map_no_check, mesh=wm.mesh, in_specs=(spec, spec, P()), out_specs=spec)
        def one_round(t, st, step):
            t = jax.tree.map(lambda x: x[0], t)
            if st is not None:
                st = type(jeng.init_state(t))(xhat=[x[0] for x in st[0]], s=[x[0] for x in st[1]])
            t, st = jeng.round_collective(t, st, step=step)
            return jax.tree.map(lambda x: x[None], (t, None if st is None else (list(st.xhat), list(st.s))))

        put = lambda t: jax.device_put(t, wm.stacked_sharding())  # noqa: E731
    rounds = []
    steps = FILTER_CASES[name][1] if backend == "simulated" else FILTER_CASES[name][1][:1]
    for step in steps:
        out = jax.tree.map(np.asarray, one_round(put(tree), None if state is None else put(state), jnp.int32(step)))
        rounds.append(((tree, state, step), out))
        tree, state = out
    return rounds


def _assert_round(got_tree, got_state, want_tree, want_state, before, bit_equal):
    want_flat = _flat(want_tree["params"])
    before_flat = _flat(before["params"])
    for n, g in got_tree["params"].items():
        g = np.asarray(g)
        if not lora.is_lora_path((n,)):
            np.testing.assert_array_equal(_bits(g), _bits(before_flat[n]), err_msg=f"passthrough {n}")
        elif bit_equal:
            np.testing.assert_array_equal(_bits(g), _bits(want_flat[n]), err_msg=n)
        else:
            np.testing.assert_allclose(g, want_flat[n], rtol=1e-5, atol=1e-6, err_msg=n)
    if want_state is not None:
        assert len(got_state[0]) == len(want_state[0]) > 1
        for g, w in zip(got_state[0], want_state[0]):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg="xhat")
        for g, w in zip(got_state[1], want_state[1]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg="s")


@pytest.mark.parametrize("name", list(FILTER_CASES))
def test_path_filter_simulated_rounds_plans_and_wire_bytes_match_reference(name):
    """``path_filter=lora_gossip_filter`` on the simulated backend, a torus
    of 4, buckets of at most 2000 bytes: the bucket plan (the adapters'
    only, the reference's order and totals), the wire bytes (those of the
    adapters alone) and two rounds (exact mixing; the fused int8 wire from
    a nonzero CHOCO state) equal the reference's, the base passing
    through untouched."""
    jeng, teng = _filter_engines(name)
    tree, _ = _filter_inputs(name)
    per_worker = T.tree_map(lambda t: t[0], _port_tree(tree))
    jper = jax.tree.map(lambda a: a[0], tree)
    plan, want_plan = teng.bucket_plan(per_worker), jeng.bucket_plan(jper)
    assert plan.num_buckets == want_plan.num_buckets > 1
    assert [b.total for b in plan.buckets] == [b.total for b in want_plan.buckets]
    assert teng.wire_bytes_per_round(per_worker) == jeng.wire_bytes_per_round(jper)
    if name == "exact":
        n_adapters = sum(t.numel() for n, t in per_worker["params"].items() if lora.is_lora_path((n,)))
        assert teng.wire_bytes_per_round(per_worker) == 4 * n_adapters * teng._sends_per_round()
    w = simulated.mixing_matrix(teng.topology)
    for (before, state, step), (want_tree, want_state) in _reference_filter_rounds(name, "simulated"):
        st = None if state is None else ChocoState(xhat=[torch.tensor(a) for a in state[0]],
                                                   s=[torch.tensor(a) for a in state[1]])
        got, st = teng.round_simulated(_port_tree(before), st, w, step=step)
        got_state = None if st is None else ([b.numpy() for b in st.xhat], [b.numpy() for b in st.s])
        _assert_round(T.tree_map(lambda t: t.numpy(), got), got_state, want_tree, want_state, before,
                      bit_equal=name == "exact")


def test_path_filter_collective_rounds_match_reference():
    """The first of those rounds on the collective backend, 4 ``gloo`` ranks
    on the CPU (one spawn, both cases), against
    the reference's ``round_collective`` under ``shard_map`` at the
    docstring's tolerance, the base passing through bit for bit; each
    rank's transport sends the adapters' bytes only."""
    keys, cases = [], []
    for name in FILTER_CASES:
        _, teng = _filter_engines(name)
        for i, ((tree, state, step), _out) in enumerate(_reference_filter_rounds(name, "collective")):
            st = None if state is None else {"xhat": list(state[0]), "s": list(state[1])}
            cases.append((teng, _port_tree(tree, np.asarray), [step], st))
            keys.append((name, i))
    results = launch(check.gossip_cases, WORLD, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
    for j, (name, i) in enumerate(keys):
        got = [r[j] for r in results]
        (before, _state, _step), (want_tree, want_state) = _reference_filter_rounds(name, "collective")[i]
        got_tree = T.tree_map(lambda *xs: np.stack(xs), *[r["tree"] for r in got])
        got_state = None
        if want_state is not None:
            got_state = (T.tree_map(lambda *xs: np.stack(xs), *[r["state"]["xhat"] for r in got]),
                         T.tree_map(lambda *xs: np.stack(xs), *[r["state"]["s"] for r in got]))
        _assert_round(got_tree, got_state, want_tree, want_state, before, bit_equal=False)
        if name == "exact":
            _, teng = _filter_engines(name)
            per_worker = T.tree_map(lambda t: t[0], _port_tree(before))
            assert {r["bytes_by_round"][0] for r in got} == {teng.wire_bytes_per_round(per_worker)}


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_bundle_and_full_scale_plan_match_reference():
    """The run bundle's fields (world, h, lr, torus, exact gossip through
    the LoRA filter, batch shapes and tokens) of the reference's
    ``llama_lora`` at smoke scale, and at full scale from shapes only
    (``jax.eval_shape`` on the reference, the ``meta`` model on the port):
    Llama-2-7B's 6,738,415,616 base parameters and 16,777,216 adapter
    parameters a worker, whose bucket plan (the filter selecting them from
    the whole tree) equals the reference's, 16 buckets of at most 4 MiB."""
    for scale in ("smoke", "full"):
        ref = jax_configs.build("llama_lora", scale)
        port = configs.build("llama_lora", scale, device="cpu")
        full = scale == "full"
        assert (port.world_size, port.cfg.h) == (ref.world_size, ref.cfg.h) == ((16, 1) if full else (4, 1))
        assert port.cfg.optimizer.lr == ref.base_lr == (1e-3 if full else 1e-2)
        assert port.cfg.gossip.topology.name == ref.cfg.gossip.topology.name == "torus"
        assert port.cfg.gossip.topology.mesh_shape == ref.cfg.gossip.topology.mesh_shape == ((4, 4) if full else (2, 2))
        assert port.cfg.gossip.compressor is None and ref.cfg.gossip.compressor is None
        assert port.cfg.micro_batch == (configs.LLAMA_MICRO_BATCH if full else 0)
        for f in ("vocab_size", "hidden", "layers", "heads", "kv_heads", "mlp_dim", "max_len", "lora_rank",
                  "lora_alpha", "rope_theta", "norm_eps"):
            assert getattr(port.model.config, f) == getattr(ref.model.config, f), f
        seq = 2048 if full else 16
        want = jax.eval_shape(lambda r: ref.model.init(r, jnp.zeros((1, seq), jnp.int32))["params"],
                              jax.random.key(0))
        flat_want = {".".join(k.key for k in path): leaf
                     for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
        got = dict(port.model.named_parameters())
        assert sorted(got) == sorted(flat_want)
        ordered = {n: got[n] for n in flat_want}
        adapters = {n: p for n, p in ordered.items() if lora.is_lora_path((n,))}
        if full:
            assert sum(p.numel() for n, p in ordered.items() if n not in adapters) == 6_738_415_616
            assert sum(p.numel() for p in adapters.values()) == 16_777_216
        plan = port.cfg.engine().bucket_plan({"params": ordered, "model_state": {}})
        ref_plan = ref.cfg.engine().bucket_plan({"params": want, "model_state": {}})
        assert [b.total for b in plan.buckets] == [b.total for b in ref_plan.buckets]
        assert [[bl.index for bl in b.leaves] for b in plan.buckets] == [
            [bl.index for bl in b.leaves] for b in ref_plan.buckets]
        assert sum(b.total for b in plan.buckets) == sum(p.numel() for p in adapters.values())
        if full:
            assert plan.num_buckets == 16
            continue
        batch, ref_batch = next(iter(port.batches(1, 0))), next(iter(ref.batches(1, 0)))
        np.testing.assert_array_equal(batch["input_ids"].numpy(), np.asarray(ref_batch["input_ids"]))
        init = port.init_params(0)
        assert sorted(init) == sorted(adapters) and all(a.shape[0] == 4 for a in init.values())
        base = configs.frozen_on_device(port, "cpu")
        assert sorted(base) == sorted(set(ordered) - set(adapters))
        assert all(t.shape == ordered[n].shape for n, t in base.items())
        assert {t.dtype for n, t in base.items() if not n.endswith(".scale")} == {torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _reference_rounds():
    """The reference's ``llama_lora`` smoke: its per-worker init (the base
    from its fixed key, the adapters per worker) and ROUNDS rounds' loss
    and consensus error."""
    bundle = jax_configs.build("llama_lora", "smoke")
    state = jax_init_stacked_state(bundle.cfg, jax.jit(bundle.init_params), jax.random.key(0), bundle.world_size)
    init = jax.tree.map(np.asarray, state.params)
    step = jax_train_step(bundle.cfg, bundle.loss_fn)
    curve = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        curve.append((float(m["loss"]), float(m["consensus_error"])))
    return init, curve


def test_smoke_rounds_match_reference_with_the_base_held_once():
    """Three rounds of ``llama_lora`` smoke (4 workers on a 2x2 torus, one
    Adam(1e-2) step on the adapters and one exact round of adapter-only
    gossip each) from the reference's init, the base held once in bf16:
    loss and consensus error every round at the docstring's tolerances.
    The base is never stacked: it stays the tensors it was given, with
    per-worker shapes, bit-unchanged; the train state stacks, optimizes
    and gossips the adapters only."""
    init, want = _reference_rounds()
    flat = llama_from_flax(init)
    for n, t in flat.items():
        if not lora.is_lora_path((n,)):
            assert torch.equal(t, t[:1].expand_as(t)), f"the reference's base differs across workers: {n}"
    bundle = configs.build("llama_lora", "smoke", device="cpu")
    frozen = llama_frozen({n: t[0] for n, t in flat.items()}, torch.bfloat16)
    kept = {n: (t.data_ptr(), t.clone()) for n, t in frozen.items()}
    state = init_stacked_state(bundle.cfg, {n: flat[n] for n in _adapters(flat)}, WORLD, frozen=frozen)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    got = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= 1e-2, (r, got, want)
        assert abs(ge - we) <= 1e-3 * we, (r, got, want)
    assert got[-1][1] < got[0][1]
    assert sorted(state.params) == sorted(state.opt_state.mu) == sorted(_adapters(flat))
    assert all(p.shape[0] == WORLD for p in state.params.values())
    for n, t in state.frozen.items():
        ptr, value = kept[n]
        assert t.data_ptr() == ptr and t.shape == flat[n].shape[1:] and torch.equal(t, value), n


def test_train_cli_llama_lora_on_cpu(capsys):
    """``--config llama_lora --device cpu`` trains (the base held once,
    the adapters alone in the one bucket) and scores a held-out batch;
    without ``--device cpu`` and without a GPU it raises."""
    from consensusml_tpu_torch.train.__main__ import main

    assert main(["--config", "llama_lora", "--device", "cpu", "--rounds", "1", "--eval-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "llama_lora/smoke: 4 workers on cpu, 3584 params per worker + 106816 frozen, held once, 1 buckets" in out
    assert "codec: none (exact gossip of the LoRA adapters only)" in out
    assert "round 0: loss" in out and "eval[mean-model]: nll=" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", "llama_lora", "--rounds", "1"])


def test_collective_llama_round_matches_simulated():
    """``llama_lora`` smoke at world 4 over ``gloo`` on the CPU, one round,
    each rank holding its own copy of the base: every rank gets the
    simulated step's loss (rtol 1e-5, atol 1e-6), consensus error (1e-4
    relative) and adapters (rtol 1e-5, atol 1e-5), the tolerances of
    ``tests/test_torch_collective_engine.py``'s train steps, and sends the
    adapters' bytes only."""
    spec = {"config": "llama_lora", "scale": "smoke", "workers": None, "codec": None, "gamma": None,
            "codec_warmup": None, "norm_impl": "flax", "topology": None, "seed": 0, "device": "cpu",
            "dist_backend": "gloo", "log_every": 0, "return_params": True, "rounds": 1}
    bundle = configs.build("llama_lora", "smoke", device="cpu")
    params, _ = bundle.convert(bundle.init_params(0))
    state = init_stacked_state(bundle.cfg, params, WORLD, frozen=configs.frozen_on_device(bundle, "cpu"))
    state, m = make_simulated_train_step(bundle.cfg, bundle.loss_fn)(state, next(iter(bundle.batches(1, 0))))
    got = launch(collective.train_rank, WORLD, spec, timeout=SPAWN_TIMEOUT)
    per_worker = {n: p[0] for n, p in state.params.items()}
    for g in got:
        assert g["rounds"][0]["loss"] == pytest.approx(float(m["loss"]), rel=1e-5, abs=1e-6)
        assert g["rounds"][0]["consensus_error"] == pytest.approx(float(m["consensus_error"]), rel=1e-4)
        assert g["rounds"][0]["wire_bytes"] == bundle.cfg.engine().wire_bytes_per_round(
            {"params": per_worker, "model_state": {}})
        assert sorted(g["params"]) == sorted(state.params)
    for name, p in state.params.items():
        np.testing.assert_allclose(np.stack([g["params"][name] for g in got]), p.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
