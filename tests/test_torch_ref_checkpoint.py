"""A checkpoint of the reference trainer, continued by the port
(``consensusml_tpu_torch.utils.checkpoint.state_from_reference``).

The reference starts from the port's numpy-seeded initial variables (in
flax layout; its own state built around them as its
``init_stacked_state`` builds it, without tracing flax's initialisers),
trains two rounds, writes its whole stacked ``TrainState``
with its own ``save_state`` (orbax) in ``tmp_path``, and reads it back with
its own ``restore_state``; the port converts that tree (numpy leaves, the
rng left out: typed JAX keys are not torch generators, and neither run
draws from them here) and both continue for three rounds on the same
batches. The converted state equals the reference's leaf for leaf, bit
for bit: parameters, BN statistics, the optimizer state with the clip's
chain and the schedule's count, CHOCO's per-bucket ``xhat``/``s``,
SlowMo's ``x``/``u`` and the round. The continued curves agree as the
port's and the reference's f32 smoke curves do
(``tests/test_torch_train.py``): the loss to 1e-5 absolute and the
consensus error to 1e-5 relative.

The run: ``mnist_mlp`` smoke at 2 workers (Adam, ``--lr-schedule linear
--warmup-rounds 1 --grad-clip 1.0 --slowmo-beta 0.2``) gossiping by CHOCO
on ``gpt2_topk``'s smoke codec (top-k 13 of 128 + int8, gamma 0.5; set on
both sides' ``GossipConfig``, as no CLI flag does: the mnist model keeps
the case cheap and the codec gives CHOCO's per-bucket state). The BN
statistics and SGD's trace are converted in
``tests/test_torch_ref_checkpoint_resnet.py``: a reference
``cifar_resnet50`` state (SGD with momentum, ``--lr-schedule cosine
--grad-clip 1.0 --slowmo-beta 0.2``) whose every leaf is filled with
numpy-seeded values, saved, restored and converted bit for bit, no round
run (a ResNet train step's compile is the cost the suite cannot spare).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.compress import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.train import SlowMoConfig as JaxSlowMoConfig
from consensusml_tpu.train import TrainState as JaxTrainState
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu.train import slowmo_init as jax_slowmo_init
from consensusml_tpu.train.schedules import build_optimizer as jax_build_optimizer
from consensusml_tpu.utils import restore_state as jax_restore_state
from consensusml_tpu.utils import save_state as jax_save_state
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.compress import topk_int8_compressor
from consensusml_tpu_torch.train.local_sgd import make_simulated_train_step
from consensusml_tpu_torch.utils.checkpoint import state_from_reference
from consensusml_tpu_torch.utils.tree import named_tensors

LOSS_ATOL, ERR_RTOL = 1e-5, 1e-5
ROUNDS, SAVED = 5, 2
CASES = {
    "mnist_mlp": dict(lr_schedule="linear", warmup_rounds=1, grad_clip=1.0, slowmo_beta=0.2),
    "cifar_resnet50": dict(lr_schedule="cosine", warmup_rounds=1, grad_clip=1.0, slowmo_beta=0.2),
}


WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name, flags):
    bundle = jax_configs.build(name, "smoke", world=WORLD)
    h = bundle.cfg.h
    tx = jax_build_optimizer(bundle.optimizer_factory, peak_lr=bundle.base_lr, kind=flags["lr_schedule"],
                             total_steps=ROUNDS * h, warmup_steps=flags["warmup_rounds"] * h,
                             grad_clip=flags["grad_clip"])
    cfg = dataclasses.replace(bundle.cfg, optimizer=tx, outer=JaxSlowMoConfig(beta=flags["slowmo_beta"]))
    if name == "mnist_mlp":
        gossip = dataclasses.replace(cfg.gossip, compressor=jax_topk_int8(ratio=0.1, chunk=128, impl="auto"), gamma=0.5)
        cfg = dataclasses.replace(cfg, gossip=gossip)
    return bundle, cfg, bundle.loss_fn


def _port(name, flags):
    bundle = configs.build(name, "smoke", world=WORLD, device="cpu")
    if name == "mnist_mlp":
        gossip = dataclasses.replace(bundle.cfg.gossip, compressor=topk_int8_compressor(ratio=0.1, chunk=128, impl="auto"),
                                     gamma=0.5)
        bundle.cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    configs.with_train_flags(bundle, rounds=ROUNDS, **flags)
    return bundle, bundle.loss_fn


def _nest(flat: dict) -> dict:
    """Dotted flax paths back to nested dicts."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(leaf)
    return out


def _reference_state(cfg, init: dict, world: int):
    """The reference's stacked ``TrainState`` around given initial
    variables, field by field as its ``init_stacked_state`` builds it."""
    params = _nest(init["params"])
    model_state = {"batch_stats": _nest(init["batch_stats"])} if "batch_stats" in init else {}
    keys = jax.random.split(jax.random.key(0), world)
    return JaxTrainState(
        step=jnp.zeros((world,), jnp.int32), params=params, model_state=model_state,
        opt_state=jax.vmap(cfg.optimizer.init)(params),
        gossip=cfg.engine().init_state({"params": params, "model_state": model_state}, world_size=world),
        rng=jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, 1), outer=jax_slowmo_init(params))


def convert_reference_checkpoint(tmp_path, name, state_fn=None):
    """Config ``name``'s reference state (``state_fn(state)`` applied, or
    two trained rounds) saved by the reference, restored, converted by the
    port and held to it leaf for leaf; returns the restored reference
    state, the port's and the reference's train step (None with
    ``state_fn``)."""
    flags = CASES[name]
    jbundle, cfg, jloss = _reference(name, flags)
    bundle, _ = _port(name, flags)
    init = bundle.init_params(0)
    template = lambda: _reference_state(cfg, init, jbundle.world_size)  # noqa: E731
    state, step = template(), None
    if state_fn is not None:
        state = state_fn(state)
    else:
        step = jax_train_step(cfg, jloss)
        for batch in jbundle.batches(SAVED, 0):
            state, _ = step(state, batch)
    path = jax_save_state(str(tmp_path), state, step=SAVED)
    restored = jax_restore_state(path, template())
    tree = jax.tree.map(np.asarray, restored._replace(rng=None))
    pstate = state_from_reference(tree, bundle, device="cpu")
    assert pstate.step == int(tree.step[0]) and pstate.outer is not None
    want = {".".join(k.key for k in p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree.params)[0]}
    for n, t in pstate.params.items():
        np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)
    mine = [t for p, t in named_tensors(pstate.opt_state) if not p.endswith(".norm")]
    mine += [t for _, t in named_tensors(pstate.gossip)] + [t for _, t in named_tensors(pstate.outer)]
    ref = [np.asarray(x) for x in jax.tree.leaves((tree.opt_state, tree.gossip, tree.outer))]
    assert len(mine) == len(ref)
    for t, r in zip(mine, ref):
        np.testing.assert_array_equal(t.numpy(), r)
    stats = {".".join(k.key for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(tree.model_state)[0]}
    for n, t in pstate.model_state.get("batch_stats", {}).items():
        np.testing.assert_array_equal(t.numpy(), stats["batch_stats." + n], err_msg=n)
    return restored, pstate, step


def test_mnist_choco_reference_checkpoint_continues_on_the_port(tmp_path):
    restored, pstate, step = convert_reference_checkpoint(tmp_path, "mnist_mlp")
    assert pstate.step == SAVED and len(pstate.gossip.xhat) == 1  # CHOCO's state, one bucket
    jbundle, _, _ = _reference("mnist_mlp", CASES["mnist_mlp"])
    bundle, loss_fn = _port("mnist_mlp", CASES["mnist_mlp"])
    pstep = make_simulated_train_step(bundle.cfg, loss_fn)
    got, want_curve = [], []
    for batch, pbatch in zip(jbundle.batches(ROUNDS - SAVED, 0, start=SAVED),
                             bundle.batches(ROUNDS - SAVED, 0, start=SAVED)):
        restored, m = step(restored, batch)
        want_curve.append((float(m["loss"]), float(m["consensus_error"])))
        pstate, m = pstep(pstate, pbatch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want_curve)):
        assert abs(gl - wl) <= LOSS_ATOL, (r, got, want_curve)
        assert abs(ge - we) <= ERR_RTOL * we, (r, got, want_curve)
    assert pstate.step == ROUNDS
