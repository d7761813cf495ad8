"""SlowMo (``consensusml_tpu_torch/train/outer.py``) and a ``mnist_mlp``
run with every long-run optimizer flag against the reference.

``slowmo_update`` is bit-equal to the reference's jitted one (XLA
contracts ``beta * u + d`` and ``x - alpha * u`` into multiply-adds; the
port does too), its state ``x``/``u`` included; ``beta=0, alpha=1`` is the
identity up to the one rounding of ``x - (x - y)`` (1e-6 absolute at these
magnitudes of at most ~5; the reference's own test holds it to 1e-5
relative); the config's checks and the refusal with overlap gossip are the
reference's.

Curves: ``mnist_mlp`` smoke (4 workers, dense gossip, Adam) with
``--lr-schedule cosine --warmup-rounds 1 --grad-clip 1.0 --slowmo-beta
0.2`` for 6 rounds, from the reference's init converted and the same
batches, against the reference's train step rebuilt with its own
``build_optimizer`` and ``SlowMoConfig``: the loss to 1e-6 absolute and
the consensus error to 1e-4 relative plus 1e-6 absolute (the tolerances
of ``tests/test_torch_mnist.py``; the absolute term covers the first
round, whose zero learning rate leaves an error of a few f32 roundings,
about 2e-7, on both sides). The clip fires in every step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.train import SlowMoConfig as JaxSlowMoConfig
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu.train import slowmo_init as jax_slowmo_init
from consensusml_tpu.train import slowmo_update as jax_slowmo_update
from consensusml_tpu.train.schedules import build_optimizer as jax_build_optimizer
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.consensus import GossipConfig
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig, init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.train.optim import adam, clip_norms
from consensusml_tpu_torch.train.outer import SlowMoConfig, slowmo_init, slowmo_update

LOSS_ATOL, ERR_RTOL, ERR_ATOL = 1e-6, 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("beta,alpha", [(0.2, 1.0), (0.8, 0.7), (0.0, 1.0)])
def test_slowmo_update_equals_the_jitted_reference_bit_for_bit(beta, alpha):
    rng = np.random.default_rng(int(beta * 10))
    x0 = {"a": rng.normal(size=(4, 300)).astype(np.float32), "b": rng.normal(size=(4, 7, 5)).astype(np.float32)}
    cfg, jcfg = SlowMoConfig(beta, alpha), JaxSlowMoConfig(beta, alpha)
    state = slowmo_init({k: torch.from_numpy(v) for k, v in x0.items()})
    jstate = jax_slowmo_init({k: jnp.asarray(v) for k, v in x0.items()})
    step = jax.jit(lambda m, s: jax_slowmo_update(jcfg, m, s))
    for r in range(3):
        mixed = {k: (v + 0.01 * (r + 1) * rng.normal(size=v.shape)).astype(np.float32) for k, v in x0.items()}
        got, state = slowmo_update(cfg, {k: torch.from_numpy(v) for k, v in mixed.items()}, state)
        want, jstate = step({k: jnp.asarray(v) for k, v in mixed.items()}, jstate)
        for k in x0:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            for part in ("x", "u"):
                np.testing.assert_array_equal(state[part][k].numpy(), np.asarray(jstate[part][k]))
            if (beta, alpha) == (0.0, 1.0):  # the identity, up to the rounding of x - (x - y)
                np.testing.assert_allclose(got[k].numpy(), mixed[k], rtol=0, atol=1e-6)
    assert state["x"]["a"].data_ptr() != got["a"].data_ptr()


def test_slowmo_checks_and_overlap_refusal_match_the_reference():
    for beta, alpha in [(1.0, 1.0), (-0.1, 1.0), (0.5, 0.0)]:
        with pytest.raises(ValueError) as mine:
            SlowMoConfig(beta, alpha)
        with pytest.raises(ValueError) as ref:
            JaxSlowMoConfig(beta, alpha)
        assert str(mine.value) == str(ref.value)
    gossip = GossipConfig(topology=topology_from_name("ring", 4), overlap=True)
    with pytest.raises(NotImplementedError, match="overlap gossip \\+ SlowMo"):
        LocalSGDConfig(gossip=gossip, optimizer=adam(1e-3), outer=SlowMoConfig(0.2))
    params = {"w": torch.ones(2, 3)}
    st = slowmo_init(params)
    assert st["x"]["w"].data_ptr() != params["w"].data_ptr() and not st["u"]["w"].any()


def test_mnist_long_run_flags_match_the_reference_curves():
    rounds = 6
    bundle = jax_configs.build("mnist_mlp", "smoke")
    tx = jax_build_optimizer(bundle.optimizer_factory, peak_lr=bundle.base_lr, kind="cosine", total_steps=rounds,
                             warmup_steps=1, grad_clip=1.0)
    cfg = dataclasses.replace(bundle.cfg, optimizer=tx, outer=JaxSlowMoConfig(beta=0.2))
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(0), bundle.world_size)
    init = {"params": jax.tree.map(np.asarray, state.params)}
    step = jax_train_step(cfg, bundle.loss_fn)
    want = []
    for batch in bundle.batches(rounds, 0):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["consensus_error"])))
    port = configs.build("mnist_mlp", "smoke", device="cpu")
    configs.with_train_flags(port, lr_schedule="cosine", warmup_rounds=1, grad_clip=1.0, slowmo_beta=0.2,
                             rounds=rounds)
    params, model_state = port.convert(init)
    pstate = init_stacked_state(port.cfg, params, port.world_size, model_state=model_state)
    pstep = make_simulated_train_step(port.cfg, port.loss_fn)
    got = []
    for batch in port.batches(rounds, 0):
        pstate, m = pstep(pstate, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
        assert float(clip_norms(port.cfg.optimizer, pstate.opt_state).min()) > 1.0  # every step clipped
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= LOSS_ATOL, (r, got[r], want[r])
        assert abs(ge - we) <= ERR_RTOL * we + ERR_ATOL, (r, got[r], want[r])
    assert got[-1][0] < got[0][0] and got[1][1] > 1e-2  # SlowMo's echo of the first disagreement
