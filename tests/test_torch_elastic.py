"""Elastic resume in the port (``consensusml_tpu_torch.utils.elastic``) held
to the reference's ``consensusml_tpu.utils.resize_state``.

The resize: a reference ``TrainState`` whose every leaf is drawn from a
numpy seed (``tests/test_torch_ref_checkpoint_resnet.py``'s filler)
becomes the port's state through ``state_from_reference``; both resize it
(grow, shrink, no-op) and the results are equal leaf for leaf, to the
bit: parameters, BN statistics, the optimizer state (Adam's count and
moments, SGD's trace, the clip's chain, the schedule's count; the joiners'
fresh), the reset gossip state (CHOCO's per-bucket ``xhat``/``s``,
push-sum's mass) and SlowMo's restarted ``x``/``u``. Cases: ``mnist_mlp``
smoke (Adam, CHOCO on ``gpt2_topk``'s smoke codec; and exact with
push-sum), ``cifar_resnet50`` smoke (SGD momentum, cosine, clip, SlowMo)
and ``gpt2_topk`` smoke (CHOCO on its own codec).

The CLI: ``--resume DIR/step_2 --workers W'`` on both backends (the
collective one on ``gloo`` ranks), grow 4 -> 6 and shrink 4 -> 3 on
``mnist_mlp`` smoke, held after one round against the reference's
``resize_state`` of the same checkpoint's state and one reference round
on the same batches: parameters to 1e-5 relative and 1e-6 absolute (one
Adam step and one dense gossip round in another rounding order), the
loss to 1e-5.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.compress import topk_int8_compressor as jax_topk_int8
from consensusml_tpu.train import SlowMoConfig as JaxSlowMoConfig
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu.train.schedules import build_optimizer as jax_build_optimizer
from consensusml_tpu.utils import resize_state as jax_resize_state
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.compress import topk_int8_compressor
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.consensus.faults import FaultConfig, fault_generator
from consensusml_tpu_torch.obs import get_registry
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.__main__ import main, parse_args
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, worker_generator
from consensusml_tpu_torch.utils.checkpoint import restore_state, save_state, state_from_reference, worker_rows
from consensusml_tpu_torch.utils.elastic import resize_state
from consensusml_tpu_torch.utils.tree import named_tensors
from test_torch_ref_checkpoint import _reference_state
from test_torch_ref_checkpoint_resnet import _filled

WORLD = 4
CASES = {
    "mnist_choco": ("mnist_mlp", dict(lr_schedule="linear", warmup_rounds=1, grad_clip=1.0, slowmo_beta=0.2), "choco"),
    "mnist_pushsum": ("mnist_mlp", {}, "push_sum"),
    "resnet": ("cifar_resnet50", dict(lr_schedule="cosine", warmup_rounds=1, grad_clip=1.0, slowmo_beta=0.2), None),
    "gpt2": ("gpt2_topk", {}, None),
}
PARAM_RTOL, PARAM_ATOL, LOSS_ATOL = 1e-5, 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundles(name, flags, gossip, world):
    """The reference's config (its ``LocalSGDConfig`` with the flags) and
    the port's bundle of ``name`` smoke at ``world``."""
    jbundle = jax_configs.build(name, "smoke", world=world)
    cfg = jbundle.cfg
    if flags:
        h = cfg.h
        tx = jax_build_optimizer(jbundle.optimizer_factory, peak_lr=jbundle.base_lr, kind=flags["lr_schedule"],
                                 total_steps=5 * h, warmup_steps=flags["warmup_rounds"] * h,
                                 grad_clip=flags["grad_clip"])
        cfg = dataclasses.replace(cfg, optimizer=tx, outer=JaxSlowMoConfig(beta=flags["slowmo_beta"]))
    bundle = configs.build(name, "smoke", world=world, device="cpu")
    if gossip == "choco":
        cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(
            cfg.gossip, compressor=jax_topk_int8(ratio=0.1, chunk=128, impl="auto"), gamma=0.5))
        bundle.cfg = dataclasses.replace(bundle.cfg, gossip=dataclasses.replace(
            bundle.cfg.gossip, compressor=topk_int8_compressor(ratio=0.1, chunk=128, impl="auto"), gamma=0.5))
    elif gossip == "push_sum":
        cfg = dataclasses.replace(cfg, gossip=dataclasses.replace(cfg.gossip, push_sum=True))
        bundle.cfg = dataclasses.replace(bundle.cfg, gossip=dataclasses.replace(bundle.cfg.gossip, push_sum=True))
    if flags:
        configs.with_train_flags(bundle, rounds=5, **flags)
    return jbundle, cfg, bundle


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _port_leaves(obj, drop_norm=False):
    return [t.numpy() for p, t in named_tensors(obj) if not (drop_norm and p.endswith(".norm"))]


def _assert_state_equal(pstate, jstate):
    """The port's stacked state against the reference's, to the bit."""
    want = {".".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    assert sorted(pstate.params) == sorted(want)
    for n, t in pstate.params.items():
        np.testing.assert_array_equal(t.numpy(), want[n], err_msg=n)
    stats = {".".join(k.key for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jstate.model_state)[0]}
    for n, t in pstate.model_state.get("batch_stats", {}).items():
        np.testing.assert_array_equal(t.numpy(), stats["batch_stats." + n], err_msg=n)
    for part, ref in (("opt_state", jstate.opt_state), ("gossip", jstate.gossip), ("outer", jstate.outer)):
        mine, theirs = _port_leaves(getattr(pstate, part), drop_norm=part == "opt_state"), _ref_leaves(ref)
        assert len(mine) == len(theirs), part
        for i, (a, b) in enumerate(zip(mine, theirs)):
            np.testing.assert_array_equal(a, b, err_msg=f"{part} leaf {i}")
    assert {int(s) for s in np.asarray(jstate.step)} == {pstate.step}


def _start(case):
    """The reference's filled state at WORLD and the port's conversion of it."""
    name, flags, gossip = CASES[case]
    jbundle, cfg, bundle = _bundles(name, flags, gossip, WORLD)
    init = bundle.init_params(0)
    if "params" not in init:  # the LMs' flat tree of parameters
        init = {"params": init}
    # one round counter for every worker: the port keeps one
    jstate = _reference_state(cfg, init, WORLD)
    jstate = _filled(jstate._replace(outer=jstate.outer if cfg.outer is not None else None))
    jstate = jstate._replace(step=jnp.full((WORLD,), 2, jnp.int32))
    if gossip == "push_sum":
        # a mass that left 1: the resize must reset it
        jstate = jstate._replace(gossip=jstate.gossip._replace(w=jnp.asarray([0.5, 1.5, 0.75, 1.25], jnp.float32)))
    tree = jax.tree.map(np.asarray, jstate._replace(rng=None))
    return jstate, state_from_reference(tree, bundle, device="cpu")


@pytest.mark.parametrize("new_world", [6, 3, WORLD], ids=["grow", "shrink", "noop"])
@pytest.mark.parametrize("case", list(CASES))
def test_resize_state_matches_the_reference_bit_for_bit(case, new_world):
    name, flags, gossip = CASES[case]
    jstate, pstate = _start(case)
    _assert_state_equal(pstate, jstate)
    _, jcfg, bundle = _bundles(name, flags, gossip, new_world)
    got = resize_state(bundle.cfg, pstate, new_world, seed=0)
    want = jax_resize_state(jcfg, jstate, new_world, rng=jax.random.key(1))
    _assert_state_equal(got, want)
    assert len(got.generators) == new_world
    if new_world == WORLD:
        assert got is pstate
        return
    if gossip == "push_sum":
        np.testing.assert_array_equal(got.gossip.w.numpy(), np.ones(new_world, np.float32))
    # survivors' rows are the input's, the input untouched
    for n, p in got.params.items():
        keep = min(WORLD, new_world)
        assert torch.equal(p[:keep], pstate.params[n][:keep]), n


def test_resize_feeds_the_elastic_families_and_keys_joiners_on_seed_plus_one():
    name, flags, gossip = CASES["mnist_pushsum"]
    _, pstate = _start("mnist_pushsum")
    _, _, bundle = _bundles(name, flags, gossip, 6)
    bundle.cfg = dataclasses.replace(bundle.cfg, gossip=dataclasses.replace(
        bundle.cfg.gossip, faults=FaultConfig(drop_prob=0.0)))
    pstate.fault_generators = [fault_generator(3, r) for r in range(WORLD)]
    reg = get_registry()
    resizes = reg.counter("consensusml_elastic_resizes_total").value
    joined = reg.counter("consensusml_elastic_joined_workers_total").value
    grown = resize_state(bundle.cfg, pstate, 6, seed=3)
    shrunk = resize_state(bundle.cfg, grown, 2, seed=3)
    assert reg.counter("consensusml_elastic_resizes_total").value == resizes + 2
    assert reg.counter("consensusml_elastic_joined_workers_total").value == joined + 2
    assert reg.gauge("consensusml_elastic_world_size").value == 2 and len(shrunk.generators) == 2
    for i in (4, 5):
        assert torch.equal(grown.generators[i].get_state(), worker_generator("cpu", 4, i).get_state())
        assert torch.equal(grown.fault_generators[i].get_state(), fault_generator(4, i).get_state())
    for i in range(WORLD):
        assert torch.equal(grown.generators[i].get_state(), pstate.generators[i].get_state())


# ---------------------------------------------------------------------------
# the restore's handling of an old gossip layout (tests/test_elastic.py)
# ---------------------------------------------------------------------------


def _mnist_choco(world=4):
    _, _, bundle = _bundles("mnist_mlp", {}, "choco", world)
    params, model_state = configs.init_on_device(bundle, 0, "cpu")
    return bundle, init_stacked_state(bundle.cfg, params, world, model_state=model_state)


def test_restore_resets_an_old_gossip_layout(tmp_path):
    """A checkpoint whose CHOCO state has another layout (an extra bucket)
    restores with the gossip state RESET to the template's zeros and a
    warning; everything else restores exactly."""
    bundle, state = _mnist_choco()
    torch.manual_seed(0)
    for p in state.params.values():
        p.add_(torch.randn_like(p))
    state.step = 2
    xhat = [torch.randn_like(x) for x in state.gossip.xhat]
    old = dataclasses.replace(state, gossip=state.gossip._replace(xhat=xhat + [torch.ones(4, 3)],
                                                                  s=xhat + [torch.ones(4, 3)]))
    path = save_state(str(tmp_path / "old_layout"), old)
    _, template = _mnist_choco()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        restored = restore_state(path, template)
    assert any("gossip" in str(w.message) and "RESET" in str(w.message) for w in caught)
    assert all((t == 0).all() for _, t in named_tensors(restored.gossip))
    assert restored.step == 2
    for n, p in restored.params.items():
        assert torch.equal(p, state.params[n]), n


def test_restore_still_fails_on_a_non_gossip_mismatch(tmp_path):
    """The gossip reset must not mask a real mismatch (the optimizer state
    of other LR flags)."""
    _, state = _mnist_choco()
    path = save_state(str(tmp_path / "ok_layout"), state)
    bundle, template = _mnist_choco()
    configs.with_train_flags(bundle, rounds=3, grad_clip=1.0)
    params, model_state = configs.init_on_device(bundle, 0, "cpu")
    bad = init_stacked_state(bundle.cfg, params, 4, model_state=model_state)
    with pytest.raises(ValueError, match="another structure"):
        restore_state(path, bad)


# ---------------------------------------------------------------------------
# the CLI, both backends
# ---------------------------------------------------------------------------

BASE = ["--device", "cpu", "--config", "mnist_mlp"]


def _port_checkpoint_as_reference(path, world):
    """The port's checkpoint at ``path`` (``world`` workers, mnist_mlp smoke,
    Adam, exact dense gossip) as the reference's ``TrainState``."""
    jbundle, jcfg, bundle = _bundles("mnist_mlp", {}, None, world)
    params, model_state = configs.init_on_device(bundle, 0, "cpu")
    pstate = restore_state(path, init_stacked_state(bundle.cfg, params, world, model_state=model_state))
    init = {"params": {n: t.numpy() for n, t in pstate.params.items()}}
    jstate = _reference_state(jcfg, init, world)
    opt = jax.tree.unflatten(jax.tree.structure(jstate.opt_state),
                             [jnp.asarray(t.numpy()) for _, t in named_tensors(pstate.opt_state)])
    return jstate._replace(opt_state=opt, step=jnp.full((world,), pstate.step, jnp.int32), outer=None), pstate.step


def _reference_round(jstate, new_world, start):
    jbundle, jcfg, _ = _bundles("mnist_mlp", {}, None, new_world)
    state = jax_resize_state(jcfg, jstate, new_world, rng=jax.random.key(1))
    step = jax_train_step(jcfg, jbundle.loss_fn)
    batch = next(iter(jbundle.batches(1, 0, start=start)))
    state, m = step(state, batch)
    return state, float(m["loss"])


def _final_rows(path, world):
    return [worker_rows(path, w)[1] for w in range(world)]


def _assert_rows_match(rows, jstate):
    want = {".".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for n, w in want.items():
        got = np.stack([r["params." + n].numpy() for r in rows])
        np.testing.assert_allclose(got, w, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=n)


def _loss(path: str, rnd: int) -> float:
    """Round ``rnd``'s loss of a ``--metrics-out`` file."""
    import json

    with open(path) as f:
        records = [json.loads(line) for line in f]
    (rec,) = [r for r in records if r["round"] == rnd]
    return rec["loss"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    assert main(BASE + ["--workers", str(WORLD), "--rounds", "2", "--checkpoint-dir", str(d / "ckpt")]) == 0
    return str(d / "ckpt" / "step_2")


@pytest.mark.parametrize("new_world", [6, 3], ids=["grow", "shrink"])
@pytest.mark.parametrize("backend", ["simulated", "collective"])
def test_cli_elastic_resume_matches_the_reference(checkpoint, tmp_path, capfd, backend, new_world):
    metrics = str(tmp_path / "metrics.jsonl")
    argv = BASE + ["--workers", str(new_world), "--rounds", "1", "--resume", checkpoint,
                   "--checkpoint-dir", str(tmp_path), "--metrics-out", metrics]
    if backend == "simulated":
        assert main(argv) == 0
    else:
        argv += ["--backend", "collective", "--dist-backend", "gloo"]
        spec = {**vars(parse_args(argv)), "workers": new_world, "sched_start": 2, "elastic_from": WORLD}
        launch(collective.train_runs, new_world, [spec], threads=1)
    out = capfd.readouterr().out
    assert f"elastic resume: {WORLD} -> {new_world} workers (joiners from consensus mean; gossip state reset)" in out
    assert f"resumed from {checkpoint} at round 2" in out
    jstate, rnd = _port_checkpoint_as_reference(checkpoint, WORLD)
    want, want_loss = _reference_round(jstate, new_world, rnd)
    assert abs(_loss(metrics, 2) - want_loss) <= LOSS_ATOL
    _assert_rows_match(_final_rows(os.path.join(str(tmp_path), "step_3"), new_world), want)


def test_cli_collective_joiner_rows_equal_the_simulated_grow(checkpoint, tmp_path):
    """A joiner rank's row after the resize (no round) equals the
    simulated grow's row to the bit: each rank's ``elastic_restore``."""
    _, _, bundle = _bundles("mnist_mlp", {}, None, 6)
    params, model_state = configs.init_on_device(bundle, 0, "cpu")
    template = init_stacked_state(bundle.cfg, {n: p[:WORLD].clone() for n, p in params.items()}, WORLD,
                                  model_state=model_state)
    grown = resize_state(bundle.cfg, restore_state(checkpoint, template), 6)
    from consensusml_tpu_torch.train.local_sgd import init_state

    for rank in (1, 4, 5):
        one = init_state(bundle.cfg, {n: p[rank].clone() for n, p in params.items()}, rank)
        got = collective.elastic_restore(checkpoint, one, bundle.cfg, rank, WORLD, 6, 0)
        assert got.step == 2
        for n, p in got.params.items():
            assert torch.equal(p[0], grown.params[n][rank]), (rank, n)
        assert torch.equal(got.generators[0].get_state(), grown.generators[rank].get_state())
