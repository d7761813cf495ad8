"""``mnist_mlp`` on the port against the JAX package: the MLP and its
conversion, the held-out data, ``evaluate`` on stacked states, the
training curves over 120 rounds on a ring and on the time-varying
one-peer exponential graph (and three on the config's own dense graph),
``gpt2_topk`` on ``--topology onepeer-exp``, and the CLI.

Curves (``mnist_mlp`` smoke: hidden 64, 4 workers, Adam 1e-3, h = 1, batch
64, f32 on both sides, from the reference's flax init converted and the
same batches): over 120 rounds the loss falls from 2.41 to ~7e-4 and the
consensus error from 2.5 (ring) or 4.3 (onepeer-exp) to ~1.5e-4. The
readings: the loss agrees to 2.4e-7 absolute (round 0; at most 1e-8 once
it is below 1e-3) and the consensus error to 9.5e-6 relative (ring, round
115; onepeer-exp 2.7e-6), the drift of two f32 matmul summation orders
through Adam. Held at 1e-6 absolute (4x the worst reading) and 1e-4
relative (10x): a gossip round with the wrong phase matrix moves the
consensus error by tens of percent, a missing Adam bias correction the
loss by more than 1e-2. On the dense graph one round is exact consensus,
W = 11^T/4: every row of W @ x is the same dot product, so the error is 0
on both sides, bit for bit.

``evaluate`` and the ``gpt2_topk --topology onepeer-exp`` curves are in
``tests/test_torch_mnist_eval.py``, and the 120-round onepeer-exp curves
in ``tests/test_torch_mnist_onepeer.py``, so that the suite's workers can
run them beside these.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.data.synthetic import SyntheticClassification as JaxSyntheticClassification
from consensusml_tpu.data.synthetic import round_batches as jax_round_batches
from consensusml_tpu.models.mlp import MLP as JaxMLP
from consensusml_tpu.models.mlp import mlp_loss_fn as jax_mlp_loss_fn
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.data import SyntheticClassification, cls_eval_batches, round_batches
from consensusml_tpu_torch.models.convert import gpt2_from_flax, mlp_from_flax, mlp_init_params
from consensusml_tpu_torch.models.mlp import MLP, mlp_loss_fn
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

LOSS_ATOL, ERR_RTOL = 1e-6, 1e-4


def _mlp_variables(hidden=64, seed=0):
    model = JaxMLP(hidden=hidden)
    return model, jax.tree.map(np.asarray, model.init(jax.random.key(seed), jnp.zeros((1, 28, 28, 1))))


def test_mlp_from_flax_forward_and_gradient_match_flax():
    """One forward and the loss's gradient of the port's ``MLP`` on
    parameters converted from flax's, against flax's apply and
    ``jax.grad``, f32: logits to 2e-6, gradients to 1e-6 (summation order)."""
    jmodel, variables = _mlp_variables()
    params, model_state = mlp_from_flax(variables)
    assert list(params) == ["Dense_0.bias", "Dense_0.kernel", "Dense_1.bias", "Dense_1.kernel"]
    assert params["Dense_0.kernel"].shape == (784, 64) and model_state == {}
    rng = np.random.default_rng(3)
    batch = {"image": rng.normal(size=(16, 28, 28, 1)).astype(np.float32),
             "label": rng.integers(0, 10, size=16).astype(np.int32)}
    want_logits = np.asarray(jmodel.apply(variables, batch["image"]))
    jloss = jax_mlp_loss_fn(jmodel)
    want_loss, want_grads = jax.value_and_grad(lambda p: jloss(p, {}, batch, None)[0])(variables["params"])
    model = MLP(hidden=64, device="meta")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    logits = torch.func.functional_call(model, leaves, (tbatch["image"],))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=2e-6, atol=2e-6)
    loss, state = mlp_loss_fn(model)(leaves, {}, tbatch, None)
    assert state == {} and float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-6)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = gpt2_from_flax(jax.tree.map(np.asarray, want_grads))
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def test_mlp_init_params_has_flax_layout_and_scheme():
    """numpy-seeded per worker: the flax tree's shapes, lecun-normal
    kernels (truncated at 2 std), zero biases, workers distinct."""
    _, variables = _mlp_variables(hidden=256)
    init = mlp_init_params(MLP(hidden=256, device="meta"), seed=5, world_size=4)
    want = {".".join(p): np.shape(v) for p, v in jax.tree_util.tree_flatten_with_path(variables["params"])[0]
            for p in [tuple(k.key for k in p)]}
    assert {n: v.shape[1:] for n, v in init["params"].items()} == want
    k0 = init["params"]["Dense_0.kernel"]
    assert k0.dtype == np.float32 and not np.array_equal(k0[0], k0[1])
    assert abs(k0.std() * np.sqrt(784) - 1) < 0.02 and np.abs(k0).max() <= 2 / 0.8796 / np.sqrt(784) + 1e-7
    assert not init["params"]["Dense_1.bias"].any()
    params, _ = mlp_from_flax(init)
    assert params["Dense_1.kernel"].shape == (4, 256, 10)


@pytest.mark.parametrize("n,image", [(2048, 28), (8192, 28), (512, 16)])
def test_holdout_and_eval_batches_match_reference(n, image):
    """The holdout split (same prototypes, another sample stream) and the
    held-out batches bit-equal to the reference's ``_cls_eval_batches``;
    the training stream unchanged by the new ``sample_seed`` field."""
    kw = dict(n=n, image_shape=(image, image, 1 if image == 28 else 3))
    data, jdata = SyntheticClassification(**kw), JaxSyntheticClassification(**kw)
    held, jheld = data.holdout(), jdata.holdout()
    np.testing.assert_array_equal(held.images, jheld.images)
    np.testing.assert_array_equal(held.labels, jheld.labels)
    np.testing.assert_array_equal(held.prototypes, data.prototypes)
    assert not np.array_equal(held.images, data.images)
    np.testing.assert_array_equal(data.images, jdata.images)
    got = list(cls_eval_batches(data, 64, 3, seed=2))
    want = list(jax_configs._cls_eval_batches(jdata, 64)(3, 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"].numpy(), np.asarray(w["image"]))
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))
    for g, w in zip(round_batches(data, 4, 1, 64, 2, seed=1), jax_round_batches(jdata, 4, 1, 64, 2, seed=1)):
        np.testing.assert_array_equal(g["image"].numpy(), np.asarray(w["image"]))


def _curves(spec, rounds):
    """The reference's and the port's ``mnist_mlp`` smoke curves on
    ``spec`` from the reference's init (converted) and the same batches."""
    bundle = jax_configs.build("mnist_mlp", "smoke")
    cfg = dataclasses.replace(bundle.cfg, gossip=dataclasses.replace(
        bundle.cfg.gossip, topology=jax_topology(spec, bundle.world_size)))
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(0), bundle.world_size)
    init = {"params": jax.tree.map(np.asarray, state.params)}
    step = jax_train_step(cfg, bundle.loss_fn)
    want = []
    for batch in bundle.batches(rounds, 0):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["consensus_error"])))
    port = configs.build("mnist_mlp", "smoke", topology=spec, device="cpu")
    assert port.cfg.gossip.topology.name == cfg.gossip.topology.name
    params, model_state = port.convert(init)
    pstate = init_stacked_state(port.cfg, params, port.world_size, model_state=model_state)
    pstep = make_simulated_train_step(port.cfg, port.loss_fn)
    got = []
    for batch in port.batches(rounds, 0):
        pstate, m = pstep(pstate, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    return got, want


@pytest.mark.parametrize("spec,rounds", [("ring", 120), ("dense", 3)])
def test_mnist_curves_match_reference(spec, rounds):
    """Every round's loss and consensus error (module docstring); the
    onepeer-exp case is in ``tests/test_torch_mnist_onepeer.py``."""
    assert_curves(spec, rounds)


def assert_curves(spec, rounds):
    """The curves on ``spec`` held to the reference's (module docstring)."""
    got, want = _curves(spec, rounds)
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= LOSS_ATOL, (r, got[r], want[r])
        assert abs(ge - we) <= ERR_RTOL * we, (r, got[r], want[r])
    assert got[-1][0] < got[0][0]
    if spec == "dense":
        assert all(e == 0.0 for _, e in got)
    else:
        assert got[-1][0] < 1e-2 * got[0][0] and got[-1][1] < 1e-2 * got[0][1]


def test_train_cli_mnist_topologies_and_eval_on_cpu(capsys):
    from consensusml_tpu_torch.train.__main__ import main

    argv = ["--device", "cpu", "--config", "mnist_mlp", "--scale", "smoke", "--rounds", "5", "--eval-batches", "2"]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "codec: none (exact gossip); dense bucketed wire"
    assert "4 workers on cpu, 50890 params per worker, 1 buckets, topology dense" in out[1]
    rounds = [line.split() for line in out if line.startswith("round ")]
    assert len(rounds) == 5 and all(float(r[r.index("consensus_error") + 1]) == 0.0 for r in rounds)
    assert out[-2].startswith("eval[mean-model]: top1=") and out[-1].startswith("eval[worker-avg]: top1=")
    assert 0.0 <= float(out[-2].split("top1=")[1]) <= 1.0
    assert main(argv + ["--topology", "onepeer-exp"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "topology onepeer-exp, period 2" in out[1] and out[-2].startswith("eval[mean-model]: top1=")
    errs = [float(r.split()[r.split().index("consensus_error") + 1]) for r in out if r.startswith("round ")]
    assert errs[-1] < errs[0]
    assert main(["--device", "cpu", "--config", "cifar_resnet50", "--rounds", "2", "--topology", "torus"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "8 workers on cpu" in out[2] and "topology torus" in out[2]
    assert main(["--device", "cpu", "--config", "mnist_mlp", "--topology", "hierarchical:slices=3"]) == 2
    assert "error: bad --topology 'hierarchical:slices=3'" in capsys.readouterr().err
    assert main(["--device", "cpu", "--config", "mnist_mlp", "--topology", "hierarchical:slices"]) == 2
