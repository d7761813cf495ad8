"""The port's ResNet against the JAX package's, on the CPU.

With the same variables (the port's numpy-seeded init, BN scales, biases
and running statistics then perturbed so no branch is zero, handed to
both as numpy), the smoke ``cifar_resnet50`` model (``ResNet([1, 1],
BottleneckBlock, width 8)``), ``resnet18`` and a one-stage ImageNet-stem
model, each in f32 under both norm impls (the port's ``"flax"`` against
flax ``nn.BatchNorm``; the port's ``"pallas"`` against the reference's
``FusedBatchNorm`` in ``impl="interpret"``): training-mode logits, loss,
every parameter's gradient and the updated ``batch_stats``, then
eval-mode logits on the updated statistics.

Tolerances: f32 on both sides with other summation orders (convolutions
by oneDNN against XLA). Read: logits within 8.1e-7 of max|logit|, the
worst leaf's gradient within 1.0e-5 of its largest element, statistics
within 4.8e-7. Held at 1e-5, 1e-4 and 1e-5; a wrong padding, a missing projection
or a BN that does not flow through its statistics moves them by 1e-2 or
more.

Shapes only, at full size: the port's ResNet-50 tree has the reference's
names, shapes and flatten order (161 parameter leaves, 23,520,842
parameters, 53,120 statistics), and its gossiped tree packs into the
reference's 23 dense buckets, under either norm impl.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.models.losses import softmax_cross_entropy as jax_xent
from consensusml_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from consensusml_tpu.models.resnet import ResNet as JaxResNet
from consensusml_tpu.models.resnet import resnet18 as jax_resnet18
from consensusml_tpu.models.resnet import resnet50 as jax_resnet50
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.models.convert import resnet_from_flax, resnet_init_params
from consensusml_tpu_torch.models.losses import softmax_cross_entropy
from consensusml_tpu_torch.models.resnet import BottleneckBlock, ResNet, resnet18, resnet50, resnet_loss_fn

JAX_IMPL = {"flax": "flax", "pallas": "interpret"}
MODELS = {
    "smoke": (
        lambda ni: JaxResNet(stage_sizes=[1, 1], block=JaxBottleneck, num_classes=10, width=8, stem="cifar",
                             dtype=jnp.float32, norm_impl=ni),
        lambda ni: configs.resnet_model("smoke", ni),
        (8, 16, 16, 3),
    ),
    "resnet18": (
        lambda ni: jax_resnet18(dtype=jnp.float32, norm_impl=ni),
        lambda ni: resnet18(dtype=torch.float32, norm_impl=ni, device="meta"),
        (2, 16, 16, 3),
    ),
    "imagenet_stem": (
        lambda ni: JaxResNet(stage_sizes=[1], block=JaxBottleneck, num_classes=10, width=8, stem="imagenet",
                             dtype=jnp.float32, norm_impl=ni),
        lambda ni: ResNet([1], BottleneckBlock, num_classes=10, width=8, stem="imagenet", dtype=torch.float32,
                          norm_impl=ni, device="meta"),
        (4, 18, 18, 3),
    ),
}


def _path(keys) -> str:
    return ".".join(str(k.key) for k in keys)


def _flat(tree) -> dict:
    return {_path(p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _variables(model, seed):
    """One worker's numpy variables: the port's init, perturbed."""
    v = resnet_init_params(model, seed, 1)
    rng = np.random.default_rng(seed + 1)
    out = {"params": {}, "batch_stats": {}}
    for col, leaves in v.items():
        for name, a in leaves.items():
            a = a[0]
            leaf = name.rsplit(".", 1)[1]
            noise = rng.normal(size=a.shape).astype(np.float32)
            if leaf in ("scale", "bias", "mean"):
                a = a + np.float32(0.1) * noise
            elif leaf == "var":
                a = a + np.float32(0.2) * np.abs(noise)
            out[col][name] = a
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, a in flat.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


@pytest.mark.parametrize("norm_impl", ["flax", "pallas"])
@pytest.mark.parametrize("name", list(MODELS))
def test_resnet_matches_reference(name, norm_impl):
    jax_model, port_model, shape = MODELS[name]
    jm, tm = jax_model(JAX_IMPL[norm_impl]), port_model(norm_impl)
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, 10, size=shape[0]).astype(np.int32)
    v = _variables(tm, seed=3)
    jv = {"params": _nest(v["params"]), "batch_stats": _nest(v["batch_stats"])}

    def jax_loss(params, stats):
        logits, upd = jm.apply({"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return jax_xent(logits, labels), (logits, upd["batch_stats"])

    (loss, (logits, new_stats)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jv["params"], jv["batch_stats"])
    eval_logits = jax.jit(lambda v: jm.apply(v, x, train=False))({"params": jv["params"], "batch_stats": new_stats})
    grads, new_stats = _flat(grads), _flat(new_stats)

    params, model_state = resnet_from_flax(jv)
    assert list(params) == list(grads)  # names and flatten order
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    stats = {n: t.clone() for n, t in model_state["batch_stats"].items()}
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels)
    t_logits = functional_call(tm, {**leaves, **stats}, (tx,), {"train": True})
    t_loss = softmax_cross_entropy(t_logits, tl)
    t_grads = dict(zip(leaves, torch.autograd.grad(t_loss, list(leaves.values()))))
    with torch.no_grad():
        t_eval = functional_call(tm, {**params, **stats}, (tx,), {"train": False})

    scale = np.abs(np.asarray(logits)).max()
    assert np.abs(t_logits.detach().numpy() - np.asarray(logits)).max() <= 1e-5 * scale
    assert abs(float(t_loss.detach()) - float(loss)) <= 1e-5
    for n, g in t_grads.items():
        want = np.asarray(grads[n])
        assert np.abs(g.numpy() - want).max() <= 1e-4 * np.abs(want).max() + 1e-8, n
    for n, s in stats.items():
        np.testing.assert_allclose(s.numpy(), np.asarray(new_stats[n]), atol=1e-5, rtol=0, err_msg=n)
    scale = np.abs(np.asarray(eval_logits)).max()
    assert np.abs(t_eval.numpy() - np.asarray(eval_logits)).max() <= 1e-5 * scale

    # the trainer's loss function: the same loss and statistics, the caller's left alone
    before = {n: t.clone() for n, t in model_state["batch_stats"].items()}
    loss2, new2 = resnet_loss_fn(tm)(params, model_state, {"image": tx, "label": tl}, None)
    assert torch.equal(loss2, t_loss.detach())
    assert all(torch.equal(new2["batch_stats"][n], stats[n]) for n in stats)
    assert all(torch.equal(model_state["batch_stats"][n], before[n]) for n in before)


def _reference_full_tree(norm_impl):
    model = jax_resnet50(num_classes=10, stem="cifar", norm_impl=JAX_IMPL[norm_impl])
    v = jax.eval_shape(lambda r: model.init(r, jnp.zeros((1, 32, 32, 3)), train=True), jax.random.key(0))
    return {"params": v["params"], "model_state": {"batch_stats": v["batch_stats"]}}


@pytest.mark.parametrize("norm_impl", ["flax", "pallas"])
def test_full_resnet50_tree_and_bucket_plan_match_reference(norm_impl):
    want = _reference_full_tree(norm_impl)
    model = resnet50(num_classes=10, stem="cifar", norm_impl=norm_impl, device="meta")
    got = {
        "params": dict(model.named_parameters()),
        "model_state": {"batch_stats": dict(model.named_buffers())},
    }
    w_params, w_stats = _flat(want["params"]), _flat(want["model_state"]["batch_stats"])
    g_params = dict(sorted(got["params"].items(), key=lambda kv: tuple(kv[0].split("."))))
    assert list(g_params) == list(w_params)
    assert [tuple(p.shape) for p in g_params.values()] == [a.shape for a in w_params.values()]
    assert sorted(got["model_state"]["batch_stats"]) == sorted(w_stats)
    assert len(w_params) == 161 and sum(p.numel() for p in g_params.values()) == 23_520_842
    assert sum(b.numel() for b in got["model_state"]["batch_stats"].values()) == 53_120
    bn = [m for m in model.modules() if type(m).__name__ in ("BatchNorm", "FusedBatchNorm")]
    assert len(bn) == 53 and sum(m.act == "relu" for m in bn) == 33

    bundle = configs.build("cifar_resnet50", "full", norm_impl=norm_impl, device="cpu")
    plan = bundle.cfg.engine().bucket_plan(got)
    ref = jax_configs.build("cifar_resnet50", "full").cfg.engine().bucket_plan(want)
    assert plan.num_buckets == ref.num_buckets == 23
    assert [b.total for b in plan.buckets] == [b.total for b in ref.buckets]
    assert [[bl.index for bl in b.leaves] for b in plan.buckets] == [
        [bl.index for bl in b.leaves] for b in ref.buckets
    ]


def test_init_params_follow_flax_schemes():
    """The port's numpy init: lecun-normal kernels (truncated at 2 std),
    the zero-init last BN scale of each block, unit scales elsewhere, zero
    biases and means, unit variances; stacked workers differ."""
    model = configs.resnet_model("smoke", "pallas")
    v = resnet_init_params(model, seed=0, world_size=2)
    p, s = v["params"], v["batch_stats"]
    k = p["BottleneckBlock_0.Conv_1.kernel"]  # (2, 3, 3, 8, 8): fan-in 72
    std = np.sqrt(1.0 / 72) / 0.87962566103423978
    assert k.shape == (2, 3, 3, 8, 8) and np.abs(k).max() <= 2 * std + 1e-6
    assert abs(k.std() - std * 0.8796) < 0.15 * std and not np.array_equal(k[0], k[1])
    assert np.all(p["BottleneckBlock_0.FusedBatchNorm_2.scale"] == 0)
    assert np.all(p["BottleneckBlock_0.FusedBatchNorm_0.scale"] == 1)
    assert np.all(p["Dense_0.bias"] == 0) and np.all(s["FusedBatchNorm_0.var"] == 1)
    assert list(p) == sorted(p, key=lambda n: tuple(n.split(".")))
    # the draws do not depend on the BN kind: only the BN layers' names differ
    flax = resnet_init_params(configs.resnet_model("smoke", "flax"), seed=0, world_size=2)["params"]
    assert {n.replace("BatchNorm_", "FusedBatchNorm_") for n in flax} == set(p)
    assert all(np.array_equal(a, p[n.replace("BatchNorm_", "FusedBatchNorm_")]) for n, a in flax.items())
