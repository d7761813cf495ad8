"""``evaluate`` on stacked states (the MLP, the ResNet with its running
statistics, GPT-2's next-token nll) and ``gpt2_topk`` smoke on
``--topology onepeer-exp``, against the JAX package: moved here from
``tests/test_torch_mnist.py`` unchanged, so that the suite's workers can
run the two files side by side.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.data.synthetic import SyntheticLM as JaxSyntheticLM
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from consensusml_tpu.models.resnet import resnet_init as jax_resnet_init
from consensusml_tpu.topology import topology_from_name as jax_topology
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu.train.evaluate import causal_lm_eval_fn as jax_causal_lm_eval_fn
from consensusml_tpu.train.evaluate import evaluate as jax_evaluate
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.data import SyntheticLM, lm_eval_batches
from consensusml_tpu_torch.models.convert import gpt2_from_flax, mlp_from_flax, resnet_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2LM, gpt2_loss_fn
from consensusml_tpu_torch.train.evaluate import causal_lm_eval_fn, evaluate
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from test_torch_mnist import _mlp_variables

def _stacked(variables_np, world, seed):
    """``world`` perturbed copies of a numpy tree (leading worker axis)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.stack([x + 0.05 * rng.normal(size=x.shape).astype(np.float32) * (r > 0)
                            for r in range(world)]).astype(np.float32), variables_np)


def test_evaluate_mlp_matches_reference():
    """Top-1 of every worker and of the mean model, on the stacked state,
    equal to the reference's ``evaluate`` over the same held-out batches."""
    jmodel, variables = _mlp_variables()
    stacked = _stacked({"params": variables["params"]}, 4, seed=1)
    bundle = jax_configs.build("mnist_mlp", "smoke")
    jstate = types.SimpleNamespace(params=jax.tree.map(jnp.asarray, stacked["params"]), model_state={})
    want = jax_evaluate(bundle.eval_fn, jstate, bundle.eval_batches(4, 0))
    port = configs.build("mnist_mlp", "smoke", device="cpu")
    params, model_state = mlp_from_flax(stacked)
    got = evaluate(port.eval_fn, types.SimpleNamespace(params=params, model_state=model_state),
                   port.eval_batches(4, 0))
    np.testing.assert_array_equal(got["per_worker"]["top1"], want["per_worker"]["top1"])
    assert got["mean_model"]["top1"] == want["mean_model"]["top1"]
    assert got["worker_mean"] == want["worker_mean"]


def test_evaluate_resnet_and_gpt2_match_reference():
    """The ResNet (smoke, f32) with its running statistics (``train=False``)
    and GPT-2's next-token nll (smoke, f32): top-1 equal; nll and
    perplexity to 1e-5 relative (f32 logits in another summation order)."""
    rb = jax_configs.build("cifar_resnet50", "smoke")
    init_fn = jax.jit(jax_resnet_init(rb.model, (1, 16, 16, 3)))
    params0, model_state0 = jax.tree.map(np.asarray, init_fn(jax.random.key(0)))
    stacked = _stacked({"params": params0, "batch_stats": model_state0["batch_stats"]}, 8, seed=2)
    jstate = types.SimpleNamespace(params=stacked["params"], model_state={"batch_stats": stacked["batch_stats"]})
    want = jax_evaluate(rb.eval_fn, jstate, rb.eval_batches(2, 0))
    port = configs.build("cifar_resnet50", "smoke", device="cpu")
    params, model_state = resnet_from_flax(stacked)
    got = evaluate(port.eval_fn, types.SimpleNamespace(params=params, model_state=model_state),
                   port.eval_batches(2, 0))
    np.testing.assert_array_equal(got["per_worker"]["top1"], want["per_worker"]["top1"])
    assert got["mean_model"]["top1"] == want["mean_model"]["top1"]

    gb = jax_configs.build("gpt2_topk", "smoke")
    geom = dataclasses.replace(gb.model.config, dtype=jnp.float32)
    jmodel = JaxGPT2LM(config=geom)
    gvars = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1), jnp.zeros((1, 16), jnp.int32)))
    gstacked = _stacked({"params": gvars["params"]}, 4, seed=3)
    eval_fn = jax_causal_lm_eval_fn(jmodel)
    want = jax_evaluate(eval_fn, types.SimpleNamespace(params=gstacked["params"], model_state={}),
                        gb.eval_batches(2, 0))
    port = configs.build("gpt2_topk", "smoke", device="cpu")
    model = GPT2LM(configs.gpt2_config("smoke", torch.float32), device="meta")
    state = types.SimpleNamespace(params=gpt2_from_flax(gstacked["params"]), model_state={})
    got = evaluate(causal_lm_eval_fn(model), state, port.eval_batches(2, 0))
    for key in ("nll", "ppl"):
        np.testing.assert_allclose(got["per_worker"][key], want["per_worker"][key], rtol=1e-5)
        assert got["mean_model"][key] == pytest.approx(float(want["mean_model"][key]), rel=1e-5)
    # the held-out LM stream is the reference's
    for g, w in zip(lm_eval_batches(SyntheticLM(vocab_size=64, seq_len=16), 8, 3, seed=4),
                    jax_configs._lm_eval_batches(JaxSyntheticLM(vocab_size=64, seq_len=16), 8)(3, 4)):
        np.testing.assert_array_equal(g["input_ids"].numpy(), np.asarray(w["input_ids"]))


def test_gpt2_topk_on_onepeer_exp_matches_reference():
    """``gpt2_topk`` smoke ``--topology onepeer-exp``: CHOCO through top-k +
    int8 (the two-step wire, the plain versions) on a time-varying graph
    of period 2, three rounds in f32 on both sides, at the f32 top-k
    curves' tolerances (``tests/test_torch_train.py``: loss 2e-3, consensus
    error 1e-4 relative)."""
    bundle = jax_configs.build("gpt2_topk", "smoke")
    geom = dataclasses.replace(bundle.model.config, dtype=jnp.float32)
    cfg = dataclasses.replace(bundle.cfg, gossip=dataclasses.replace(
        bundle.cfg.gossip, topology=jax_topology("onepeer-exp", bundle.world_size)))
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(0), bundle.world_size)
    init = jax.tree.map(np.asarray, state.params)
    step = jax_train_step(cfg, jax_gpt2_loss_fn(JaxGPT2LM(config=geom)))
    want = []
    for batch in bundle.batches(3, 0):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["consensus_error"])))
    port = configs.build("gpt2_topk", "smoke", topology="onepeer-exp", device="cpu")
    topo = port.cfg.gossip.topology
    assert topo.is_time_varying and topo.period == 2 and not port.cfg.engine().fused_wire_active
    loss_fn = gpt2_loss_fn(GPT2LM(configs.gpt2_config("smoke", torch.float32), device="meta"))
    pstate = init_stacked_state(port.cfg, gpt2_from_flax(init), port.world_size)
    pstep = make_simulated_train_step(port.cfg, loss_fn)
    got = []
    for batch in port.batches(3, 0):
        pstate, m = pstep(pstate, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= 2e-3 and abs(ge - we) <= 1e-4 * we, (r, got, want)

