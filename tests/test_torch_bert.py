"""``bert_mlm`` on the port against the JAX package: the model
(``BertMLM`` through ``bert_from_flax``), its loss and gradients, the MLM
data and held-out batches, the masked-LM eval sums, the run bundle and
the full-scale bucket plan, and the smoke training curve; then the
collective backend on the CPU against the simulated one.

Parameters and token ids come from numpy seeds and feed both sides.

Tolerances. f32: both frameworks compute the same ops on the same values
in other summation orders: logits to 2e-5 (3.1e-6 read with and without
an attention mask), the loss to 1e-5 and every gradient to 2e-5 of its
leaf's largest element (loss 0, gradients 1.1e-6 read, against the jitted
reference). bf16: the
two round at slightly different places (XLA fuses elementwise chains
that ATen rounds one by one), a few bf16 ulps per layer, and this model
rounds more steps in bf16 than GPT-2 (the embedding sums, the MLM head),
so logits to 2.5e-2 of the largest |logit| (``chip_smoke.py``'s
``LOGITS_REL_TOL``): 2.0e-2 read against the jitted reference (0.080 on
logits up to 3.9), whose own eager and jitted programs differ by 1.6e-2
(0.0625). The training curves, three rounds of the smoke config (8
local Adam(1e-2) steps and a ring round each) from the reference's
per-worker init, at ``tests/test_torch_train.py``'s tolerances: in f32,
loss within 2e-3 absolute and consensus error within 1e-4 relative every
round (its round-0 limits); in bf16 within 1e-2 and 1e-3 every round (its
bf16 later-round limits: Adam's first steps normalise each gradient
element by its own size, so a bf16 rounding difference can move an
element by up to 2 lr, and here round 0 already holds eight such steps,
where GPT-2's holds two). Readings in the test's docstring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.configs import _lm_eval_batches as jax_lm_eval_batches
from consensusml_tpu.data.synthetic import SyntheticLM as JaxSyntheticLM
from consensusml_tpu.data.synthetic import lm_round_batches as jax_lm_round_batches
from consensusml_tpu.data.synthetic import mlm_corrupt as jax_mlm_corrupt
from consensusml_tpu.models.bert import BertConfig as JaxBertConfig
from consensusml_tpu.models.bert import BertMLM as JaxBertMLM
from consensusml_tpu.models.bert import bert_mlm_loss_fn as jax_bert_mlm_loss_fn
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu.train.evaluate import mlm_eval_fn as jax_mlm_eval_fn
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.data import SyntheticLM, lm_eval_batches, lm_round_batches, mlm_corrupt
from consensusml_tpu_torch.models.bert import BertConfig, BertMLM, bert_mlm_loss_fn
from consensusml_tpu_torch.models.convert import bert_from_flax, normal_init_params
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.evaluate import mlm_eval_fn
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

GEOM = dict(vocab_size=64, hidden=32, layers=2, heads=2, mlp_dim=64, max_len=32)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGITS_F32_TOL, LOGITS_BF16_REL_TOL = 2e-5, 2.5e-2
ROUNDS = 3


def random_flax_params(model, seed, seq=8):
    """The flax tree's structure with every leaf redrawn from numpy:
    LayerNorm scales near 1, everything else (biases included) nonzero."""
    tree = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, seq), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.normal(0.0, 0.2, size=leaf.shape).astype(np.float32)
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def pair(dtype_name, seed=0, dropout=0.0):
    jdt, tdt = DTYPES[dtype_name]
    jmodel = JaxBertMLM(config=JaxBertConfig(**GEOM, dropout=dropout, dtype=jdt))
    params = random_flax_params(jmodel, seed)
    tmodel = BertMLM(BertConfig(**GEOM, dropout=dropout, dtype=tdt), device="cpu")
    tmodel.load_state_dict(bert_from_flax(params))
    return jmodel, params, tmodel.eval()


def _batch(seed, b=3, s=16, masked=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 63, size=(b, s)).astype(np.int32)
    lens = [s, 11, 5][:b]
    mask = np.stack([np.arange(s) < n for n in lens]).astype(np.int32) if masked else None
    return ids, mask


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_bert_logits_match_reference(dtype_name, masked):
    jmodel, params, tmodel = pair(dtype_name)
    ids, mask = _batch(1, masked=masked)
    fn = jax.jit(jmodel.apply, static_argnames=("deterministic",))
    want = fn({"params": params}, jnp.asarray(ids), None if mask is None else jnp.asarray(mask), deterministic=True)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 16, 64)
    want = np.asarray(want, np.float32)
    if dtype_name == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=LOGITS_F32_TOL, atol=LOGITS_F32_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_BF16_REL_TOL * np.abs(want).max())


def test_bert_tree_matches_flax_layout():
    """The port's parameter names, shapes and flatten order are the flax
    tree's: ``qkv`` (hidden, heads, 3 d_head), ``out`` (heads, d_head,
    hidden), ``mlm_bias`` (vocab,), every leaf f32."""
    jmodel, params, tmodel = pair("f32")
    want = bert_from_flax(params)
    got = dict(tmodel.named_parameters())
    assert sorted(got) == sorted(want)
    assert all(tuple(got[n].shape) == tuple(t.shape) and got[n].dtype == torch.float32 for n, t in want.items())
    assert tuple(got["layer_0.qkv.kernel"].shape) == (32, 2, 48)
    assert tuple(got["layer_0.out.kernel"].shape) == (2, 16, 32)
    init = normal_init_params(tmodel, seed=0, world_size=2)
    assert list(init) == list(want)  # the reference's flatten order
    assert not np.array_equal(init["tok_emb.embedding"][0], init["tok_emb.embedding"][1])
    one = normal_init_params(tmodel, seed=0, world_size=2, ranks=[1])
    assert all(np.array_equal(one[n][0], init[n][1]) for n in init)
    assert (init["mlm_bias"] == 0).all() and (init["ln_emb.scale"] == 1).all()


@pytest.mark.parametrize("masked", [False, True])
def test_bert_loss_and_grads_match_reference(masked):
    """``bert_mlm_loss_fn`` (dropout 0, f32) and its gradient against
    ``jax.grad`` of the reference's, with and without an attention mask."""
    jmodel, params, tmodel = pair("f32")
    ids, mask = _batch(2, masked=masked)
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 63, size=ids.shape).astype(np.int32)
    mlm_mask = (rng.random(ids.shape) < 0.3).astype(np.float32)
    jbatch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels), "mlm_mask": jnp.asarray(mlm_mask)}
    tbatch = {"input_ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels),
              "mlm_mask": torch.from_numpy(mlm_mask)}
    if masked:
        jbatch["attention_mask"], tbatch["attention_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    jloss = jax_bert_mlm_loss_fn(jmodel)
    (want, _), wgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params, {}, jbatch, jax.random.key(0))
    leaves = {n: t.clone().requires_grad_() for n, t in bert_from_flax(params).items()}
    loss, state = bert_mlm_loss_fn(BertMLM(tmodel.config, device="meta"))(leaves, {}, tbatch, None)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert state == {}
    assert float(loss.detach()) == pytest.approx(float(want), abs=1e-5)
    for (name, got), want_g in zip(zip(leaves, grads), bert_from_flax(jax.tree.map(np.asarray, wgrads)).values()):
        scale = float(want_g.abs().max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want_g.numpy(), rtol=0, atol=2e-5 * scale, err_msg=name)


def test_mlm_data_bit_equal_to_reference():
    """``mlm_corrupt``, ``lm_round_batches(mlm_rate=0.15)`` (resumed at a
    later round too) and the held-out MLM batches: the reference's arrays
    bit for bit, in its dtypes (int32 ids and labels, f32 mask)."""
    for vocab, seq in ((64, 16), (30522, 128)):
        jdata, tdata = JaxSyntheticLM(vocab_size=vocab, seq_len=seq), SyntheticLM(vocab_size=vocab, seq_len=seq)
        assert tdata.mask_token == jdata.mask_token == vocab - 1
        ids = tdata.sample(np.random.default_rng(9), (2, 3))
        pairs = [(mlm_corrupt(ids, tdata, 4, 7, 0.15), jax_mlm_corrupt(ids, jdata, 4, 7, 0.15))]
        for start in (0, 5):
            pairs += zip(lm_round_batches(tdata, 3, 2, 4, 2, seed=5, start=start, mlm_rate=0.15),
                         jax_lm_round_batches(jdata, 3, 2, 4, 2, seed=5, start=start, mlm_rate=0.15))
        pairs += zip(lm_eval_batches(tdata, 4, 3, seed=2, mlm_rate=0.15),
                     jax_lm_eval_batches(jdata, 4, mlm_rate=0.15)(3, 2))
        for got, want in pairs:
            assert sorted(got) == sorted(want) == ["input_ids", "labels", "mlm_mask"]
            for key in want:
                w = np.asarray(want[key])
                assert got[key].numpy().dtype == w.dtype, key
                np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
            assert got["mlm_mask"].numpy().any() and (got["input_ids"].numpy()[got["mlm_mask"].numpy() > 0]
                                                      == vocab - 1).all()


def test_mlm_eval_fn_sums_match_reference():
    """The masked-position ``correct``, ``count`` and ``nll`` sums of one
    model on two held-out smoke batches (f32; the nll sum to 1e-5)."""
    jmodel, params, tmodel = pair("f32", seed=4)
    data = SyntheticLM(vocab_size=64, seq_len=16)
    jfn, tfn = jax.jit(jax_mlm_eval_fn(jmodel)), mlm_eval_fn(BertMLM(tmodel.config, device="meta"))
    tparams = bert_from_flax(params)
    for batch in lm_eval_batches(data, 8, 2, seed=0, mlm_rate=0.15):
        want = jfn(params, {}, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
        with torch.no_grad():
            got = tfn(tparams, {}, batch)
        assert float(got["count"]) == float(want["count"]) > 0
        assert float(got["correct"]) == float(want["correct"])
        assert float(got["nll"]) == pytest.approx(float(want["nll"]), rel=1e-5)


def _leaf_shapes_from_reference(bundle, seq):
    shapes = jax.eval_shape(bundle.init_params, jax.random.key(0))
    return shapes, jax.eval_shape(lambda r: bundle.model.init(r, jnp.zeros((1, seq), jnp.int32)), jax.random.key(0))


@pytest.mark.parametrize("scale", ["smoke", "full"])
def test_bundle_and_bucket_plan_match_reference(scale):
    """The run bundle's fields (world, h, lr, ring, exact gossip, batch
    shapes) and the bucket plan (bucket count, totals, leaf order) of the
    reference's ``bert_mlm``, from shapes only (``jax.eval_shape`` on the
    reference, the ``meta`` model on the port): BERT-base's 109,514,298
    parameters in 75 buckets of at most 4 MiB at full scale."""
    ref = jax_configs.build("bert_mlm", scale)
    port = configs.build("bert_mlm", scale, device="cpu")
    seq = 128 if scale == "full" else 16
    assert (port.world_size, port.cfg.h) == (ref.world_size, ref.cfg.h) == ((32, 8) if scale == "full" else (4, 8))
    assert port.cfg.optimizer.lr == ref.base_lr == (1e-4 if scale == "full" else 1e-2)
    assert port.cfg.gossip.topology.name == ref.cfg.gossip.topology.name == "ring"
    assert port.cfg.gossip.compressor is None and ref.cfg.gossip.compressor is None
    assert port.cfg.gossip.bucket_bytes == ref.cfg.gossip.bucket_bytes == 4 * 2**20
    assert port.model.config.max_len == ref.model.config.max_len
    for name in ("vocab_size", "hidden", "layers", "heads", "mlp_dim", "type_vocab", "dropout"):
        assert getattr(port.model.config, name) == getattr(ref.model.config, name), name
    want = jax.eval_shape(lambda r: ref.init_params(r), jax.random.key(0))
    got = dict(port.model.named_parameters())
    flat_want = {".".join(k.key for k in path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(got) == sorted(flat_want)
    if scale == "full":
        assert sum(p.numel() for p in got.values()) == 109_514_298
    ordered = {n: got[n] for n in flat_want}
    plan = port.cfg.engine().bucket_plan({"params": ordered, "model_state": {}})
    ref_plan = ref.cfg.engine().bucket_plan({"params": want, "model_state": {}})
    assert plan.num_buckets == ref_plan.num_buckets
    assert [b.total for b in plan.buckets] == [b.total for b in ref_plan.buckets]
    assert [[bl.index for bl in b.leaves] for b in plan.buckets] == [
        [bl.index for bl in b.leaves] for b in ref_plan.buckets
    ]
    if scale == "full":
        assert plan.num_buckets == 75
    batch = next(iter(port.batches(1, 0)))
    ref_batch = next(iter(ref.batches(1, 0)))
    assert {k: tuple(v.shape) for k, v in batch.items()} == {k: tuple(v.shape) for k, v in ref_batch.items()}
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(ref_batch[k]), err_msg=k)


def _reference_curve(f32: bool):
    import dataclasses

    bundle = jax_configs.build("bert_mlm", "smoke")
    loss_fn = bundle.loss_fn
    if f32:
        geom = dataclasses.replace(bundle.model.config, dtype=jnp.float32)
        loss_fn = jax_bert_mlm_loss_fn(JaxBertMLM(config=geom))
    # jitted: the eager flax init of four workers took ~12 s
    state = jax_init_stacked_state(bundle.cfg, jax.jit(bundle.init_params), jax.random.key(0), bundle.world_size)
    init = jax.tree.map(np.asarray, state.params)
    step = jax_train_step(bundle.cfg, loss_fn)
    curve = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        curve.append((float(m["loss"]), float(m["consensus_error"])))
    return init, curve


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_smoke_training_curves_match_reference(f32):
    """Three rounds of ``bert_mlm`` smoke (4 workers, 8 local Adam steps,
    one exact ring round each) from the reference's per-worker init: loss
    and consensus error each round, at the module docstring's tolerances.
    Readings, loss and relative consensus error by round: bf16 1.8e-3 and
    1.3e-5, 1.0e-3 and 4.8e-5, 4.0e-4 and 4.3e-6; f32 at most 4.8e-7 and
    9.2e-7."""
    init, want = _reference_curve(f32)
    bundle = configs.build("bert_mlm", "smoke", device="cpu")
    loss_fn = bundle.loss_fn
    if f32:
        loss_fn = bert_mlm_loss_fn(BertMLM(BertConfig(**GEOM, dropout=0.0, dtype=torch.float32), device="meta"))
    state = init_stacked_state(bundle.cfg, bert_from_flax(init), bundle.world_size)
    step = make_simulated_train_step(bundle.cfg, loss_fn)
    got = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        loss_tol, err_tol = (2e-3, 1e-4) if f32 else (1e-2, 1e-3)
        assert abs(gl - wl) <= loss_tol, (r, got, want)
        assert abs(ge - we) <= err_tol * we, (r, got, want)
    assert got[-1][1] < got[0][1] and got[-1][0] < got[0][0]


@pytest.mark.parametrize("name", ["bert_mlm", "cifar_resnet50", "gpt2_topk", "mnist_mlp"])
def test_init_on_device_equals_the_stacked_draw(name, monkeypatch):
    """``bundle.init_params(seed)`` and ``configs.init_on_device`` (workers
    drawn a few at a time in threads, here three, so the smoke configs' 4
    or 8 workers span several draws) give every config's serial stacked
    draw of all its ranks bit for bit, in its order."""
    from consensusml_tpu_torch.utils import tree as T

    monkeypatch.setattr(configs, "_INIT_THREADS", 3)
    bundle = configs.build(name, "smoke", device="cpu")
    serial = bundle.init_params(3, ranks=list(range(bundle.world_size)))
    threaded = bundle.init_params(3)
    assert T.flatten(threaded)[1] == T.flatten(serial)[1]
    assert all(np.array_equal(a, b) for a, b in zip(T.leaves(threaded), T.leaves(serial)))
    params, model_state = configs.init_on_device(bundle, 3, "cpu")
    want, want_state = bundle.convert(serial)
    assert list(params) == list(want) and all(torch.equal(params[n], want[n]) for n in want)
    assert [torch.equal(a, b) for a, b in zip(T.leaves(model_state), T.leaves(want_state))] == [True] * len(
        T.leaves(want_state))


def test_train_cli_bert_mlm_on_cpu(capsys):
    """``--config bert_mlm --device cpu`` trains and scores held-out
    batches; without ``--device cpu`` and without a GPU it raises."""
    from consensusml_tpu_torch.train.__main__ import main

    assert main(["--config", "bert_mlm", "--device", "cpu", "--rounds", "2", "--eval-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert "bert_mlm/smoke: 4 workers on cpu" in out and "codec: none (exact gossip)" in out
    assert "round 1: loss" in out and "eval[mean-model]:" in out and "top1=" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", "bert_mlm", "--rounds", "1"])


def test_collective_bert_round_matches_simulated():
    """``bert_mlm`` smoke at world 2 over ``gloo`` on the CPU, one round:
    every rank gets the simulated step's loss (rtol 1e-5, atol 1e-6) and
    the simulated parameters (rtol 1e-5, atol 1e-5), the tolerances of
    ``tests/test_torch_collective_engine.py``'s train steps. A ring of two
    averages both workers, so the simulated consensus error is 0 and each
    rank's, after sums in another order, a rounding residue: held below
    1e-5 (5.3e-7 read, on parameters of RMS ~0.02 per element)."""
    spec = {"config": "bert_mlm", "scale": "smoke", "workers": 2, "codec": None, "gamma": None,
            "codec_warmup": None, "norm_impl": "flax", "topology": None, "seed": 0, "device": "cpu",
            "dist_backend": "gloo", "log_every": 1, "return_params": True, "rounds": 1}
    bundle = configs.build("bert_mlm", "smoke", world=2, device="cpu")
    params, _ = bundle.convert(bundle.init_params(0))
    state = init_stacked_state(bundle.cfg, params, 2)
    state, m = make_simulated_train_step(bundle.cfg, bundle.loss_fn)(state, next(iter(bundle.batches(1, 0))))
    got = launch(collective.train_rank, 2, spec, timeout=120.0)
    for g in got:
        assert g["rounds"][0]["loss"] == pytest.approx(float(m["loss"]), rel=1e-5, abs=1e-6)
        assert float(m["consensus_error"]) == 0.0 and g["rounds"][0]["consensus_error"] < 1e-5
    for name, p in state.params.items():
        np.testing.assert_allclose(np.stack([g["params"][name] for g in got]), p.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
