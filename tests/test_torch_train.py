"""Consensus-SGD training of ``gpt2_topk`` and ``cifar_resnet50`` (smoke)
on the port against the JAX package, from the same initial parameters
(the reference's per-worker flax init, converted) and the same batches.
``gpt2_topk``: on ``--codec int8`` (the fused wire) and on the config's
own codec (chunked top-k + int8, the two-step wire; the smoke model packs
into one bucket, where the reference's jnp and kernel paths give the same
payloads). ``cifar_resnet50``: exact gossip of the weights and the BN
statistics, SGD with momentum, under both norm impls (the reference's
model rebuilt with ``norm_impl="interpret"`` against the port's
``"pallas"``, whose kernels' plain versions run on the CPU). The smoke
ResNet runs in f32 on both sides: its curves agree to 4.8e-7 (loss) and
1.2e-7 (relative consensus error) over three rounds (read), held at 1e-5
and 1e-5.

The fifth slice's path, ``--codec topk_int4 --norm-impl pallas`` (the
same top-k with int4 values, every LayerNorm the fused one), is held in
f32 against the reference with ``topk_int4_compressor(impl="interpret")``
and ``norm_impl="interpret"`` (at the smoke width its LayerNorm takes its
jnp path, the same math; tests/test_torch_fused_ln.py holds the Pallas
kernels at hidden 128), at the f32 top-k curves' tolerances.

The sixth slice's paths, ``--codec int4`` and ``--codec fp8`` (the fused
wire's other two formats), are held against the reference's Pallas codecs
in interpret mode at the config's precision, at the int8 fused wire's
tolerances.

The top-k curves are held twice. In f32 (the model computed in f32 in
both frameworks) they agree to ~2e-6 (loss) and ~3e-7 (relative
consensus error), well inside the tolerances below. In bf16, the
config's own precision, the two frameworks' Adam steps differ by up to
~2 lr in a few elements (see below), and top-k amplifies that: the 32
LayerNorm scales of a chunk all sit within ~6e-3 of 1.0, so which 13 of
128 are shipped is decided by that noise, and a flipped pick moves a
parameter by ~0.3 (read after round 0). Readings in bf16, loss and
relative consensus error: round 0 7.7e-4 and 3.2e-5 (inside the
tolerances below: the loss is taken before any pick, and the picks of
the first exchange mostly agree), round 1 3.6e-3 and 1.8e-4, round 2
1.2e-3 and 7.1e-5, the gossip being bit-exact
(tests/test_torch_consensus.py). So round 0 is held to the tolerances
below and the later rounds to 1e-2 and 1e-3 (about 3x and 5x the
readings, and still 20x and 100x below what a wrong round moves).

Tolerances (loss and consensus-error curves over three rounds): the two
frameworks run the bf16 model with different summation orders and bf16
rounding points (logits agree to ~6e-2 on this model,
tests/test_torch_gpt2.py), and Adam's first steps normalise each
gradient element by its own magnitude, so a tiny gradient difference can
move a parameter by up to ~2 lr = 6e-3. The mean loss (~4.3) agrees to
2e-3 absolute (7.7e-4 read) and the consensus error (5 to 13; it is
dominated by the workers' independent initialisations and the gossip,
which are bit-exact) to 1e-4 relative (1.2e-5 read). A wrong round — a
lost gossip step, a wrong bucket layout, a missing Adam bias correction
— moves them by far more (the consensus error drops by a third a round,
the loss by 0.2).

The tests are spread over four files so that the suite's workers
(``--dist loadfile``) can run them side by side: this one (the data, the
fused-BN ResNet curves, the GPT-2 CLI, and the helpers the others
import), ``tests/test_torch_train_resnet.py`` (the ResNet curves with
PyTorch's batch norm), ``tests/test_torch_train_fused.py`` (the fused
wire's three formats), ``tests/test_torch_train_topk.py`` (the config's
own codec and top-k + int4 with the fused LayerNorm) and
``tests/test_torch_train_cli.py`` (the ResNet CLI).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.compress import PallasFp8Compressor as JaxFp8
from consensusml_tpu.compress import PallasInt4Compressor as JaxInt4
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.compress.reference import topk_int4_compressor as jax_topk_int4
from consensusml_tpu.data.synthetic import SyntheticClassification as JaxSyntheticClassification
from consensusml_tpu.data.synthetic import SyntheticLM as JaxSyntheticLM
from consensusml_tpu.data.synthetic import lm_round_batches as jax_lm_round_batches
from consensusml_tpu.data.synthetic import round_batches as jax_round_batches
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu.models.gpt2 import gpt2_loss_fn as jax_gpt2_loss_fn
from consensusml_tpu.models.resnet import resnet_init as jax_resnet_init
from consensusml_tpu.models.resnet import resnet_loss_fn as jax_resnet_loss_fn
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.data import SyntheticClassification, SyntheticLM, lm_round_batches, round_batches
from consensusml_tpu_torch.models.convert import gpt2_from_flax, resnet_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2LM, gpt2_loss_fn
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS = 3


def test_lm_round_batches_identical():
    for vocab, seq, start in ((64, 16, 0), (50257, 40, 7)):
        want = list(jax_lm_round_batches(JaxSyntheticLM(vocab_size=vocab, seq_len=seq), 3, 2, 4, 2, seed=5, start=start))
        got = list(lm_round_batches(SyntheticLM(vocab_size=vocab, seq_len=seq), 3, 2, 4, 2, seed=5, start=start))
        for g, w in zip(got, want):
            assert g["input_ids"].dtype == torch.int32
            np.testing.assert_array_equal(g["input_ids"].numpy(), np.asarray(w["input_ids"]))


@pytest.mark.parametrize("n,image,start", [(512, 16, 0), (4096, 32, 5)])
def test_classification_round_batches_identical(n, image, start):
    """``cifar_resnet50``'s data at both scales' shapes: images and labels
    bit-equal to the reference's."""
    kw = dict(n=n, image_shape=(image, image, 3), noise=0.25)
    want = list(jax_round_batches(JaxSyntheticClassification(**kw), 8, 1, 8, 2, seed=3, start=start))
    got = list(round_batches(SyntheticClassification(**kw), 8, 1, 8, 2, seed=3, start=start))
    for g, w in zip(got, want):
        assert g["image"].dtype == torch.float32 and g["label"].dtype == torch.int32
        assert g["image"].shape == (8, 1, 8, image, image, 3)
        np.testing.assert_array_equal(g["image"].numpy(), np.asarray(w["image"]))
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))


@pytest.mark.parametrize("norm_impl", ["pallas"])
def test_resnet_smoke_training_curves_match_reference(norm_impl):
    """The fused-BN path; the ``"flax"`` case is in
    ``tests/test_torch_train_resnet.py`` (the same body, split so that the
    suite's workers can take the two apart)."""
    resnet_curves(norm_impl)


def resnet_curves(norm_impl):
    """The ResNet smoke curves against the reference's under ``norm_impl``
    (module docstring)."""
    bundle = jax_configs.build("cifar_resnet50", "smoke")
    model = bundle.model.clone(norm_impl="interpret" if norm_impl == "pallas" else "flax")
    init_fn = jax.jit(jax_resnet_init(model, (1, 16, 16, 3)))
    state = jax_init_stacked_state(bundle.cfg, init_fn, jax.random.key(0), bundle.world_size)
    init = {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.model_state["batch_stats"])}
    step = jax_train_step(bundle.cfg, jax_resnet_loss_fn(model))
    want = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        want.append((float(m["loss"]), float(m["consensus_error"])))

    port = configs.build("cifar_resnet50", "smoke", norm_impl=norm_impl, device="cpu")
    params, model_state = resnet_from_flax(init)
    pstate = init_stacked_state(port.cfg, params, port.world_size, model_state=model_state)
    pstep = make_simulated_train_step(port.cfg, port.loss_fn)
    got = []
    for batch in port.batches(ROUNDS, 0):
        pstate, m = pstep(pstate, batch)
        assert m["imgs_per_s"] > 0
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for (gl, ge), (wl, we) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 and abs(ge - we) <= 1e-5 * we, (got, want)
    assert got[-1][1] < got[0][1]
    # the BN statistics rode the gossip: the stacked state moved and stays finite
    stats = pstate.model_state["batch_stats"]
    stem_var = stats[("FusedBatchNorm_0" if norm_impl == "pallas" else "BatchNorm_0") + ".var"]
    assert all(torch.isfinite(t).all() for t in stats.values()) and not torch.all(stem_var == 1)


def _reference_run(seed, codec="int8", f32=False, norm_impl="flax"):
    import dataclasses

    bundle = jax_configs.build("gpt2_topk", "smoke")
    cfg = bundle.cfg
    loss_fn = bundle.loss_fn
    if f32:
        geom = dataclasses.replace(bundle.model.config, dtype=jnp.float32, norm_impl=norm_impl)
        loss_fn = jax_gpt2_loss_fn(JaxGPT2LM(config=geom))
    comp = {
        # train.py --codec int8|int4|fp8 off-TPU: the Pallas codec in interpret mode
        "int8": lambda: JaxInt8(chunk=128, impl="interpret"),
        "int4": lambda: JaxInt4(chunk=128, impl="interpret"),
        "fp8": lambda: JaxFp8(chunk=128, impl="interpret"),
        # train.py --codec topk_int4 at smoke scale, on the kernel path
        "topk_int4": lambda: jax_topk_int4(ratio=0.1, chunk=128, impl="interpret"),
    }.get(codec)
    if comp is not None:
        gossip = dataclasses.replace(bundle.cfg.gossip, compressor=comp())
        cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(seed), bundle.world_size)
    init = jax.tree.map(np.asarray, state.params)
    step = jax_train_step(cfg, loss_fn)
    curves = []
    for batch in bundle.batches(ROUNDS, seed):
        state, m = step(state, batch)
        curves.append((float(m["loss"]), float(m["consensus_error"])))
    return init, curves, cfg.engine().fused_wire_active


def _port_run(init, codec, f32=False, norm_impl="flax"):
    bundle = configs.build("gpt2_topk", "smoke", codec=codec, norm_impl=norm_impl, device="cpu")
    loss_fn = bundle.loss_fn
    if f32:
        loss_fn = gpt2_loss_fn(GPT2LM(configs.gpt2_config("smoke", torch.float32, norm_impl), device="meta"))
    state = init_stacked_state(bundle.cfg, gpt2_from_flax(init), bundle.world_size)
    step = make_simulated_train_step(bundle.cfg, loss_fn)
    got = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    return bundle, state, got


def _assert_curves_match(got, want, later=(2e-3, 1e-4)):
    """Loss within 2e-3 and consensus error within 1e-4 relative in round
    0; ``later`` holds the other rounds (bf16 top-k, module docstring)."""
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        loss_tol, err_tol = later if r else (2e-3, 1e-4)
        assert abs(gl - wl) <= loss_tol, (r, got, want)
        assert abs(ge - we) <= err_tol * we, (r, got, want)
    assert got[-1][1] < got[0][1]  # gossip contracts the disagreement


def test_train_cli_on_cpu(capsys):
    from consensusml_tpu_torch.train.__main__ import main

    # no --codec: the config's own (top-k + int8, the two-step wire)
    assert main(["--device", "cpu", "--scale", "smoke", "--rounds", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("codec: topk_int8/128 k=13 -> plain PyTorch versions")
    assert "two-step bucketed wire" in out[0] and "active=False" in out[0]
    rounds = [line for line in out if line.startswith("round ")]
    assert len(rounds) == 2 and all("consensus_error" in r and "round_ms" in r for r in rounds)
    # --codec int8 still rides the fused wire
    assert main(["--device", "cpu", "--scale", "smoke", "--rounds", "1", "--codec", "int8"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("codec: int8/128 -> plain PyTorch versions") and "active=True" in out[0]
    assert "fused one-pass bucketed wire" in out[0]
    # the fifth slice's path: top-k + int4 values, the fused LayerNorm
    argv = ["--device", "cpu", "--scale", "smoke", "--rounds", "2", "--codec", "topk_int4", "--norm-impl", "pallas"]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("codec: topk_int4/128 k=13 -> plain PyTorch versions") and "active=False" in out[0]
    assert out[1] == "LN: fused LN, plain PyTorch versions (norm_impl='pallas')"
    rounds = [line.split() for line in out if line.startswith("round ")]
    errs = [float(r[r.index("consensus_error") + 1]) for r in rounds]
    losses = [float(r[r.index("loss") + 1]) for r in rounds]
    assert len(rounds) == 2 and all(np.isfinite(losses)) and all(0 < e < float("inf") for e in errs)


@pytest.mark.parametrize("codec", ["int4", "fp8"])
def test_train_cli_fused_formats_on_cpu(capsys, codec):
    from consensusml_tpu_torch.train.__main__ import main

    assert main(["--device", "cpu", "--scale", "smoke", "--rounds", "2", "--codec", codec]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"codec: {codec}/128 -> plain PyTorch versions") and "active=True" in out[0]
    assert "fused one-pass bucketed wire" in out[0]
    rounds = [line.split() for line in out if line.startswith("round ")]
    errs = [float(r[r.index("consensus_error") + 1]) for r in rounds]
    losses = [float(r[r.index("loss") + 1]) for r in rounds]
    assert len(rounds) == 2 and all(np.isfinite(losses)) and 0 < errs[1] < errs[0]
