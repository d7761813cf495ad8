"""Consensus-SGD training of ``gpt2_topk`` (smoke, ``--codec int8``) on the
port against the JAX package, from the same initial parameters (the
reference's per-worker flax init, converted) and the same batches.

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
"""

import jax
import numpy as np
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.compress import PallasInt8Compressor as JaxInt8
from consensusml_tpu.data.synthetic import SyntheticLM as JaxSyntheticLM
from consensusml_tpu.data.synthetic import lm_round_batches as jax_lm_round_batches
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.data import SyntheticLM, lm_round_batches
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

ROUNDS = 3


def test_lm_round_batches_identical():
    for vocab, seq, start in ((64, 16, 0), (50257, 40, 7)):
        want = list(jax_lm_round_batches(JaxSyntheticLM(vocab_size=vocab, seq_len=seq), 3, 2, 4, 2, seed=5, start=start))
        got = list(lm_round_batches(SyntheticLM(vocab_size=vocab, seq_len=seq), 3, 2, 4, 2, seed=5, start=start))
        for g, w in zip(got, want):
            assert g["input_ids"].dtype == torch.int32
            np.testing.assert_array_equal(g["input_ids"].numpy(), np.asarray(w["input_ids"]))


def _reference_run(seed):
    import dataclasses

    bundle = jax_configs.build("gpt2_topk", "smoke")
    # train.py --codec int8 off-TPU: the Pallas int8 codec in interpret mode
    gossip = dataclasses.replace(bundle.cfg.gossip, compressor=JaxInt8(chunk=128, impl="interpret"))
    cfg = dataclasses.replace(bundle.cfg, gossip=gossip)
    state = jax_init_stacked_state(cfg, bundle.init_params, jax.random.key(seed), bundle.world_size)
    init = jax.tree.map(np.asarray, state.params)
    step = jax_train_step(cfg, bundle.loss_fn)
    curves = []
    for batch in bundle.batches(ROUNDS, seed):
        state, m = step(state, batch)
        curves.append((float(m["loss"]), float(m["consensus_error"])))
    return init, curves, cfg.engine().fused_wire_active


def test_smoke_training_curves_match_reference():
    init, want, fused = _reference_run(seed=0)
    assert fused
    bundle = configs.build("gpt2_topk", "smoke", codec="int8", device="cpu")
    assert bundle.cfg.engine().fused_wire_active
    state = init_stacked_state(bundle.cfg, gpt2_from_flax(init), bundle.world_size)
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    got = []
    for batch in bundle.batches(ROUNDS, 0):
        state, m = step(state, batch)
        got.append((float(m["loss"]), float(m["consensus_error"])))
    for r, ((gl, ge), (wl, we)) in enumerate(zip(got, want)):
        assert abs(gl - wl) <= 2e-3, (r, got, want)
        assert abs(ge - we) <= 1e-4 * we, (r, got, want)
    assert got[-1][1] < got[0][1]  # gossip contracts the disagreement


def test_train_cli_on_cpu(capsys):
    from consensusml_tpu_torch.train.__main__ import main

    assert main(["--device", "cpu", "--scale", "smoke", "--rounds", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("codec: int8/128 -> plain PyTorch versions") and "active=True" in out[0]
    rounds = [line for line in out if line.startswith("round ")]
    assert len(rounds) == 2 and all("consensus_error" in r and "round_ms" in r for r in rounds)
