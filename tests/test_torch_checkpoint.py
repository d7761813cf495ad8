"""Checkpoint and resume of the port on the simulated backend
(``consensusml_tpu_torch/utils/checkpoint.py``); the CLI and the
collective backend are in ``tests/test_torch_collective_resume.py``.

Resume is bit for bit: a run of four rounds and a run of two, saved
through ``AsyncSaver`` (its write beside the next rounds), restored into
a freshly built state and continued for two, end in the same state, every
tensor equal to the bit (parameters, model state, the optimizer's
moments, counts, schedule count and clip norms, SlowMo's ``x``/``u``, the
gossip state), the same generators' states and the same round. Held on
``mnist_mlp`` with every long-run flag (4 workers) and on the narrow
ResNet (``cifar_resnet50`` smoke, the fused BN's plain versions) with SGD
(2 workers). A state built with other flags, or another world size, is
refused; a write that fails raises at ``wait``. ``state_from_reference``
builds on the card unless asked for the CPU.
"""

import os

import pytest
import torch

from consensusml_tpu_torch import configs
from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.utils.checkpoint import (
    AsyncSaver,
    checkpoint_round,
    checkpoint_world_size,
    restore_state,
    save_state,
    state_from_reference,
)



def _load(path):
    """Every worker file of a checkpoint directory, in worker order."""
    files = sorted(f for f in os.listdir(path) if f.startswith("worker_"))
    return [torch.load(os.path.join(path, f), weights_only=True) for f in files]


def assert_checkpoints_equal(a, b, rtol=0.0):
    ra, rb = _load(a), _load(b)
    assert len(ra) == len(rb) and checkpoint_round(a) == checkpoint_round(b)
    for wa, wb in zip(ra, rb):
        assert wa["paths"] == wb["paths"] and wa["round"] == wb["round"]
        for p, x, y in zip(wa["paths"], wa["tensors"], wb["tensors"]):
            if rtol == 0.0 or not x.is_floating_point():
                assert torch.equal(x, y), p
            else:
                torch.testing.assert_close(x, y, rtol=rtol, atol=1e-7, msg=p)
        if rtol == 0.0:
            assert torch.equal(wa["generator"], wb["generator"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh(bundle):
    params, model_state = configs.init_on_device(bundle, 0, "cpu")
    return init_stacked_state(bundle.cfg, params, bundle.world_size, seed=0, model_state=model_state,
                              frozen=configs.frozen_on_device(bundle, "cpu"))


@pytest.mark.parametrize("config,flags", [
    ("mnist_mlp", dict(lr_schedule="cosine", warmup_rounds=1, grad_clip=1.0, slowmo_beta=0.2)),
    ("cifar_resnet50", dict(lr_schedule="linear", warmup_rounds=1, grad_clip=0.5)),
])
def test_simulated_resume_is_bit_for_bit(tmp_path, config, flags):
    world, norm_impl = (4, "flax") if config == "mnist_mlp" else (2, "pallas")
    bundle = configs.build(config, "smoke", world=world, device="cpu", norm_impl=norm_impl)
    configs.with_train_flags(bundle, rounds=4, **flags)
    batches = list(bundle.batches(4, 0))
    step = make_simulated_train_step(bundle.cfg, bundle.loss_fn)
    a = _fresh(bundle)
    for batch in batches:
        a, _ = step(a, batch)
    b = _fresh(bundle)
    for batch in batches[:2]:
        b, _ = step(b, batch)
    saver = AsyncSaver()
    saver.submit(str(tmp_path), b, step=2)
    for batch in batches[2:]:  # the write runs beside these rounds: it holds round 2's copy
        b, _ = step(b, batch)
    saver.wait()
    path = saver.last_path
    assert path == str(tmp_path / "step_2") and checkpoint_round(path) == 2
    assert checkpoint_world_size(path) == bundle.world_size
    c = restore_state(path, _fresh(bundle))
    assert c.step == 2
    for batch in batches[2:]:
        c, _ = step(c, batch)
    save_state(str(tmp_path / "a"), a)
    save_state(str(tmp_path / "c"), c)
    assert_checkpoints_equal(str(tmp_path / "a"), str(tmp_path / "c"))
    with pytest.raises(ValueError, match="structure"):  # other flags, another optimizer state
        restore_state(path, _fresh(configs.build(config, "smoke", world=world, device="cpu")))
    with pytest.raises(ValueError, match="has 3"):
        restore_state(path, _fresh(configs.build(config, "smoke", world=3, device="cpu")))


def test_async_saver_raises_a_failed_write_at_wait(tmp_path):
    bundle = configs.build("mnist_mlp", "smoke", world=2, device="cpu")
    state = _fresh(bundle)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = AsyncSaver()
    saver.submit(str(blocker), state, step=1)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        saver.wait()
    saver.wait()  # the error is raised once
    with pytest.raises(ValueError, match="no cml_meta.json"):
        restore_state(str(tmp_path), state)


def test_state_from_reference_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = configs.build("mnist_mlp", "smoke", world=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_reference({}, bundle)
