"""The train CLI's checkpoints and resume on both backends and across them
(``--checkpoint-dir``/``--checkpoint-every``/``--resume``; the library's
simulated resume is in ``tests/test_torch_checkpoint.py``).

The acceptance commands on ``mnist_mlp`` at 2 workers with every
long-run flag: a straight run of 4 rounds on each backend saving every 2,
then the collective backend resumed from its own round-2 checkpoint and
from the simulated one's, and the simulated backend from the collective
one's, 2 rounds each. Each resumed run prints its source's round lines
for rounds 2 and 3, loss, consensus error and learning rate to the last
printed digit. Its final checkpoint equals its backend's straight run's
bit for bit when it resumed its own backend's checkpoint, and to 1e-6
relative across backends (the collective gossip sums as a chain of
multiply-adds, the simulated one as ``W @ x``: a few roundings apart).
The narrow ResNet (``cifar_resnet50`` smoke, the fused BN's plain
versions, 2 ranks) resumes bit for bit on the collective backend too; the
library's simulated resume is in ``tests/test_torch_checkpoint.py``.

The straight collective run also exports its consensus mean for serving
(``--export-serving``) at each checkpoint: rank 0 writes the ranks'
all-reduce mean, generations 1 and 2, equal to the mean of the last
checkpoint's workers.

The collective runs of each case share one spawn of ranks
(``collective.train_runs`` over the CLI's parsed flags, as
``_main_collective`` builds them): a run reads the checkpoint the one
before it wrote.
"""

import os

import pytest
import torch

from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.serve.export import load_serving
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.__main__ import main, parse_args
from consensusml_tpu_torch.utils.checkpoint import checkpoint_round

FLAGS = ["--lr-schedule", "cosine", "--warmup-rounds", "1", "--grad-clip", "1.0", "--slowmo-beta", "0.2"]
COLL = ["--backend", "collective", "--dist-backend", "gloo"]
CROSS_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _rounds(out: str) -> dict[int, str]:
    """Each round line's loss, consensus error and learning rate, as printed."""
    got = {}
    for line in out.splitlines():
        if line.startswith("round "):
            words = line.split()
            got[int(words[1].rstrip(":"))] = " ".join(
                words[words.index(k) + 1] for k in ("loss", "consensus_error", "lr"))
    return got


def _collective(argvs: list[list[str]], sched_starts: list[int], capfd) -> list[dict[int, str]]:
    """The collective runs of ``argvs`` in one spawn of 2 ranks, in turn;
    each run's printed rounds (rank 0's lines, split at each run's
    checkpoint line)."""
    specs = [{**vars(parse_args(argv + COLL)), "workers": 2, "sched_start": start}
             for argv, start in zip(argvs, sched_starts)]
    launch(collective.train_runs, 2, specs, threads=1)
    runs = capfd.readouterr().out.split("checkpoint: ")
    return [_rounds(r) for r in runs[: len(argvs)]]


def test_cli_resume_on_both_backends_and_across(tmp_path, capfd):
    """The acceptance commands on ``mnist_mlp`` at 2 workers (module
    docstring)."""
    base = ["--device", "cpu", "--config", "mnist_mlp", "--workers", "2", *FLAGS]
    ckpt = lambda d: ["--checkpoint-dir", str(tmp_path / d)]  # noqa: E731
    resume = lambda d: ["--rounds", "2", "--resume", str(tmp_path / d / "step_2")]  # noqa: E731
    assert main(base + ["--rounds", "4", *ckpt("sim"), "--checkpoint-every", "2"]) == 0
    sim = _rounds(capfd.readouterr().out)
    art = str(tmp_path / "coll_art")
    coll, coll_to_coll, sim_to_coll = _collective(
        [base + ["--rounds", "4", *ckpt("coll"), "--checkpoint-every", "2", "--export-serving", art],
         base + resume("coll") + ckpt("coll_to_coll"), base + resume("sim") + ckpt("sim_to_coll")], [0, 2, 2], capfd)
    assert main(base + resume("coll") + ckpt("coll_to_sim")) == 0
    out = capfd.readouterr().out
    assert f"resumed from {tmp_path / 'coll' / 'step_2'} at round 2" in out
    coll_to_sim = _rounds(out)
    assert sorted(sim) == [0, 1, 2, 3] and sim == coll
    for got, src in ((coll_to_coll, coll), (sim_to_coll, sim), (coll_to_sim, coll)):
        assert got == {r: src[r] for r in (2, 3)}, (got, src)
    assert_checkpoints_equal(str(tmp_path / "coll" / "step_4"), str(tmp_path / "coll_to_coll" / "step_4"))
    assert_checkpoints_equal(str(tmp_path / "coll" / "step_4"), str(tmp_path / "sim_to_coll" / "step_4"), CROSS_RTOL)
    assert_checkpoints_equal(str(tmp_path / "sim" / "step_4"), str(tmp_path / "coll_to_sim" / "step_4"), CROSS_RTOL)
    meta, params, _ = load_serving(art)
    assert (meta["config_name"], meta["round"], meta["world_size"], meta["generation"]) == ("mnist_mlp", 4, 2, 2)
    workers = _load(str(tmp_path / "coll" / "step_4"))
    rows = [dict(zip(w["paths"], w["tensors"])) for w in workers]
    for name, got in params.items():
        assert torch.equal(got, (rows[0]["params." + name] + rows[1]["params." + name]) / 2), name


def test_cli_resnet_resumes_bit_for_bit_on_the_collective_backend(tmp_path, capfd):
    base = ["--device", "cpu", "--config", "cifar_resnet50", "--norm-impl", "pallas", "--workers", "2",
            "--grad-clip", "0.5", "--lr-schedule", "linear"]
    straight, resumed = _collective(
        [base + ["--rounds", "2", "--checkpoint-dir", str(tmp_path / "a"), "--checkpoint-every", "1"],
         base + ["--rounds", "1", "--resume", str(tmp_path / "a" / "step_1"), "--checkpoint-dir", str(tmp_path / "b")]],
        [0, 1], capfd)
    assert sorted(straight) == [0, 1] and resumed == {1: straight[1]}
    assert_checkpoints_equal(str(tmp_path / "a" / "step_2"), str(tmp_path / "b" / "step_2"))
