"""The train CLI's long-run flags: its refusals (exit code 2, the
reference's messages), the periodic and final held-out eval on both
backends (the collective backend's all-reduced mean model scores the
simulated one's top-1 exactly), the SlowMo warning, and the round
watchdog on both backends (off the critical path when it does not fire;
exit code 3 from the collective backend when a rank's fires)."""

import pytest
import torch

from consensusml_tpu_torch.train.__main__ import main

BASE = ["--device", "cpu", "--config", "mnist_mlp", "--workers", "2"]
COLL = ["--backend", "collective", "--dist-backend", "gloo"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv,message", [
    (["--eval-every", "2"], "error: --eval-every requires --eval-batches"),
    (["--lr-schedule", "cosine", "--rounds", "2", "--warmup-rounds", "2"],
     "error: warmup (2 steps) must be shorter than the schedule (2 steps)"),
    (["--lr-schedule", "linear", "--rounds", "0"], "error: kind='linear' decays over the horizon"),
    (["--overlap-gossip", "--slowmo-beta", "0.2"], "error: --slowmo-beta: overlap gossip + SlowMo is not supported"),
    (["--resume", "/nonexistent/step_2"], "error: cannot restore /nonexistent/step_2: no cml_meta.json"),
])
@pytest.mark.parametrize("backend", ["simulated", "collective"])
def test_refusals_exit_2(capsys, argv, message, backend):
    extra = COLL if backend == "collective" else []
    assert main(BASE + extra + argv) == 2
    assert message in capsys.readouterr().err


def test_resume_at_another_world_size_is_refused(tmp_path, capsys):
    """A resume at another world size was refused until the elastic resize
    was ported; it now resizes (``tests/test_torch_elastic.py`` holds the
    resized state to the reference's)."""
    assert main(BASE + ["--rounds", "1", "--checkpoint-dir", str(tmp_path)]) == 0
    capsys.readouterr()
    assert main(BASE[:-1] + ["3", "--resume", str(tmp_path / "step_1")]) == 0
    out = capsys.readouterr().out
    assert "elastic resume: 2 -> 3 workers (joiners from consensus mean; gossip state reset)" in out
    assert "mnist_mlp/smoke: 3 workers on cpu" in out
    # without --workers the run takes the checkpoint's world size
    assert main(BASE[:-2] + ["--rounds", "1", "--resume", str(tmp_path / "step_1")]) == 0
    assert "mnist_mlp/smoke: 2 workers on cpu" in capsys.readouterr().out


def _evals(out: str) -> list[str]:
    return [line for line in out.splitlines() if "eval[" in line]


def test_eval_every_on_both_backends(capfd):
    argv = BASE + ["--rounds", "3", "--eval-batches", "2", "--eval-every", "1", "--round-timeout", "60",
                   "--slowmo-beta", "0.5"]
    assert main(argv) == 0
    out = capfd.readouterr()
    sim = _evals(out.out)
    assert "warning: --slowmo-beta 0.5" in out.err
    assert [line.split(" eval")[0] for line in sim[:4]] == ["[round 0]", "[round 0]", "[round 1]", "[round 1]"]
    assert sim[-2].startswith("eval[mean-model]: top1=") and len(sim) == 6
    assert main(argv + COLL) == 0
    assert _evals(capfd.readouterr().out) == sim


def test_collective_watchdog_exits_3(capfd):
    assert main(BASE + COLL + ["--rounds", "4", "--round-timeout", "0.001"]) == 3
    assert "watchdog: no train round progress" in capfd.readouterr().err
