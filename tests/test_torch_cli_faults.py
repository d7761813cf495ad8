"""The train CLI's gossip flags (``python -m consensusml_tpu_torch.train``):
``--drop-prob``, ``--push-sum``, ``--bucket-bytes``, ``--gossip-steps``
and ``--codec-refresh``, with the reference ``train.py``'s wiring order
and refusals.

- Each flag runs ``mnist_mlp`` smoke for one round on the CPU, and the
  fault flags also ``cifar_resnet50`` smoke (its BN statistics mixed
  beside the weights) and the collective backend.
- The refusals, with the reference's outcomes (``train.py:456-477``,
  ``:552-598``): ``--push-sum`` on ``gpt2_topk`` (CHOCO) exits 2 with
  ``error: --push-sum is incompatible ...``; ``--drop-prob`` on it raises
  ``NotImplementedError`` (fault-tolerant compressed gossip), as
  ``--drop-prob`` on a directed topology without ``--push-sum`` does (the
  reference lets both escape, exit code 1); ``--gossip-steps 2 --push-sum``
  and ``--codec-refresh`` on an exact config exit 2; a bad
  ``--bucket-bytes`` exits 2.
- The README's fault example, ``cifar_resnet50 --topology onepeer-exp
  --push-sum --drop-prob 0.1``, runs (the old ``gpt2_topk --drop-prob 0.1
  --push-sum`` is refused by both packages).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from consensusml_tpu_torch.train.__main__ import main

ROOT = Path(__file__).resolve().parents[1]
MNIST = ["--device", "cpu", "--config", "mnist_mlp", "--rounds", "1"]


def _round_lines(out):
    return [line for line in out.splitlines() if line.startswith("round ")]


@pytest.mark.parametrize("flags,expect", [
    (["--drop-prob", "0.3", "--topology", "ring"], "faults drop_prob=0.3"),
    (["--push-sum", "--topology", "onepeer-exp"], "push-sum"),
    (["--push-sum", "--drop-prob", "0.2", "--topology", "onepeer-exp"], "push-sum, faults drop_prob=0.2"),
    (["--bucket-bytes", "0"], "dense per-leaf wire"),
    (["--bucket-bytes", "1000"], "dense bucketed wire"),
    (["--gossip-steps", "2", "--topology", "ring"], "dense bucketed wire"),
])
def test_each_flag_runs_mnist(capsys, flags, expect):
    assert main(MNIST + flags) == 0
    out = capsys.readouterr().out
    assert expect in out
    lines = _round_lines(out)
    assert len(lines) == 1 and "nan" not in lines[0]
    assert ("alive_frac" in lines[0]) == ("--drop-prob" in flags)
    if flags == ["--bucket-bytes", "1000"]:
        assert re.search(r"\b(\d+) buckets", out) and int(re.search(r"\b(\d+) buckets", out).group(1)) > 1


def test_codec_refresh_and_gossip_steps_on_gpt2(capsys):
    argv = ["--device", "cpu", "--config", "gpt2_topk", "--rounds", "1"]
    assert main(argv + ["--codec-refresh", "2", "--gossip-steps", "2", "--bucket-bytes", "0"]) == 0
    out = capsys.readouterr().out
    assert "per-leaf wire" in out and len(_round_lines(out)) == 1


def test_faults_and_push_sum_on_resnet(capsys):
    argv = ["--device", "cpu", "--config", "cifar_resnet50", "--rounds", "1"]
    assert main(argv + ["--topology", "onepeer-exp", "--push-sum", "--drop-prob", "0.1"]) == 0
    assert "push-sum, faults drop_prob=0.1" in capsys.readouterr().out
    assert main(argv + ["--drop-prob", "0.1"]) == 0  # the config's ring
    assert "alive_frac" in capsys.readouterr().out


def test_collective_backend_takes_the_flags(capfd):
    argv = MNIST + ["--backend", "collective", "--workers", "4", "--topology", "onepeer-exp", "--push-sum",
                    "--drop-prob", "0.3"]
    assert main(argv) == 0
    out = capfd.readouterr().out  # rank 0 prints from its own process
    assert "push-sum, faults drop_prob=0.3" in out
    assert "alive_frac" in _round_lines(out)[0]


def test_refusals_match_reference(capsys):
    gpt2 = ["--device", "cpu", "--config", "gpt2_topk", "--rounds", "1"]
    assert main(gpt2 + ["--push-sum"]) == 2
    assert "error: --push-sum is incompatible with a compressed-gossip config" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="COMPRESSED"):
        main(gpt2 + ["--drop-prob", "0.1"])
    with pytest.raises(NotImplementedError, match="SYMMETRIC"):
        main(MNIST + ["--topology", "onepeer-exp", "--drop-prob", "0.1"])
    assert main(MNIST + ["--push-sum", "--gossip-steps", "2"]) == 2
    assert "--gossip-steps" in capsys.readouterr().err
    assert main(MNIST + ["--codec-refresh", "5"]) == 2
    assert "without a compressor" in capsys.readouterr().err
    assert main(MNIST + ["--bucket-bytes", "-4"]) == 2
    assert "error: --bucket-bytes" in capsys.readouterr().err
    with pytest.raises(ValueError, match="drop_prob"):
        main(MNIST + ["--drop-prob", "1.0"])


def test_the_readme_fault_example():
    """The README's example, as a user runs it (``--device cpu``, one
    round), and the one it replaced, refused with exit code 2 as the
    reference refuses it (``--push-sum`` on a compressed config)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    base = [sys.executable, "-m", "consensusml_tpu_torch.train", "--device", "cpu", "--rounds", "1"]
    ok = subprocess.run(base + ["--config", "cifar_resnet50", "--topology", "onepeer-exp", "--push-sum",
                                "--drop-prob", "0.1"], capture_output=True, text=True, env=env, timeout=300)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "round 0:" in ok.stdout
    old = subprocess.run(base + ["--config", "gpt2_topk", "--drop-prob", "0.1", "--push-sum"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert old.returncode == 2 and "--push-sum is incompatible" in old.stderr
