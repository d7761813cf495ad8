"""The train CLI on ``cifar_resnet50`` smoke (``python -m
consensusml_tpu_torch.train --config cifar_resnet50``) under both norm
impls, on the CPU: moved here from ``tests/test_torch_train.py``
unchanged, so that the suite's workers can run the two files side by
side.
"""

import pytest


@pytest.mark.parametrize("norm_impl", ["flax", "pallas"])
def test_train_cli_resnet_on_cpu(capsys, norm_impl):
    from consensusml_tpu_torch.train.__main__ import main

    argv = ["--device", "cpu", "--config", "cifar_resnet50", "--scale", "smoke", "--rounds", "3",
            "--norm-impl", norm_impl]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "codec: none (exact gossip); dense bucketed wire"
    assert out[1].startswith("BN: ") and (("PyTorch batch norm" in out[1]) == (norm_impl == "flax"))
    assert "8 workers on cpu, 8402 params per worker, 1 buckets" in out[2]
    rounds = [line.split() for line in out if line.startswith("round ")]
    assert len(rounds) == 3 and all(r[-2] == "imgs/s" and float(r[-1]) > 0 for r in rounds)
    errs = [float(r[r.index("consensus_error") + 1]) for r in rounds]
    assert errs[-1] < errs[0]

