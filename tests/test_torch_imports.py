"""Guards of the port: it never imports the JAX stack or the JAX package,
and its entry points never run on the CPU unless asked to."""

import ast
from pathlib import Path

import pytest
import torch

from consensusml_tpu_torch import configs
from consensusml_tpu_torch.models.paged_attention import resolve_attention_impl
from consensusml_tpu_torch.serve import Engine

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "consensusml_tpu")
FILES = sorted((ROOT / "consensusml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.build_model("gpt2_topk", "smoke")
    model = configs.build_model("gpt2_topk", "smoke", device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.build("gpt2_topk", "smoke", codec="int8")
    from consensusml_tpu_torch.train.__main__ import main as train_main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--scale", "smoke", "--rounds", "1"])
    assert "plain PyTorch versions" in configs.build("gpt2_topk", "smoke", codec="int8", device="cpu").codec_path
    # the fifth slice's path: the fused LayerNorm on the top-k + int4 codec
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.build("gpt2_topk", "smoke", codec="topk_int4", norm_impl="pallas")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--scale", "smoke", "--rounds", "1", "--codec", "topk_int4", "--norm-impl", "pallas"])
    bundle = configs.build("gpt2_topk", "smoke", codec="topk_int4", norm_impl="pallas", device="cpu")
    assert "plain PyTorch versions" in bundle.codec_path and "plain PyTorch versions" in bundle.norm_path
    with pytest.raises(ValueError):
        configs.build("gpt2_topk", "smoke", norm_impl="interpret", device="cpu")
    with pytest.raises(NotImplementedError):
        configs.build("gpt2_topk", "smoke", codec="topk_fp8", device="cpu")
    # the sixth slice's paths: the fused wire's int4 and fp8 formats
    for codec in ("int4", "fp8"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            configs.build("gpt2_topk", "smoke", codec=codec)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(["--scale", "smoke", "--rounds", "1", "--codec", codec])
        assert "plain PyTorch versions" in configs.build("gpt2_topk", "smoke", codec=codec, device="cpu").codec_path
    for norm_impl in ("flax", "pallas"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            configs.build("cifar_resnet50", "smoke", norm_impl=norm_impl)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(["--config", "cifar_resnet50", "--scale", "smoke", "--rounds", "1", "--norm-impl", norm_impl])
    bundle = configs.build("cifar_resnet50", "smoke", norm_impl="pallas", device="cpu")
    assert "plain PyTorch versions" in bundle.norm_path
    # the twelfth slice's paths: mnist_mlp, and any config on another topology
    for argv in (["--config", "mnist_mlp"], ["--config", "mnist_mlp", "--topology", "onepeer-exp"],
                 ["--config", "cifar_resnet50", "--topology", "torus"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_main(argv + ["--rounds", "1", "--eval-batches", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.build("mnist_mlp", "smoke")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        configs.build("mnist_mlp", "full", topology="hierarchical:slices=2,outer_every=2")
    assert configs.build("mnist_mlp", "full", topology="exp", device="cpu").cfg.gossip.topology.name == "exp"


def test_auto_tier_on_cpu_is_the_plain_version():
    assert resolve_attention_impl("auto", "cpu") == "torch"
    assert resolve_attention_impl("auto", torch.device("cpu")) == "torch"


def test_feed_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """The device feed and the ring's feed stage on the card unless given
    ``device="cpu"``; without one they raise, as the trainer does."""
    from consensusml_tpu_torch.data import DevicePrefetcher, SyntheticClassification, native_cls_feed
    from consensusml_tpu_torch.train.__main__ import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher(iter([]), 2)
    ds = SyntheticClassification(n=16, image_shape=(2, 2, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        native_cls_feed(ds, 2, 1, 2, 1)
    DevicePrefetcher(iter([]), 2, device="cpu").close()  # nothing staged: no card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config", "cifar_resnet50", "--rounds", "1", "--native-loader"])


def test_scan_covers_the_parallel_modules():
    """The scan above reads every module of ``parallel/`` (model, sequence
    and pipeline parallelism) and the train CLI's tensor-parallel path."""
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("__init__", "axis", "check", "pipeline", "ring_attention", "sharding", "tensor", "ulysses"):
        assert f"consensusml_tpu_torch/parallel/{mod}.py" in names, mod


def test_parallel_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    """``--model-axes`` on the collective backend and the sequence-parallel
    check run on the card unless given ``--device cpu`` / ``device="cpu"``;
    without one they raise."""
    from consensusml_tpu_torch.parallel.check import sequence_parallel
    from consensusml_tpu_torch.train.__main__ import main as train_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--config", "gpt2_topk", "--backend", "collective", "--workers", "2", "--model-axes", "tp=2",
                    "--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sequence_parallel(0, 1, [(1, 64, 2, 64)])
