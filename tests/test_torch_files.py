"""File datasets of the port (``consensusml_tpu_torch/data/files.py``) against
the reference's (``consensusml_tpu/data/files.py``) on files this test
writes from a numpy seed: MNIST idx files plain and gzipped (with and
without the held-out ``t10k`` pair), CIFAR-10 binary batches, and
``tokens.bin`` in 16- and 32-bit ids (with and without ``tokens.val.bin``).
Both packages load equal arrays, carve equal held-out splits, and give
equal round batches at a given ``(seed, start)``, equal held-out batches,
and equal BERT-style corrupted batches; each config built with
``data_dir`` trains on the files through the CLI.
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jax_configs
from consensusml_tpu.data import files as jax_files
from consensusml_tpu.data.synthetic import round_batches as jax_round_batches
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.data import cls_eval_batches, files, round_batches


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_idx(path, arr, gz=False):
    code = {np.uint8: 0x08, np.int32: 0x0C}[arr.dtype.type]
    header = struct.pack(f">BBBB{arr.ndim}I", 0, 0, code, arr.ndim, *arr.shape)
    body = arr.astype(">i4").tobytes() if code == 0x0C else arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(header + body)


def _mnist(root, gz, test_files, n=80):
    rng = np.random.default_rng(0)
    os.makedirs(root, exist_ok=True)
    sfx = ".gz" if gz else ""
    _write_idx(os.path.join(root, "train-images-idx3-ubyte" + sfx), rng.integers(0, 256, (n, 28, 28), np.uint8), gz)
    _write_idx(os.path.join(root, "train-labels-idx1-ubyte" + sfx), rng.integers(0, 10, n, np.uint8), gz)
    if test_files:
        _write_idx(os.path.join(root, "t10k-images-idx3-ubyte" + sfx), rng.integers(0, 256, (16, 28, 28), np.uint8), gz)
        _write_idx(os.path.join(root, "t10k-labels-idx1-ubyte" + sfx), rng.integers(0, 10, 16, np.uint8), gz)


def _cifar(root, per_batch=8):
    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
        rec = np.concatenate([rng.integers(0, 10, (per_batch, 1), np.uint8),
                              rng.integers(0, 256, (per_batch, 3072), np.uint8)], axis=1)
        rec.tofile(os.path.join(root, name))


def _tokens(root, dtype, vocab, n=4000, val=False):
    rng = np.random.default_rng(2)
    os.makedirs(root, exist_ok=True)
    rng.integers(0, vocab - 1, n).astype(dtype).tofile(os.path.join(root, "tokens.bin"))
    if val:
        rng.integers(0, vocab - 1, 500).astype(dtype).tofile(os.path.join(root, "tokens.val.bin"))


def _equal(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("gz,test_files", [(False, True), (True, True), (True, False)])
def test_mnist_files_load_and_batch_as_the_reference(tmp_path, gz, test_files):
    _mnist(str(tmp_path / "mnist"), gz, test_files)
    got, want = files.find_classification(str(tmp_path)), jax_files.find_classification(str(tmp_path))
    for attr in ("images", "labels", "holdout_images", "holdout_labels"):
        _equal(getattr(got, attr), getattr(want, attr))
    assert got.source == want.source and got.image_shape == (28, 28, 1) and got.n == want.n
    _equal(files.read_idx(str(tmp_path / "mnist" / ("train-labels-idx1-ubyte" + (".gz" if gz else "")))),
           jax_files.read_idx(str(tmp_path / "mnist" / ("train-labels-idx1-ubyte" + (".gz" if gz else "")))))
    for g, w in zip(round_batches(got, 4, 1, 8, 2, seed=3, start=5), jax_round_batches(want, 4, 1, 8, 2, seed=3, start=5)):
        _equal(g["image"].numpy(), w["image"])
        _equal(g["label"].numpy(), w["label"])
    for g, w in zip(cls_eval_batches(got, 8, 2, seed=1), jax_configs._cls_eval_batches(want, 8)(2, 1)):
        _equal(g["image"].numpy(), w["image"])


def test_cifar_files_load_and_batch_as_the_reference(tmp_path):
    _cifar(str(tmp_path / "cifar-10-batches-bin"))
    got, want = files.load_cifar10(str(tmp_path)), jax_files.load_cifar10(str(tmp_path))
    for attr in ("images", "labels", "holdout_images", "holdout_labels"):
        _equal(getattr(got, attr), getattr(want, attr))
    assert got.image_shape == (32, 32, 3) and files.load_mnist(str(tmp_path)) is None
    bundle, jbundle = configs.build("cifar_resnet50", "smoke", world=2, device="cpu", data_dir=str(tmp_path)), \
        jax_configs.build("cifar_resnet50", "smoke", world=2, data_dir=str(tmp_path))
    assert bundle.data_source == got.source
    for g, w in zip(bundle.batches(2, 0, start=3), jbundle.batches(2, 0, start=3)):
        _equal(g["image"].numpy(), w["image"])
    with pytest.raises(ValueError, match="not a multiple"):
        np.zeros(10, np.uint8).tofile(str(tmp_path / "bad.bin"))
        files._read_cifar_bin(str(tmp_path / "bad.bin"))


@pytest.mark.parametrize("dtype,val", [(np.uint16, False), (np.uint32, True)])
def test_token_files_load_and_batch_as_the_reference(tmp_path, dtype, val):
    _tokens(str(tmp_path), dtype, vocab=64, val=val)
    got, want = files.load_tokens(str(tmp_path), 16, 64), jax_files.load_tokens(str(tmp_path), 16, 64)
    assert got.source == want.source and np.dtype(dtype).name in got.source
    _equal(got.tokens, want.tokens)
    _equal(got.val_tokens, want.val_tokens)
    _equal(got.holdout().tokens, want.holdout().tokens)
    for mlm in (0.0, 0.15):
        for g, w in zip(files.token_round_batches(got, 2, 2, 4, 2, seed=3, mlm_rate=mlm, start=4),
                        jax_files.token_round_batches(want, 2, 2, 4, 2, seed=3, mlm_rate=mlm, start=4)):
            assert sorted(g) == sorted(w)
            for k in g:
                _equal(g[k].numpy(), w[k])
    for name in ("bert_mlm", "gpt2_topk", "llama_lora"):
        bundle = configs.build(name, "smoke", device="cpu", data_dir=str(tmp_path))
        jbundle = jax_configs.build(name, "smoke", data_dir=str(tmp_path))
        for g, w in zip(bundle.eval_batches(2, 1), jbundle.eval_batches(2, 1)):
            for k in g:
                _equal(g[k].numpy(), w[k])
        (g,), (w,) = list(bundle.batches(1, 0, start=2)), list(jbundle.batches(1, 0, start=2))
        _equal(g["input_ids"].numpy(), w["input_ids"])
    (tmp_path / "tokens.bin").write_bytes(np.full(100, 70, np.uint16).tobytes())
    with pytest.raises(ValueError, match="reserved as \\[MASK\\]"):
        configs.build("gpt2_topk", "smoke", device="cpu", data_dir=str(tmp_path))


def test_train_cli_on_mnist_files_with_metrics_out(tmp_path, capsys):
    from consensusml_tpu_torch.train.__main__ import main

    _mnist(str(tmp_path / "d"), gz=False, test_files=True, n=512)
    jsonl = tmp_path / "m.jsonl"
    assert main(["--device", "cpu", "--config", "mnist_mlp", "--rounds", "2", "--data-dir", str(tmp_path / "d"),
                 "--metrics-out", str(jsonl), "--eval-batches", "1"]) == 0
    out = capsys.readouterr().out
    assert f"training: data mnist:{tmp_path / 'd'}" in out and "eval[mean-model]: top1=" in out
    import json

    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["round"] for r in records] == [0, 1] and {"wall_s", "loss", "consensus_error"} <= set(records[0])
