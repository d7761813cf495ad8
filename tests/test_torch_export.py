"""The train-to-serve handoff against ``consensusml_tpu.serve.export``:
the artifact's meta and generations, an artifact carried across from the
reference and scored, and ``--export-serving`` on the trainer's simulated
backend (the collective backend's export rides the spawn of
``tests/test_torch_collective_resume.py``).

- ``serve_meta.json``: the same keys and values as the reference's
  ``export_serving`` writes, over two exports, a bump, a rollback pin and
  a draft;
- ``Engine.score`` of an engine loaded from the reference's artifact
  (``load_serving`` -> :func:`artifact_from_reference` -> ``load_engine``)
  against the reference's model on its mean (bf16, 3.5e-2 of max|logit|);
- ``python -m consensusml_tpu_torch.train --config gpt2_topk --device cpu
  --rounds 2 --checkpoint-every 1 --export-serving DIR``: two exports,
  generations 1 and 2, and the engine's score equal to the consensus-mean
  model of the run's last checkpoint, bit for bit.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jconfigs
from consensusml_tpu.serve import export as jexport
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.serve import ServeConfig, load_engine
from consensusml_tpu_torch.serve import export as texport
from consensusml_tpu_torch.train.__main__ import main
from consensusml_tpu_torch.train.local_sgd import init_stacked_state
from consensusml_tpu_torch.utils.checkpoint import restore_state
from consensusml_tpu_torch.utils.tree import consensus_mean

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stacked_state(step=3, seed=0):
    """A port stand-in for a ``TrainState`` of ``gpt2_topk`` smoke (4
    workers), and the reference's with the same stacked numpy parameters."""
    bundle = configs.build("gpt2_topk", "smoke", device="cpu")
    init = bundle.init_params(seed)
    params, _ = bundle.convert(init)
    port = types.SimpleNamespace(params=params, model_state={}, frozen={}, step=step, generators=[None] * 4)
    nested = {}
    for path, leaf in init.items():  # the flax tree of the dotted paths
        *outer, last = path.split(".")
        node = nested
        for key in outer:
            node = node.setdefault(key, {})
        node[last] = jnp.asarray(leaf)
    ref = types.SimpleNamespace(params=nested, model_state={}, step=jnp.full((4,), step, jnp.int32))
    return port, ref


def test_meta_and_generations_match_reference(tmp_path):
    """Two exports to one path (generations 1, 2), a bump (3), a rollback
    pin of the first meta (4, ``rolled_back_from`` 3) and a draft: the
    same metas, key for key, as the reference's."""
    port, ref = stacked_state()
    metas = {}
    for name, mod, state in (("port", texport, port), ("ref", jexport, ref)):
        path = str(tmp_path / name)
        seen = []
        for rnd in (3, 5):
            mod.export_serving(path, state, config_name="gpt2_topk", scale="smoke", round=rnd)
            seen.append(mod.serving_meta(path))
        seen.append(mod.bump_generation(path))
        seen.append(mod.pin_generation(path, seen[0]))
        seen.append(mod.serving_meta(path))
        params = port.params if mod is texport else jax.tree.map(lambda x: x[0], ref.params)
        draft_dir = mod.export_draft(path, params, config_name="gpt2_topk", scale="smoke")
        seen.append(mod.serving_meta(draft_dir))
        metas[name] = seen
    assert metas["port"] == metas["ref"]
    assert [m["generation"] for m in metas["port"][:2]] == [1, 2] and metas["port"][4]["generation"] == 4
    assert set(metas["port"][0]) == {"config_name", "scale", "round", "world_size", "generation"}


def test_score_on_an_artifact_carried_from_the_reference(tmp_path):
    """The reference's artifact, loaded by its ``load_serving`` and carried
    across, served by the port on the CPU: its generation kept, and its
    scores the reference's model's on the reference's mean."""
    _port, ref = stacked_state(seed=4)
    jexport.export_serving(str(tmp_path / "ref"), ref, config_name="gpt2_topk", scale="smoke")
    jexport.bump_generation(str(tmp_path / "ref"))
    meta, params, model_state = jexport.load_serving(str(tmp_path / "ref"))
    path = texport.artifact_from_reference(str(tmp_path / "port"), meta, jax.tree.map(np.asarray, params),
                                           jax.tree.map(np.asarray, model_state))
    ids = np.random.default_rng(5).integers(0, 64, size=(2, 16))
    want = np.asarray(jconfigs.build("gpt2_topk", "smoke").model.apply({"params": params}, jnp.asarray(ids)),
                      np.float32)
    with load_engine(path, ServeConfig(num_slots=2), device="cpu") as eng:
        got = eng.score(ids).numpy()
        assert eng.generation == 2 == texport.serving_meta(path)["generation"]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 3.5e-2


def test_cli_export_serving_on_the_simulated_backend(tmp_path, capfd):
    """``--export-serving`` with ``--checkpoint-every 1``: an export a
    round, its line printed, generations 1 and 2; ``load_engine`` serves
    it, and its score is the consensus-mean model's of the last checkpoint
    bit for bit."""
    art, ck = str(tmp_path / "art"), str(tmp_path / "ck")
    assert main(["--config", "gpt2_topk", "--device", "cpu", "--rounds", "2", "--checkpoint-every", "1",
                 "--checkpoint-dir", ck, "--export-serving", art]) == 0
    out = capfd.readouterr().out
    assert f"serving artifact: {art} (round 1, generation 1)" in out
    assert f"serving artifact: {art} (round 2, generation 2)" in out
    meta = texport.serving_meta(art)
    assert (meta["round"], meta["world_size"], meta["generation"]) == (2, 4, 2)
    bundle = configs.build("gpt2_topk", "smoke", device="cpu")
    params, model_state = configs.init_on_device(bundle, 1, "cpu")
    state = restore_state(os.path.join(ck, "step_2"), init_stacked_state(bundle.cfg, params, 4, seed=1,
                                                                         model_state=model_state))
    model = texport.build_serving_model(meta, consensus_mean(state.params), "cpu").to_compute_dtype()
    ids = np.random.default_rng(2).integers(0, 64, size=(3, 16))
    with torch.inference_mode():
        want = model(torch.from_numpy(ids))
    with load_engine(art, device="cpu") as eng:
        assert torch.equal(eng.score(ids), want)
        eng.warmup()
        res = eng.submit([1, 2, 3], 5).result(timeout=60)
        assert res.finish_reason == "max_tokens" and len(res.tokens) == 5


def test_load_engine_refusals(tmp_path, monkeypatch):
    """An artifact of a config without a decode path, and ``spec_k`` where
    no draft rides the artifact, are refused; without a GPU the engine is
    built only where the caller asks for the CPU."""
    port, _ref = stacked_state()
    texport.export_mean(str(tmp_path / "mlp"), {}, config_name="mnist_mlp", round=0, world_size=1)
    with pytest.raises(ValueError, match="decode path"):
        load_engine(str(tmp_path / "mlp"), device="cpu")
    texport.export_serving(str(tmp_path / "lm"), port, config_name="gpt2_topk")
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_engine(str(tmp_path / "lm"), spec_k=2, device="cpu")
    with pytest.raises(ValueError, match="not a serving artifact"):
        texport.load_serving(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_engine(str(tmp_path / "lm"))
