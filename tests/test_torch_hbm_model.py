"""The port's analytic memory model
(``consensusml_tpu_torch/tools/hbm_model.py``) against the reference's
``tools/hbm_model.py``.

``predict()`` is held to the reference's component by component for all
five configs at smoke scale, except the named differences of its
docstring: a LoRA run's frozen base is held once (``frozen``), not in
every worker's ``params``. Its state components are exact claims, held to
the state a run of the port allocates; under ``model_axes`` it is held
to the reference's at tp 2 and 4.
"""

import importlib.util
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import hbm_model as ref  # noqa: E402

pytestmark = pytest.mark.profiling


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port():
    spec = importlib.util.spec_from_file_location(
        "port_hbm_model", os.path.join(ROOT, "consensusml_tpu_torch", "tools", "hbm_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CONFIGS = ["mnist_mlp", "cifar_resnet50", "bert_mlm", "gpt2_topk", "llama_lora"]


@pytest.mark.parametrize("name", CONFIGS)
def test_predict_equals_the_references_component_by_component(name):
    want = ref.predict(name, "smoke")
    got = _port().predict(name, "smoke")
    w, g = want["per_device"], got["per_device"]
    assert set(g) == set(w) | {"frozen"}
    named = {"params", "frozen"} if name == "llama_lora" else set()
    for key in set(w) - named:
        assert g[key] == w[key], key
    if name == "llama_lora":
        # the named difference: the base leaves every worker's f32 params
        # and is held once, in its held dtypes
        assert g["params"] < w["params"] and g["frozen"] > 0
        assert got["predicted_peak_bytes"] - g["params"] - g["frozen"] == want["predicted_peak_bytes"] - w["params"]
    else:
        assert g["frozen"] == 0 and got["predicted_peak_bytes"] == want["predicted_peak_bytes"]
    assert got["world"] == want["world"] and got["model_axes"] == []


def test_state_components_are_the_states_bytes():
    """``params``, ``opt`` and ``gossip`` equal the bytes of one worker's
    share of the state the port's run allocates (``gpt2_topk`` smoke:
    CHOCO's per-bucket state)."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state
    from consensusml_tpu_torch.utils import tree as T

    pred = _port().predict("gpt2_topk", "smoke")["per_device"]
    b = configs.build("gpt2_topk", "smoke", device="cpu")
    params, model_state = configs.init_on_device(b, 0, "cpu")
    state = init_stacked_state(b.cfg, params, b.world_size, model_state=model_state)
    w = b.world_size
    share = lambda ts: sum(math.prod(t.shape) * t.element_size() for t in ts) // w  # noqa: E731
    assert pred["params"] == share(state.params.values())
    assert pred["opt"] == share(t for _, t in T.named_tensors(state.opt_state))
    assert pred["gossip"] == share(T.leaves(state.gossip))


def test_llama_frozen_base_is_held_once_in_its_dtypes():
    from consensusml_tpu_torch import configs

    port = _port()
    pred = port.predict("llama_lora", "smoke")
    b = configs.build("llama_lora", "smoke", device="cpu")
    frozen = configs.frozen_on_device(b, "cpu")
    assert pred["per_device"]["frozen"] == sum(t.numel() * t.element_size() for t in frozen.values())
    # stacked over the simulated backend's workers, the base once
    assert port.stacked_bytes(pred, 4) == 4 * (pred["predicted_peak_bytes"] - pred["per_device"]["frozen"]) + \
        pred["per_device"]["frozen"]


@pytest.mark.parametrize("name", ["llama_lora", "gpt2_topk"])
@pytest.mark.parametrize("tp", [2, 4])
def test_model_axes_raise_until_parallel_is_ported(name, tp):
    """``parallel/`` is ported: ``model_axes`` no longer raises, and the
    prediction is the reference's component by component at tp 2 and 4
    (each leaf divided by the axes its rule names, the activations by the
    product), the LoRA base's named difference apart."""
    want = ref.predict(name, "smoke", model_axes=(("tp", tp),))
    got = _port().predict(name, "smoke", model_axes=(("tp", tp),))
    w, g = want["per_device"], got["per_device"]
    for key in set(w) - {"params"}:
        assert g[key] == w[key], key
    assert got["model_axes"] == want["model_axes"] == [["tp", tp]]
    if name == "llama_lora":
        assert g["frozen"] > 0
        assert got["predicted_peak_bytes"] - g["params"] - g["frozen"] == want["predicted_peak_bytes"] - w["params"]
    else:
        assert g["params"] == w["params"] and got["predicted_peak_bytes"] == want["predicted_peak_bytes"]


def test_cli_prints_the_predictions(capsys):
    assert _port().main(["--config", "mnist_mlp", "--scale", "smoke"]) == 0
    out = capsys.readouterr().out
    assert '"config": "mnist_mlp"' in out and "predicted_peak_bytes" in out
