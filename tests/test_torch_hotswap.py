"""The drain-free hot swap of the port's engine (``Engine.watch``,
``serve/pool/hotswap.py``), held to the reference's protocol: a watched
engine flips to a new generation of its artifact mid-traffic with no
dropped stream (target and draft together), and rejects a generation that
goes backwards and a tree that does not match the live one leaf for leaf,
serving on; a corrected rewrite at the refused generation is taken."""

import time
import types

import numpy as np
import pytest
import torch

from consensusml_tpu_torch import configs
from consensusml_tpu_torch.serve import ServeConfig, load_engine
from consensusml_tpu_torch.serve import export as texport

pytestmark = pytest.mark.serving


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed):
    """A stand-in for a 4-worker ``gpt2_topk`` smoke ``TrainState``."""
    bundle = configs.build("gpt2_topk", "smoke", device="cpu")
    params, _ = bundle.convert(bundle.init_params(seed))
    return types.SimpleNamespace(params=params, model_state={}, frozen={}, step=seed, generators=[None] * 4)


def _wait(cond, timeout=30.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("timed out")
        time.sleep(0.005)


def _scores_as(eng, state, ids):
    """Whether the engine scores ``ids`` as ``state``'s mean model does."""
    mean = {n: t.mean(0) for n, t in state.params.items()}
    model = texport.build_serving_model({"config_name": "gpt2_topk"}, mean, "cpu").to_compute_dtype()
    with torch.inference_mode():
        return torch.equal(eng.score(ids), model(torch.from_numpy(ids)))


@pytest.mark.parametrize("spec_k", [0, 2], ids=["plain", "speculative"])
def test_watched_engine_flips_mid_traffic_without_dropping_a_stream(tmp_path, spec_k):
    """Generation 1 serving eight 24-token streams on two slots; generation
    2 (and, on a speculative engine, its new draft) exported once the first
    tokens are out: the engine flips between steps, every stream finishes
    whole, and it then scores as generation 2's mean model (its draft is
    generation 2's draft)."""
    art = str(tmp_path / "art")
    one, two = _state(1), _state(2)
    texport.export_serving(art, one, config_name="gpt2_topk")
    if spec_k:
        texport.export_draft(art, {n: t[0] for n, t in one.params.items()}, config_name="gpt2_topk")
    eng = load_engine(art, ServeConfig(num_slots=2, block_size=8), spec_k=spec_k, device="cpu")
    with eng:
        eng.warmup()
        watcher = eng.watch(art, poll_s=3600.0)  # polled by hand below
        ids = np.random.default_rng(0).integers(0, 64, size=(2, 8))
        assert eng.generation == 1 and _scores_as(eng, one, ids)
        handles = [eng.submit([i + 1, 2, 3, 4], 24) for i in range(8)]
        next(handles[0].tokens(timeout=60))
        if spec_k:
            texport.export_draft(art, {n: t[1] for n, t in two.params.items()}, config_name="gpt2_topk")
        texport.export_serving(art, two, config_name="gpt2_topk")
        assert watcher.poll_once()
        _wait(lambda: eng.generation == 2)
        results = [h.result(timeout=120) for h in handles]
        assert all(r.finish_reason == "max_tokens" and len(r.tokens) == 24 for r in results)
        st = eng.stats()
        assert (st["swaps"], st["swap_rejected"], st["hotswap"]["staged"]) == (1, 0, 1)
        assert _scores_as(eng, two, ids)
        if spec_k:
            draft = dict(eng._draft_dm.model.named_parameters())
            assert all(torch.equal(draft[n], t[1].to(draft[n].dtype)) for n, t in two.params.items())


def test_watcher_rejects_a_regression_and_a_mismatched_tree(tmp_path):
    """At generation 3: a meta at generation 2 is rejected and counted
    once however often it is polled; a generation-4 tree with a leaf
    missing stages, is refused at the flip (counted) and the engine serves
    generation 3 on; the same generation rewritten whole is taken."""
    art = str(tmp_path / "art")
    three = _state(3)
    texport.export_serving(art, three, config_name="gpt2_topk", generation=3)
    with load_engine(art, ServeConfig(num_slots=2, block_size=8), device="cpu") as eng:
        watcher = eng.watch(art, poll_s=3600.0)
        texport.export_serving(art, _state(4), config_name="gpt2_topk", generation=2)
        assert not watcher.poll_once() and not watcher.poll_once()
        assert watcher.rejected == 1 and eng.generation == 3
        bad = _state(5)
        del bad.params["ln_f.bias"]
        texport.export_serving(art, bad, config_name="gpt2_topk", generation=4)
        assert watcher.poll_once()
        _wait(lambda: eng.stats()["swap_rejected"] == 1)
        assert eng.generation == 3 and watcher.generation == 3 and not watcher.poll_once()
        ids = np.random.default_rng(1).integers(0, 64, size=(1, 8))
        assert _scores_as(eng, three, ids)
        good = _state(6)
        texport.export_serving(art, good, config_name="gpt2_topk", generation=4)
        assert watcher.poll_once()
        _wait(lambda: eng.generation == 4)
        assert eng.stats()["swaps"] == 1 and _scores_as(eng, good, ids)
