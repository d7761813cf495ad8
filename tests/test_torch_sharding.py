"""``parallel.sharding``: the port's rule matching against the reference's
``consensusml_tpu/parallel/sharding.py`` (the reference's rule cases;
every leaf of the smoke GPT-2 and of ``llama_tiny`` with rank-4 adapters
gets the reference's per-dim spec under the stock rules), and the shard
plan (the ranks' pieces tile every leaf once)."""

import jax
import numpy as np
import pytest
import torch

from consensusml_tpu import configs as jconfigs
from consensusml_tpu.parallel import sharding as jsh
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.parallel import sharding as tsh


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RULES = [(r"q_proj/base/kernel", (None, "tp")), (r"down_proj", ("tp", None))]
CASES = [
    ("layer_0/q_proj/base/kernel", 2, RULES),
    ("layer_3/down_proj/kernel", 2, RULES),
    ("final_norm/scale", 1, RULES),
    ("anything", 2, None),
    ("stages/layer/kernel", 3, [(r"stages/", ("pp",), "lead")]),
    ("stages/layer/bias", 2, jsh.pipeline_pp_rules()),
    ("moe/wi", 3, jsh.moe_ep_rules()),
]


@pytest.mark.parametrize("path,ndim,rules", CASES, ids=[c[0] for c in CASES])
def test_spec_for_path_equals_the_references(path, ndim, rules):
    assert tsh.spec_for_path(path, ndim, rules) == jsh.spec_for_path(path, ndim, rules)


@pytest.mark.parametrize("path,ndim,rules,match", [
    ("layer_0/q_proj/base/kernel", 1, RULES, "only"),
    ("x/kernel", 2, [(r"kernel", ("tp",), "laed")], "must be 'lead'"),
])
def test_spec_for_path_refuses_as_the_reference(path, ndim, rules, match):
    for fn in (tsh.spec_for_path, jsh.spec_for_path):
        with pytest.raises(ValueError, match=match):
            fn(path, ndim, rules)


def _reference_leaves(name):
    bundle = jconfigs.build(name, "smoke")
    params = bundle.init_params(jax.random.key(0))
    if isinstance(params, tuple):
        params = params[0]
    return {jax.tree_util.keystr(p, simple=True, separator="/"): leaf.shape
            for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("name,rules", [("gpt2_topk", "gpt2_tp_rules"), ("llama_lora", "llama_tp_rules")])
def test_every_leaf_gets_the_references_spec(name, rules):
    """The port's leaves (dotted module paths) against the reference's
    flax paths, one for one, under the stock rules: the same spec each."""
    want = _reference_leaves(name)
    model = configs.build(name, "smoke", device="cpu").model
    got = {tsh.tree_path(n): tuple(p.shape) for n, p in model.named_parameters()}
    assert got == {k: tuple(v) for k, v in want.items()}
    port_rules, ref_rules = getattr(tsh, rules)(), getattr(jsh, rules)()
    split = 0
    for path, shape in got.items():
        spec = tsh.spec_for_path(path, len(shape), port_rules)
        assert spec == jsh.spec_for_path(path, len(shape), ref_rules), path
        split += "tp" in spec
    assert split >= 5  # the rules really split the model


@pytest.mark.parametrize("name,tp", [("gpt2_topk", 2), ("llama_lora", 2), ("llama_lora", 4)])
def test_shard_plan_tiles_every_leaf(name, tp):
    """Each leaf a rule splits is covered exactly once by the tp ranks'
    pieces, equal pieces along the rule's dim in rank order; every other
    leaf is whole on every rank."""
    bundle = configs.build(name, "smoke", device="cpu")
    rules = bundle.tp_rules("tp")
    for n, p in bundle.model.named_parameters():
        shape = tuple(p.shape)
        cover = np.zeros(shape, np.int64)
        x = torch.arange(p.numel()).reshape(shape)
        pieces = []
        for i in range(tp):
            plan = tsh.shard_plan(n, shape, rules, {"tp": tp}, {"tp": i})
            cover[plan] += 1
            pieces.append(x[plan])
        spec = tsh.spec_for_path(tsh.tree_path(n), len(shape), rules)
        split = "tp" in spec
        assert (cover == (1 if split else tp)).all(), n
        if split:
            assert torch.equal(torch.cat(pieces, dim=spec.index("tp")), x), n
    jax.clear_caches()


def test_shard_plan_refuses_a_dim_that_does_not_split():
    """The smoke GPT-2's 2 heads over 4 ranks: refused, not padded."""
    with pytest.raises(ValueError, match="does not split into 4"):
        tsh.shard_plan("h_0.qkv.kernel", (32, 2, 48), tsh.gpt2_tp_rules(), {"tp": 4}, {"tp": 0})
