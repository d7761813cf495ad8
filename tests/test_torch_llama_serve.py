"""Llama serving on the port against the JAX package: ``LlamaLM``'s
prefill (``return_kv``) and paged decode step (``kv_cache`` +
``block_table``), the hooks' refusals, and greedy streams through the
port's ``Engine`` against the JAX ``Engine`` serving ``LlamaLM``.

The model is ``llama_tiny`` (4 heads on 2 kv heads: GQA rep 2, head dim
16, max_len 128) with rank-4 adapters, its flax tree drawn from a numpy
seed and carried across by ``llama_from_flax`` (base plus adapters, as a
served ``llama_lora`` model is loaded). The port runs on the CPU, where
the paged-attention wrapper is its plain version (the kernel's function
in PyTorch; ``tests/test_torch_cuda.py`` holds the kernel to it on the
card); the reference runs its gather tier and its Pallas kernel in
interpret mode.

Tolerances, each a fraction of the largest |value| of the compared
tensor. f32: the same ops on the same values in other summation orders
(the plain version's dot products and softmax sum are f64 rounded once),
1e-5 for logits and K/V, the bound ``tests/test_torch_llama.py`` holds
the training forward's f32 logits to (readings: prefill logits 6.2e-6,
K/V 2.5e-6, decode logits 9.8e-7). bf16: the two frameworks round at
other places (XLA rounds every op of ``silu`` and of the fused
elementwise chains, ATen each op's result), 3.5e-2, that file's bf16
bound (readings: prefill logits 2.7e-2, K/V and pages 6.9e-3, decode
logits 1.2e-2); the pages written by a decode step are bf16 K/V of the
same forward. Greedy engine streams (f32) are held token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from consensusml_tpu.models.llama import LlamaLM as JaxLlamaLM
from consensusml_tpu.serve import Engine as JaxEngine
from consensusml_tpu.serve import ServeConfig as JaxServeConfig
from consensusml_tpu_torch.models.convert import llama_from_flax
from consensusml_tpu_torch.models.llama import LlamaConfig, LlamaLM
from consensusml_tpu_torch.serve import Engine, ServeConfig
from consensusml_tpu_torch.serve.decode import DecodeModel

pytestmark = pytest.mark.serving

GEOM = dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=128, lora_rank=4)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
REL_TOL = {"f32": 1e-5, "bf16": 3.5e-2}


def _flax_params(seed):
    """The tiny model's flax tree, every leaf redrawn from numpy: norm
    scales near 1, every other leaf (``lora_b`` too) N(0, 0.2)."""
    tree = jax.eval_shape(JaxLlamaLM(config=JaxLlamaConfig(**GEOM)).init, jax.random.key(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.normal(0.0, 0.2, size=leaf.shape).astype(np.float32)
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def _models(name, seed=3):
    jdt, tdt = DTYPES[name]
    params = _flax_params(seed)
    jmodel = JaxLlamaLM(config=JaxLlamaConfig(**GEOM, dtype=jdt))
    tmodel = LlamaLM(LlamaConfig(**GEOM, dtype=tdt), device="cpu")
    tmodel.load_state_dict(llama_from_flax(params))
    return jmodel, params, tmodel.eval()


def _close(got, want, name, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= REL_TOL[name], f"{what}: {err} of max|value| > {REL_TOL[name]}"


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_prefill_logits_and_pre_repeat_kv_match_reference(name):
    """``return_kv=True``: the logits and each layer's pre-repeat ``(k, v)``
    ``(B, S, Hkv, D)`` against the reference's."""
    jmodel, params, tmodel = _models(name)
    ids = np.random.default_rng(5).integers(0, GEOM["vocab_size"], size=(2, 24)).astype(np.int32)
    want_logits, want_kvs = jmodel.apply({"params": params}, jnp.asarray(ids), return_kv=True)
    with torch.inference_mode():
        got_logits, got_kvs = tmodel(torch.from_numpy(ids).long(), return_kv=True)
    _close(got_logits, want_logits, name, "logits")
    assert len(got_kvs) == GEOM["layers"]
    for i, ((gk, gv), (wk, wv)) in enumerate(zip(got_kvs, want_kvs)):
        assert tuple(gk.shape) == (2, 24, GEOM["kv_heads"], GEOM["hidden"] // GEOM["heads"])
        _close(gk.float(), wk, name, f"layer {i} k")
        _close(gv.float(), wv, name, f"layer {i} v")


def _paged_case(name, seed=8, s=4, bs=4, nb=8):
    """Pages of pre-repeat kv heads (block 0 the trash), a block table
    whose last lane is free (all trash), and positions: one slot at its
    table's last position after the steps, one at 0."""
    jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    hkv, d = GEOM["kv_heads"], GEOM["hidden"] // GEOM["heads"]
    n = s * nb + 1
    pages = [{kk: rng.normal(size=(n, bs, hkv, d)).astype(np.float32) for kk in ("k", "v")}
             for _ in range(GEOM["layers"])]
    table = rng.permutation(np.arange(1, n))[: s * nb].reshape(s, nb).astype(np.int32)
    table[-1] = 0
    positions = np.array([nb * bs - 4, 0, 13, 0], np.int32)[:s]
    tokens = rng.integers(0, GEOM["vocab_size"], size=(3, s)).astype(np.int32)
    jpages = [{kk: jnp.asarray(a, jdt) for kk, a in pg.items()} for pg in pages]
    tpages = [{kk: torch.from_numpy(a).to(tdt) for kk, a in pg.items()} for pg in pages]
    return jpages, tpages, table, positions, tokens


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("jimpl", ["gather", "interpret"])
def test_paged_decode_steps_match_reference(name, jimpl):
    """Three single-token decode steps over pre-repeat pages: each step's
    logits for the live lanes against the reference's ``kv_cache`` +
    ``block_table`` call (its gather tier, or its Pallas kernel in
    interpret mode), and the pages the steps wrote (every block but the
    trash) after the last step."""
    jmodel, params, tmodel = _models(name)
    jpages, tpages, table, positions, tokens = _paged_case(name)
    live = slice(0, len(positions) - 1)
    for step in range(3):
        pos = positions + step
        want, jpages = jmodel.apply(
            {"params": params}, jnp.asarray(tokens[step][:, None]), positions=jnp.asarray(pos),
            kv_cache=jpages, block_table=jnp.asarray(table), attn_impl=jimpl,
        )
        with torch.inference_mode():
            got = tmodel(torch.from_numpy(tokens[step][:, None]).long(), positions=torch.from_numpy(pos),
                         kv_cache=tpages, block_table=torch.from_numpy(table))
        _close(got[live], np.asarray(want)[live], name, f"step {step} logits")
    for i, (jp, tp) in enumerate(zip(jpages, tpages)):
        for kk in ("k", "v"):
            _close(tp[kk][1:].float(), np.asarray(jp[kk], np.float32)[1:], name, f"layer {i} {kk} pages")


def test_decode_step_expands_gqa_in_the_kernel_not_the_pages(monkeypatch):
    """The decode step hands the paged attention the pre-repeat pages
    (``(N, bs, Hkv, D)``) and the query's H heads, and never repeats K/V
    itself."""
    from consensusml_tpu_torch.models import paged_attention as tpa

    _, _, tmodel = _models("f32")
    _, tpages, table, positions, tokens = _paged_case("f32")
    seen, inside = [], []
    plain, repeat = tpa.paged_attention_plain, torch.Tensor.repeat_interleave

    def spy(q, k_pages, v_pages, *args):  # the kernel's stand-in: it repeats the heads it gathered
        seen.append((tuple(q.shape), tuple(k_pages.shape)))
        inside.append(True)
        try:
            return plain(q, k_pages, v_pages, *args)
        finally:
            inside.pop()

    def guarded(*a, **k):
        if not inside:
            pytest.fail("the model repeated K/V outside the paged attention")
        return repeat(*a, **k)

    monkeypatch.setattr(tpa, "paged_attention_plain", spy)
    monkeypatch.setattr(torch.Tensor, "repeat_interleave", guarded)
    with torch.inference_mode():
        tmodel(torch.from_numpy(tokens[0][:, None]).long(), positions=torch.from_numpy(positions),
               kv_cache=tpages, block_table=torch.from_numpy(table))
    hd = GEOM["hidden"] // GEOM["heads"]
    assert seen == [((4, 1, GEOM["heads"], hd), (33, 4, GEOM["kv_heads"], hd))] * GEOM["layers"]


PROMPTS = [np.random.default_rng(40 + i).integers(0, GEOM["vocab_size"], size=4 + 3 * i).tolist()
           for i in range(4)]
MAX_NEW = 16


def test_engine_greedy_streams_match_jax_engine():
    """Four streams of 16 greedy tokens (f32); the JAX engine serving
    ``LlamaLM`` (paged, gather tier) is the reference. The port's tight
    pool (9 usable blocks of 8 against a peak demand of 14) must preempt
    by recompute and still match token for token; both pools end with
    every block free."""
    jmodel, params, tmodel = _models("f32")
    with JaxEngine(jmodel, params, JaxServeConfig(num_slots=4, max_len=32, kv_impl="paged")) as je:
        je.warmup()
        want = [h.result(timeout=120).tokens for h in [je.submit(p, MAX_NEW) for p in PROMPTS]]
    for num_blocks in (0, 10):
        cfg = ServeConfig(num_slots=4, max_len=32, block_size=8, num_blocks=num_blocks)
        with Engine(tmodel, cfg, device="cpu") as eng:
            assert eng.warmup() == {"prefill": 3, "decode": 1}
            results = [h.result(timeout=120) for h in [eng.submit(p, MAX_NEW) for p in PROMPTS]]
            stats = eng.stats()
            eng._pool.check()
        assert [r.tokens for r in results] == want
        assert all(r.finish_reason == "max_tokens" for r in results)
        assert stats["attn_impl"] == "torch"
        assert stats["pool"]["free_blocks"] == stats["pool"]["usable_blocks"]
        assert (stats["evictions"] > 0) == (num_blocks == 10)


def test_decode_model_geometry_and_compute_dtype():
    """``DecodeModel.wrap`` takes Llama's pre-repeat kv heads and head dim
    from its config and the device from its embedding;
    ``to_compute_dtype`` casts the Dense kernels, the adapters and the
    embedding once (RMSNorm scales stay f32) and leaves the logits bit for
    bit as the per-op casts gave them."""
    _, _, tmodel = _models("bf16")
    dm = DecodeModel.wrap(tmodel)
    assert (dm.layers, dm.kv_heads, dm.head_dim, dm.max_len, dm.vocab_size) == (2, 2, 16, 128, 256)
    assert dm.cache_dtype == torch.bfloat16 and dm.device == torch.device("cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(1, 12))).long()
    with torch.inference_mode():
        before = tmodel(ids)
        tmodel.to_compute_dtype()
        after = tmodel(ids)
    dtypes = {n: p.dtype for n, p in tmodel.named_parameters()}
    assert {n for n, dt in dtypes.items() if dt == torch.float32} == {n for n in dtypes if n.endswith(".scale")}
    assert dtypes["layer_0.q_proj.lora_a"] == dtypes["tok_emb.embedding"] == torch.bfloat16
    assert torch.equal(before, after)
    with pytest.raises(ValueError):
        DecodeModel.wrap(torch.nn.Linear(2, 2))


def _refusal_cases():
    pages = [{kk: np.zeros((3, 4, 2, 16), np.float32) for kk in ("k", "v")} for _ in range(GEOM["layers"])]
    table = np.array([[1, 2]], np.int32)
    one = np.array([[3]], np.int32)
    # (what, ids, kwargs, the reference's exception or None where it serves the call, the port's)
    return [
        ("decode_and_prefill", one, dict(kv_cache=pages, block_table=table, positions=np.array([2]), return_kv=True),
         ValueError, ValueError),
        ("table_without_cache", one, dict(block_table=table, positions=np.array([2])), ValueError, ValueError),
        ("two_token_decode", np.array([[3, 4]], np.int32), dict(kv_cache=pages, block_table=table,
                                                                positions=np.array([2])), ValueError, ValueError),
        ("verify_window", np.array([[3, 4]], np.int32), dict(kv_cache=pages, block_table=table,
                                                             positions=np.array([[2, 3]])), None, NotImplementedError),
        ("slot_cache", one, dict(kv_cache=pages, positions=np.array([2])), None, NotImplementedError),
    ]


@pytest.mark.parametrize("case", _refusal_cases(), ids=lambda c: c[0])
def test_serving_hooks_refuse_as_the_reference(case):
    """The hooks' refusals (the reference's ``LlamaLM.__call__``): decode
    and prefill are exclusive, ``block_table`` needs ``kv_cache``, decode
    steps take a single token (ValueError on both sides); the 2-D verify
    window and the per-slot cache, which the reference serves, are not
    ported and raise ``NotImplementedError``."""
    _what, ids, kwargs, jexc, texc = case
    jmodel, params, tmodel = _models("f32")
    jkw = {k: (v if isinstance(v, (bool, np.ndarray)) else [{kk: jnp.asarray(a) for kk, a in pg.items()} for pg in v])
           for k, v in kwargs.items()}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in jkw.items()}
    if jexc is not None:
        with pytest.raises(jexc):
            jmodel.apply({"params": params}, jnp.asarray(ids), **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
               v if isinstance(v, bool) else [{kk: torch.from_numpy(a) for kk, a in pg.items()} for pg in v])
           for k, v in kwargs.items()}
    with pytest.raises(texc):
        tmodel(torch.from_numpy(ids).long(), **tkw)
