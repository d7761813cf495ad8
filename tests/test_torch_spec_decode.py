"""Speculative decode's pieces against ``consensusml_tpu.serve``: the paged
window (2-D ``positions``) of ``GPT2LM`` and ``LlamaLM``, the window's
scatter and attention, and the verify's integer decisions; then the port's
speculative engine against its own plain engine.

Held to the reference (numpy-seeded weights and pages in both packages):

- the window forward's logits and the pages it writes, GPT-2 (2 layers,
  hidden 64, vocab 256) and ``llama_tiny``, in f32 (2e-5 of max|logit|)
  and bf16 (3.5e-2), on both tiers of the port, with a slot whose window
  runs past its row into the trash-padded columns and a free lane;
- ``paged_update_kv_cache_window`` (exact) and ``cached_attention_window``
  (f32, 2e-6);
- ``make_verify_fn``'s ``n_accept`` and ``final`` on greedy inputs whose
  draft agrees with the target for 0 .. k rows, exactly.

Held to the port itself (its sampling does not reproduce JAX's threefry
bits): a speculative engine whose draft is the target gives the plain
engine's streams token for token, greedy and sampled; a draft cut to the
target's first layer gives the plain greedy stream.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models import attention as jattn
from consensusml_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from consensusml_tpu.models.llama import LlamaLM as JaxLlamaLM
from consensusml_tpu.serve import decode as jdecode
from consensusml_tpu.serve.pool import spec as jspec
from consensusml_tpu_torch.models import attention as tattn
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM
from consensusml_tpu_torch.models.llama import LlamaConfig, LlamaLM
from consensusml_tpu_torch.serve import Engine, ServeConfig
from consensusml_tpu_torch.serve import pool as P
from consensusml_tpu_torch.serve.decode import DecodeModel

pytestmark = pytest.mark.serving

GPT2_GEOM = dict(vocab_size=256, hidden=64, layers=2, heads=4, max_len=64)
LLAMA_GEOM = dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=64)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
REL_TOL = {"f32": 2e-5, "bf16": 3.5e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_params(jmodel, seed):
    """The model's flax tree, every leaf redrawn from numpy: norm scales
    near 1, every other leaf N(0, 0.2)."""
    tree = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.normal(0.0, 0.2, size=leaf.shape).astype(np.float32)
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def models(family, dtype="f32", seed=3):
    """``(jax model, flax params, port model on the CPU)`` of one family
    with the same numpy-drawn weights."""
    jdt, tdt = DTYPES[dtype]
    if family == "gpt2":
        jmodel = JaxGPT2LM(config=JaxGPT2Config(**GPT2_GEOM, dropout=0.0, dtype=jdt))
        tmodel = GPT2LM(GPT2Config(**GPT2_GEOM, dropout=0.0, dtype=tdt), device="cpu")
    else:
        jmodel = JaxLlamaLM(config=JaxLlamaConfig(**LLAMA_GEOM, dtype=jdt))
        tmodel = LlamaLM(LlamaConfig(**LLAMA_GEOM, dtype=tdt), device="cpu")
    params = flax_params(jmodel, seed)
    tmodel.load_state_dict(gpt2_from_flax(params))
    return jmodel, params, tmodel.eval()


def japply(jmodel, params, *args, **kwargs):
    statics = ("deterministic", "return_kv", "attn_impl")
    return jax.jit(jmodel.apply, static_argnames=statics)({"params": params}, *args, deterministic=True, **kwargs)


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def random_pages(family, n, bs, seed):
    kvh = LLAMA_GEOM["kv_heads"] if family == "llama" else GPT2_GEOM["heads"]
    d = GPT2_GEOM["hidden"] // GPT2_GEOM["heads"]
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=(n, bs, kvh, d)).astype(np.float32) for k in ("k", "v")} for _ in range(2)]


# three slots, a window of W = 4 (k = 3), 8-token pages, 8 pages a slot plus
# one trash column: slot 0 mid-cache, slot 1 near max_len (its rows 64, 65,
# 66 resolve to the trash column), slot 2 a free lane (all trash)
WINDOW_TABLE = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 0], [9, 10, 11, 12, 13, 14, 15, 16, 0], [0] * 9], np.int32)
WINDOW_POS = np.array([[10, 11, 12, 13], [63, 64, 65, 66], [0, 1, 2, 3]], np.int32)


@pytest.mark.parametrize("impl", ["default", "torch"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_window_forward_matches_reference(family, dtype, impl):
    """The verify window (2-D positions with the pages and a trash-padded
    table) against the reference's gather tier: the live slots' logits,
    and every page but the trash block, which the port writes in place."""
    jdt, tdt = DTYPES[dtype]
    jmodel, params, tmodel = models(family, dtype)
    pages = random_pages(family, 17, 8, seed=11)
    ids = np.random.default_rng(12).integers(0, 256, size=WINDOW_POS.shape).astype(np.int32)
    want, want_pages = japply(jmodel, params, jnp.asarray(ids), positions=jnp.asarray(WINDOW_POS),
                              kv_cache=[{k: jnp.asarray(v, jdt) for k, v in pg.items()} for pg in pages],
                              block_table=jnp.asarray(WINDOW_TABLE), attn_impl="gather")
    tpages = [{k: torch.from_numpy(v).to(tdt) for k, v in pg.items()} for pg in pages]
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(ids).long(), positions=torch.from_numpy(WINDOW_POS), kv_cache=tpages,
                     block_table=torch.from_numpy(WINDOW_TABLE), **({} if impl == "default" else {"attn_impl": impl}))
    assert rel_err(got[:2], np.asarray(want)[:2]) <= REL_TOL[dtype]
    for tp, wp in zip(tpages, want_pages):
        for key in ("k", "v"):
            assert rel_err(tp[key][1:].float(), np.asarray(wp[key], np.float32)[1:]) <= REL_TOL[dtype]


def test_window_scatter_and_attention_match_reference():
    """``paged_update_kv_cache_window`` writes the same rows (exactly) and
    ``cached_attention_window`` gives the same output (f32) as the
    reference's, rows past a slot's row into its trash column."""
    rng = np.random.default_rng(0)
    cache = {k: rng.normal(size=(17, 8, 2, 16)).astype(np.float32) for k in ("k", "v")}
    kw, vw = (rng.normal(size=(3, 4, 2, 16)).astype(np.float32) for _ in range(2))
    jk, jv = jattn.paged_update_kv_cache_window({k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(kw),
                                                jnp.asarray(vw), jnp.asarray(WINDOW_TABLE), jnp.asarray(WINDOW_POS))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tattn.paged_update_kv_cache_window(tcache, torch.from_numpy(kw), torch.from_numpy(vw),
                                       torch.from_numpy(WINDOW_TABLE), torch.from_numpy(WINDOW_POS))
    np.testing.assert_array_equal(tcache["k"][1:].numpy(), np.asarray(jk)[1:])
    np.testing.assert_array_equal(tcache["v"][1:].numpy(), np.asarray(jv)[1:])
    q = rng.normal(size=(3, 4, 2, 16)).astype(np.float32)
    kg, vg = (rng.normal(size=(3, 72, 2, 16)).astype(np.float32) for _ in range(2))
    want = jattn.cached_attention_window(jnp.asarray(q), jnp.asarray(kg), jnp.asarray(vg),
                                         positions=jnp.asarray(WINDOW_POS), dtype=jnp.float32)
    got = tattn.cached_attention_window(torch.from_numpy(q), torch.from_numpy(kg), torch.from_numpy(vg),
                                        positions=torch.from_numpy(WINDOW_POS), dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


def _greedy_proposals(jmodel, params, pages, table, tokens, positions, agree, k):
    """Proposals that agree with the target's greedy tokens for the first
    ``agree[s]`` rows of slot ``s`` and then differ, found row by row with
    the reference's window forward."""
    props = np.zeros((len(tokens), k), np.int32)
    pos = positions[:, None] + np.arange(k + 1)[None, :]
    for i in range(k):
        window = np.concatenate([tokens[:, None], props], axis=1)
        logits, _ = japply(jmodel, params, jnp.asarray(window), positions=jnp.asarray(pos),
                           kv_cache=[{kk: jnp.asarray(v) for kk, v in pg.items()} for pg in pages],
                           block_table=jnp.asarray(table), attn_impl="gather")
        best = np.asarray(logits)[:, i].argmax(-1)
        props[:, i] = np.where(i < agree, best, (best + 1) % 256)
    return props


def test_verify_decisions_match_reference_on_greedy_inputs():
    """``make_verify_fn`` on greedy lanes whose draft agrees with the
    target for 0, 1, 2 and 3 rows of k = 3: the same ``n_accept`` and
    ``final`` (the target's token at the first rejected row, or the bonus)
    as the reference's, and ``n_accept`` the agreement."""
    k = 3
    jmodel, params, tmodel = models("gpt2", "f32", seed=5)
    table = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 0], [9, 10, 11, 12, 13, 14, 15, 16, 0],
                      [17, 18, 19, 20, 21, 22, 23, 24, 0], [25, 26, 27, 28, 29, 30, 31, 32, 0]], np.int32)
    pages = random_pages("gpt2", 33, 8, seed=6)
    tokens = np.array([5, 17, 200, 3], np.int32)
    positions = np.array([12, 30, 61, 40], np.int32)
    agree = np.array([0, 1, 2, 3])
    props = _greedy_proposals(jmodel, params, pages, table, tokens, positions, agree, k)
    q_probs = np.eye(256, dtype=np.float32)[props]  # a greedy draft: one-hot at its proposals
    q_sel = np.ones((4, k), np.float32)
    temp, top_p, seeds = np.zeros(4, np.float32), np.ones(4, np.float32), np.arange(4, dtype=np.uint32)
    jdm = jdecode.DecodeModel.wrap(jmodel)
    n_want, f_want, _ = jspec.make_verify_fn(jdm, k)(
        params, [{kk: jnp.asarray(v) for kk, v in pg.items()} for pg in pages], jnp.asarray(table),
        *(jnp.asarray(a) for a in (tokens, props, q_sel, q_probs, positions, temp, top_p, seeds)))
    verify = P.make_verify_fn(DecodeModel.wrap(tmodel), k, attn_impl="torch")
    tpages = [{kk: torch.from_numpy(v.copy()) for kk, v in pg.items()} for pg in pages]
    args = (tokens, props, q_sel, q_probs, positions, temp, top_p, seeds.astype(np.int64))
    n_got, f_got, _logits = verify(tpages, torch.from_numpy(table), *(torch.from_numpy(a) for a in args))
    assert n_got.tolist() == np.asarray(n_want).tolist() == agree.tolist()
    assert f_got.tolist() == np.asarray(f_want).tolist()


def _engine(model, spec_k=0, draft=None, **cfg):
    spec = None if not spec_k else P.SpecConfig(model=draft if draft is not None else copy.deepcopy(model), k=spec_k)
    return Engine(copy.deepcopy(model), ServeConfig(num_slots=3, block_size=8, **cfg), device="cpu", spec_decode=spec)


PROMPTS = [[3, 14, 15, 92, 65], list(range(40, 61)), [7] * 9, [200, 100, 50]]


def _streams(eng, sampled, max_new=12):
    with eng:
        kw = lambda i: {"temperature": 0.9, "top_p": 0.95, "seed": 100 + i} if sampled else {}  # noqa: E731
        handles = [eng.submit(p, max_new, **kw(i)) for i, p in enumerate(PROMPTS)]
        out = [h.result(timeout=120).tokens for h in handles]
        return out, eng.stats()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_self_draft_engine_gives_the_plain_streams(sampled):
    """A speculative engine whose draft is the target (k = 3) serves the
    plain engine's streams token for token, greedy and sampled, accepting
    every proposal; one more request than slots, so a lane is reused."""
    _j, _p, tmodel = models("gpt2", "f32", seed=8)
    plain, _ = _streams(_engine(tmodel), sampled)
    spec, st = _streams(_engine(tmodel, spec_k=3), sampled)
    assert spec == plain
    assert st["spec"]["acceptance_rate"] == 1.0 and st["spec"]["tokens_per_round"] > 1.0


def test_truncated_draft_gives_the_plain_greedy_stream():
    """A draft of the target's embeddings, first block and final norm
    (k = 4): the greedy streams are the plain engine's; it accepts some
    proposals and rejects others."""
    _j, params, tmodel = models("gpt2", "f32", seed=9)
    draft = GPT2LM(GPT2Config(**{**GPT2_GEOM, "layers": 1}, dropout=0.0, dtype=torch.float32), device="cpu")
    draft.load_state_dict({n: t for n, t in tmodel.state_dict().items() if not n.startswith("h_1.")})
    plain, _ = _streams(_engine(tmodel), False)
    spec, st = _streams(_engine(tmodel, spec_k=4, draft=draft), False)
    assert spec == plain
    assert 0.0 < st["spec"]["acceptance_rate"] < 1.0


def test_spec_engine_refuses_a_draft_it_cannot_verify():
    """The reference's refusals: a draft of another vocabulary, or one
    whose positions stop short of the engine's cache."""
    _j, _p, tmodel = models("gpt2", "f32")
    for geom in ({**GPT2_GEOM, "vocab_size": 128}, {**GPT2_GEOM, "max_len": 32}):
        draft = GPT2LM(GPT2Config(**geom, dropout=0.0, dtype=torch.float32), device="cpu")
        with pytest.raises(ValueError):
            Engine(tmodel, ServeConfig(block_size=8), device="cpu", spec_decode=P.SpecConfig(model=draft, k=2))
    with pytest.raises(ValueError):
        P.SpecConfig(model=tmodel, k=0)
