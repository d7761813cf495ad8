"""GPT-2 parity: the port's ``GPT2LM`` (loaded through ``gpt2_from_flax``)
against the JAX package's ``GPT2LM`` with the same parameters.

Parameters and token ids come from numpy seeds and feed both models. The
three paths of the slice are compared: the full forward, the prefill
``return_kv`` forward, and the paged single-token decode step.

Tolerances: in f32 both frameworks compute the same ops on the same
values and differ only in summation order, so logits agree to 2e-5. In
bf16 the two frameworks round at slightly different places (XLA fuses and
rounds elementwise chains differently from ATen), so activations differ
by a few bf16 ulps (2**-8 relative) per layer; logits of this 2-layer
model agree to 6e-2 absolute on values of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu_torch.models.attention import paged_update_kv_cache
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM

GEOM = dict(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32)
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=0.0, atol=6e-2)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def random_flax_params(model, seed):
    """The flax tree's structure with every leaf redrawn from numpy:
    LayerNorm scales near 1, everything else (biases included) nonzero."""
    tree = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        noise = rng.normal(0.0, 0.2, size=leaf.shape).astype(np.float32)
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_map_with_path(draw, tree)


def japply(jmodel, params, *args, **kwargs):
    """The JAX model's forward, jitted (much faster than eager dispatch)."""
    statics = ("deterministic", "return_kv", "attn_impl")
    fn = jax.jit(jmodel.apply, static_argnames=statics)
    return fn({"params": params}, *args, deterministic=True, **kwargs)


def pair(dtype_name, seed=0):
    jdt, tdt = DTYPES[dtype_name]
    jmodel = JaxGPT2LM(config=JaxGPT2Config(**GEOM, dropout=0.0, dtype=jdt))
    params = random_flax_params(jmodel, seed)
    tmodel = GPT2LM(GPT2Config(**GEOM, dtype=tdt), device="cpu")
    tmodel.load_state_dict(gpt2_from_flax(params))
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_full_forward_logits_match(dtype_name):
    jmodel, params, tmodel = pair(dtype_name)
    ids = np.random.default_rng(1).integers(0, 64, size=(2, 13))
    want = np.asarray(japply(jmodel, params, jnp.asarray(ids)))
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 13, 64)
    np.testing.assert_allclose(got, want, **TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_prefill_return_kv_matches(dtype_name):
    jmodel, params, tmodel = pair(dtype_name, seed=2)
    ids = np.random.default_rng(3).integers(0, 64, size=(1, 16))
    want_logits, want_kvs = japply(jmodel, params, jnp.asarray(ids), return_kv=True)
    with torch.inference_mode():
        got_logits, got_kvs = tmodel(torch.from_numpy(ids), return_kv=True)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), **TOL[dtype_name])
    assert len(got_kvs) == len(want_kvs) == GEOM["layers"]
    for (gk, gv), (wk, wv) in zip(got_kvs, want_kvs):
        assert tuple(gk.shape) == wk.shape == (1, 16, 2, 16)
        np.testing.assert_allclose(gk.float().numpy(), np.asarray(wk, np.float32), **TOL[dtype_name])
        np.testing.assert_allclose(gv.float().numpy(), np.asarray(wv, np.float32), **TOL[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["default", "torch"])
def test_paged_decode_step_matches(dtype_name, impl):
    """Two slots with different lengths decode one token against pages
    that hold the same (numpy) history in both frameworks; a free lane
    rides along writing into the trash block. ``"default"`` names no
    tier, which resolves to the plain version for CPU tensors."""
    jdt, tdt = DTYPES[dtype_name]
    jmodel, params, tmodel = pair(dtype_name, seed=4)
    rng = np.random.default_rng(5)
    n, bs, h, d = 9, 8, GEOM["heads"], GEOM["hidden"] // GEOM["heads"]
    pages_np = [
        {k: rng.normal(size=(n, bs, h, d)).astype(np.float32) for k in ("k", "v")}
        for _ in range(GEOM["layers"])
    ]
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    positions = np.array([27, 9, 0], np.int32)
    tokens = np.array([7, 50, 0], np.int32)
    jpages = [{k: jnp.asarray(v, jdt) for k, v in pg.items()} for pg in pages_np]
    want, want_pages = japply(
        jmodel, params, jnp.asarray(tokens)[:, None],
        positions=jnp.asarray(positions), kv_cache=jpages,
        block_table=jnp.asarray(table), attn_impl="gather",
    )
    tpages = [{k: torch.from_numpy(v).to(tdt) for k, v in pg.items()} for pg in pages_np]
    with torch.inference_mode():
        got = tmodel(
            torch.from_numpy(tokens)[:, None], positions=torch.from_numpy(positions),
            kv_cache=tpages, block_table=torch.from_numpy(table),
            **({} if impl == "default" else {"attn_impl": impl}),
        )
    # the live lanes' logits; lane 2 is a free lane (garbage by design)
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2], **TOL[dtype_name])
    for tp, wp in zip(tpages, want_pages):  # pages were updated in place
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tp[key][1:].float().numpy(), np.asarray(wp[key], np.float32)[1:],
                **TOL[dtype_name],
            )


def test_paged_update_writes_in_place_and_clamps_nothing():
    pages = {"k": torch.zeros(3, 4, 1, 2), "v": torch.zeros(3, 4, 1, 2)}
    k = torch.ones(2, 1, 1, 2)
    table = torch.tensor([[2, 1], [0, 0]])
    lengths = paged_update_kv_cache(pages, k, 2 * k, table, torch.tensor([5, 0]))
    assert lengths.tolist() == [6, 1]
    assert pages["k"][1, 1].tolist() == [[1.0, 1.0]]  # slot 0, pos 5 -> block 1 row 1
    assert pages["v"][0, 0].tolist() == [[2.0, 2.0]]  # free lane -> trash block
    with pytest.raises(IndexError):
        paged_update_kv_cache(pages, k, k, table, torch.tensor([8, 0]))


def test_wpe_lookup_clamps_positions():
    """A position past max_len (it scatters into the trash block through
    the table's padding column) still embeds finitely: the position-table
    lookup clamps where PyTorch would otherwise raise."""
    _, _, tmodel = pair("f32")
    pages = [{"k": torch.zeros(2, 32, 2, 16), "v": torch.zeros(2, 32, 2, 16)} for _ in range(2)]
    with torch.inference_mode():
        logits = tmodel(
            torch.tensor([[3]]), positions=torch.tensor([40]), kv_cache=pages,
            block_table=torch.tensor([[1, 0]]),
        )
    assert torch.isfinite(logits).all()
    assert pages[0]["k"][0, 8].abs().sum() > 0  # the write went to trash, row 40 - 32
