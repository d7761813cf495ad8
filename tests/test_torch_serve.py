"""Serving parity: the port's sampling, buckets, block pool, engine and
socket front-end against ``consensusml_tpu.serve``.

The end-to-end check serves the same f32 tiny GPT-2 (numpy-seeded
parameters loaded into both packages) and the same prompts through the
JAX ``Engine`` (paged, gather tier) and the port's ``Engine`` on the CPU
(plain-kernel tier): greedy token streams must be identical, including a
port run whose small pool forces recompute preemption.
"""

import json
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensusml_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from consensusml_tpu.models.gpt2 import GPT2LM as JaxGPT2LM
from consensusml_tpu.serve import Engine as JaxEngine
from consensusml_tpu.serve import ServeConfig as JaxServeConfig
from consensusml_tpu.serve import decode as jdecode
from consensusml_tpu.serve import sampling as jsampling
from consensusml_tpu_torch.models.convert import gpt2_from_flax
from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM
from consensusml_tpu_torch.serve import Engine, ServeConfig, ServeServer
from consensusml_tpu_torch.serve import decode as tdecode
from consensusml_tpu_torch.serve import pool as P
from consensusml_tpu_torch.serve import sampling as tsampling
from test_torch_gpt2 import GEOM, random_flax_params

pytestmark = pytest.mark.serving


def test_adjusted_probs_matches_reference():
    """Temperature, nucleus mask and greedy one-hot (ties to the lowest
    index); f32 softmax and cumsum agree to 1e-6."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0.0, 2.0, size=(5, 64)).astype(np.float32)
    logits[4, [3, 9]] = logits[4].max() + 1.0  # a tie for the greedy lane
    temp = np.array([0.0, 0.7, 1.0, 1.5, 0.0], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3, 1.0], np.float32)
    want = np.asarray(jsampling.adjusted_probs(*(jnp.asarray(x) for x in (logits, temp, top_p))))
    got = tsampling.adjusted_probs(*(torch.from_numpy(x) for x in (logits, temp, top_p)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert got[4].argmax().item() == 3 and got[4].max().item() == 1.0


def test_sampling_replays_from_seed_and_greedy_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32))
    temp = torch.tensor([0.0, 1.0, 1.0, 1.0])
    top_p = torch.ones(4)
    seeds = torch.tensor([5, 5, 5, 6])
    pos = torch.tensor([3, 3, 3, 3])
    a = tsampling.sample_token(logits, temp, top_p, seeds, pos)
    b = tsampling.sample_token(logits, temp, top_p, seeds, pos)
    assert a.tolist() == b.tolist() and a[1] == a[2]
    assert a[0].item() == logits[0].argmax().item()
    u = tsampling.sampling_uniforms(torch.arange(100), torch.arange(100), 0, 64)
    assert 0.0 < u.min().item() and u.max().item() < 1.0
    # a sampled lane draws from the whole distribution over many positions
    many = tsampling.sample_token(
        logits[1:2].expand(2000, -1), torch.ones(2000), torch.ones(2000),
        torch.full((2000,), 9), torch.arange(2000),
    )
    freq = np.bincount(many.numpy(), minlength=64) / 2000
    np.testing.assert_allclose(freq, torch.softmax(logits[1], -1).numpy(), atol=0.04)


@pytest.mark.parametrize("max_len,smallest", [(32, 8), (1024, 16), (100, 8), (8, 8)])
def test_prefill_buckets_match(max_len, smallest):
    assert tdecode.prefill_buckets(max_len, smallest) == jdecode.prefill_buckets(max_len, smallest)


def test_block_pool_refuses_double_alloc_double_free_and_overflow():
    pool = P.BlockPool(num_slots=3, max_len=32, block_size=8, num_blocks=9)
    assert pool.usable_blocks == 8 and pool.blocks_per_slot == 4
    got = pool.alloc(0, 2)
    assert P.TRASH_BLOCK not in got
    with pytest.raises(RuntimeError):
        pool.alloc(0, 1)  # double alloc
    with pytest.raises(ValueError):
        pool.extend(0, 3)  # past blocks_per_slot
    pool.alloc(1, 4)
    with pytest.raises(P.NoFreeBlocks):
        pool.alloc(2, 3)
    assert pool.release(0) == got
    with pytest.raises(RuntimeError):
        pool.release(0)  # double free
    assert list(pool.block_row(1, 6)[4:]) == [P.TRASH_BLOCK] * 2
    pool.check()
    pool._free.append(pool.owned(1)[0])  # corrupt: a block both held and free
    with pytest.raises(AssertionError):
        pool.check()


def test_block_pool_random_churn_never_leaks():
    rng = np.random.default_rng(3)
    pool = P.BlockPool(num_slots=4, max_len=32, block_size=4, num_blocks=20)
    for _ in range(400):
        slot = int(rng.integers(4))
        op = rng.random()
        try:
            if slot not in pool._owned:
                pool.alloc(slot, int(rng.integers(1, 5)))
            elif op < 0.5:
                pool.extend(slot, 1)
            else:
                pool.release(slot)
        except (P.NoFreeBlocks, ValueError):
            pass
        pool.check()
        table = pool.device_table("cpu")
        for s in range(4):
            assert table[s, len(pool.owned(s)) :].eq(P.TRASH_BLOCK).all()


def test_admission_scheduler_budget():
    s = P.AdmissionScheduler(prefill_budget=32)
    s.start_tick()
    assert s.try_admit(64)  # the first admission of a tick always fits
    assert not s.try_admit(8)
    s.start_tick()
    assert s.try_admit(16) and s.try_admit(16) and not s.try_admit(8)


def _models():
    jmodel = JaxGPT2LM(config=JaxGPT2Config(**GEOM, dropout=0.0, dtype=jnp.float32))
    params = random_flax_params(jmodel, seed=11)
    tmodel = GPT2LM(GPT2Config(**GEOM, dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(gpt2_from_flax(params))
    return jmodel, params, tmodel


PROMPTS = [np.random.default_rng(20 + i).integers(0, 63, size=4 + 3 * i).tolist() for i in range(4)]
MAX_NEW = 16


def test_engine_greedy_streams_match_jax_engine():
    """Four streams of 16 greedy tokens; the JAX engine (paged, gather) is
    the reference. The port's tight pool (9 usable blocks against a peak
    demand of 14) must preempt by recompute and still match token for
    token; both pools end with every block free."""
    jmodel, params, tmodel = _models()
    with JaxEngine(jmodel, params, JaxServeConfig(num_slots=4, max_len=32, kv_impl="paged")) as je:
        je.warmup()
        want = [h.result(timeout=120).tokens for h in [je.submit(p, MAX_NEW) for p in PROMPTS]]
    for num_blocks in (0, 10):
        cfg = ServeConfig(num_slots=4, block_size=8, num_blocks=num_blocks)
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


def test_server_streams_line_json():
    _, _, tmodel = _models()
    eng = Engine(tmodel, ServeConfig(num_slots=2, max_new_tokens=5), device="cpu")
    server = ServeServer(eng)
    try:
        direct = eng.submit(PROMPTS[1], 5).result(timeout=60).tokens
        lines = _request(server.address, {"ids": PROMPTS[1], "request_id": "t-1"})
        assert [json.loads(x)["token"] for x in lines[:-1]] == direct
        done = json.loads(lines[-1])
        assert done["done"] and done["tokens"] == direct and done["request_id"] == "t-1"
        assert done["finish_reason"] == "max_tokens" and done["seed"] == 0
        err = json.loads(_request(server.address, {"ids": [999]})[0])
        assert "error" in err
    finally:
        server.shutdown()
    assert not eng._thread.is_alive()


def _request(address, payload):
    with socket.create_connection(address, timeout=30) as s:
        s.sendall(json.dumps(payload).encode() + b"\n")
        data = b""
        while chunk := s.recv(65536):
            data += chunk
    return data.decode().strip().splitlines()
