"""Tensor parallelism on the collective backend (``--model-axes tp=N``):
the port against the reference's hybrid gossip-DP x tp and against
itself without model axes.

- ``llama_tiny`` with rank-4 adapters, f32, SGD(0.05, momentum 0.9), h 2,
  every leaf trained (the reference's ``tests/test_hybrid_parallel.py``
  setup: Adam would amplify the reduction-order noise), 2 rounds at tp 2
  (a 2x2 torus of workers) and tp 4 (a ring of 2; llama_tiny's 2 kv heads
  do not split over 4 ranks, so k and v are gathered): the port's 8
  ``gloo`` ranks against the reference's collective run on the 8-device
  host mesh and against the port's simulated run, at the reference's
  tolerances (loss rtol 1e-3 atol 1e-4; consensus error rtol 2e-3 atol
  1e-5; parameters rtol 5e-3 atol 5e-4).
- ``gpt2_topk`` smoke through the CLI's rank target at ``--workers 2
  --model-axes tp=2`` with its own codec (top-k + int8 on the logical
  bucket) against the same run without model axes, and its in-run check
  against the program without model axes (a worker step's gradients,
  round 0's loss).
- the CLI's ``--model-axes`` refusals and exit codes against
  ``train.main``'s, and its note when a config's default is dropped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train as ref_train
from consensusml_tpu.comm import WorkerMesh as JaxWorkerMesh
from consensusml_tpu.consensus import GossipConfig as JaxGossipConfig
from consensusml_tpu.data import SyntheticLM, lm_round_batches
from consensusml_tpu.models.llama import llama_loss_fn as jax_llama_loss, llama_tiny as jax_llama_tiny
from consensusml_tpu.parallel import llama_tp_rules as jax_llama_tp_rules
from consensusml_tpu.topology import RingTopology, TorusTopology
from consensusml_tpu.train import (LocalSGDConfig as JaxLocalSGDConfig, init_stacked_state as jax_init_stacked,
                                   make_collective_train_step as jax_collective_step)
from consensusml_tpu_torch.comm.launch import launch
from consensusml_tpu_torch.consensus import GossipConfig
from consensusml_tpu_torch.models.llama import LlamaConfig, LlamaLM, llama_loss_fn
from consensusml_tpu_torch.parallel.check import tp_train_case
from consensusml_tpu_torch.topology import topology_from_name
from consensusml_tpu_torch.train import collective
from consensusml_tpu_torch.train.__main__ import main, parse_args
from consensusml_tpu_torch.train.local_sgd import LocalSGDConfig, init_stacked_state, make_simulated_train_step
from consensusml_tpu_torch.train.optim import sgd

LOSS_TOL = dict(rtol=1e-3, atol=1e-4)
ERR_TOL = dict(rtol=2e-3, atol=1e-5)
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)
SEQ, BATCH, ROUNDS, H = 16, 4, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(tp):
    """The reference's hybrid run (its own test's setup) on the 8 host
    devices: rounds, final stacked params by '/' path, initial params and
    batches as numpy."""
    world = 8 // tp
    model = jax_llama_tiny(lora_rank=4, dtype=jnp.float32)
    topo = RingTopology(world) if world != 4 else TorusTopology(2, 2)
    cfg = JaxLocalSGDConfig(gossip=JaxGossipConfig(topology=topo), optimizer=optax.sgd(0.05, momentum=0.9), h=H)
    init = lambda r: model.init(r, jnp.zeros((1, SEQ), jnp.int32))["params"]  # noqa: E731
    batches = list(lm_round_batches(SyntheticLM(vocab_size=256, seq_len=SEQ), world, H, BATCH, ROUNDS, 0))
    wmesh = JaxWorkerMesh.create(topo, devices=jax.devices()[:8], model_axes=(("tp", tp),))
    state = jax_init_stacked(cfg, init, jax.random.key(0), world)
    flat = lambda tree: {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(x)  # noqa: E731
                         for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    init_params = flat(state.params)
    state = wmesh.shard_stacked(state, rules=jax_llama_tp_rules("tp"))
    step = jax_collective_step(cfg, jax_llama_loss(model), wmesh)
    rounds = []
    for b in batches:
        state, m = step(state, wmesh.shard_stacked(b))
        rounds.append((float(m["loss"]), float(m["consensus_error"])))
    return {"rounds": rounds, "params": flat(state.params), "init": init_params,
            "batches": [{k: np.asarray(v) for k, v in b.items()} for b in batches], "world": world,
            "topology": ("ring", world) if world != 4 else ("torus", world)}


@pytest.fixture(scope="module")
def runs():
    """The reference's runs at tp 2 and 4, then the port's 8 ranks of each."""
    out = {}
    for tp in (2, 4):
        ref = _reference(tp)
        case = {"model": dict(vocab_size=256, hidden=64, layers=2, heads=4, kv_heads=2, mlp_dim=128, max_len=128,
                              lora_rank=4, dtype="float32"),
                "topology": ref["topology"], "tp": tp, "lr": 0.05, "momentum": 0.9, "h": H,
                "params": {n.replace("/", "."): a for n, a in ref["init"].items()}, "batches": ref["batches"]}
        out[tp] = (ref, case, launch(tp_train_case, ref["world"], case, per_worker=tp, timeout=600))
    jax.clear_caches()
    return out


def _simulated(case, world):
    model = LlamaLM(LlamaConfig(**{**case["model"], "dtype": torch.float32}), device="cpu")
    cfg = LocalSGDConfig(gossip=GossipConfig(topology=topology_from_name(*case["topology"])),
                         optimizer=sgd(case["lr"], case["momentum"]), h=case["h"])
    state = init_stacked_state(cfg, {n: torch.from_numpy(a.copy()) for n, a in case["params"].items()}, world)
    step = make_simulated_train_step(cfg, llama_loss_fn(model))
    rounds = []
    for b in case["batches"]:
        state, m = step(state, {k: torch.from_numpy(v.copy()) for k, v in b.items()})
        rounds.append((float(m["loss"]), float(m["consensus_error"])))
    return rounds, {n: p.numpy() for n, p in state.params.items()}


def _port_params(port, world):
    by_worker = {r["worker"]: r["params"] for r in port if r["index"] == 0}
    return {n: np.stack([by_worker[w][n] for w in range(world)]) for n in by_worker[0]}


@pytest.mark.parametrize("tp", [2, 4])
def test_llama_tp_matches_the_references_collective_run(runs, tp):
    ref, case, port = runs[tp]
    for r in port:  # every rank reports the logical workers' values
        for (want_loss, want_err), got in zip(ref["rounds"], r["rounds"]):
            np.testing.assert_allclose(got["loss"], want_loss, **LOSS_TOL)
            np.testing.assert_allclose(got["consensus_error"], want_err, **ERR_TOL)
    got = _port_params(port, ref["world"])
    for n, w in ref["params"].items():
        np.testing.assert_allclose(got[n.replace("/", ".")], w, **PARAM_TOL, err_msg=n)


@pytest.mark.parametrize("tp", [2, 4])
def test_llama_tp_matches_the_ports_simulated_run(runs, tp):
    ref, case, port = runs[tp]
    rounds, params = _simulated(case, ref["world"])
    for (want_loss, want_err), got in zip(rounds, port[0]["rounds"]):
        np.testing.assert_allclose(got["loss"], want_loss, **LOSS_TOL)
        np.testing.assert_allclose(got["consensus_error"], want_err, **ERR_TOL)
    got = _port_params(port, ref["world"])
    for n, w in params.items():
        np.testing.assert_allclose(got[n], w, **PARAM_TOL, err_msg=n)
    # the exact gossip's wire carries the logical payload once: the ranks'
    # pieces and the replicated leaves (sent by model index 0 alone)
    assert len({rd["wire_bytes"] for r in port for rd in r["rounds"]}) == 1


def _gpt2_spec(model_axes):
    args = parse_args(["--config", "gpt2_topk", "--device", "cpu", "--backend", "collective", "--workers", "2",
                       "--rounds", "2", "--log-every", "0"])
    spec = {**vars(args), "workers": 2, "sched_start": 0, "elastic_from": None}
    if model_axes:
        spec.update(model_axes=[["tp", 2]], tp_check={"grad_rel_tol": 3e-2, "leaf_rel_tol": 4e-2, "loss_rtol": 1e-3})
    return spec


def test_gpt2_topk_tp2_with_its_codec_matches_the_run_without_tp():
    """bf16 GPT-2 smoke on the config's top-k + int8 codec: the tp run's
    losses and consensus errors within 1e-3 of the run without model axes
    (the row-split products' partial sums are reduced in f32 and rounded
    once more), the same logical wire bytes a round, and its in-run check
    against the program without model axes within the card gates. Its
    parameters are held in f32 below: in bf16 a near tie of the codec's
    top-k can flip."""
    tp = collective.run(_gpt2_spec(True), 2)
    plain = collective.run(_gpt2_spec(False), 2)
    for a, b in zip(tp[0]["rounds"], plain[0]["rounds"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-3)
        np.testing.assert_allclose(a["consensus_error"], b["consensus_error"], rtol=1e-3)
        assert a["wire_bytes"] == b["wire_bytes"] and a["wire_bytes_worker_ranks"] == 2 * b["wire_bytes"]
        assert a["tp_bytes"] > 0 and a["tp_gather_bytes"] > 0
    assert tp[0]["wire_bytes_per_round"] == plain[0]["wire_bytes_per_round"]
    assert tp[0]["buckets"] == plain[0]["buckets"]
    check = tp[0]["tp_check"]
    assert check["grad_rel_err"] <= 3e-2 and check["loss_rel_err"] <= 1e-3


def _gpt2_case(tp):
    """``gpt2_topk`` smoke's gossip (top-k + int8 on the two-step wire) and
    Adam, its model in f32, on a ring of 2 workers."""
    from consensusml_tpu_torch import configs

    bundle = configs.build("gpt2_topk", "smoke", world=2, device="cpu")
    params, _ = bundle.convert(bundle.init_params(0))
    batches = [{k: v.numpy() for k, v in b.items()} for b in bundle.batches(3, 0)]
    c = bundle.model.config
    return {"family": "gpt2", "model": dict(vocab_size=c.vocab_size, hidden=c.hidden, layers=c.layers, heads=c.heads,
                                            max_len=c.max_len, dropout=c.dropout, dtype="float32"),
            "cfg": bundle.cfg, "topology": ("ring", 2), "tp": tp, "batches": batches,
            "params": {n: p.numpy() for n, p in params.items()}}


def test_gpt2_topk_tp2_in_f32_equals_the_run_without_tp():
    """The same gossip and optimizer with the model in f32, 3 rounds (two
    compressed): tp 2 against tp 1 at the llama case's tolerances. In f32
    the two programs part only by the order of their f32 sums, too little
    to move the codec's top-k choice (in bf16 a near tie can flip, and a
    flipped coordinate moves by the workers' disagreement times gamma)."""
    got = launch(tp_train_case, 2, _gpt2_case(2), per_worker=2, timeout=600)
    want = launch(tp_train_case, 2, _gpt2_case(1), timeout=600)
    for (a, b) in zip(got[0]["rounds"], want[0]["rounds"]):
        np.testing.assert_allclose(a["loss"], b["loss"], **LOSS_TOL)
        np.testing.assert_allclose(a["consensus_error"], b["consensus_error"], **ERR_TOL)
        assert a["wire_bytes"] == b["wire_bytes"]
    for w in range(2):
        for n, p in want[w]["params"].items():
            np.testing.assert_allclose(got[2 * w]["params"][n], p, **PARAM_TOL, err_msg=n)


REFUSALS = {
    "bad_value": ["--config", "gpt2_topk", "--model-axes", "tp=x"],
    "size_below_1": ["--config", "gpt2_topk", "--model-axes", "tp=0"],
    "two_axes": ["--config", "gpt2_topk", "--model-axes", "tp=2,pp=2"],
    "no_rules": ["--config", "mnist_mlp", "--model-axes", "tp=2"],
    "simulated": ["--config", "gpt2_topk", "--model-axes", "tp=2"],
}


def _run(fn, argv, capsys):
    rc = fn(argv)
    out = capsys.readouterr()
    return rc, out.err.strip().splitlines(), out.out


@pytest.mark.parametrize("case", list(REFUSALS))
def test_model_axes_refusals_equal_the_references(case, capsys):
    argv = REFUSALS[case] + ["--device", "cpu", "--rounds", "1"]
    want_rc, want_err, _ = _run(ref_train.main, argv + ["--backend", "simulated"], capsys)
    got_rc, got_err, _ = _run(main, argv, capsys)
    assert got_rc == want_rc == 2
    assert got_err[0] == want_err[0] and got_err[0].startswith("error: ")
    if case != "simulated":  # the collective backend refuses the same
        assert _run(main, argv + ["--backend", "collective"], capsys)[:2] == (got_rc, got_err)


@pytest.mark.parametrize("value", ["none", "", "NONE"])
def test_model_axes_none_runs_without_model_axes(value, capsys):
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.__main__ import _model_axes

    args = parse_args(["--config", "llama_lora", "--scale", "full", "--device", "cpu", "--model-axes", value])
    bundle = configs.build("llama_lora", "smoke", device="cpu")
    bundle.model_axes = (("tp", 4),)  # the full config's default
    assert _model_axes(args, bundle) == ((), None)
    assert capsys.readouterr().out == ""


def test_config_default_dropped_with_the_references_note(capsys, monkeypatch):
    """``llama_lora`` full defaults to tp 4 a worker; on a host of fewer
    devices than 16 x 4 the default is dropped with the reference's note
    (``train.py:740-746``, its device count the port's: the CUDA cards, or
    one for ``--device cpu``) and the run goes on without model axes."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.__main__ import _model_axes

    bundle = configs.build("llama_lora", "smoke", device="cpu")
    bundle.model_axes, bundle.world_size = (("tp", 4),), 16
    args = parse_args(["--config", "llama_lora", "--scale", "full", "--device", "cpu"])
    assert _model_axes(args, bundle) == ((), None)
    devices = 1
    want = (f"note: dropping config default model_axes=tp=4 (needs {bundle.world_size}x4 devices, have "
            f"{devices}); pass --model-axes to force")
    assert capsys.readouterr().out.strip() == want
    # an explicit value is honoured whatever the device count
    args = parse_args(["--config", "llama_lora", "--scale", "full", "--device", "cpu", "--model-axes", "tp=2",
                       "--backend", "collective"])
    assert _model_axes(args, bundle) == ((("tp", 2),), None)


def test_model_axes_refuse_the_flags_that_do_not_run_under_them(capsys):
    rc = main(["--config", "gpt2_topk", "--device", "cpu", "--backend", "collective", "--model-axes", "tp=2",
               "--grad-clip", "1.0", "--eval-batches", "1", "--rounds", "1"])
    assert rc == 2
    assert capsys.readouterr().err.strip() == "error: --model-axes does not run with --eval-batches, --grad-clip yet"
