"""The port's cost plane (``consensusml_tpu_torch.obs.costs``,
``obs.memviz``, ``workcount``, ``/profile``) against the reference's
(``consensusml_tpu.obs.costs``, ``obs.memviz``, ``/profile``).

- the ledger's arithmetic: ``ExecutableCost.floors_s`` and ``peak_bytes``,
  ``attribution``, ``observe_measured``, ``register_transfer`` and
  ``snapshot`` equal the reference's on the same rows, peaks and times,
  and so does the Prometheus text of every ``consensusml_cost_*``,
  ``consensusml_compile_*`` and ``consensusml_hbm_*`` family;
- the counting pass: ``mnist_mlp`` smoke's ``train.step`` flops within
  ``MNIST_FLOPS_RTOL`` of the reference's ``cost_analysis()`` on the CPU;
  every kernel wrapper's count, on CPU tensors and on fake CUDA ones,
  equal to its shape formula (each operand read once, each result written
  once; the operations its function does); registration analysis only
  (two CLI runs with and without ``--cost-ledger`` bit-equal, generators
  and tensors untouched); the gossip round's row tagged as the
  reference's;
- serving: every executable has a row and the wide event joins it;
- ``/profile``: single-flight (200, then 409), its families counted, the
  ``--profile-dir`` window's session refused, captures rotated;
- ``obs_report`` renders the attribution and memory sections from port
  rows.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import consensusml_tpu.obs.costs as rcosts
import consensusml_tpu.obs.memviz as rmemviz
from consensusml_tpu.obs.metrics import MetricsRegistry as RRegistry
from consensusml_tpu_torch import workcount
from consensusml_tpu_torch.obs import costs as qcosts
from consensusml_tpu_torch.obs import memviz as qmemviz
from consensusml_tpu_torch.obs.metrics import MetricsRegistry as QRegistry

pytestmark = pytest.mark.profiling

# the counting pass against XLA's cost analysis of the same step: XLA counts
# its fused program (a comparison, a select or a convert inside a fusion
# counts like any elementwise op, some reductions count one op an element
# where the pass counts the output), the pass the eager ops; the matmuls,
# 99% of the step's flops, are counted alike (measured gap: 0.38%)
MNIST_FLOPS_RTOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs beside five other workers on
    eight cores, where more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN (the attribution's unmeasured fields)."""
    return json.dumps(a, sort_keys=True, default=str) == json.dumps(b, sort_keys=True, default=str)


ROW = dict(name="toy.step", platform="cpu", flops=3.2e9, bytes_accessed=1.6e9, argument_bytes=4096,
           output_bytes=2048, temp_bytes=1024, alias_bytes=512, generated_code_bytes=0, compile_s=0.25)


def _ledgers(peaks=(1e12, 1e11, 1e10)):
    rreg, qreg = RRegistry(), QRegistry()
    kw = dict(platform="cpu", peak_flops_per_s=peaks[0], peak_bytes_per_s=peaks[1], peak_transfer_bytes_per_s=peaks[2])
    return rcosts.CostLedger(registry=rreg, **kw), qcosts.CostLedger(registry=qreg, **kw), rreg, qreg


@pytest.mark.parametrize("kind", ["compiled", "transfer"])
def test_floors_and_peak_bytes_equal_the_references(kind):
    r = rcosts.ExecutableCost(**ROW, kind=kind)
    q = qcosts.ExecutableCost(**ROW, kind=kind)
    assert q.peak_bytes == r.peak_bytes == 4096 + 1024 + 2048 - 512
    for peaks in ((1e12, 1e11, 1e10), (5e10, 2e10, None), (0.0, 1e9, None)):
        assert q.floors_s(*peaks) == r.floors_s(*peaks)
    assert q.as_dict() == r.as_dict()


def test_attribution_observe_snapshot_and_prometheus_equal_the_references():
    rled, qled, rreg, qreg = _ledgers()
    rows = [dict(ROW), {**ROW, "name": "gossip.round", "flops": 1e6, "bytes_accessed": 8e9}]
    for row in rows:
        rled._record(rcosts.ExecutableCost(**row))
        qled._record(qcosts.ExecutableCost(**row))
    assert _same(qled.attribution("toy.step"), rled.attribution("toy.step"))
    for name, seconds in (("toy.step", 0.0125), ("gossip.round", 0.2), ("toy.step", 0.004)):
        assert _same(qled.observe_measured(name, seconds), rled.observe_measured(name, seconds))
    assert _same(qled.snapshot(), rled.snapshot())
    assert qled.names() == rled.names()
    with pytest.raises(KeyError):
        qled.observe_measured("nope", 1.0)
    assert qreg.to_prometheus() == rreg.to_prometheus()
    assert "consensusml_cost_floor_ratio" in qreg.to_prometheus()


def test_register_transfer_equals_the_references():
    rled, qled, rreg, qreg = _ledgers()
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((64, 32)).astype(np.float32), "b": rng.standard_normal(32).astype(np.float32),
            "e": rng.integers(0, 9, (16,)).astype(np.int32)}
    r = rled.register_transfer("serve.hotswap.stage", {k: jnp.asarray(v) for k, v in tree.items()}, meta={"g": 1})
    q = qled.register_transfer("serve.hotswap.stage", {k: torch.from_numpy(v) for k, v in tree.items()},
                               meta={"g": 1})
    assert q.as_dict() == r.as_dict()
    assert _same(qled.attribution("serve.hotswap.stage"), rled.attribution("serve.hotswap.stage"))
    assert qreg.to_prometheus() == rreg.to_prometheus()
    # a module stages its parameters and buffers
    lin = torch.nn.Linear(32, 64)
    assert qled.register_transfer("m", lin).argument_bytes == 4 * (32 * 64 + 64)


def test_compile_counters_count_compiled_rows_only():
    _r, qled, _rr, qreg = _ledgers()
    qled.register("a", lambda x: x * 2, torch.ones(8))
    qled.register("b", lambda x: x @ x.T, torch.ones(8, 4))
    n1 = qreg.counter("consensusml_compile_total").value
    qled.register_transfer("stage", torch.ones(16))
    assert n1 == 2 and qreg.counter("consensusml_compile_total").value == 2
    assert qreg.counter("consensusml_compile_seconds_total").value > 0
    assert qled.row("b").flops == 2 * 8 * 8 * 4 and qled.row("a").flops == 8
    assert qled.row("a").meta["generated_code"] == "none (eager)"


def test_peaks_are_per_card_and_unknown_cards_raise():
    led = qcosts.CostLedger(registry=QRegistry(), platform="NVIDIA H100 80GB HBM3")
    assert (led.peak_flops_per_s, led.peak_bytes_per_s, led.peak_transfer_bytes_per_s) == (989.4e12, 3.35e12, 64e9)
    assert qcosts.CostLedger(registry=QRegistry(), platform="cpu").peak_flops_per_s == rcosts.DEVICE_PEAKS["cpu"][0]
    with pytest.raises(ValueError, match="no peaks known"):
        qcosts.CostLedger(registry=QRegistry(), platform="NVIDIA Imaginary 1")
    own = qcosts.CostLedger(registry=QRegistry(), platform="NVIDIA Imaginary 1", peak_flops_per_s=1e12,
                            peak_bytes_per_s=1e11)
    assert own.peak_transfer_bytes_per_s == 1e11
    assert qcosts.device_kind("cpu") == "cpu"


@pytest.mark.parametrize("sides", [(120.0, 100.0, 90.0), (120.0, 100.0, None), (None, 100.0, 80.0),
                                   (50.0, 0.0, 10.0)])
def test_reconcile_drift_and_hbm_families_equal_the_references(sides):
    rreg, qreg = RRegistry(), QRegistry()
    ra, qa = rmemviz.HbmAccountant(registry=rreg), qmemviz.HbmAccountant(registry=qreg, device="cpu")
    live = sides[2]
    if live is None:  # the reference's CPU live side: its samples' high-water mark
        live = ra.live_peak_bytes
    want = ra.reconcile(sides[0], sides[1], live)
    got = qa.reconcile(sides[0], sides[1], live)
    assert _same(got, want)
    keep = lambda text: [x for x in text.splitlines() if "consensusml_hbm" in x]  # noqa: E731
    assert keep(qreg.to_prometheus()) == keep(rreg.to_prometheus())


def test_memory_accounting_on_the_cpu_has_no_live_side():
    """No runtime accounts CPU tensors: the live side is None (dropping
    out of the drift pairs), the runtime stats None, the tick's gauges
    NaN; the engine's tagged consumers are read from the registry."""
    reg = QRegistry()
    reg.gauge("consensusml_pool_hbm_bytes").set(4096.0)
    live = qmemviz.live_array_bytes("cpu", reg)
    assert live == {"bytes": None, "arrays": None, "tagged": {"consensusml_pool_hbm_bytes": 4096.0}}
    assert qmemviz.device_memory_stats("cpu") is None
    acct = qmemviz.HbmAccountant(registry=reg, device="cpu")
    tick = acct.tick()
    assert tick["live_bytes"] is None and acct.live_peak_bytes is None
    doc = acct.reconcile(200.0, 100.0)
    assert doc["drift_pct"] == {"analytic_vs_compiled": 100.0}
    assert qmemviz.compiled_footprint(qcosts.ExecutableCost(**ROW)) == 4096 + 1024 + 2048 - 512


def test_load_tool_loads_the_ports_own_tools():
    assert qmemviz.load_tool("hbm_model").__file__.endswith(os.path.join("consensusml_tpu_torch", "tools",
                                                                          "hbm_model.py"))
    assert qmemviz.load_tool("profile_summary") is not None and qmemviz.load_tool("nope") is None


# ---------------------------------------------------------------------------
# the counting pass
# ---------------------------------------------------------------------------


def _mnist_step_costs():
    from consensusml_tpu import configs as rconfigs
    from consensusml_tpu.train import init_stacked_state as r_init
    from consensusml_tpu.train import make_simulated_train_step as r_step
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step

    rb = rconfigs.build("mnist_mlp", "smoke")
    rstate = r_init(rb.cfg, rb.init_params, jax.random.key(0), rb.world_size)
    rrow = rcosts.CostLedger(registry=RRegistry(), platform="cpu").register(
        "train.step", r_step(rb.cfg, rb.loss_fn), rstate, next(iter(rb.batches(1, 0))))
    b = configs.build("mnist_mlp", "smoke", device="cpu")
    params, model_state = configs.init_on_device(b, 0, "cpu")
    state = init_stacked_state(b.cfg, params, b.world_size, model_state=model_state)
    qrow = qcosts.CostLedger(registry=QRegistry(), platform="cpu").register(
        "train.step", make_simulated_train_step(b.cfg, b.loss_fn), state, next(iter(b.batches(1, 0))))
    return rrow, qrow


def test_mnist_train_step_flops_near_the_references_cost_analysis():
    rrow, qrow = _mnist_step_costs()
    assert qrow.flops == pytest.approx(rrow.flops, rel=MNIST_FLOPS_RTOL)
    # the same arguments and outputs (the reference's 48 more argument
    # bytes: its typed PRNG keys; the port's generators are not tensors)
    assert qrow.argument_bytes == pytest.approx(rrow.argument_bytes, abs=64)
    assert qrow.output_bytes == pytest.approx(rrow.output_bytes, rel=1e-3)
    assert qrow.temp_bytes > 0 and qrow.peak_bytes > 0


def _kernel_cases():
    """Each of the 19 wrappers at a small shape: name -> (CPU operands,
    call, (flops, bytes) by its shape formula)."""
    from consensusml_tpu_torch.compress import kernels as tck
    from consensusml_tpu_torch.models import flash_attention as tfa
    from consensusml_tpu_torch.models import fused_bn as tbn
    from consensusml_tpu_torch.models import fused_ln as tln
    from consensusml_tpu_torch.models import paged_attention as tpa

    g = torch.Generator().manual_seed(0)
    r = lambda *s, dtype=torch.float32: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    rows, c, k = 6, 256, 8
    m = rows * c
    x = r(rows, c)
    out = {}
    for fmt, code in (("int8", 1), ("int4", 0.5), ("fp8", 1)):
        quant, dequant = getattr(tck, f"quantize_{fmt}"), getattr(tck, f"dequantize_{fmt}")
        out[f"quantize_{fmt}"] = ((x,), quant, (3 * m, 4 * m + code * m + 4 * rows))
        out[f"dequantize_{fmt}"] = (quant(x), dequant, (m, code * m + 4 * rows + 4 * m))
    out["chunked_topk"] = ((x, k), tck.chunked_topk, (k * m, 4 * m + 8 * rows * k))
    vals, idx = tck.chunked_topk(x, k)
    out["chunk_scatter"] = ((vals, idx, c, x), tck.chunk_scatter, (2 * rows * k, 2 * 4 * m + 8 * rows * k))
    out["fused_choco_encode"] = ((x, x * 0.5), lambda a, b: tck.fused_pack_quantize(a, b, fmt="int4"),
                                 (5 * m, 8 * m + m // 2 + 4 * rows + 4 * m))
    data, scales, _h = tck.fused_pack_quantize(x, x * 0.5, fmt="fp8")
    out["fused_dequantize_accumulate"] = (
        (x, [(data, scales)] * 3), lambda s, src: tck.fused_dequantize_accumulate(s, src, fmt="fp8",
                                                                                 weights=(0.5, 0.25, 0.25)),
        (10 * m, 4 * m + 3 * (m + 4 * rows) + 4 * m))
    b, s, h, d = 2, 16, 2, 64
    q, kk, v, do = (r(b, s, h, d, dtype=torch.bfloat16) for _ in range(4))
    pairs, elems, rws = b * h * s * (s + 1) // 2, b * s * h * d, b * h * s
    _o, lse = tfa.flash_attention(q, kk, v, causal=True, return_lse=True)
    mask = torch.ones(b, s)
    out["flash_attention_fwd"] = ((q, kk, v, mask), lambda *a: tfa.flash_attention(*a[:3], causal=True, kv_mask=a[3],
                                                                                   return_lse=True),
                                  (4 * d * pairs, 4 * elems * 2 + rws * 4 + b * s * 4))
    delta = r(b, h, s)
    out["flash_attention_bwd_dq"] = ((q, kk, v, do, lse, delta), lambda *a: tfa.flash_attention_bwd_dq(*a, causal=True),
                                     (6 * d * pairs, 5 * elems * 2 + 2 * rws * 4))
    out["flash_attention_bwd_dkv"] = ((q, kk, v, do, lse, delta),
                                      lambda *a: tfa.flash_attention_bwd_dkv(*a),
                                      (8 * d * b * h * s * s, 6 * elems * 2 + 2 * rws * 4))
    slots, w, bs, nb, hkv = 3, 2, 4, 5, 1
    pages = r(slots * nb + 1, bs, hkv, d, dtype=torch.bfloat16)
    table = torch.arange(1, slots * nb + 1, dtype=torch.int32).view(slots, nb)
    pos = torch.tensor([[0, 1], [5, 6], [18, 19]], dtype=torch.int32)
    keys = slots * nb * bs  # the static extent: every key the block table reaches
    out["paged_attention"] = ((r(slots, w, h, d, dtype=torch.bfloat16), pages, pages, table, pos), tpa.paged_attention,
                              (4 * w * keys * h * d, 2 * keys * hkv * d * 2 + slots * w * h * d * 4 + 4 * (
                                  slots * nb + slots * w)))
    mr, hd = 32, 64
    x2, g2 = r(mr, hd, dtype=torch.bfloat16), r(hd)
    out["ln_fwd"] = ((x2, g2, g2), lambda *a: tln.ln_fwd(*a, 1e-6), (8 * mr * hd, 2 * mr * hd + 4 * mr * hd + 8 * hd))
    out["ln_bwd"] = ((x2.float(), x2, g2), tln.ln_bwd, (16 * mr * hd, (4 + 2 * 2) * mr * hd + 12 * hd))
    n = mr * hd
    mean, _var, scale, shift, rsqrt = tbn.bn_forward_stats(x2, g2, g2, 1e-5)
    out["bn_stats"] = ((x2,), tbn.bn_stats, (3 * n, 2 * n + 8 * hd))
    out["bn_norm"] = ((x2, scale, shift, True), tbn.bn_norm, (3 * n, 4 * n + 8 * hd))
    out["bn_bwd"] = ((x2, x2, scale, shift, mean, rsqrt, True), tbn.bn_bwd, (11 * n, 6 * n + 24 * hd))
    return out


def _fake_cuda(mode, x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="cuda")
    if isinstance(x, (list, tuple)):
        return type(x)(_fake_cuda(mode, v) for v in x)
    return x


KERNEL_NAMES = ["quantize_int8", "dequantize_int8", "quantize_int4", "dequantize_int4", "quantize_fp8",
                "dequantize_fp8", "chunked_topk", "chunk_scatter", "fused_choco_encode", "fused_dequantize_accumulate",
                "flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv", "paged_attention",
                "ln_fwd", "ln_bwd", "bn_stats", "bn_norm", "bn_bwd"]


def test_kernel_names_are_every_kernel():
    from consensusml_tpu_torch import kernels

    assert sorted(KERNEL_NAMES) == sorted(kernels.KERNELS)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_wrapper_counts_its_shape_formula_on_cpu_and_fake_cuda_tensors(name):
    """The wrapper reports its function's work from its shapes: on CPU
    tensors (its plain version runs, the ops uncounted) and on fake CUDA
    ones (the card's layout; the plain version on ``meta`` copies), the
    same (flops, bytes), the formula's."""
    ops, call, (flops, nbytes) = _kernel_cases()[name]
    c = workcount.WorkCounter()
    with c:
        call(*ops)
    assert (c.flops, c.bytes) == (float(flops), float(nbytes))
    assert c.ops == 0 and list(c.kernels) == [name.replace("flash_attention_fwd", "flash_attention").replace(
        "fused_choco_encode", "fused_pack_quantize")]
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fops = _fake_cuda(mode, ops)
        assert all(t.is_cuda and not workcount.on_card(t) for t in workcount._tensors(fops))
        f = workcount.WorkCounter()
        with f:
            res = call(*fops)
    assert (f.flops, f.bytes) == (c.flops, c.bytes)
    assert all(t.device.type == "cuda" for t in workcount._tensors(res))


def test_fake_pass_writes_nothing_draws_nothing_and_counts_live_memory():
    lin = torch.nn.Linear(64, 32)
    w0 = lin.weight.detach().clone()
    g = torch.Generator().manual_seed(3)
    state = g.get_state().clone()
    x = torch.randn(8, 64)

    def f(x, g):
        y = lin(x).relu()
        lin.weight.data.add_(1.0)  # a write to a captured tensor lands on its fake
        return (y * torch.rand(y.shape, generator=g)).sum()

    a = workcount.analyze(f, x, g)
    assert torch.equal(lin.weight, w0) and torch.equal(g.get_state(), state)
    assert a.flops == 2 * 8 * 64 * 32 + 8 * 32 * 2 + 1 + 32 * 64
    assert a.argument_bytes == x.numel() * 4 and a.output_bytes == 4 and a.temp_bytes > 0
    assert isinstance(a.result, torch.Tensor) and not workcount.on_card(a.result)


def _train_cli(tmp, name, extra, config="gpt2_topk"):
    from consensusml_tpu_torch.train.__main__ import main

    path = os.path.join(tmp, f"{name}.jsonl")
    assert main(["--config", config, "--device", "cpu", "--rounds", "2", "--metrics-out", path, *extra]) == 0
    with open(path) as f:
        return [(r["loss"], r["consensus_error"]) for r in map(json.loads, f)]


def test_cost_ledger_cli_rounds_are_bit_equal_to_a_run_without_it(tmp_path, capsys):
    """``--cost-ledger`` is analysis only: two rounds of ``gpt2_topk``
    smoke (the top-k codec's four kernel wrappers, the fused LN's) give
    the same losses and consensus errors as without it, and print the
    reference's lines."""
    flags = ["--norm-impl", "pallas"]
    without = _train_cli(str(tmp_path), "without", flags)
    capsys.readouterr()
    with_ = _train_cli(str(tmp_path), "with", [*flags, "--cost-ledger"])
    out = capsys.readouterr().out
    assert with_ == without
    for line in ("cost ledger: train.step", "cost ledger: gossip.round", "cost attribution: train.step",
                 "hbm reconciliation: analytic"):
        assert line in out


def test_registration_leaves_tensors_generators_and_rounds_as_they_were():
    """The state after registering ``train.step`` and ``gossip.round`` is
    the state before, bit for bit (parameters, optimizer and CHOCO state,
    generators, the round counter), and two rounds from it equal two
    rounds from an unregistered twin."""
    from consensusml_tpu_torch import configs
    from consensusml_tpu_torch.train.local_sgd import init_stacked_state, make_simulated_train_step
    from consensusml_tpu_torch.utils import tree as T

    b = configs.build("gpt2_topk", "smoke", device="cpu")
    batches = list(b.batches(2, 0))

    def fresh():
        params, model_state = configs.init_on_device(b, 0, "cpu")
        return init_stacked_state(b.cfg, params, b.world_size, model_state=model_state)

    state, twin = fresh(), fresh()
    before = [t.clone() for _, t in T.named_tensors((state.params, state.opt_state, state.gossip))]
    gens = [g.get_state().clone() for g in state.generators]
    led = qcosts.CostLedger(registry=QRegistry(), platform="cpu")
    step = make_simulated_train_step(b.cfg, b.loss_fn)
    row = led.register("train.step", step, state, batches[0])
    grow = b.cfg.engine().register_costs(led, {"params": state.params, "model_state": state.model_state})
    after = [t for _, t in T.named_tensors((state.params, state.opt_state, state.gossip))]
    assert all(torch.equal(x, y) for x, y in zip(before, after)) and len(before) == len(after)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(state.generators, gens)) and state.step == 0
    assert row.meta["kernels"]["chunked_topk"]["calls"] > 0 and grow.flops > 0
    twin_step = make_simulated_train_step(b.cfg, b.loss_fn)
    for batch in batches:
        state, m = step(state, batch)
        twin, tm = twin_step(twin, batch)
        assert float(m["loss"]) == float(tm["loss"])
    assert all(torch.equal(state.params[n], twin.params[n]) for n in state.params)


def test_gossip_round_row_is_tagged_as_the_references():
    """``ConsensusEngine.register_costs``: the bucket plan, wire bytes and
    transport facts of the reference's row, for the config's top-k wire
    and an overlap twin."""
    from consensusml_tpu import configs as rconfigs
    from consensusml_tpu_torch import configs

    for name in ("gpt2_topk", "mnist_mlp"):
        rb = rconfigs.build(name, "smoke")
        probe = jax.eval_shape(rb.init_params, jax.random.key(0))
        params, model_state = probe if isinstance(probe, tuple) else (probe, {})
        stack = lambda t: jax.ShapeDtypeStruct((rb.world_size, *t.shape), t.dtype)  # noqa: E731
        rrow = rb.cfg.engine().register_costs(rcosts.CostLedger(registry=RRegistry(), platform="cpu"),
                                              jax.tree.map(stack, {"params": params, "model_state": model_state}))
        b = configs.build(name, "smoke", device="cpu")
        p, ms = configs.init_on_device(b, 0, "cpu")
        qrow = b.cfg.engine().register_costs(qcosts.CostLedger(registry=QRegistry(), platform="cpu"),
                                             {"params": p, "model_state": ms})
        for key in ("world", "buckets", "bucket_elems", "wire_bytes_per_round", "fused_wire", "pipeline_depth",
                    "gossip_steps", "overlap_twin"):
            assert qrow.meta[key] == rrow.meta[key], (name, key)
        assert qrow.flops > 0 and qrow.argument_bytes > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _engine(spec=True, prefix=True):
    import copy

    from consensusml_tpu_torch.models.gpt2 import GPT2Config, GPT2LM
    from consensusml_tpu_torch.serve import Engine, ServeConfig
    from consensusml_tpu_torch.serve import pool as P

    torch.manual_seed(0)
    m = GPT2LM(GPT2Config(vocab_size=64, hidden=32, layers=2, heads=2, max_len=32, dropout=0.0, dtype=torch.float32),
               device="cpu")
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.05)
    sc = P.SpecConfig(model=copy.deepcopy(m), k=2) if spec else None
    return Engine(m, ServeConfig(num_slots=2, block_size=8, prefix_cache=prefix), device="cpu", spec_decode=sc)


@pytest.mark.parametrize("spec", [False, True])
def test_every_serving_executable_has_a_row_and_each_wide_event_joins_it(spec):
    with _engine(spec=spec) as eng:
        eng.warmup()
        pages = [t.clone() for pg in eng._pages for t in pg.values()]
        led = qcosts.CostLedger(registry=QRegistry(), platform="cpu")
        rows = eng.register_costs(led)
        want = {f"serve.{k}prefill.b{b}" for b in eng.buckets for k in ("", "prefix_")}
        want |= {"serve.decode", "serve.hotswap.stage"}
        if spec:
            want |= {f"serve.draft_{k}prefill.b{b}" for b in eng.buckets for k in ("", "prefix_")}
            want |= {"serve.spec.propose", "serve.spec.verify"}
        assert set(rows) == set(led.names()) == want
        assert all(r.flops > 0 for r in rows.values() if r.kind == "compiled")
        assert rows["serve.hotswap.stage"].argument_bytes == sum(p.numel() * 4 for p in eng._dm.model.parameters())
        assert all(torch.equal(a, b) for a, b in zip(pages, [t for pg in eng._pages for t in pg.values()]))
        log = eng._events
        # distinct first blocks: no prefix hit, so each admission runs its full prefill
        hs = [eng.submit([10 * i + 1, 2, 3, 4, 5] * (1 + i), 3, tenant="t") for i in range(3)]
        for h in hs:
            h.result(timeout=120)
        deadline = time.time() + 30
        while log.emitted_total < 3 and time.time() < deadline:
            time.sleep(0.01)
        for ev in log.events(3):
            assert ev["cost_joined"] is True and ev["flops"] > 0
            step_rows = ["serve.spec.propose", "serve.spec.verify"] if spec else ["serve.decode"]
            want_flops = sum(rows[f"serve.prefill.b{b}"].flops + (rows[f"serve.draft_prefill.b{b}"].flops if spec
                                                                   else 0.0) for b in ev["prefill_buckets"])
            want_flops += ev["decode_ticks"] * sum(rows[n].flops for n in step_rows)
            assert ev["flops"] == pytest.approx(want_flops) and ev["tflops"] == pytest.approx(want_flops / 1e12)


def test_wide_events_stay_unjoined_without_a_ledger():
    with _engine(spec=False, prefix=False) as eng:
        eng.submit([1, 2, 3], 2).result(timeout=120)
        time.sleep(0.05)
        ev = eng._events.events(1)[0]
        assert ev["cost_joined"] is False and ev["flops"] == 0.0


# ---------------------------------------------------------------------------
# /profile and the summary
# ---------------------------------------------------------------------------


def _get(url, timeout=60):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_profile_is_single_flight_counts_its_families_and_rotates(tmp_path):
    from consensusml_tpu_torch.obs import MetricsServer

    reg = QRegistry()
    srv = MetricsServer(registry=reg, profile_dir=str(tmp_path), profile_quota=2)
    try:
        results = {}
        t = threading.Thread(target=lambda: results.setdefault("a", _get(srv.url("/profile?ms=700"))))
        t.start()
        deadline = time.time() + 10
        while srv._profile_inflight is None and time.time() < deadline:
            time.sleep(0.005)
        code_b, doc_b = _get(srv.url("/profile?ms=50"))
        t.join()
        code_a, doc_a = results["a"]
        assert code_a == 200 and code_b == 409 and doc_b["capture_id"] == doc_a["capture_id"]
        assert os.path.exists(doc_a["trace_json"]) and "device_total_ms" in doc_a["summary"]
        assert reg.counter("consensusml_profile_rejected_total").value == 1
        assert _get(srv.url("/profile?ms=x"))[0] == 400
        for _ in range(2):
            assert _get(srv.url("/profile?ms=10"))[0] == 200
        caps = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("cap-"))
        assert len(caps) == 2 and not os.path.exists(doc_a["dir"])
        assert reg.counter("consensusml_profile_captures_total").value == 3
    finally:
        srv.close()


def test_profile_refuses_while_the_profile_dir_window_holds_the_session(tmp_path):
    from consensusml_tpu_torch.obs import MetricsServer
    from consensusml_tpu_torch.utils.profiling import claim_profiler, release_profiler

    reg = QRegistry()
    srv = MetricsServer(registry=reg, profile_dir=str(tmp_path))
    try:
        assert claim_profiler("profile-dir", wait=False)
        try:
            code, doc = _get(srv.url("/profile?ms=20"))
        finally:
            release_profiler()
        assert code == 409 and doc["capture_id"] == "profile-dir"
        assert reg.counter("consensusml_profile_rejected_total").value == 1
        assert _get(srv.url("/profile?ms=20"))[0] == 200
    finally:
        srv.close()


def _summary_tool():
    return qmemviz.load_tool("profile_summary")


def test_profile_summary_keeps_kernel_names_and_the_references_family_rule(tmp_path, capsys):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "dur": d, "ts": 0} for n, d in
          (("flash_fwd_kernel<64, true>", 100), ("quantize_int8_kernel", 20), ("fusion", 10), ("fusion.1", 5),
           ("fused_pack.4", 3), ("fused_pack.8", 4))]
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 8},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 50}, {"ph": "i", "name": "mark"}]
    (tmp_path / "cap").mkdir()
    path = tmp_path / "cap" / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tool = _summary_tool()
    out = tool.summarize(str(path))
    ops = {o["op"]: o["ms"] for o in out["ops"]}
    assert ops["flash_fwd_kernel<64, true>"] == 0.1 and ops["fusion"] == pytest.approx(0.015)
    assert "fused_pack.4" in ops and "fused_pack.8" in ops and "fusion.1" not in ops
    assert out["kernel_count"] == 6 and out["event_count"] == 8 and out["cpu_ops"][0]["op"] == "aten::mm"
    host = tmp_path / "host.json"
    host.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": "train.round", "dur": 1500.0},
                                                {"ph": "X", "name": "train.round", "dur": 500.0}]}))
    assert tool.main([str(tmp_path / "cap"), "--json", "--host-trace", str(host)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["device_total_ms"] == pytest.approx(0.15) and doc["host_spans"][0]["count"] == 2
    assert tool.main([str(tmp_path / "nope")]) == 1


# ---------------------------------------------------------------------------
# the cluster view and the report
# ---------------------------------------------------------------------------


def test_obs_report_renders_attribution_and_memory_from_port_rows(tmp_path):
    from consensusml_tpu_torch.obs import ClusterWriter, aggregate
    from consensusml_tpu_torch.tools import obs_report

    reg = QRegistry()
    led = qcosts.CostLedger(registry=reg, platform="cpu", peak_flops_per_s=1e9, peak_bytes_per_s=1e9)
    led.register("toy.step", lambda x: (x @ x).sum(), torch.ones(32, 32))
    led.observe_measured("toy.step", 0.005)
    acct = qmemviz.HbmAccountant(registry=reg, device="cpu")
    acct.reconcile(analytic_bytes=110.0, compiled_bytes=100.0, live_peak_bytes=120.0)
    ClusterWriter(str(tmp_path), rank=0, registry=reg).write(round=3)
    doc = aggregate(str(tmp_path))
    row = {r["executable"]: r for r in doc["attribution"]}["toy.step"]
    assert row["flops"] == 2 * 32**3 + 1 and row["measured_s"] == pytest.approx(0.005)
    assert row["floor_ratio"] == pytest.approx(0.005 / max(row["flops"], row["bytes_accessed"]) * 1e9)
    assert doc["hbm"]["drift_pct"]["analytic_vs_compiled"] == pytest.approx(10.0)
    text = obs_report.render(doc) if hasattr(obs_report, "render") else None
    if text is None:
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert obs_report.main([str(tmp_path)]) == 0
        text = buf.getvalue()
    assert "cost attribution" in text and "toy.step" in text and "hbm reconciliation: analytic" in text
