"""The train CLI's input pipeline (``--native-loader``, ``--native-wire``,
``--prefetch-depth``) against the reference ``train.py``'s, on the CPU.

- ``mnist_mlp`` and ``cifar_resnet50`` smoke with ``--native-loader`` (the
  u8 wire by default, as the reference's image configs) on the simulated
  and the collective (``gloo``) backends: every round's loss and
  consensus error equal the reference's train step fed the reference's
  ring batches through ``train.py``'s u8 dequant, from the same initial
  parameters (the port's init, loaded into the reference's state).
- ``--prefetch-depth 0`` and 2 give the same rounds to the last bit; the
  ``feed:`` line and the feed families appear with the prefetcher only.
- The refusals, exit code 2 and the first line of the message equal the
  reference's: ``--native-wire u8`` without the ring, on a config without
  a u8 path, an unknown wire, and ``--native-loader`` under
  ``--churn-schedule``; the collective backend refuses as the simulated one.
- The u8 dequant's bits against ``jax.jit`` of the reference's expression
  over all 256 codes, for both affines.

The reference's ring is its own ``native/`` library, which its loader
builds with ``make`` when the ``.so`` is missing and loads under a lock of
its own process only: under ``pytest -n`` another worker may be writing
the ``.so`` when this one opens it (``object file has no loadable
segments``), and the loader then keeps that failure for the rest of the
process. ``_reference_native`` waits such a build out before the
reference's ring is used: it retries the load, clearing the kept failure,
until the library loads or a bound passes.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as ref_train  # imported at collection: its logger binds the session's stdout
from consensusml_tpu import configs as jax_configs
from consensusml_tpu.train import init_stacked_state as jax_init_stacked_state
from consensusml_tpu.train import make_simulated_train_step as jax_train_step
from consensusml_tpu_torch import configs
from consensusml_tpu_torch.train.__main__ import main
from consensusml_tpu_torch.data.native_pipeline import dequant_u8

TOL = {"mnist_mlp": (1e-6, 1e-4), "cifar_resnet50": (1e-5, 1e-5)}  # loss atol, consensus-error rtol
ROUNDS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(leaf)
    return out


def _ref_u8_loss(base, qscale, qoff):
    """``train.py``'s u8 wrapper of the loss (``train.py:877-890``)."""

    def loss_fn(params, model_state, batch, rng):
        img = batch.get("image")
        if img is not None and img.dtype == jnp.uint8:
            batch = dict(batch, image=jnp.asarray(img, jnp.float32) / qscale - qoff)
        return base(params, model_state, batch, rng)

    return loss_fn


def _reference_native(timeout_s: float = 120.0, poll_s: float = 0.5):
    """The reference's native library, loaded: a load that fails while
    another process builds it is retried (its kept failure cleared) until
    it loads; past ``timeout_s`` the last failure is raised."""
    from consensusml_tpu import native as ref_native

    deadline = time.monotonic() + timeout_s
    while True:
        lib = ref_native._load()
        if lib is not None:
            return lib
        if time.monotonic() > deadline:
            raise AssertionError(f"the reference's native library did not load: {ref_native._load_failed}")
        time.sleep(poll_s)
        ref_native._load_failed = None


def _reference_rounds(name, world, seed=0):
    """The reference's rounds on its ring's u8 batches from the port's
    initial parameters."""
    _reference_native()
    bundle = jax_configs.build(name, "smoke", world=world)
    init = configs.build(name, "smoke", world=world, device="cpu").init_params(seed)
    state = jax_init_stacked_state(bundle.cfg, bundle.init_params, jax.random.key(0), world)
    model_state = {"batch_stats": _nest(init["batch_stats"])} if "batch_stats" in init else state.model_state
    state = state._replace(params=_nest(init["params"]), model_state=model_state)
    src = bundle.native_batches
    step = jax_train_step(bundle.cfg, _ref_u8_loss(bundle.loss_fn, src.qscale, src.qoff))
    out = []
    for batch in src(ROUNDS, seed, 0, wire="u8"):
        assert batch["image"].dtype == jnp.uint8
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["consensus_error"])))
    return out


def _port_rounds(tmp_path, argv, tag):
    path = tmp_path / f"{tag}.jsonl"
    assert main(argv + ["--device", "cpu", "--rounds", str(ROUNDS), "--metrics-out", str(path)]) == 0
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return [(r["loss"], r["consensus_error"]) for r in rows]


def _assert_close(name, got, want):
    atol, rtol = TOL[name]
    assert len(got) == len(want) == ROUNDS
    for (gl, ge), (wl, we) in zip(got, want):
        assert abs(gl - wl) <= atol and abs(ge - we) <= rtol * we, (got, want)


@pytest.mark.parametrize("name", ["mnist_mlp", "cifar_resnet50"])
def test_simulated_native_loader_matches_the_reference(name, tmp_path, capsys):
    got = _port_rounds(tmp_path, ["--config", name, "--native-loader"], name)
    out = capsys.readouterr().out
    assert "native wire: u8 (auto: image config, --native-wire f32 overrides)" in out
    assert "feed: 2 rounds prefetched, stall " in out
    _assert_close(name, got, _reference_rounds(name, configs.build(name, "smoke", device="cpu").world_size))


@pytest.mark.parametrize("name,world", [("mnist_mlp", 4), ("cifar_resnet50", 4)])
def test_collective_native_loader_matches_the_reference(name, world, tmp_path, capfd):
    argv = ["--config", name, "--native-loader", "--backend", "collective", "--dist-backend", "gloo",
            "--workers", str(world)]
    got = _port_rounds(tmp_path, argv, name)
    out = capfd.readouterr().out
    assert "native wire: u8 (auto" in out and "feed: 2 rounds prefetched" in out
    _assert_close(name, got, _reference_rounds(name, world))


def test_prefetch_depths_give_the_same_rounds(tmp_path, capsys):
    base = ["--config", "mnist_mlp", "--native-loader", "--native-wire", "f32"]
    runs = {d: _port_rounds(tmp_path, base + ["--prefetch-depth", str(d)], f"d{d}") for d in (0, 2, 3)}
    out = capsys.readouterr().out
    assert out.count("native wire: f32 (explicit)") == 3 and out.count("feed: 2 rounds prefetched") == 2
    assert runs[0] == runs[2] == runs[3]
    # the Python loader, fed at the default depth and at none
    assert _port_rounds(tmp_path, ["--config", "mnist_mlp"], "py2") == _port_rounds(
        tmp_path, ["--config", "mnist_mlp", "--prefetch-depth", "0"], "py0")


REFUSALS = {
    "u8_without_loader": ["--config", "mnist_mlp", "--native-wire", "u8"],
    "u8_without_image_path": ["--config", "gpt2_topk", "--native-loader", "--native-wire", "u8"],
    "churn": ["--config", "mnist_mlp", "--native-loader", "--churn-schedule", "join@1:1"],
}


def _run(fn, argv, capsys):
    try:
        rc = fn(argv)
    except SystemExit as e:  # argparse
        rc = e.code
    return rc, capsys.readouterr().err.strip().splitlines()


@pytest.mark.parametrize("case", list(REFUSALS) + ["unknown_wire"])
def test_refusals_equal_the_references(case, capsys):
    argv = REFUSALS.get(case, ["--config", "mnist_mlp", "--native-wire", "f16"]) + ["--device", "cpu",
                                                                                  "--rounds", "1"]
    want_rc, want_err = _run(ref_train.main, argv + ["--backend", "simulated"], capsys)
    got_rc, got_err = _run(main, argv, capsys)
    assert got_rc == want_rc == 2
    if case == "unknown_wire":  # argparse's own message names the program
        assert got_err[-1].split(": ", 1)[1] == want_err[-1].split(": ", 1)[1]
    else:
        assert got_err[0] == want_err[0] and got_err[0].startswith("error: ")
    if case != "churn":
        assert _run(main, argv + ["--backend", "collective", "--workers", "2"], capsys) == (got_rc, got_err)


@pytest.mark.parametrize("qscale,qoff", [(32.0, 4.0), (255.0, 0.0)])
def test_u8_dequant_is_the_references_bits(qscale, qoff):
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = np.asarray(jax.jit(lambda x: jnp.asarray(x, jnp.float32) / qscale - qoff)(codes))
    got = dequant_u8(torch.from_numpy(codes), qscale, qoff).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_bundle_sources_keep_the_contract():
    """``apply_native_wire`` sets the u8 wire on the image config's source,
    which keeps its affine; the config's loss dequants a u8 image as
    :func:`dequant_u8` does and passes an f32 one through unchanged."""
    from consensusml_tpu_torch.train.feed import apply_native_wire

    bundle = configs.build("mnist_mlp", "smoke", device="cpu")
    base_loss, base_source = bundle.loss_fn, bundle.native_batches
    assert apply_native_wire(bundle, True, None) == ("u8", "auto: image config, --native-wire f32 overrides")
    assert bundle.loss_fn is base_loss and bundle.native_batches.supports_views
    assert (bundle.native_batches.qscale, bundle.native_batches.qoff) == (32.0, 4.0)
    assert (bundle.native_batches.wire, base_source.wire) == ("u8", "f32")
    batch = next(iter(bundle.native_batches(1, 0)))
    assert batch["image"].dtype == torch.uint8
    assert bundle.loss_fn.__wrapped__ is not None  # the config's loss, behind its dequant
    seen = configs._dequanting(lambda p, m, b, g: b["image"], bundle.native_batches)
    assert torch.equal(seen(None, None, batch, None), dequant_u8(batch["image"], 32.0, 4.0))
    f32 = dequant_u8(batch["image"], 32.0, 4.0)
    assert seen(None, None, dict(batch, image=f32), None) is f32
    plain = configs.build("gpt2_topk", "smoke", device="cpu")
    assert apply_native_wire(plain, True, None) == ("f32", "auto: config has no u8 path")
    assert dataclasses.replace(plain).native_batches is plain.native_batches
