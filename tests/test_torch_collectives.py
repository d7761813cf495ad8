"""The port's collective backend (``consensusml_tpu_torch/comm/``: the
transport, the mesh, the collectives, the launcher) against the JAX
package's ``shard_map`` collectives on the 8 virtual CPU devices of
``tests/conftest.py``.

The port's side spawns ``gloo`` ranks on the CPU, one process a worker
(:func:`consensusml_tpu_torch.comm.launch.launch`), grouped into one
spawn per world size (8, 4, 2) whose results every case reads. The
reference's side runs ``collectives.ppermute_shift``, ``mix``,
``mix_buckets`` and ``consensus_error`` under ``jax.shard_map`` on the
same stacked numpy inputs.

- ``ppermute_shift``: bit-equal, and equal to ``x[topology.shift_src(r)]``
  (``offset=+1`` receives from rank ``r - 1``).
- ``mix`` and ``mix_buckets`` on shift topologies (rings of 8, 4 and 2,
  the 2x4 torus, the exponential graph and each one-peer-exponential
  phase): bit-equal in f32 and in bf16 (accumulated in f32), since the
  port mirrors XLA's contraction of the chain (``fma(self_weight, x, w_1
  r_1)`` for f32 leaves, ``fma(w_1, r_1, self_weight x)`` for bf16 ones,
  then ``fma(w_j, r_j, acc)``). The ring of 2 sends both its
  shifts to one peer: the buckets' messages are told apart by their
  (shift, bucket) tag.
- Dense topologies are all-reduce means: ``gloo`` and XLA sum the ranks
  in different orders, so each element is held to ``(n - 1) * 2**-23 *
  sum_j |x_j| / n`` (the rounding error of an n-term f32 sum in any
  order), bf16 to one bf16 ulp of the mean's magnitude.
- ``consensus_error``: two all-reduce means on both sides, in different
  summation orders: rtol 1e-5.
- The launcher: a rank that raises fails the launch with its traceback
  while the others, blocked in the collective, are killed; a rank that
  stalls past the timeout fails it with ``TimeoutError``; no process is
  left behind either way. Given no device, a rank target takes its
  rank's card, and raises where the ranks see none.
- The train CLI's ``--backend collective``: ``mnist_mlp`` smoke with 4
  ``gloo`` ranks on the CPU prints rank 0's round lines; without a GPU it
  raises unless given ``--device cpu``; ``--dist-backend nccl`` is refused
  on the CPU and with more ranks than cards, before anything is spawned; a
  run whose ranks raise exits non-zero with a rank's traceback.
"""

import multiprocessing
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from consensusml_tpu.comm import WorkerMesh as JaxMesh
from consensusml_tpu.comm import collectives as jcoll
from consensusml_tpu.topology import DenseTopology as JaxDense
from consensusml_tpu.topology import ExponentialTopology as JaxExp
from consensusml_tpu.topology import OnePeerExponentialTopology as JaxOnePeer
from consensusml_tpu.topology import RingTopology as JaxRing
from consensusml_tpu.topology import TorusTopology as JaxTorus
from consensusml_tpu_torch.comm import check
from consensusml_tpu_torch.comm.launch import RankFailed, launch
from consensusml_tpu_torch.comm.mesh import rank_device
from consensusml_tpu_torch.comm.transport import check_nccl_world
from consensusml_tpu_torch.train.collective import check_flags
from consensusml_tpu_torch.topology import (
    DenseTopology,
    ExponentialTopology,
    OnePeerExponentialTopology,
    RingTopology,
    TorusTopology,
)

# name -> (JAX topology, port topology); one-peer-exponential phases by index
TOPOLOGIES = {
    "ring8": (JaxRing(8), RingTopology(8)),
    "ring4": (JaxRing(4), RingTopology(4)),
    "ring2": (JaxRing(2), RingTopology(2)),
    "torus2x4": (JaxTorus(2, 4), TorusTopology(2, 4)),
    "dense4": (JaxDense(4), DenseTopology(4)),
    "exp8": (JaxExp(8), ExponentialTopology(8)),
    **{f"onepeer8_phase{i}": (JaxOnePeer(8).phases[i], OnePeerExponentialTopology(8).phases[i]) for i in range(3)},
}
NAMES = list(TOPOLOGIES)
ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120.0


def _inputs(name, world):
    seed = NAMES.index(name)
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.normal(size=(world, 5, 3)).astype(np.float32),
        # bf16 values (exactly representable), mixed in f32
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(world, 64)), jnp.bfloat16).astype(jnp.float32)),
        "buckets": [rng.normal(size=(world, 7)).astype(np.float32), rng.normal(size=(world, 12)).astype(np.float32)],
    }


_RESULTS: dict = {}


def _port(name):
    """The port's results for topology ``name``: one spawn per world size,
    every topology of that size in it (cached)."""
    world = TOPOLOGIES[name][1].world_size
    if world not in _RESULTS:
        names = [n for n in NAMES if TOPOLOGIES[n][1].world_size == world]
        cases = []
        for n in names:
            x = _inputs(n, world)
            topo = TOPOLOGIES[n][1]
            cases += [(topo, x["f32"], "float32"), (topo, x["bf16"], "bfloat16"), (topo, x["buckets"], "float32")]
        per_rank = launch(check.collective_ops, world, cases, "gloo", "cpu", timeout=SPAWN_TIMEOUT)
        _RESULTS[world] = {
            n: [[r[3 * i + j] for r in per_rank] for j in range(3)] for i, n in enumerate(names)
        }
    return _RESULTS[world][name]


def _shard(topo, fn, *xs):
    """``fn`` per worker under ``shard_map`` over ``topo``'s mesh, on flat
    stacked inputs; flat stacked outputs."""
    wm = JaxMesh.create(topo, platform="cpu")
    spec = P(*topo.axis_names)
    to_mesh = lambda x: x.reshape(*topo.mesh_shape, *x.shape[1:])  # noqa: E731
    run = jax.jit(jax.shard_map(fn, mesh=wm.mesh, in_specs=(spec,) * len(xs), out_specs=spec))
    out = run(*[jax.device_put(to_mesh(jnp.asarray(x)), wm.worker_sharding()) for x in xs])
    return jax.tree.map(lambda o: np.asarray(o).reshape(topo.world_size, *o.shape[len(topo.mesh_shape):]), out)


def _dense_bound(x):
    """Per-element bound of an n-term f32 mean summed in another order."""
    n = x.shape[0]
    return (n - 1) * 2.0**-23 * np.abs(x).sum(0) / n


@pytest.mark.parametrize("name", [n for n in NAMES if not TOPOLOGIES[n][1].uses_psum])
def test_ppermute_shift_direction_bit_equal(name):
    jtopo, topo = TOPOLOGIES[name]
    x = _inputs(name, topo.world_size)["f32"]
    got = _port(name)[0]
    for k, s in enumerate(jtopo.shifts):
        want = _shard(jtopo, lambda b, s=s: jcoll.ppermute_shift(b, jtopo, s), x)
        mine = np.stack([got[r]["shifts"][k] for r in range(topo.world_size)])
        np.testing.assert_array_equal(mine, want)
        np.testing.assert_array_equal(mine, x[[topo.shift_src(r, topo.shifts[k]) for r in range(topo.world_size)]])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_mix_matches_reference(name, dtype):
    jtopo, topo = TOPOLOGIES[name]
    x = _inputs(name, topo.world_size)[dtype]
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = _shard(jtopo, lambda b: jcoll.mix(b, jtopo).astype(jnp.float32), x.astype(jdtype))
    got = np.stack([r["mix"] for r in _port(name)[0 if dtype == "f32" else 1]])
    if not topo.uses_psum:
        np.testing.assert_array_equal(got, want)
    elif dtype == "f32":
        assert np.all(np.abs(got - want) <= _dense_bound(x))
    else:
        # one bf16 ulp of the mean's magnitude (2**-7 relative)
        assert np.all(np.abs(got - want) <= 2.0**-7 * np.abs(want) + 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_mix_buckets_matches_reference(name):
    """Two buckets of other sizes in one exchange: every bucket's sends
    before any combine, each tagged by shift and bucket."""
    jtopo, topo = TOPOLOGIES[name]
    bufs = _inputs(name, topo.world_size)["buckets"]
    want = _shard(jtopo, lambda a, b: tuple(jcoll.mix_buckets([a, b], jtopo)), *bufs)
    got = _port(name)[2]
    for i, w in enumerate(want):
        mine = np.stack([r["mix_buckets"][i] for r in got])
        if topo.uses_psum:
            assert np.all(np.abs(mine - w) <= _dense_bound(bufs[i]))
        else:
            np.testing.assert_array_equal(mine, w)


@pytest.mark.parametrize("name", NAMES)
def test_consensus_error_matches_reference(name):
    """Every rank reports the same value, the reference's within 1e-5."""
    jtopo, topo = TOPOLOGIES[name]
    x = _inputs(name, topo.world_size)
    for j, case in enumerate((x["f32"], x["buckets"])):
        args = [case] if j == 0 else case
        want = _shard(jtopo, lambda *bs: jnp.broadcast_to(jcoll.consensus_error(list(bs), jtopo),
                                                           (1,) * len(jtopo.mesh_shape)), *args)
        errs = {r["consensus_error"] for r in _port(name)[0 if j == 0 else 2]}
        assert len(errs) == 1
        np.testing.assert_allclose(errs.pop(), float(want.reshape(-1)[0]), rtol=1e-5)


def test_a_rank_that_raises_fails_the_launch_and_no_rank_survives():
    """Rank 3 has no row of the input and raises; ranks 0-2 block in the
    ring's exchange until the parent kills them."""
    x = np.zeros((3, 4), np.float32)
    with pytest.raises(RankFailed, match=r"(?s)rank 3 failed:.*IndexError") as info:
        launch(check.collective_ops, 4, [(RingTopology(4), x, "float32")], "gloo", "cpu", timeout=SPAWN_TIMEOUT)
    assert info.value.rank == 3
    assert not multiprocessing.active_children()


def test_a_stalled_rank_times_out_and_every_rank_is_killed():
    with pytest.raises(TimeoutError, match="did not finish within 3"):
        launch(check.stall, 2, 3600.0, timeout=3.0)
    assert not multiprocessing.active_children()


def test_topology_and_world_must_agree():
    with pytest.raises(RankFailed, match="the topology has 4 workers but the process group has 2 ranks"):
        launch(check.collective_ops, 2, [(RingTopology(4), np.zeros((4, 2), np.float32), "float32")],
               "gloo", "cpu", timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("target", ["collective_ops", "gossip_cases"])
def test_rank_targets_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, target):
    """Given no device, a rank target takes its rank's card: with no card
    visible to the ranks it raises, naming ``device='cpu'``."""
    from consensusml_tpu_torch.consensus import ConsensusEngine, GossipConfig

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")  # the spawned ranks inherit it
    x = np.zeros((2, 4), np.float32)
    case = {"collective_ops": (RingTopology(2), x, "float32"),
            "gossip_cases": (ConsensusEngine(GossipConfig(RingTopology(2))), {"x": x}, [0], None)}[target]
    with pytest.raises(RankFailed, match="pass device='cpu' to run on the CPU"):
        launch(getattr(check, target), 2, [case], timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("world,cards,ok", [(4, 1, False), (4, 4, True), (8, 4, False), (1, 1, True)])
def test_nccl_takes_one_rank_a_card(world, cards, ok):
    if ok:
        check_nccl_world(world, cards)
    else:
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            check_nccl_world(world, cards)


# ---------------------------------------------------------------------------
# the train CLI's collective backend
# ---------------------------------------------------------------------------

CLI = [sys.executable, "-m", "consensusml_tpu_torch.train", "--config", "mnist_mlp", "--scale", "smoke",
       "--backend", "collective", "--workers", "4", "--rounds", "2"]


def _cli(args, timeout=SPAWN_TIMEOUT):
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run(CLI + args, capture_output=True, text=True, timeout=timeout, cwd=ROOT, env=env)


def test_cli_trains_mnist_collectively_on_the_cpu():
    """Rank 0 prints every round's line: the all-reduced loss and consensus
    error (dense gossip: 0), the wire bytes (one all-reduce of the 50,890
    f32 parameters), and every rank's times."""
    out = _cli(["--device", "cpu", "--dist-backend", "gloo"])
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "codec: none (exact gossip); dense bucketed wire" in lines
    assert any(ln.startswith("mnist_mlp/smoke: 4 ranks (collective, --dist-backend gloo) on cpu") for ln in lines)
    rounds = [ln for ln in lines if ln.startswith("round ")]
    assert [ln.split(":")[0] for ln in rounds] == ["round 0", "round 1"]
    for ln in rounds:
        assert "consensus_error 0 " in ln and "wire_bytes 203560 " in ln
        assert ln.count("ranks_round_ms [") == 1 and "staging_ms [" in ln and "wire_ms [" in ln


def test_cli_refuses_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    from consensusml_tpu_torch.train.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = CLI[3:] + ["--dist-backend", "gloo"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device(0)
    assert rank_device(3, "cpu") == torch.device("cpu")


def test_cli_refuses_nccl_on_the_cpu_before_it_spawns():
    from consensusml_tpu_torch.train.__main__ import main

    with pytest.raises(ValueError, match="use --dist-backend gloo with --device cpu"):
        main(CLI[3:] + ["--device", "cpu", "--dist-backend", "nccl"])
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("device,backend,world,cards,ok", [
    ("cuda", "nccl", 4, 1, False), ("cuda", "nccl", 2, 2, True), ("cpu", "nccl", 1, 0, False),
    ("cuda", "gloo", 8, 1, True), ("cpu", "gloo", 4, 0, True)])
def test_cli_flag_checks(device, backend, world, cards, ok):
    if ok:
        check_flags(device, backend, world, cards)
    else:
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            check_flags(device, backend, world, cards)


def test_cli_run_whose_ranks_raise_fails_with_their_traceback():
    """A negative seed passes the parent's checks and raises in every rank
    (numpy refuses it when the rank draws its worker's parameters): the
    run exits non-zero with a rank's traceback, before any round."""
    out = _cli(["--device", "cpu", "--dist-backend", "gloo", "--seed", "-1"])
    assert out.returncode != 0
    assert re.search(r"(?s)RankFailed: rank \d failed:.*in train_rank.*expected non-negative integer", out.stderr)
    assert "round 0" not in out.stdout
