"""Rank targets that drive the collective backend on given inputs and
return what came out, as numpy: the cross-backend checks of the tests
(``tests/test_torch_collectives.py``, ``tests/test_torch_collective_
engine.py``) and of ``chip_smoke.py``. Run them through
:func:`consensusml_tpu_torch.comm.launch.launch`; each builds its rank's
:class:`~.mesh.WorkerMesh` and takes its row of the stacked inputs, so
the parent holds the results against the simulated backend (or the JAX
package) on the same stacked inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from consensusml_tpu_torch import kernels
from consensusml_tpu_torch.comm import collectives
from consensusml_tpu_torch.comm.mesh import WorkerMesh
from consensusml_tpu_torch.consensus.pushsum import PushSumState
from consensusml_tpu_torch.train.local_sgd import worker_generator
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "collective_ops", "masked_ops", "gossip_cases", "overlap_cases", "inflight_across_barriers", "in_turn",
    "seeded_tree", "seeded_state", "seeded_gossip_round", "stall", "to_numpy",
]


def to_numpy(tree: Any) -> Any:
    """A tree of tensors as numpy arrays (bf16 as f32, which holds it exactly)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    return T.tree_map(conv, tree)


def _row(stacked: np.ndarray, rank: int, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(stacked[rank]))
    return t.to(device=device, dtype=dtype or t.dtype)


def collective_ops(rank: int, world: int, cases: list, dist_backend: str = "gloo", device: str | None = None) -> list:
    """For each ``(topology, stacked, dtype)`` case (``stacked`` a numpy
    ``(world, ...)`` array, or a list of them for the bucket form), this
    rank's :func:`~.collectives.ppermute_shift` along each shift, its
    :func:`~.collectives.mix` (or :func:`~.collectives.mix_buckets` of the
    list) and the :func:`~.collectives.consensus_error`, on the rank's
    card (:func:`~.mesh.rank_device`) unless ``device="cpu"``."""
    out = []
    for topology, stacked, dtype in cases:
        mesh = WorkerMesh.create(topology, dist_backend, device)
        dtype = getattr(torch, dtype)
        if isinstance(stacked, list):
            bufs = [_row(x, rank, mesh.device, dtype) for x in stacked]
            mixed = collectives.mix_buckets(bufs, topology, mesh)
            err = collectives.consensus_error(bufs, topology, mesh)
            out.append({"mix_buckets": to_numpy(mixed), "consensus_error": float(err)})
            continue
        x = _row(stacked, rank, mesh.device, dtype)
        shifted = [] if topology.uses_psum else [
            collectives.ppermute_shift(x, topology, s, mesh) for s in topology.shifts
        ]
        out.append({
            "shifts": to_numpy(shifted),
            "mix": to_numpy(collectives.mix(x, topology, mesh)),
            "consensus_error": float(collectives.consensus_error({"x": x}, topology, mesh)),
        })
    return out


def masked_ops(rank: int, world: int, cases: list, dist_backend: str = "gloo", device: str | None = None) -> list:
    """For each ``(topology, stacked, dtype, alive)`` case (``alive`` a
    ``(world,)`` 0/1 mask; ``stacked`` a numpy ``(world, ...)`` array, or a
    list of them for the bucket form), this rank's
    :func:`~.collectives.mix_masked` (or :func:`~.collectives.mix_buckets`
    of the list with the flag), on the rank's card unless
    ``device="cpu"``."""
    out = []
    for topology, stacked, dtype, alive in cases:
        mesh = WorkerMesh.create(topology, dist_backend, device)
        dtype = getattr(torch, dtype)
        flag = float(alive[rank])
        if isinstance(stacked, list):
            bufs = [_row(x, rank, mesh.device, dtype) for x in stacked]
            out.append({"mix_buckets": to_numpy(collectives.mix_buckets(bufs, topology, mesh, flag))})
            continue
        x = _row(stacked, rank, mesh.device, dtype)
        out.append({"mix_masked": to_numpy(collectives.mix_masked(x, topology, mesh, flag))})
    return out


def _state_row(engine, x, state, rank: int, device):
    """The engine's zero state for this rank's tree, or its row of the
    stacked numpy ``state`` (``{"xhat": [...], "s": [...]}`` or ``{"w": ...}``)."""
    st = engine.init_state(x)
    if st is None or state is None:
        return st
    if "w" in state:
        return type(st)(w=_row(state["w"], rank, device))
    return type(st)(xhat=[_row(a, rank, device) for a in state["xhat"]],
                    s=[_row(a, rank, device) for a in state["s"]])


def _state_numpy(st):
    if st is None:
        return None
    return {name: None if value is None else (_state_numpy(value) if hasattr(value, "_asdict") else to_numpy(value))
            for name, value in st._asdict().items()}


def _gossip_rounds(rank: int, engine, tree: dict, steps: list, state, dist_backend: str, device: str | None,
                   alive=None) -> dict:
    mesh = WorkerMesh.create(engine.topology, dist_backend, device)
    x = T.tree_map(lambda a: _row(a, rank, mesh.device), tree)
    st = _state_row(engine, x, state, rank, mesh.device)
    kernels.reset_launch_counts()
    before = mesh.transport.stats.snapshot()
    bytes_by_round = []
    for i, step in enumerate(steps):
        b0 = mesh.transport.stats.bytes_sent
        flag = None if alive is None else float(alive[i][rank])
        x, st = engine.round_collective(x, st, mesh, step=step, alive=flag)
        bytes_by_round.append(mesh.transport.stats.bytes_sent - b0)
    counts = {"launches": kernels.launch_counts(), "forms": kernels.form_counts()}
    moved = mesh.transport.stats.since(before)
    err = float(engine.consensus_error_collective(x, mesh))
    return {
        "tree": to_numpy(x),
        "state": _state_numpy(st),
        "consensus_error": err,
        "bytes_by_round": bytes_by_round,
        "transport": moved,
        **counts,
    }


def gossip_cases(rank: int, world: int, cases: list, dist_backend: str = "gloo", device: str | None = None) -> list:
    """For each ``(engine, tree, steps, state[, alive])`` case in turn, in
    one process group: ``engine.round_collective`` on this rank's row of
    the stacked numpy ``tree`` (a dict of leaves or of sub-dicts, as the
    gossiped tree), once for each round counter in ``steps``, from the
    stacked numpy ``state`` (CHOCO's ``{"xhat": [...], "s": [...]}`` or
    push-sum's ``{"w": ...}``; the engine's initial state when ``None``),
    with this rank's flag of ``alive[i]`` (a ``(world,)`` 0/1 mask a
    round) in round ``i`` when given. Returns per case the final tree and
    state as numpy, the consensus error, the kernel launches of the rounds
    (``kernels.launch_counts()`` and the forms, zeroed just before), the
    transport's bytes sent each round and its totals. Runs on the rank's
    card unless ``device="cpu"``."""
    return [_gossip_rounds(rank, engine, tree, steps, state, dist_backend, device, *rest)
            for engine, tree, steps, state, *rest in cases]


def _overlap_rounds(rank: int, engine, tree: dict, steps: list, dist_backend: str, device: str | None) -> dict:
    mesh = WorkerMesh.create(engine.topology, dist_backend, device)
    x = T.tree_map(lambda a: _row(a, rank, mesh.device), tree)
    st = engine.init_state(x)
    kernels.reset_launch_counts()
    zs, states, bytes_by_round = [], [], []
    for step in steps:
        b0 = mesh.transport.stats.bytes_sent
        z = engine.apply_correction(x, st)
        zs.append(T.tree_map(np.copy, to_numpy(z)))
        inflight = engine.correction_collective_start(z, st, mesh, step=step)
        with torch.no_grad():  # what local steps would write, in place, while the exchange is in flight
            for leaf in T.leaves(z):
                leaf.mul_(0.99).add_(0.01)
        st = inflight.wait()
        x = z
        bytes_by_round.append(mesh.transport.stats.bytes_sent - b0)
        states.append(T.tree_map(np.copy, _state_numpy(st)))
    return {"tree": to_numpy(x), "state": _state_numpy(st), "z": zs, "states": states,
            "bytes_by_round": bytes_by_round,
            "launches": kernels.launch_counts(), "forms": kernels.form_counts()}


def overlap_cases(rank: int, world: int, cases: list, dist_backend: str = "gloo", device: str | None = None) -> list:
    """For each ``(engine, tree, steps)`` case (an overlap engine) in turn,
    in one process group, from this rank's row of the stacked numpy
    ``tree`` and the engine's zero :class:`~consensusml_tpu_torch.
    consensus.OverlapState`, one round per round counter in ``steps``:
    the queued correction applied (``z``), the next one started on ``z``
    (:meth:`~consensusml_tpu_torch.consensus.ConsensusEngine.
    correction_collective_start`), every leaf of ``z`` moved in place to
    ``0.99 z + 0.01`` while its exchange is in flight (what the local
    steps do to the parameters), then finished. Returns per case the
    final tree and state, every round's ``z`` and state as numpy, the
    transport's bytes each round and the kernel launches. Runs on the
    rank's card unless ``device="cpu"``."""
    return [_overlap_rounds(rank, engine, tree, steps, dist_backend, device) for engine, tree, steps in cases]


def inflight_across_barriers(rank: int, world: int, turns: int = 3, dist_backend: str = "gloo",
                             device: str | None = None) -> dict:
    """An exchange left in flight on the mesh's in-flight transport while
    the ranks take turns through ``turns`` barriers of the mesh's own
    group and an all-reduce on it (as the collective train step's turn
    taking and metrics do), then finished: what each rank received (its
    left and right neighbours' ranks on a ring) and the all-reduce."""
    from consensusml_tpu_torch.topology import topology_from_name

    topo = topology_from_name("ring", world)
    mesh = WorkerMesh.create(topo, dist_backend, device)
    mine = torch.full((1000,), float(rank), device=mesh.device)
    posted = collectives.ppermute_shifts_start([mine], topo, topo.shifts, mesh)
    mine.fill_(-1.0)  # overwritten while in flight: what was sent is what the start staged
    for _ in range(turns):
        mesh.barrier()
    total = collectives.all_reduce_mean([torch.ones(3, device=mesh.device) * rank], mesh)[0]
    got = posted.wait()
    return {"received": [float(r[0][0]) for r in got], "uniform": all(bool((r[0] == r[0][0]).all()) for r in got),
            "mean": total.tolist()}


def in_turn(rank: int, world: int, calls: list) -> list:
    """``[target(rank, world, *args) for target, args in calls]``: several
    rank targets in one spawn and process group, in order."""
    return [target(rank, world, *args) for target, args in calls]


def seeded_tree(leaves: list, seed: int, rank: int, device, scale: float = 0.05) -> dict:
    """Worker ``rank``'s seeded gossiped tree: ``{"params": ...,
    "model_state": ...}`` with a ``N(0, scale^2)`` f32 leaf at each ``(path,
    shape)`` of ``leaves`` (paths from ``T.flatten_with_paths`` of the
    gossiped tree), drawn in that order from a generator on ``device``
    seeded by ``(seed, rank)``: the same bits in a rank and in a parent
    that stacks every rank's tree. Returns ``(tree, generator)``."""
    gen = worker_generator(device, seed, rank)
    tree: dict = {"params": {}, "model_state": {}}
    for path, shape in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.randn(shape, generator=gen, device=device) * scale
    return tree, gen


def seeded_state(engine, tree: dict, gen: torch.Generator, scale: float = 0.05):
    """A mid-run gossip state for ``tree`` from ``gen``: nonzero CHOCO
    buffers, a push-sum mass in [0.5, 1.5), or for overlap gossip nonzero
    queued corrections (and CHOCO buffers when compressed); ``None`` for
    exact mixing."""
    from consensusml_tpu_torch.consensus import ChocoState, OverlapState

    zero = engine.init_state(tree)
    if zero is None:
        return None
    if isinstance(zero, PushSumState):
        return PushSumState(w=0.5 + torch.rand(zero.w.shape, generator=gen, device=zero.w.device))
    draw = lambda z: torch.randn(z.shape, generator=gen, device=z.device, dtype=z.dtype) * scale  # noqa: E731
    if isinstance(zero, OverlapState):
        choco = None if zero.choco is None else ChocoState(xhat=[draw(z) for z in zero.choco.xhat],
                                                           s=[draw(z) for z in zero.choco.s])
        return OverlapState(correction=T.tree_map(draw, zero.correction), choco=choco,
                            pending=tuple(T.tree_map(draw, p) for p in zero.pending))
    return type(zero)(xhat=[draw(z) for z in zero.xhat], s=[draw(z) for z in zero.s])


def seeded_gossip_round(mesh: WorkerMesh, engine, leaves: list, seed: int, step: int, alive=None) -> dict:
    """One ``engine.round_collective`` over ``mesh`` from this rank's
    :func:`seeded_tree` and :func:`seeded_state`, with this rank's flag of
    the ``(world,)`` mask ``alive`` when given; for overlap gossip the
    round's gossip instead: the seeded correction applied (``tree`` is
    then ``z``) and the next one computed from ``z``
    (``correction_collective_start``, then ``wait()``). Returns the round's
    tree and state as numpy, its kernel launches and forms (zeroed just
    before), and what the transport moved, beside the ``leaves`` and the
    engine's ``wire_bytes_per_round`` of that tree."""
    tree, gen = seeded_tree(leaves, seed, mesh.rank, mesh.device)
    state = seeded_state(engine, tree, gen)
    wire = engine.wire_bytes_per_round(tree)
    flag = None if alive is None else float(alive[mesh.rank])
    kernels.reset_launch_counts()
    before = mesh.transport.stats.snapshot()
    if engine.config.overlap:
        tree = engine.apply_correction(tree, state)
        state = engine.correction_collective_start(tree, state, mesh, step=step).wait()
    else:
        tree, state = engine.round_collective(tree, state, mesh, step=step, alive=flag)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return {
        "tree": to_numpy(tree),
        "state": _state_numpy(state),
        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
        "forms": kernels.form_counts(),
        "transport": mesh.transport.stats.since(before),
        "leaves": list(leaves),
        "wire_bytes_per_round": wire,
    }


def stall(rank: int, world: int, seconds: float) -> None:
    """Rank 0 sleeps ``seconds`` before the group's barrier and the others
    wait there: one stalled rank holds every rank (the launcher's timeout
    is what ends it)."""
    import time

    import torch.distributed as dist

    if rank == 0:
        time.sleep(seconds)
    dist.barrier()
