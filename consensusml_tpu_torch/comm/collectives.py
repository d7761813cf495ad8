"""Gossip collectives of one rank (port of ``consensusml_tpu/comm/collectives.py``).

The reference runs these per worker inside ``shard_map``: a shift is an
XLA ``ppermute``, a dense topology a ``pmean``. Here each worker is a
process and every function takes its :class:`~.mesh.WorkerMesh`; a shift
is a send to the rank ``offset`` ahead on the shift's axis and a receive
from the rank ``offset`` behind (``topology.shift_src``), and a mean is an
all-reduce sum divided by the world size, both on the mesh's transport.
``topology`` may be a phase of the mesh's time-varying topology.

The mixing operator equals ``W @ x`` with the topology's mixing matrix
(held against :mod:`.simulated` and the reference's ``shard_map``
collectives by ``tests/test_torch_collectives.py``). :func:`combine` is
that sum for values already received, so a caller that left the exchange
in flight (:func:`ppermute_shifts_start`, :func:`all_reduce_mean_start`)
mixes what comes back as :func:`mix` would. Shift mixing
accumulates in f32 as the reference's compiled program does: XLA
contracts its ``x * self_weight + w_1 r_1 + ...`` chain into one
multiply-add of the first two terms (``fma(self_weight, x, w_1 r_1)`` for
f32 leaves, ``fma(w_1, r_1, self_weight x)`` for bf16 ones), then
``fma(w_j, r_j, acc)`` for each later shift, in shift order, and so does
:func:`mix` (bit for bit; that contraction is the CPU compiler's choice,
and a compiler upgrade could change it).

:func:`mix_masked`, :func:`mix_tree_masked` and :func:`mix_buckets` with
an ``alive`` flag are the fault-masked round (``consensus/faults.py``): a
dead neighbour's term becomes this worker's own value, a dead worker
keeps its value. The reference's terms in its order: ``acc = x *
self_weight``, then ``acc + w_s * (a_s x_s + (1 - a_s) x)`` a shift; with
0/1 flags the bracket is exactly ``x_s`` or ``x``, so the chain is
:func:`mix`'s, contracted as it is. A dense topology takes ``S / n + x (n
- A) / n`` with ``S = sum_j a_j x_j`` and ``A = sum_j a_j`` (both one
all-reduce). The neighbours' flags cross the transport once a round
(:func:`neighbour_flags`), not once a leaf or bucket.

Telemetry, the reference's names: ``consensusml_ppermutes_traced_total``
counts a shift's send of one tensor and
``consensusml_link_wire_bytes_traced_total{src,dst}`` its bytes on every
directed edge (worlds past 256 count
``consensusml_link_unaccounted_ppermutes_total`` instead), in the first
run of each gossip program only (:func:`~consensusml_tpu_torch.obs.tracer.
trace_program`), as the reference counts them once a compile; the
``comm.bucket_sends`` and ``comm.bucket_combine`` spans time
:func:`mix_buckets`.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

from consensusml_tpu_torch.comm.mesh import WorkerMesh
from consensusml_tpu_torch.comm.transport import InFlight
from consensusml_tpu_torch.compress.reference import fma_f32
from consensusml_tpu_torch.obs import get_registry
from consensusml_tpu_torch.obs import span as _span
from consensusml_tpu_torch.obs.tracer import tracing_program
from consensusml_tpu_torch.topology import Shift, Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "shift_dst",
    "ppermute_shifts",
    "ppermute_shifts_start",
    "all_reduce_mean_start",
    "combine",
    "ppermute_shift",
    "ppermute_shift_tree",
    "all_reduce_mean",
    "mix",
    "mix_tree",
    "mix_buckets",
    "mix_masked",
    "mix_tree_masked",
    "neighbour_flags",
    "consensus_error",
]


_TRACED_PPERMUTES = get_registry().counter(
    "consensusml_ppermutes_traced_total",
    "ppermute collectives traced into gossip programs (per XLA compile)",
)

# worlds past this cap skip the per-edge expansion (label cardinality)
_EDGE_ACCOUNT_MAX_WORLD = 256


def _account_sends(tensors: list[torch.Tensor], topology: Topology, shifts) -> None:
    """The trace-time counters of one exchange: a ppermute a tensor a
    shift, its bytes on every directed edge (shapes only, no sync)."""
    reg = get_registry()
    for shift in shifts:
        for x in tensors:
            _TRACED_PPERMUTES.inc()
            if topology.world_size > _EDGE_ACCOUNT_MAX_WORLD:
                reg.counter(
                    "consensusml_link_unaccounted_ppermutes_total",
                    "traced ppermutes skipped by per-edge wire accounting "
                    f"(world_size > {_EDGE_ACCOUNT_MAX_WORLD})",
                ).inc()
                continue
            nbytes = x.numel() * x.element_size()
            for dst in range(topology.world_size):
                reg.counter(
                    "consensusml_link_wire_bytes_traced_total",
                    "bytes traced onto each directed gossip edge (per XLA "
                    "compile; programs replay, so also the per-round wire "
                    "per edge)",
                    labels={"src": topology.shift_src(dst, shift), "dst": dst},
                ).inc(nbytes)


def shift_dst(topology: Topology, rank: int, shift: Shift) -> int:
    """The rank that RECEIVES ``rank``'s value under ``shift`` (the inverse
    of ``topology.shift_src``)."""
    coords = list(topology.coords(rank))
    coords[shift.axis] += shift.offset
    return topology.rank(coords)


def ppermute_shifts(tensors: list[torch.Tensor], topology: Topology, shifts, mesh: WorkerMesh) -> list[list]:
    """Every tensor along every shift at once: per shift, the list of
    values this rank receives (from ``topology.shift_src(rank, shift)``).
    All sends and receives are posted before any is waited on, as the
    reference issues every bucket's ``ppermute`` before any combine."""
    return ppermute_shifts_start(tensors, topology, shifts, mesh, mesh.transport).wait()


def ppermute_shifts_start(tensors: list[torch.Tensor], topology: Topology, shifts, mesh: WorkerMesh,
                          transport=None) -> InFlight:
    """:func:`ppermute_shifts` posted on ``transport`` (default: the mesh's
    in-flight one, :meth:`~.mesh.WorkerMesh.inflight_transport`), nothing
    waited on: ``wait()`` gives the per-shift lists."""
    routes = [(shift_dst(topology, mesh.rank, s), topology.shift_src(mesh.rank, s)) for s in shifts]
    if tracing_program():
        _account_sends(tensors, topology, shifts)
    transport = mesh.inflight_transport() if transport is None else transport
    return transport.exchange_start(list(tensors), routes)


def ppermute_shift(x: torch.Tensor, topology: Topology, shift: Shift, mesh: WorkerMesh) -> torch.Tensor:
    """Receive the value a cyclic ``shift`` away: ``offset=+1`` receives
    from the left neighbour (rank ``i - 1`` on the shift's axis)."""
    return ppermute_shifts([x], topology, [shift], mesh)[0][0]


def ppermute_shift_tree(tree: Any, topology: Topology, shift: Shift, mesh: WorkerMesh) -> Any:
    leaves, spec = T.flatten(tree)
    return T.unflatten(spec, ppermute_shifts(leaves, topology, [shift], mesh)[0])


def all_reduce_mean(tensors: list[torch.Tensor], mesh: WorkerMesh) -> list[torch.Tensor]:
    """``pmean`` of each tensor over the ranks: the all-reduce sum in f32,
    divided by the world size, cast back."""
    return all_reduce_mean_start(tensors, mesh, mesh.transport).wait()


def all_reduce_mean_start(tensors: list[torch.Tensor], mesh: WorkerMesh, transport=None) -> InFlight:
    """:func:`all_reduce_mean` posted on ``transport`` (default: the mesh's
    in-flight one): ``wait()`` gives the means."""
    transport = mesh.inflight_transport() if transport is None else transport
    dtypes = [t.dtype for t in tensors]
    posted = transport.all_reduce_sum_start([t.to(torch.float32) for t in tensors])
    return InFlight(lambda: [(s / mesh.world_size).to(d) for s, d in zip(posted.wait(), dtypes)])


def combine(x: torch.Tensor, topology: Topology, recvs: list[torch.Tensor], f32_terms: bool = False,
            computed: bool = False) -> torch.Tensor:
    """``x``'s mix with the values ``recvs`` it received, one a shift in
    shift order (:func:`mix` once the exchange is done). ``computed``: x
    is computed in the same compiled program in the reference (overlap
    gossip's ``z + pending``), which contracts it as a bf16 leaf's."""
    # x * self_weight + each shift's w * r in shift order, contracted as
    # the reference's compiled program does: the first two terms fused into
    # one multiply-add (fma(self_weight, x, w_1 r_1) for f32 leaves; for
    # bf16 ones, whose f32 x is a conversion, fma(w_1, r_1, self_weight x)),
    # then fma(w_j, r_j, acc) for each later shift. ``f32_terms``: the
    # terms are f32 values computed from x (the masked round's), which
    # the compiled program contracts as an f32 leaf's whatever x's dtype
    f32 = lambda v: torch.tensor(v, dtype=torch.float32).to(x.device)  # noqa: E731
    xf = x.to(torch.float32)
    sw = f32(topology.self_weight)
    if not recvs:
        return (xf * sw).to(x.dtype)
    shifts = topology.shifts
    w1, r1 = f32(shifts[0].weight), recvs[0].to(torch.float32)
    if (x.dtype == torch.float32 and not computed) or f32_terms:
        acc = fma_f32(sw, xf, w1 * r1)
    else:
        acc = fma_f32(w1, r1, xf * sw)
    for s, r in zip(shifts[1:], recvs[1:]):
        acc = fma_f32(f32(s.weight), r.to(torch.float32), acc)
    return acc.to(x.dtype)


def mix(x: torch.Tensor, topology: Topology, mesh: WorkerMesh) -> torch.Tensor:
    """One gossip averaging round, ``x_i <- sum_j W[i, j] x_j``: a mean
    over every rank for a dense topology (exact consensus in one round),
    the weighted shifts accumulated in f32 otherwise."""
    if topology.uses_psum:
        return all_reduce_mean([x], mesh)[0]
    recvs = ppermute_shifts([x], topology, topology.shifts, mesh)
    return combine(x, topology, [r[0] for r in recvs])


def mix_tree(tree: Any, topology: Topology, mesh: WorkerMesh) -> Any:
    return T.tree_map(lambda x: mix(x, topology, mesh), tree)


def mix_buckets(bufs: list[torch.Tensor], topology: Topology, mesh: WorkerMesh, alive=None,
                alive_nbrs: list[torch.Tensor] | None = None, spans: bool = True) -> list[torch.Tensor]:
    """One gossip round over flat bucket buffers (or any tensors): per
    buffer exactly :func:`mix`, or :func:`mix_masked` given this worker's
    ``alive`` flag, with every buffer's sends posted before any buffer's
    combine (one exchange for all of them). ``alive_nbrs``: the flags of
    :func:`neighbour_flags`, exchanged here when not given. ``spans``:
    record the ``comm.bucket_*`` spans (the reference's per-leaf wire mixes
    without them)."""
    if not bufs:
        return []
    if alive is not None:
        return _mix_masked_all(bufs, topology, mesh, alive, alive_nbrs)
    if topology.uses_psum:
        return all_reduce_mean(bufs, mesh)
    scope = _span if spans else lambda name, **attrs: contextlib.nullcontext()
    with scope("comm.bucket_sends", buckets=len(bufs)):
        inflight = ppermute_shifts(bufs, topology, topology.shifts, mesh)
    with scope("comm.bucket_combine"):
        return [combine(b, topology, [recv[i] for recv in inflight]) for i, b in enumerate(bufs)]


def _flag(alive, device) -> torch.Tensor:
    return torch.as_tensor(alive, dtype=torch.float32).to(device).reshape(())


def neighbour_flags(alive, topology: Topology, mesh: WorkerMesh) -> list[torch.Tensor]:
    """This worker's in-neighbours' flags, one a shift (a 4-byte message
    a shift): exchange them once a round and pass them to every masked
    mix of that round."""
    return [r[0] for r in ppermute_shifts([_flag(alive, mesh.device)], topology, topology.shifts, mesh)]


def _mix_masked_all(xs: list[torch.Tensor], topology: Topology, mesh: WorkerMesh, alive,
                    alive_nbrs: list[torch.Tensor] | None) -> list[torch.Tensor]:
    a = _flag(alive, xs[0].device)
    if topology.uses_psum:
        n = float(topology.world_size)
        xf = [x.to(torch.float32) for x in xs]
        sums = mesh.transport.all_reduce_sum([a * x for x in xf] + [a.reshape(1)])
        count = sums.pop()[0]
        return [torch.where(a > 0, s / n + x * (n - count) / n, x).to(orig.dtype)
                for s, x, orig in zip(sums, xf, xs)]
    if alive_nbrs is None:
        alive_nbrs = neighbour_flags(a, topology, mesh)
    inflight = ppermute_shifts(xs, topology, topology.shifts, mesh)
    out = []
    for i, x in enumerate(xs):
        xf = x.to(torch.float32)
        # a_s x_s + (1 - a_s) x: exactly x_s or x for a 0/1 flag
        terms = [a_n * r[i].to(torch.float32) + (1.0 - a_n) * xf for a_n, r in zip(alive_nbrs, inflight)]
        out.append(torch.where(a > 0, combine(x, topology, terms, f32_terms=True), xf).to(x.dtype))
    return out


def mix_masked(x: torch.Tensor, topology: Topology, mesh: WorkerMesh, alive,
               alive_nbrs: list[torch.Tensor] | None = None) -> torch.Tensor:
    """One fault-masked gossip round of ``x`` (module docstring):
    ``alive`` is this worker's 0/1 flag, ``alive_nbrs`` its neighbours'
    (:func:`neighbour_flags`; exchanged here when not given)."""
    return _mix_masked_all([x], topology, mesh, alive, alive_nbrs)[0]


def mix_tree_masked(tree: Any, topology: Topology, mesh: WorkerMesh, alive) -> Any:
    """:func:`mix_masked` of every leaf, the flags exchanged once."""
    leaves, spec = T.flatten(tree)
    return T.unflatten(spec, mix_buckets(leaves, topology, mesh, alive))


def consensus_error(tree: Any, topology: Topology, mesh: WorkerMesh) -> torch.Tensor:
    """RMS disagreement across workers, ``sqrt(mean_i ||theta_i -
    theta_bar||^2)``, in f32 by two all-reduce means (the mean of every
    leaf, then of this rank's squared deviation), with no gather of the
    parameters. Every rank gets the same value."""
    leaves = [x.to(torch.float32) for x in T.leaves(tree)]
    if not leaves:
        return torch.zeros(())
    means = all_reduce_mean(leaves, mesh)
    sq = sum(((x - m) ** 2).sum() for x, m in zip(leaves, means))
    return torch.sqrt(all_reduce_mean([sq.reshape(1)], mesh)[0][0])
