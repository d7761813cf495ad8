"""Push-sum (ratio) consensus: exact averaging on directed and faulty
graphs (port of ``consensusml_tpu/consensus/pushsum.py``).

Masked gossip (:mod:`.faults`) folds a dead peer's weight onto the
RECEIVER's self-weight, which keeps the network mean only for a
symmetric mixing matrix. Push-sum (Kempe et al. 2003; stochastic
gradient push, Assran et al. 2019) lifts that: every worker carries a
scalar mass ``w`` (1 at the start) beside its parameters, both mix with
a COLUMN-stochastic operator (each sender splits its outgoing mass to
sum to 1, keeping the shares meant for dead receivers), and the
estimate is the ratio ``z = x / w``. Column stochasticity keeps ``sum_i
x_i`` and ``sum_i w_i`` under any fault pattern on any directed graph,
so ``z`` converges to the true mean.

Send-side masking:

    C'[i,j] = C[i,j] * a_i * a_j              (i != j)
    C'[j,j] = a_j * (1 - sum_{i!=j} C[i,j] a_i) + (1 - a_j)

On a symmetric topology ``C'`` is doubly stochastic, ``w`` stays 1 and
push-sum is the masked mixing. On the collective backend a worker needs
its in-neighbours' flags (whose payloads it takes) and its
out-neighbours' flags (whether its shares arrive): both are exchanged
once a round, the latter along the reversed shifts.

The de-bias is ``m / max(w, MASS_FLOOR)``: a worker whose mass is still
zero (a joiner before its first in-edge, a dead worker cut off from
everyone) has a numerator that is zero too, and the floor turns 0/0 into
0 instead of a NaN that would re-enter the swarm next round.

The reference's deviation from classic SGP is kept: the trainer's local
steps act on the de-biased ``z``, where SGP steps the biased ``x = z *
w``. Re-biasing at the next round then scales each worker's update by
its mass, a re-weighting whenever ``w`` leaves 1 (faults on a directed
graph). It is kept so that the port's rounds equal the reference's; the
mass stays within the mixing operator's range of 1, so the effect is
bounded.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from consensusml_tpu_torch.comm import collectives, simulated
from consensusml_tpu_torch.compress.reference import fma_f32
from consensusml_tpu_torch.topology import Shift, Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "MASS_FLOOR",
    "PushSumState",
    "pushsum_init",
    "pushsum_matrix",
    "pushsum_round_simulated",
    "pushsum_round_collective",
]

MASS_FLOOR = 1e-12


class PushSumState(NamedTuple):
    """Per-worker push-sum mass: 0-dim per worker, ``(world,)`` stacked."""

    w: torch.Tensor


def pushsum_init(world_size: int | None = None, device=None) -> PushSumState:
    """Unit mass: 0-dim for the per-worker (collective) view, ``(world,)``
    for stacked state."""
    shape = () if world_size is None else (world_size,)
    return PushSumState(w=torch.ones(shape, dtype=torch.float32, device=device))


def _debias(m: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return m / torch.clamp(w, min=MASS_FLOOR)


def _reverse(shift: Shift) -> Shift:
    return Shift(shift.axis, -shift.offset, shift.weight)


def pushsum_matrix(w_mat: torch.Tensor, alive: torch.Tensor | None) -> torch.Tensor:
    """The send-side-masked column-stochastic ``C'`` of the module
    docstring for an ``(n, n)`` mixing matrix and an ``(n,)`` 0/1 mask (the
    matrix itself without one), the reference's elementwise steps in its
    order."""
    if alive is None:
        return w_mat
    alive = alive.to(device=w_mat.device, dtype=w_mat.dtype)
    off = w_mat * alive[:, None] * alive[None, :]
    off = off - torch.diag(torch.diagonal(off))
    diag = alive * (1.0 - off.sum(0)) + (1.0 - alive)
    return off + torch.diag(diag)


def pushsum_round_simulated(tree: Any, state: PushSumState, w_mat: torch.Tensor,
                            alive: torch.Tensor | None = None) -> tuple[Any, PushSumState]:
    """One push-sum round on stacked tensors (leading axis = workers):
    re-bias ``x = z * w``, mix ``x`` and ``w`` through ``C'`` (f32 ``C' @
    x``, as the exact round), de-bias. A 0-dim mass means every worker at
    ``w``."""
    c = pushsum_matrix(w_mat.to(torch.float32), alive)
    n = c.shape[0]
    w = torch.broadcast_to(state.w.to(device=c.device, dtype=torch.float32), (n,))
    col = lambda v, ndim: v.reshape((n,) + (1,) * (ndim - 1))  # noqa: E731
    mixed = T.tree_map(lambda z: simulated.mix_stacked(z.to(torch.float32) * col(w, z.dim()), c), tree)
    w_new = c @ w
    z_new = T.tree_map(lambda m, z: _debias(m, col(w_new, m.dim())).to(z.dtype), mixed, tree)
    return z_new, PushSumState(w=w_new)


def _power_of_two(v: float) -> bool:
    m, _ = math.frexp(float(v))
    return v > 0 and m == 0.5


def _mix_plain(z: torch.Tensor, w: torch.Tensor | None, topology: Topology, recvs: list) -> torch.Tensor:
    """The unmasked mass mix of ``x = z * w`` (``w`` None: ``x = z``) as
    the reference's compiled ``collectives.mix`` of it: where every weight
    equals the self-weight and is a power of two (the one-peer graphs'
    halves), XLA factors ``x C + r_1 C + ...`` into ``(x + r_1 + ...) C``
    and contracts ``z w + r_1`` into one multiply-add; otherwise the
    product is rounded and mixed as any tensor (``collectives.mix``)."""
    sw = float(torch.tensor(topology.self_weight, dtype=torch.float32))
    weights = [float(torch.tensor(s.weight, dtype=torch.float32)) for s in topology.shifts]
    if recvs and all(v == sw for v in weights) and _power_of_two(sw):
        acc = fma_f32(z, w, recvs[0]) if w is not None else z + recvs[0]
        for r in recvs[1:]:
            acc = acc + r
        return acc * sw
    return collectives.combine(z if w is None else z * w, topology, recvs)


def pushsum_round_collective(tree: Any, state: PushSumState, topology: Topology, mesh,
                             alive: torch.Tensor | None = None) -> tuple[Any, PushSumState]:
    """One push-sum round of THIS rank's worker over ``mesh``: re-bias
    ``x = z * w``, mix every leaf and the mass in one exchange (the
    reference's ``_mass_mix`` term for term, as its compiled program
    rounds it), de-bias. ``alive`` is this worker's 0-dim 0/1 flag
    (``None``: nobody faults); the flags cross the transport once a
    round."""
    w = state.w.to(torch.float32)
    leaves, spec = T.flatten(tree)
    zf = [z.to(torch.float32) for z in leaves]
    x = [z * w for z in zf] + [w]
    if topology.uses_psum:
        # dense: symmetric, so send-side masking is the receive-side fold
        # of mix_masked (both mean exactly)
        mixed = collectives.mix_buckets(x, topology, mesh, alive)
    elif alive is None:
        inflight = collectives.ppermute_shifts(x, topology, topology.shifts, mesh)
        mixed = [_mix_plain(z, w if i < len(zf) else None, topology, [r[i] for r in inflight])
                 for i, z in enumerate(zf + [w])]
    else:
        a = torch.as_tensor(alive, dtype=torch.float32).to(w.device).reshape(())
        shifts = list(topology.shifts)
        flags = collectives.ppermute_shifts([a], topology, shifts + [_reverse(s) for s in shifts], mesh)
        a_src = [f[0] for f in flags[: len(shifts)]]
        a_dst = [f[0] for f in flags[len(shifts):]]
        # the shares meant for dead receivers stay home
        folded = None
        for s, a_d in zip(shifts, a_dst):
            term = s.weight * (1.0 - a_d)
            folded = term if folded is None else folded + term
        keep = folded + topology.self_weight
        inflight = collectives.ppermute_shifts(x, topology, shifts, mesh)
        mixed = []
        for i, xf in enumerate(x):
            # keep * x, then each in-neighbour's share as one multiply-add
            acc = keep * xf
            for s, a_s, recv in zip(shifts, a_src, inflight):
                acc = fma_f32(s.weight * a_s, recv[i], acc)
            mixed.append(torch.where(a > 0, acc, xf))
    w_new = mixed.pop()
    z_new = [_debias(m, w_new).to(z.dtype) for m, z in zip(mixed, leaves)]
    return T.unflatten(spec, z_new), PushSumState(w=w_new)
