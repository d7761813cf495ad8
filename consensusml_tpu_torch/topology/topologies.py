"""Gossip topologies (port of ``consensusml_tpu/topology/topologies.py``).

numpy only, as in the reference; the port keeps its own copy so that it
never imports the JAX package. Every family of the reference: ring, 2-D
torus, dense, the static exponential graph, the time-varying one-peer
exponential graph and the hierarchical ring-of-rings, with
:func:`rederive` (the same family at a new world size) and
:func:`topology_from_name`, the CLI's names and errors.

The gossip step is ``x_i <- sum_j W[i, j] x_j`` with ``W`` doubly
stochastic, built from *shifts* (cyclic rotations along mesh axes) with
Metropolis-Hastings weights ``1 / (degree + 1)`` per neighbour and the
remainder on self. Degenerate sizes (a ring of 2, a torus axis of 2, where
+1 and -1 reach the same node) keep both shifts, whose weights add in the
mixing matrix, so every backend applies the same operator. A time-varying
topology applies ``phases[t % period]`` at round ``t``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "Shift",
    "Topology",
    "RingTopology",
    "TorusTopology",
    "DenseTopology",
    "ExponentialTopology",
    "TimeVaryingTopology",
    "OnePeerExponentialTopology",
    "HierarchicalTopology",
    "topology_from_name",
    "rederive",
]


@dataclasses.dataclass(frozen=True)
class Shift:
    """One weighted cyclic rotation along a mesh axis.

    ``offset=+1`` means worker ``i`` receives the value held by worker
    ``i - 1`` along ``axis`` (a cyclic right-rotation of the data): one
    send to the next worker and one receive from the previous.
    """

    axis: int  # index into Topology.axis_names
    offset: int  # cyclic offset along that axis (non-zero)
    weight: float


@dataclasses.dataclass(frozen=True)
class Topology:
    """Base: a weighted, doubly-stochastic, connected gossip graph on a
    mesh. Undirected graphs (ring/torus/dense/exp) have symmetric ``W``;
    directed ones (one-peer exponential phases) are doubly stochastic but
    asymmetric — see :attr:`symmetric`."""

    mesh_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    shifts: tuple[Shift, ...]
    self_weight: float
    name: str = "custom"

    def __post_init__(self) -> None:
        if len(self.mesh_shape) != len(self.axis_names):
            raise ValueError("mesh_shape and axis_names must align")
        if any(d < 1 for d in self.mesh_shape):
            raise ValueError(f"mesh_shape must be positive, got {self.mesh_shape}")
        total = self.self_weight + sum(s.weight for s in self.shifts)
        if not np.isclose(total, 1.0):
            raise ValueError(f"weights must sum to 1, got {total}")

    @property
    def world_size(self) -> int:
        return int(np.prod(self.mesh_shape))

    # ---- coordinates ----------------------------------------------------
    def coords(self, rank: int) -> tuple[int, ...]:
        """Row-major coordinates of ``rank`` on the mesh."""
        return tuple(np.unravel_index(rank, self.mesh_shape))

    def rank(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.mesh_shape, mode="wrap"))

    def shift_src(self, rank: int, shift: Shift) -> int:
        """The rank whose value ``rank`` RECEIVES under ``shift`` — the
        one inverse-shift definition every consumer shares (mixing-matrix
        construction here, per-edge wire accounting in comm/collectives,
        probe edge sets in obs.links): a drifted copy would silently
        attribute bytes or probes to the wrong link."""
        src = list(self.coords(rank))
        src[shift.axis] = (src[shift.axis] - shift.offset) % self.mesh_shape[
            shift.axis
        ]
        return self.rank(src)

    def neighbors(self, rank: int) -> list[tuple[int, float]]:
        """(neighbor_rank, weight) pairs worker ``rank`` receives from."""
        out: dict[int, float] = {}
        for s in self.shifts:
            r = self.shift_src(rank, s)
            out[r] = out.get(r, 0.0) + s.weight
        return sorted(out.items())

    def edges(self) -> list[tuple[int, int, float]]:
        """Directed wire edges ``(src, dst, weight)``: ``dst`` receives
        ``src``'s value with this mixing weight. Built from the same
        shift arithmetic as :meth:`neighbors`, so it names exactly the
        links one gossip round moves payloads across — the per-link
        probe / cluster-report edge set (obs.links). Parallel shifts
        onto the same edge merge (weights add), matching the mixing
        matrix. Self-loops are omitted: they are not wire."""
        out: list[tuple[int, int, float]] = []
        for dst in range(self.world_size):
            for src, w in self.neighbors(dst):
                if src != dst:
                    out.append((src, dst, w))
        return out

    # ---- mixing matrix --------------------------------------------------
    def mixing_matrix(self) -> np.ndarray:
        """Doubly-stochastic ``W`` with ``W[i, j]`` = weight of j's value in
        i's update. Built from the same shifts a send/receive backend runs,
        so the stacked (matrix product) and collective backends apply the
        identical operator."""
        n = self.world_size
        w = np.eye(n) * self.self_weight
        for i in range(n):
            for j, wt in self.neighbors(i):
                w[i, j] += wt
        return w

    @property
    def symmetric(self) -> bool:
        """True when the mixing matrix equals its transpose (undirected
        graph). One-peer phases are directed (doubly stochastic but not
        symmetric); fault masking currently requires symmetry to preserve
        the network mean."""
        w = self.mixing_matrix()
        return bool(np.allclose(w, w.T, atol=1e-12))

    def spectral_gap(self) -> float:
        """Per-round consensus contraction rate.

        Symmetric ``W``: ``1 - |lambda_2|`` via eigvalsh. Directed doubly
        stochastic ``W`` (one-peer phases): eigvalsh would silently
        symmetrize, so use the operator norm of ``W`` restricted to the
        disagreement subspace, ``1 - ||W - 11^T/n||_2`` — the tight
        worst-case contraction either way.
        """
        w = self.mixing_matrix()
        n = w.shape[0]
        if n < 2:
            return 1.0
        if np.allclose(w, w.T, atol=1e-12):
            eig = np.sort(np.abs(np.linalg.eigvalsh(w)))
            return float(1.0 - eig[-2])
        return float(1.0 - np.linalg.norm(w - np.full((n, n), 1.0 / n), 2))

    @property
    def uses_psum(self) -> bool:
        """Dense topologies are one all-reduce mean, not neighbour shifts."""
        return False

    @property
    def is_time_varying(self) -> bool:
        """True when the mixing operator depends on the round index."""
        return False


def _metropolis_ring(n: int) -> tuple[tuple[Shift, ...], float]:
    if n == 1:
        return (), 1.0
    if n == 2:
        # +1 and -1 reach the same neighbor; two shifts of weight 1/4 merge
        # to the Metropolis weight 1/2 on the single edge.
        return (Shift(0, +1, 0.25), Shift(0, -1, 0.25)), 0.5
    w = 1.0 / 3.0  # degree 2 -> 1/(2+1)
    return (Shift(0, +1, w), Shift(0, -1, w)), 1.0 - 2.0 * w


class RingTopology(Topology):
    """1-D ring: each worker averages with its two cyclic neighbors."""

    def __init__(self, world_size: int, axis_name: str = "workers"):
        shifts, self_w = _metropolis_ring(world_size)
        super().__init__(
            mesh_shape=(world_size,),
            axis_names=(axis_name,),
            shifts=shifts,
            self_weight=self_w,
            name="ring",
        )


class TorusTopology(Topology):
    """2-D torus: 4-neighbor averaging on a (rows x cols) wraparound grid,
    one mesh axis each."""

    def __init__(self, rows: int, cols: int, axis_names: tuple[str, str] = ("rows", "cols")):
        if rows < 1 or cols < 1:
            raise ValueError(f"torus dims must be positive, got {rows}x{cols}")
        shifts: list[Shift] = []
        # Actual graph degree: a size-2 axis contributes ONE neighbor (the
        # +1/-1 shifts merge onto the same edge), size>2 contributes two.
        degree = sum(1 if s == 2 else (2 if s > 2 else 0) for s in (rows, cols))
        if degree == 0:
            super().__init__((1, 1), axis_names, (), 1.0, name="torus")
            return
        w = 1.0 / (degree + 1)
        for axis, size in ((0, rows), (1, cols)):
            if size == 1:
                continue
            if size == 2:
                # one merged edge of Metropolis weight w, split across the
                # two equivalent shifts (matches _metropolis_ring(2))
                shifts += [Shift(axis, +1, w / 2), Shift(axis, -1, w / 2)]
            else:
                shifts += [Shift(axis, +1, w), Shift(axis, -1, w)]
        self_w = 1.0 - sum(s.weight for s in shifts)
        super().__init__((rows, cols), axis_names, tuple(shifts), self_w, name="torus")


class DenseTopology(Topology):
    """Fully-connected: one round reaches exact consensus (W = 11^T / n).
    A collective backend runs it as one all-reduce mean, not n-1 shifts
    (:attr:`uses_psum`)."""

    def __init__(self, world_size: int, axis_name: str = "workers"):
        n = world_size
        if n < 1:
            raise ValueError(f"world_size must be positive, got {n}")
        if n == 1:
            shifts: tuple[Shift, ...] = ()
        else:
            shifts = tuple(Shift(0, off, 1.0 / n) for off in range(1, n))
        super().__init__(
            mesh_shape=(n,),
            axis_names=(axis_name,),
            shifts=shifts,
            self_weight=1.0 / n,
            name="dense",
        )

    @property
    def uses_psum(self) -> bool:
        return True


def _exp_offsets(n: int) -> list[int]:
    """Unique non-zero power-of-two cyclic offsets modulo ``n``."""
    offs: set[int] = set()
    p = 1
    while p < n:
        offs.add(p % n)
        p *= 2
    offs.discard(0)
    return sorted(offs)


class ExponentialTopology(Topology):
    """Static exponential graph: neighbors at cyclic offsets ``±2^p``.

    The undirected exponential graph has diameter ``O(log n)`` with only
    ``O(log n)`` neighbors per worker, so its spectral gap decays like
    ``1/log n`` instead of the ring's ``1/n^2`` — near-dense mixing at a
    logarithmic communication cost. The edge set {±2^p mod n} is closed
    under negation, so ``W`` is symmetric and :meth:`Topology.spectral_gap`
    applies.
    """

    def __init__(self, world_size: int, axis_name: str = "workers"):
        n = world_size
        if n < 1:
            raise ValueError(f"world_size must be positive, got {n}")
        offs: set[int] = set()
        for o in _exp_offsets(n):
            offs.update((o, (n - o) % n))
        offs.discard(0)
        degree = len(offs)
        w = 1.0 / (degree + 1) if degree else 0.0
        shifts = tuple(Shift(0, o, w) for o in sorted(offs))
        super().__init__(
            mesh_shape=(n,),
            axis_names=(axis_name,),
            shifts=shifts,
            self_weight=1.0 - degree * w if degree else 1.0,
            name="exp",
        )


@dataclasses.dataclass(frozen=True, init=False)
class TimeVaryingTopology(Topology):
    """A periodic schedule of per-round topologies on one mesh.

    Round ``t`` applies ``phases[t % period]``. The simulated backend
    indexes a stacked array of per-phase mixing matrices
    (``comm.simulated.phase_matrices``). Every phase must share the mesh
    shape and axis names.

    ``phases`` is a declared dataclass field so equality/hash distinguish
    different schedules on the same mesh.
    """

    phases: tuple[Topology, ...] = ()

    def __init__(self, phases: Sequence[Topology], name: str = "time-varying"):
        phases = tuple(phases)
        if not phases:
            raise ValueError("TimeVaryingTopology needs at least one phase")
        ms, an = phases[0].mesh_shape, phases[0].axis_names
        for p in phases:
            if p.mesh_shape != ms or p.axis_names != an:
                raise ValueError(
                    f"all phases must share mesh_shape/axis_names; got "
                    f"{p.mesh_shape}/{p.axis_names} vs {ms}/{an}"
                )
            if p.is_time_varying:
                raise ValueError("phases cannot themselves be time-varying")
        super().__init__(
            mesh_shape=ms, axis_names=an, shifts=(), self_weight=1.0, name=name
        )
        object.__setattr__(self, "phases", phases)

    @property
    def is_time_varying(self) -> bool:
        return True

    @property
    def symmetric(self) -> bool:
        return all(p.symmetric for p in self.phases)

    @property
    def period(self) -> int:
        return len(self.phases)

    def edges(self) -> list[tuple[int, int, float]]:
        """Union of every phase's edges, weights averaged over the
        period (an edge used 1-in-K rounds reports weight/K) — the
        per-ROUND expected wire, matching ``_sends_per_round``'s
        per-period averaging."""
        acc: dict[tuple[int, int], float] = {}
        for p in self.phases:
            for src, dst, w in p.edges():
                acc[(src, dst)] = acc.get((src, dst), 0.0) + w / self.period
        return [(s, d, w) for (s, d), w in sorted(acc.items())]

    def phase_matrices(self) -> np.ndarray:
        """``(period, n, n)`` stacked per-phase mixing matrices."""
        return np.stack([p.mixing_matrix() for p in self.phases])

    def effective_matrix(self) -> np.ndarray:
        """One full period's operator ``W_{P-1} @ ... @ W_0``."""
        out = np.eye(self.world_size)
        for w in self.phase_matrices():
            out = w @ out
        return out

    def mixing_matrix(self) -> np.ndarray:
        raise ValueError(
            "time-varying topology has no single mixing matrix; use "
            "phase_matrices() (per round) or effective_matrix() (per period)"
        )

    def spectral_gap(self) -> float:
        """Per-PERIOD contraction: ``1 - ||W_eff - 11^T/n||_2``.

        The phase matrices need not be symmetric (one-peer graphs are
        directed), so this uses the operator norm of the effective matrix
        on the disagreement subspace rather than eigenvalues.
        """
        n = self.world_size
        dev = self.effective_matrix() - np.full((n, n), 1.0 / n)
        return float(1.0 - np.linalg.norm(dev, 2))


class OnePeerExponentialTopology(TimeVaryingTopology):
    """One-peer exponential gossip: round ``t`` averages with the single
    peer at cyclic offset ``2^(t mod tau)``.

    Each round moves only ONE payload per worker (the cheapest
    possible gossip round), yet for ``n = 2^tau`` the product of one
    period's matrices is EXACTLY ``11^T/n`` — perfect consensus every
    ``tau`` rounds, a finite-time guarantee no static graph of any degree
    can match (Assran et al. 2019, SGP; Ying et al. 2021, exponential
    graphs). For other ``n`` the phases remain doubly stochastic and the
    contraction is geometric rather than exact.
    """

    def __init__(self, world_size: int, axis_name: str = "workers"):
        n = world_size
        if n < 1:
            raise ValueError(f"world_size must be positive, got {n}")
        offsets = _exp_offsets(n) or [0]
        phases = [
            Topology(
                mesh_shape=(n,),
                axis_names=(axis_name,),
                shifts=(Shift(0, o, 0.5),) if o else (),
                self_weight=0.5 if o else 1.0,
                name=f"onepeer-exp[{o}]",
            )
            for o in offsets
        ]
        super().__init__(phases, name="onepeer-exp")


class HierarchicalTopology(TimeVaryingTopology):
    """Ring-of-rings: inner gossip every round, gossip between groups
    every ``outer_every``-th round.

    The mesh is ``(slices, inner)``. Phases ``0 .. outer_every-2`` mix
    along the INNER ring only (between the workers of one group, on the
    fast links). Phase ``outer_every-1`` mixes along the OUTER ring
    (between corresponding workers of neighbouring groups, on the slower
    links between hosts), amortized 1-in-K. Every phase is doubly
    stochastic, so the time-varying paths and the per-period spectral gap
    apply unchanged.
    """

    def __init__(
        self,
        slices: int,
        inner: int,
        outer_every: int = 4,
        axis_names: tuple[str, str] = ("slices", "workers"),
    ):
        if slices < 1 or inner < 1:
            raise ValueError(f"need positive dims, got {slices}x{inner}")
        if outer_every < 1:
            raise ValueError(f"outer_every must be >= 1, got {outer_every}")
        if outer_every < 2 and inner > 1:
            # zero inner phases would leave workers within a slice
            # disconnected: the graph never reaches consensus
            raise ValueError(
                f"outer_every=1 with inner={inner} > 1 has no inner-ring "
                "phase, so workers inside a slice never mix; use "
                "outer_every >= 2 (or inner=1)"
            )
        mesh = (slices, inner)

        def ring_phase(axis: int, size: int, tag: str) -> Topology:
            shifts, self_w = _metropolis_ring(size)
            shifts = tuple(Shift(axis, s.offset, s.weight) for s in shifts)
            return Topology(
                mesh_shape=mesh,
                axis_names=axis_names,
                shifts=shifts,
                self_weight=self_w,
                name=f"hier-{tag}",
            )

        inner_phase = ring_phase(1, inner, "inner")
        outer_phase = ring_phase(0, slices, "outer")
        phases = [inner_phase] * (outer_every - 1) + [outer_phase]
        super().__init__(phases, name="hierarchical")


def rederive(topo: Topology, world_size: int) -> Topology:
    """Rebuild ``topo``'s FAMILY at a new world size — the membership
    controller's topology refresh on join/leave.

    Same family, new size: a ring stays a ring, a torus re-factors into
    the squarest grid at the new size, a hierarchical schedule keeps its
    slice count and period. Raises for sizes the family cannot host
    (e.g. a slice count that no longer divides the world) — the caller
    decides whether to fall back to another family or refuse the event.
    """
    if world_size == topo.world_size:
        return topo
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    if isinstance(topo, HierarchicalTopology):
        slices = topo.phases[-1].mesh_shape[0]
        if world_size % slices:
            raise ValueError(
                f"hierarchical topology with slices={slices} cannot host "
                f"world_size={world_size} (not divisible)"
            )
        # period = (outer_every - 1) inner phases + 1 outer phase
        return HierarchicalTopology(
            slices, world_size // slices, outer_every=topo.period
        )
    simple = {
        "ring": "ring",
        "dense": "dense",
        "exp": "exp",
        "onepeer-exp": "onepeer-exp",
        "torus": "torus",
    }
    family = simple.get(topo.name)
    if family is None:
        raise ValueError(
            f"cannot rederive topology {topo.name!r} at a new world size; "
            "known families: ring|torus|dense|exp|onepeer-exp|hierarchical"
        )
    return topology_from_name(family, world_size)


def topology_from_name(name: str, world_size: int, **kwargs) -> Topology:
    """Build a topology from a CLI-style name:
    ring | torus | dense | exp (static exponential graph) |
    onepeer-exp (time-varying one-peer exponential) |
    hierarchical (multi-slice ring-of-rings; pass ``slices=`` and
    optionally ``outer_every=``).

    For ``torus``, pass ``rows``/``cols`` or let it factor ``world_size``
    into the squarest grid."""
    name = name.lower()
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    simple = {
        "ring": RingTopology,
        "dense": DenseTopology,
        "exp": ExponentialTopology,
        "exponential": ExponentialTopology,
        "onepeer-exp": OnePeerExponentialTopology,
        "one-peer-exp": OnePeerExponentialTopology,
    }
    if name in simple:
        if kwargs:
            raise ValueError(f"{name} topology takes no extra args, got {sorted(kwargs)}")
        return simple[name](world_size)
    if name == "torus":
        if unknown := set(kwargs) - {"rows", "cols"}:
            raise ValueError(f"torus topology got unknown args {sorted(unknown)}")
        rows, cols = kwargs.get("rows"), kwargs.get("cols")
        if rows is not None and cols is None:
            if world_size % rows:
                raise ValueError(f"rows={rows} does not divide world_size={world_size}")
            cols = world_size // rows
        elif cols is not None and rows is None:
            if world_size % cols:
                raise ValueError(f"cols={cols} does not divide world_size={world_size}")
            rows = world_size // cols
        elif rows is None and cols is None:
            rows = int(np.floor(np.sqrt(world_size)))
            while world_size % rows:
                rows -= 1
            cols = world_size // rows
        if rows * cols != world_size:
            raise ValueError(f"torus {rows}x{cols} != world_size {world_size}")
        return TorusTopology(rows, cols)
    if name in ("hierarchical", "hier", "ring-of-rings"):
        if unknown := set(kwargs) - {"slices", "outer_every"}:
            raise ValueError(f"hierarchical topology got unknown args {sorted(unknown)}")
        slices = kwargs.get("slices")
        if slices is None:
            raise ValueError("hierarchical topology needs slices=<int>")
        if slices < 1:
            raise ValueError(f"slices must be positive, got {slices}")
        if world_size % slices:
            raise ValueError(
                f"slices={slices} does not divide world_size={world_size}"
            )
        return HierarchicalTopology(
            slices, world_size // slices,
            outer_every=kwargs.get("outer_every", 4),
        )
    raise ValueError(
        f"unknown topology {name!r} "
        "(expected ring|torus|dense|exp|onepeer-exp|hierarchical)"
    )
