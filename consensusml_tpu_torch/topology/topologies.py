"""Gossip topologies (port of ``consensusml_tpu/topology/topologies.py``).

numpy only, as in the reference; the port keeps its own copy so that it
never imports the JAX package. This slice carries the base
:class:`Topology` and the ring, the topology of ``gpt2_topk``. The other
families (torus, dense, exponential, one-peer, hierarchical, time-varying)
wait for a later slice: :func:`topology_from_name` raises
``NotImplementedError`` for them.

The gossip step is ``x_i <- sum_j W[i, j] x_j`` with ``W`` doubly
stochastic, built from *shifts* (cyclic rotations along mesh axes) with
Metropolis-Hastings weights ``1 / (degree + 1)`` per neighbour and the
remainder on self. A ring of 2 keeps two shifts of weight 1/4 onto the
same neighbour, which merge to the Metropolis 1/2 in the matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Shift", "Topology", "RingTopology", "topology_from_name"]


@dataclasses.dataclass(frozen=True)
class Shift:
    """One weighted cyclic rotation along a mesh axis: ``offset=+1`` means
    worker ``i`` receives the value held by worker ``i - 1``."""

    axis: int
    offset: int
    weight: float


@dataclasses.dataclass(frozen=True)
class Topology:
    """A weighted, doubly-stochastic, connected gossip graph on a mesh."""

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

    def coords(self, rank: int) -> tuple[int, ...]:
        """Row-major coordinates of ``rank`` on the mesh."""
        return tuple(np.unravel_index(rank, self.mesh_shape))

    def rank(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.mesh_shape, mode="wrap"))

    def shift_src(self, rank: int, shift: Shift) -> int:
        """The rank whose value ``rank`` receives under ``shift``."""
        src = list(self.coords(rank))
        src[shift.axis] = (src[shift.axis] - shift.offset) % self.mesh_shape[shift.axis]
        return self.rank(src)

    def neighbors(self, rank: int) -> list[tuple[int, float]]:
        """(neighbour_rank, weight) pairs worker ``rank`` receives from;
        parallel shifts onto one neighbour merge (weights add)."""
        out: dict[int, float] = {}
        for s in self.shifts:
            r = self.shift_src(rank, s)
            out[r] = out.get(r, 0.0) + s.weight
        return sorted(out.items())

    def mixing_matrix(self) -> np.ndarray:
        """Doubly-stochastic ``W`` (float64) with ``W[i, j]`` = weight of
        j's value in i's update, built from the shifts."""
        n = self.world_size
        w = np.eye(n) * self.self_weight
        for i in range(n):
            for j, wt in self.neighbors(i):
                w[i, j] += wt
        return w

    @property
    def symmetric(self) -> bool:
        w = self.mixing_matrix()
        return bool(np.allclose(w, w.T, atol=1e-12))

    def spectral_gap(self) -> float:
        """Per-round consensus contraction rate: ``1 - |lambda_2|`` for a
        symmetric ``W``, ``1 - ||W - 11^T/n||_2`` otherwise."""
        w = self.mixing_matrix()
        n = w.shape[0]
        if n < 2:
            return 1.0
        if np.allclose(w, w.T, atol=1e-12):
            eig = np.sort(np.abs(np.linalg.eigvalsh(w)))
            return float(1.0 - eig[-2])
        return float(1.0 - np.linalg.norm(w - np.full((n, n), 1.0 / n), 2))


def _metropolis_ring(n: int) -> tuple[tuple[Shift, ...], float]:
    if n == 1:
        return (), 1.0
    if n == 2:
        return (Shift(0, +1, 0.25), Shift(0, -1, 0.25)), 0.5
    w = 1.0 / 3.0
    return (Shift(0, +1, w), Shift(0, -1, w)), 1.0 - 2.0 * w


class RingTopology(Topology):
    """1-D ring: each worker averages with its two cyclic neighbours."""

    def __init__(self, world_size: int, axis_name: str = "workers"):
        shifts, self_w = _metropolis_ring(world_size)
        super().__init__(
            mesh_shape=(world_size,),
            axis_names=(axis_name,),
            shifts=shifts,
            self_weight=self_w,
            name="ring",
        )


_LATER = ("torus", "dense", "exp", "exponential", "onepeer-exp", "one-peer-exp",
          "hierarchical", "hier", "ring-of-rings")


def topology_from_name(name: str, world_size: int, **kwargs) -> Topology:
    """A topology from its CLI name. This slice has ``ring`` only; the
    reference's other families raise ``NotImplementedError``."""
    name = name.lower()
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    if name == "ring":
        if kwargs:
            raise ValueError(f"ring topology takes no extra args, got {sorted(kwargs)}")
        return RingTopology(world_size)
    if name in _LATER:
        raise NotImplementedError(
            f"topology {name!r} is not ported yet (ring only in this slice)"
        )
    raise ValueError(f"unknown topology {name!r} (expected ring)")
