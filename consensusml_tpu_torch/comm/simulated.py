"""Simulated-workers backend (port of ``consensusml_tpu/comm/simulated.py``).

Workers are a stacked leading axis of every tensor on ONE device; one
gossip round is a product with the topology's doubly-stochastic mixing
matrix. It is the operator the collective backend (a later slice)
implements with sends and receives, and the port's test oracle for it.
A time-varying topology stacks one matrix a phase (:func:`phase_matrices`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from consensusml_tpu_torch.topology import Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = [
    "mixing_matrix",
    "phase_matrices",
    "mix_stacked",
    "mix_tree_stacked",
    "consensus_error_stacked",
    "consensus_error_masked",
]


def mixing_matrix(topology: Topology, dtype=torch.float32, device=None) -> torch.Tensor:
    """The topology's mixing matrix as a tensor (flat worker order)."""
    return torch.as_tensor(np.asarray(topology.mixing_matrix()), dtype=dtype, device=device)


def phase_matrices(topology: Topology, dtype=torch.float32, device=None) -> torch.Tensor:
    """``(period, n, n)`` stacked matrices of a time-varying topology; round
    ``t`` uses index ``t % period``."""
    return torch.as_tensor(np.asarray(topology.phase_matrices()), dtype=dtype, device=device)


def mix_stacked(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x_i <- sum_j W[i, j] x_j`` over the leading worker axis: an f32
    ``W @ flat`` (as the reference accumulates), cast back to x's dtype."""
    n = w.shape[0]
    flat = x.to(torch.float32).reshape(n, -1)
    mixed = w.to(device=x.device, dtype=torch.float32) @ flat
    return mixed.reshape(x.shape).to(x.dtype)


def mix_tree_stacked(tree: Any, w: torch.Tensor) -> Any:
    return T.tree_map(lambda x: mix_stacked(x, w), tree)


def consensus_error_stacked(tree: Any, world_size: int) -> torch.Tensor:
    """``sqrt(mean_i ||theta_i - theta_bar||^2)`` over every leaf, in f32."""
    total = None
    for x in T.leaves(tree):
        x = x.to(torch.float32).reshape(world_size, -1)
        dev = x - x.mean(dim=0, keepdim=True)
        term = (dev * dev).sum() / world_size
        total = term if total is None else total + term
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


def consensus_error_masked(tree: Any, alive) -> torch.Tensor:
    """:func:`consensus_error_stacked` over the ALIVE workers only: mean and
    deviation restricted to the rows where ``alive`` (``(world,)`` 0/1
    floats) is 1, divided by ``max(sum(alive), 1)`` (0, not NaN, when
    every worker is dead)."""
    leaves = T.leaves(tree)
    if not leaves:
        return torch.zeros(())
    a = torch.as_tensor(alive, dtype=torch.float32, device=leaves[0].device)
    n_alive = torch.clamp(a.sum(), min=1.0)
    total = torch.zeros((), device=a.device)
    for x in leaves:
        x = x.to(torch.float32).reshape(a.shape[0], -1)
        dev = (x - T.masked_worker_mean(x, a, n_alive=n_alive)[None, :]) * a[:, None]
        total = total + (dev * dev).sum() / n_alive
    return torch.sqrt(total)
