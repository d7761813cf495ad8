"""Simulated-workers backend (port of ``consensusml_tpu/comm/simulated.py``).

Workers are a stacked leading axis of every tensor on ONE device; one
gossip round is a product with the topology's doubly-stochastic mixing
matrix. It is the operator the collective backend (a later slice)
implements with sends and receives, and the port's test oracle for it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from consensusml_tpu_torch.topology import Topology
from consensusml_tpu_torch.utils import tree as T

__all__ = ["mixing_matrix", "mix_stacked", "mix_tree_stacked", "consensus_error_stacked"]


def mixing_matrix(topology: Topology, dtype=torch.float32, device=None) -> torch.Tensor:
    """The topology's mixing matrix as a tensor (flat worker order)."""
    return torch.as_tensor(np.asarray(topology.mixing_matrix()), dtype=dtype, device=device)


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
