"""Tensor parallelism in the collective backend: a worker's parameters,
optimizer state and gossip state split over its ranks by the config's
rules (:mod:`.sharding`), the reference's hybrid gossip-DP x tp
(``consensusml_tpu/train/local_sgd.py`` under ``WorkerMesh.model_axes``,
where GSPMD inserts the collectives).

A rank holds its piece of each leaf a rule splits and the whole of every
other leaf. The models (``models/gpt2.py``, ``models/llama.py``) run the
logical program on those pieces with :mod:`.axis`'s differentiable
collectives: a column-split product's input enters by ``copy_to``, a
row-split product's partial sums leave by ``reduce_from``, an embedding
table split on hidden is gathered whole (``gather_to``). A replicated
leaf then gets the same gradient on every rank of the worker, and a
split leaf its piece of the logical gradient.

The gossip:

- exact mixing is linear and element-wise, so each model index gossips
  its pieces with the same index of the neighbouring workers (the mesh's
  gossip group): a piece of the logical round;
- a compressed codec selects over the logical bucket (chunked top-k):
  pieces compressed apart would keep other coordinates, a different
  result. So each rank gathers the logical tree from its worker's ranks
  (:meth:`TensorParallel.gather`, bytes counted apart from the wire's),
  runs the logical round on it with the logical gossip state, the same on
  every rank of the worker, and keeps its piece. Each rank of a worker
  then sends the worker's whole payload to the same index of its
  neighbours: the wire carries it ``size`` times.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from consensusml_tpu_torch.parallel.axis import Axis, all_gather
from consensusml_tpu_torch.parallel.sharding import shard_plan, spec_for_path, tree_path

__all__ = ["TensorParallel"]


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A worker's rank on its one model axis, with the rules that split its
    leaves."""

    axis: Axis
    rules: Any

    def split_dim(self, name: str, ndim: int) -> int | None:
        """The dim of leaf ``name`` the axis splits, or None (replicated)."""
        spec = spec_for_path(tree_path(name), ndim, self.rules)
        dims = [i for i, a in enumerate(spec) if a == self.axis.name]
        return dims[0] if dims else None

    def shard(self, name: str, tensor: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """This rank's piece of ``tensor`` (``lead`` leading axes, e.g. the
        worker stack's, are not the leaf's and stay whole)."""
        plan = shard_plan(name, tuple(tensor.shape[lead:]), self.rules, {self.axis.name: self.axis.size},
                          {self.axis.name: self.axis.index})
        return tensor[(slice(None),) * lead + plan].clone(memory_format=torch.contiguous_format)

    def shard_named(self, named: dict, lead: int = 0) -> dict:
        return {n: self.shard(n, t, lead) for n, t in named.items()}

    def gather(self, name: str, piece: torch.Tensor, lead: int = 0) -> torch.Tensor:
        """The logical leaf from every rank's ``piece`` (all-gathered along
        the split dim; a replicated leaf as it is)."""
        dim = self.split_dim(name, piece.dim() - lead)
        return piece if dim is None else all_gather(piece, self.axis, lead + dim)

    def gather_named(self, named: dict, lead: int = 0) -> dict:
        return {n: self.gather(n, t, lead) for n, t in named.items()}

    def split_names(self, named: dict, lead: int = 0) -> set:
        return {n for n, t in named.items() if self.split_dim(n, t.dim() - lead) is not None}
