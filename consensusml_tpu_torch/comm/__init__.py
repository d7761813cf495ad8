"""Gossip backends (counterpart of ``consensusml_tpu.comm``): the stacked
simulated backend (:mod:`.simulated`) and the collective one, one process
per worker over ``torch.distributed`` (:mod:`.collectives`, :mod:`.mesh`,
:mod:`.transport`, :mod:`.launch`), with the fault-masked mixes beside
the exact ones."""

from consensusml_tpu_torch.comm import simulated
from consensusml_tpu_torch.comm.collectives import (
    consensus_error,
    mix,
    mix_masked,
    mix_tree,
    mix_tree_masked,
    ppermute_shift,
)
from consensusml_tpu_torch.comm.mesh import WorkerMesh

__all__ = [
    "WorkerMesh", "consensus_error", "mix", "mix_masked", "mix_tree", "mix_tree_masked", "ppermute_shift",
    "simulated",
]
