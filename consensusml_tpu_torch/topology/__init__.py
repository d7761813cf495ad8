"""Gossip topologies (counterpart of ``consensusml_tpu.topology``)."""

from consensusml_tpu_torch.topology.topologies import (
    RingTopology,
    Shift,
    Topology,
    topology_from_name,
)

__all__ = ["Shift", "Topology", "RingTopology", "topology_from_name"]
