"""Gossip topologies (counterpart of ``consensusml_tpu.topology``): each
yields a doubly-stochastic mixing matrix ``W`` (the simulated backend's
``x <- W @ x``) and the weighted shifts it is built from."""

from consensusml_tpu_torch.topology.topologies import (
    DenseTopology,
    ExponentialTopology,
    HierarchicalTopology,
    OnePeerExponentialTopology,
    RingTopology,
    Shift,
    TimeVaryingTopology,
    Topology,
    TorusTopology,
    rederive,
    topology_from_name,
)

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
