"""Consensus engine (counterpart of ``consensusml_tpu.consensus``)."""

from consensusml_tpu_torch.consensus.engine import ChocoState, ConsensusEngine, GossipConfig

__all__ = ["ChocoState", "ConsensusEngine", "GossipConfig"]
