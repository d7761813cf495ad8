"""Consensus engine (counterpart of ``consensusml_tpu.consensus``): exact
and compressed gossip, fault injection, push-sum and overlap gossip."""

from consensusml_tpu_torch.consensus.bucketing import Bucket, BucketPlan, build_plan
from consensusml_tpu_torch.consensus.engine import (
    ChocoState,
    ConsensusEngine,
    GossipConfig,
    OverlapState,
)
from consensusml_tpu_torch.consensus.faults import (
    FaultConfig,
    draw_alive,
    fault_generator,
    masked_mixing_matrix,
    record_fault_metrics,
    tree_all_finite,
)
from consensusml_tpu_torch.consensus.pushsum import (
    MASS_FLOOR,
    PushSumState,
    pushsum_init,
    pushsum_matrix,
    pushsum_round_collective,
    pushsum_round_simulated,
)

__all__ = [
    "Bucket", "BucketPlan", "build_plan",
    "ChocoState", "ConsensusEngine", "GossipConfig", "OverlapState",
    "FaultConfig", "draw_alive", "fault_generator", "masked_mixing_matrix", "record_fault_metrics",
    "tree_all_finite",
    "MASS_FLOOR", "PushSumState", "pushsum_init", "pushsum_matrix", "pushsum_round_collective",
    "pushsum_round_simulated",
]
