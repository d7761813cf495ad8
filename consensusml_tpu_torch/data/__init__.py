"""Input data (counterpart of ``consensusml_tpu.data``)."""

from consensusml_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticLM,
    lm_round_batches,
    round_batches,
)

__all__ = ["SyntheticClassification", "round_batches", "SyntheticLM", "lm_round_batches"]
