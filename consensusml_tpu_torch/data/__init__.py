"""Input data (counterpart of ``consensusml_tpu.data``)."""

from consensusml_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticLM,
    cls_eval_batches,
    lm_eval_batches,
    lm_round_batches,
    round_batches,
)

__all__ = [
    "SyntheticClassification", "round_batches", "SyntheticLM", "lm_round_batches", "cls_eval_batches",
    "lm_eval_batches",
]
