"""Input data (counterpart of ``consensusml_tpu.data``)."""

from consensusml_tpu_torch.data.synthetic import (
    SyntheticClassification,
    SyntheticLM,
    cls_eval_batches,
    lm_eval_batches,
    lm_round_batches,
    mlm_corrupt,
    round_batches,
)

__all__ = [
    "SyntheticClassification", "round_batches", "SyntheticLM", "lm_round_batches", "cls_eval_batches",
    "lm_eval_batches", "mlm_corrupt",
]
