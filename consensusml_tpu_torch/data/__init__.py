"""Input data (counterpart of ``consensusml_tpu.data``)."""

from consensusml_tpu_torch.data.synthetic import SyntheticLM, lm_round_batches

__all__ = ["SyntheticLM", "lm_round_batches"]
