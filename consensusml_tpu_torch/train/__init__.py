"""Consensus-SGD training (counterpart of ``consensusml_tpu.train``).
``python -m consensusml_tpu_torch.train`` is the entry point."""
