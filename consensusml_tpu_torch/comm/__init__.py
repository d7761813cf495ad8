"""Gossip backends (counterpart of ``consensusml_tpu.comm``). This slice
has the stacked simulated backend; the collective backend over
``torch.distributed`` waits for a later slice."""
