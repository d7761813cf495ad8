"""Gossip backends (counterpart of ``consensusml_tpu.comm``): the stacked
simulated backend (:mod:`.simulated`) and the collective one, one process
per worker over ``torch.distributed`` (:mod:`.collectives`, :mod:`.mesh`,
:mod:`.transport`, :mod:`.launch`)."""
