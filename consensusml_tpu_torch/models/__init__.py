"""Model building blocks of the port (counterpart of ``consensusml_tpu.models``)."""
