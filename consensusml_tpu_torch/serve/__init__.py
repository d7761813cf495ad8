"""Paged-KV serving (counterpart of ``consensusml_tpu.serve``)."""

from consensusml_tpu_torch.serve.engine import Engine, ServeConfig
from consensusml_tpu_torch.serve.server import ServeServer

__all__ = ["Engine", "ServeConfig", "ServeServer"]
