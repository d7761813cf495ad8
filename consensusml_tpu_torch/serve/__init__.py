"""Paged-KV serving (counterpart of ``consensusml_tpu.serve``): the
train-to-serve handoff (:mod:`.export`), the engine and its socket
front-end, speculative decode, the prefix cache and the hot swap
(:mod:`.pool`)."""

from consensusml_tpu_torch.serve.decode import DecodeModel
from consensusml_tpu_torch.serve.engine import Engine, ServeConfig, load_engine
from consensusml_tpu_torch.serve.export import (
    bump_generation,
    export_draft,
    export_serving,
    load_serving,
    serving_meta,
)
from consensusml_tpu_torch.serve.pool.spec import SpecConfig
from consensusml_tpu_torch.serve.server import ServeServer

__all__ = [
    "DecodeModel",
    "Engine",
    "ServeConfig",
    "ServeServer",
    "SpecConfig",
    "load_engine",
    "bump_generation",
    "export_draft",
    "export_serving",
    "load_serving",
    "serving_meta",
]
