"""Gossip codecs (counterpart of ``consensusml_tpu.compress``)."""

from consensusml_tpu_torch.compress.base import Compressor, Int8Payload
from consensusml_tpu_torch.compress.kernels import (
    FusedBucketCodec,
    PallasInt8Compressor,
    fused_bucket_codec,
    fused_pack_quantize,
    resolve_codec_impl,
)
from consensusml_tpu_torch.compress.reference import Int8Compressor

__all__ = [
    "Compressor",
    "Int8Payload",
    "Int8Compressor",
    "PallasInt8Compressor",
    "FusedBucketCodec",
    "fused_bucket_codec",
    "fused_pack_quantize",
    "resolve_codec_impl",
]
