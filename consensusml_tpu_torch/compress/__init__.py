"""Gossip codecs (counterpart of ``consensusml_tpu.compress``)."""

from consensusml_tpu_torch.compress.base import (
    ComposedCompressor,
    Compressor,
    Int8Payload,
    LocalTopKPayload,
    TopKPayload,
)
from consensusml_tpu_torch.compress.kernels import (
    ChunkedTopKCompressor,
    FusedBucketCodec,
    PallasInt8Compressor,
    chunk_scatter,
    chunked_topk,
    dequantize_int8,
    fused_bucket_codec,
    fused_pack_quantize,
    quantize_int8,
    resolve_codec_impl,
)
from consensusml_tpu_torch.compress.reference import Int8Compressor, TopKCompressor, topk_int8_compressor

__all__ = [
    "Compressor",
    "ComposedCompressor",
    "Int8Payload",
    "TopKPayload",
    "LocalTopKPayload",
    "Int8Compressor",
    "TopKCompressor",
    "topk_int8_compressor",
    "PallasInt8Compressor",
    "ChunkedTopKCompressor",
    "FusedBucketCodec",
    "fused_bucket_codec",
    "fused_pack_quantize",
    "quantize_int8",
    "dequantize_int8",
    "chunked_topk",
    "chunk_scatter",
    "resolve_codec_impl",
]
