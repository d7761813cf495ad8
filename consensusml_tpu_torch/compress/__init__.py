"""Gossip codecs (counterpart of ``consensusml_tpu.compress``)."""

from consensusml_tpu_torch.compress.base import (
    ComposedCompressor,
    Compressor,
    Int4Payload,
    Int8Payload,
    LocalTopKPayload,
    TopKPayload,
)
from consensusml_tpu_torch.compress.kernels import (
    ChunkedTopKCompressor,
    FusedBucketCodec,
    PallasInt4Compressor,
    PallasInt8Compressor,
    chunk_scatter,
    chunked_topk,
    dequantize_int4,
    dequantize_int8,
    fused_bucket_codec,
    fused_pack_quantize,
    quantize_int4,
    quantize_int8,
)
from consensusml_tpu_torch.compress.reference import (
    Int4Compressor,
    Int8Compressor,
    TopKCompressor,
    topk_int4_compressor,
    topk_int8_compressor,
)

__all__ = [
    "Compressor",
    "ComposedCompressor",
    "Int8Payload",
    "Int4Payload",
    "TopKPayload",
    "LocalTopKPayload",
    "Int8Compressor",
    "Int4Compressor",
    "TopKCompressor",
    "topk_int8_compressor",
    "topk_int4_compressor",
    "PallasInt8Compressor",
    "PallasInt4Compressor",
    "ChunkedTopKCompressor",
    "FusedBucketCodec",
    "fused_bucket_codec",
    "fused_pack_quantize",
    "quantize_int8",
    "dequantize_int8",
    "quantize_int4",
    "dequantize_int4",
    "chunked_topk",
    "chunk_scatter",
]
