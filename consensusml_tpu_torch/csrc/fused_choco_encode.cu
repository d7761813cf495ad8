// Fused CHOCO encode of the bucketed gossip wire, in its three formats:
// int8, int4 (two codes a byte) and fp8 (e4m3fn).
//
// Replaces: consensusml_tpu/compress/kernels.py:fused_pack_quantize
// (pallas_call at :953, kernel body _fused_encode_kernel at :903 with the
// shared math _fused_quant at :871). Per row of (R, chunk) f32:
//   d      = flush(x' - xhat')          x' = flush(x), xhat' = flush(xhat)
//   scale  = flush(max|d| * f32(1/L))   (NaN propagates, as jnp.max does)
//   inv    = scale > 0 ? 1 / scale : 0
//   q      = the code of d * inv        int8: clip(rint(.), -127, 127);
//                                       int4: clip(rint(.), -7, 7), packed
//                                       two a byte (byte j: column j low,
//                                       column j + chunk/2 high); fp8: e4m3
//   xhat'' = flush(fma(value(q), scale, xhat'))   (one rounding)
// and writes q, scale and xhat''. The result must equal the reference bit
// for bit, and the reference is the program XLA compiles, not the
// expressions it was written as: XLA turns absmax / L into a product with
// the f32 reciprocal of L, fuses xhat + q * scale into one multiply-add
// (rounding twice differs in the last bit of 3-11% of values), and runs
// with subnormals flushed (int8_quant.cuh). So every rounding is spelled
// out here and nothing is left to nvcc's contraction: __fsub_rn/__fmul_rn
// for d and d * inv, the quantize math of int8_quant.cuh (shared with the
// stand-alone codecs, whose bytes the fused wire ships), and __fmaf_rn for
// xhat''.
//
// What bounds it on the H100: bytes. Each element reads 8 bytes (x, xhat)
// and writes 5 (int8, fp8) or 4.5 (int4) (q, xhat''), with a handful of
// flops: ~0.4 flop/byte, far below the ridge. Design for that: one warp
// per row (256 threads, 8 rows a block), 16-byte float4 loads and 4-byte /
// float4 stores, neighbouring lanes on neighbouring addresses; the row max
// is a warp shuffle reduction, so nothing but the outputs goes back to
// device memory. The second pass re-reads the row (a 512-float row is 4 KB
// per input) from L1/L2 rather than holding it in registers, so one kernel
// serves every chunk that is a multiple of 128. The int4 pass reads a
// float4 of the row's first half and the float4 chunk/2 further on, whose
// codes share bytes, and writes both halves' xhat''.

#include <stdint.h>

#include "int8_quant.cuh"

namespace {

using cml::kWarp;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float delta(float xv, float hv) {
  return cml::flush(__fsub_rn(cml::flush(xv), cml::flush(hv)));
}

// one element: its code (a byte, or an int4 nibble) and xhat''
template <int F>
__device__ __forceinline__ uint32_t quant(float xv, float hv, float inv, float scale, float& out) {
  const float y = __fmul_rn(delta(xv, hv), inv);
  uint32_t code;
  float value;
  if constexpr (F == cml::kFp8) {
    code = cml::e4m3_code(y);
    value = cml::e4m3_value(code);
  } else {
    const int qi = F == cml::kInt4 ? cml::round_clip_int4(y) : cml::round_clip_int8(y);
    code = static_cast<uint32_t>(qi) & (F == cml::kInt4 ? 0xfu : 0xffu);
    value = static_cast<float>(qi);
  }
  out = cml::flush(__fmaf_rn(value, scale, cml::flush(hv)));
  return code;
}

template <int F>
__device__ __forceinline__ void encode_rows(const float* __restrict__ x, const float* __restrict__ xhat,
                                            uint8_t* __restrict__ q, float* __restrict__ scales,
                                            float* __restrict__ hat, long long rows, int chunk) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * chunk;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const float4* h4 = reinterpret_cast<const float4*>(xhat + base);
  const int n4 = chunk / 4;

  float m = 0.f;
  for (int i = lane; i < n4; i += kWarp) {
    const float4 a = x4[i];
    const float4 b = h4[i];
    m = cml::max_nan(m, fabsf(delta(a.x, b.x)));
    m = cml::max_nan(m, fabsf(delta(a.y, b.y)));
    m = cml::max_nan(m, fabsf(delta(a.z, b.z)));
    m = cml::max_nan(m, fabsf(delta(a.w, b.w)));
  }
  m = cml::warp_max_nan(m);
  const float scale = F == cml::kInt8 ? cml::int8_scale(m) : F == cml::kInt4 ? cml::int4_scale(m) : cml::fp8_scale(m);
  const float inv = cml::int8_inv(scale);
  if (lane == 0) scales[row] = scale;

  float4* o4 = reinterpret_cast<float4*>(hat + base);
  if constexpr (F == cml::kInt4) {
    // word i packs bytes 4i..4i+3: low nibbles from float4 i, high nibbles
    // from float4 i + chunk/8 (chunk/2 elements further on)
    uint32_t* w4 = reinterpret_cast<uint32_t*>(q + static_cast<size_t>(row) * (chunk / 2));
    const int half4 = n4 / 2;
    for (int i = lane; i < half4; i += kWarp) {
      const float4 alo = x4[i], blo = h4[i];
      const float4 ahi = x4[i + half4], bhi = h4[i + half4];
      float4 olo, ohi;
      const uint32_t b0 = quant<F>(alo.x, blo.x, inv, scale, olo.x) | quant<F>(ahi.x, bhi.x, inv, scale, ohi.x) << 4;
      const uint32_t b1 = quant<F>(alo.y, blo.y, inv, scale, olo.y) | quant<F>(ahi.y, bhi.y, inv, scale, ohi.y) << 4;
      const uint32_t b2 = quant<F>(alo.z, blo.z, inv, scale, olo.z) | quant<F>(ahi.z, bhi.z, inv, scale, ohi.z) << 4;
      const uint32_t b3 = quant<F>(alo.w, blo.w, inv, scale, olo.w) | quant<F>(ahi.w, bhi.w, inv, scale, ohi.w) << 4;
      w4[i] = b0 | b1 << 8 | b2 << 16 | b3 << 24;
      o4[i] = olo;
      o4[i + half4] = ohi;
    }
  } else {
    uint32_t* w4 = reinterpret_cast<uint32_t*>(q + base);
    for (int i = lane; i < n4; i += kWarp) {
      const float4 a = x4[i];
      const float4 b = h4[i];
      float4 o;
      const uint32_t c0 = quant<F>(a.x, b.x, inv, scale, o.x);
      const uint32_t c1 = quant<F>(a.y, b.y, inv, scale, o.y);
      const uint32_t c2 = quant<F>(a.z, b.z, inv, scale, o.z);
      const uint32_t c3 = quant<F>(a.w, b.w, inv, scale, o.w);
      w4[i] = c0 | c1 << 8 | c2 << 16 | c3 << 24;
      o4[i] = o;
    }
  }
}

// one kernel name a format, so a profiler trace tells them apart
#define CML_ENCODE_KERNEL(NAME, F)                                                                           \
  __global__ void __launch_bounds__(kWarp * kRowsPerBlock)                                                   \
      NAME(const float* __restrict__ x, const float* __restrict__ xhat, uint8_t* __restrict__ q,             \
           float* __restrict__ scales, float* __restrict__ hat, long long rows, int chunk) {                 \
    encode_rows<F>(x, xhat, q, scales, hat, rows, chunk);                                                    \
  }
CML_ENCODE_KERNEL(choco_encode_int8_kernel, cml::kInt8)
CML_ENCODE_KERNEL(choco_encode_int4_kernel, cml::kInt4)
CML_ENCODE_KERNEL(choco_encode_fp8_kernel, cml::kFp8)
#undef CML_ENCODE_KERNEL

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk that is not a
// positive multiple of 128 or an unknown format (0 int8, 1 int4, 2 fp8).
// q is (rows, chunk) bytes, or (rows, chunk / 2) for int4.
extern "C" int cml_fused_choco_encode(const void* x, const void* xhat, void* q, void* scales, void* hat,
                                      long long rows, int chunk, int fmt, void* stream) {
  if (chunk <= 0 || chunk % 128 != 0 || fmt < cml::kInt8 || fmt > cml::kFp8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = fmt == cml::kInt8 ? choco_encode_int8_kernel
                : fmt == cml::kInt4 ? choco_encode_int4_kernel
                                    : choco_encode_fp8_kernel;
  kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(xhat), static_cast<uint8_t*>(q),
      static_cast<float*>(scales), static_cast<float*>(hat), rows, chunk);
  return static_cast<int>(cudaGetLastError());
}
