// Fused CHOCO encode of the bucketed gossip wire, int8 format.
//
// Replaces: consensusml_tpu/compress/kernels.py:fused_pack_quantize
// (pallas_call at :953, kernel body _fused_encode_kernel at :892 with the
// shared math _fused_quant at :871). Per row of (R, chunk) f32:
//   d      = x - xhat
//   scale  = max|d| * f32(1/127)     (NaN propagates, as jnp.max does)
//   inv    = scale > 0 ? 1 / scale : 0
//   q      = clip(rint(d * inv), -127, 127)   as int8 (NaN -> 0)
//   xhat'  = fma(q, scale, xhat)      (one rounding)
// and writes q, scale and xhat'. The result must equal the reference bit
// for bit, and the reference is the program XLA compiles, not the
// expressions it was written as: XLA turns absmax / 127.0 into a product
// with the f32 reciprocal of 127, and fuses xhat + q * scale into one
// multiply-add (in its jitted rounds and its Pallas kernels alike; each
// differs from the naive reading in the last bit of ~8% of values). So
// every rounding is spelled out here and nothing is left to nvcc's
// contraction: __fsub_rn/__fmul_rn for d and d * inv, the int8 math of
// int8_quant.cuh (shared with the stand-alone quantize kernel), and
// __fmaf_rn for xhat'.
//
// What bounds it on the H100: bytes. Each element reads 8 bytes (x, xhat)
// and writes 5 (q, xhat'), with a handful of flops: ~0.4 flop/byte, far
// below the ridge. Design for that: one warp per row (256 threads, 8 rows
// a block), 16-byte float4 loads and char4/float4 stores, neighbouring
// lanes on neighbouring addresses; the row max is a warp shuffle
// reduction, so nothing but the outputs goes back to device memory. The
// second pass re-reads the row (a 512-float row is 4 KB per input) from
// L1/L2 rather than holding it in registers, so one kernel serves every
// chunk that is a multiple of 128.

#include <stdint.h>

#include "int8_quant.cuh"

namespace {

using cml::kWarp;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ void quant(float xv, float hv, float inv, float scale, signed char& q,
                                      float& out) {
  const int qi = cml::round_clip_int8(__fmul_rn(__fsub_rn(xv, hv), inv));
  q = static_cast<signed char>(qi);
  out = __fmaf_rn(static_cast<float>(qi), scale, hv);
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock) choco_encode_int8_kernel(
    const float* __restrict__ x, const float* __restrict__ xhat, int8_t* __restrict__ q,
    float* __restrict__ scales, float* __restrict__ hat, long long rows, int chunk) {
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
    m = cml::max_nan(m, fabsf(__fsub_rn(a.x, b.x)));
    m = cml::max_nan(m, fabsf(__fsub_rn(a.y, b.y)));
    m = cml::max_nan(m, fabsf(__fsub_rn(a.z, b.z)));
    m = cml::max_nan(m, fabsf(__fsub_rn(a.w, b.w)));
  }
  m = cml::warp_max_nan(m);
  const float scale = cml::int8_scale(m);
  const float inv = cml::int8_inv(scale);
  if (lane == 0) scales[row] = scale;

  char4* q4 = reinterpret_cast<char4*>(q + base);
  float4* o4 = reinterpret_cast<float4*>(hat + base);
  for (int i = lane; i < n4; i += kWarp) {
    const float4 a = x4[i];
    const float4 b = h4[i];
    char4 c;
    float4 o;
    quant(a.x, b.x, inv, scale, c.x, o.x);
    quant(a.y, b.y, inv, scale, c.y, o.y);
    quant(a.z, b.z, inv, scale, c.z, o.z);
    quant(a.w, b.w, inv, scale, c.w, o.w);
    q4[i] = c;
    o4[i] = o;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk that is not a
// positive multiple of 128.
extern "C" int cml_fused_choco_encode_int8(const void* x, const void* xhat, void* q, void* scales,
                                           void* hat, long long rows, int chunk, void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  choco_encode_int8_kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(xhat), static_cast<int8_t*>(q),
      static_cast<float*>(scales), static_cast<float*>(hat), rows, chunk);
  return static_cast<int>(cudaGetLastError());
}
