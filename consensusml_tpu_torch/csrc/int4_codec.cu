// Stand-alone per-row int4 quantize and dequantize, two codes a byte.
//
// Replaces: consensusml_tpu/compress/kernels.py:quantize_int4 (pallas_call
// at :205, kernel body _quant4_kernel at :177) and dequantize_int4
// (pallas_call at :242, _dequant4_kernel at :224). On the top-k + int4
// codec's path they carry the selected values: (R, C) f32 rows (C a
// multiple of 128; 128 at GPT-2-medium, one worker's value vector
// zero-padded to whole rows) to (R, C/2) packed bytes plus one f32 scale
// a row, and back.
//   quantize:   scale = flush(max|x'| * f32(1/7)); inv = scale > 0 ? 1/scale : 0;
//               q = clip(rint(x' * inv), -7, 7), NaN to 0, x' = flush(x)
//               (int8_quant.cuh: subnormals read as zeros, as the
//               reference's compiled program reads them);
//               byte j = (q[j] & 0xF) | (q[j + C/2] & 0xF) << 4
//   dequantize: nibble sign-extended (n > 7 -> n - 16), out =
//               flush(float(q) * flush(scale)) (one rounding, __fmul_rn)
// Bit-equal to the plain versions (compress/kernels.py) and, through
// them, to the reference as XLA compiles it.
//
// What bounds them on the H100: bytes (quantize reads 4 bytes and writes
// half a byte an element, dequantize the reverse, with a few flops).
// Design: quantize is one warp per row (8 rows a block): a float4 pass for
// the warp-shuffle row max, then a second pass (from L1/L2) in which each
// lane reads a float4 of the row's first half and the float4 C/2 further
// on, and stores the four bytes they pack as one 32-bit word. Dequantize
// is one thread per 4 bytes (one 32-bit load, two float4 stores: the low
// nibbles to columns 4i.., the high ones to C/2 + 4i..), the row's scale
// read through the cache.

#include <stdint.h>

#include "int8_quant.cuh"

namespace {

using cml::kWarp;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t nibble(float y, float inv) {
  return static_cast<uint32_t>(cml::round_clip_int4(__fmul_rn(cml::flush(y), inv))) & 0xFu;
}

__device__ __forceinline__ float sext(uint32_t nib, float s) {
  const int q = nib > 7u ? static_cast<int>(nib) - 16 : static_cast<int>(nib);
  return cml::dequant(static_cast<float>(q), s);
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock) quantize_int4_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ packed, float* __restrict__ scales, long long rows,
    int chunk) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const int half = chunk / 2;
  const float4* x4 = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * chunk);
  const int n4 = chunk / 4;

  float m = 0.f;
  for (int i = lane; i < n4; i += kWarp) {
    const float4 a = x4[i];
    m = cml::max_nan(m, fabsf(cml::flush(a.x)));
    m = cml::max_nan(m, fabsf(cml::flush(a.y)));
    m = cml::max_nan(m, fabsf(cml::flush(a.z)));
    m = cml::max_nan(m, fabsf(cml::flush(a.w)));
  }
  m = cml::warp_max_nan(m);
  const float scale = cml::int4_scale(m);
  const float inv = cml::int8_inv(scale);
  if (lane == 0) scales[row] = scale;

  // word i packs bytes 4i..4i+3: low nibbles from float4 i, high nibbles
  // from float4 i + C/8 (C/2 elements further on)
  uint32_t* out = reinterpret_cast<uint32_t*>(packed + static_cast<size_t>(row) * half);
  const int h4 = half / 4;
  for (int i = lane; i < h4; i += kWarp) {
    const float4 lo = x4[i];
    const float4 hi = x4[i + h4];
    out[i] = (nibble(lo.x, inv) | nibble(hi.x, inv) << 4) | (nibble(lo.y, inv) | nibble(hi.y, inv) << 4) << 8 |
             (nibble(lo.z, inv) | nibble(hi.z, inv) << 4) << 16 | (nibble(lo.w, inv) | nibble(hi.w, inv) << 4) << 24;
  }
}

__global__ void __launch_bounds__(kThreads) dequantize_int4_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ scales, float* __restrict__ out,
    long long n4, int half4) {
  const uint32_t* p4 = reinterpret_cast<const uint32_t*>(packed);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4; i += stride) {
    const long long row = i / half4;
    const int j = static_cast<int>(i - row * half4);
    const float s = __ldg(scales + row);
    const uint32_t w = p4[i];
    float4* o4 = reinterpret_cast<float4*>(out + static_cast<size_t>(row) * half4 * 8);
    o4[j] = make_float4(sext(w & 0xFu, s), sext(w >> 8 & 0xFu, s), sext(w >> 16 & 0xFu, s),
                        sext(w >> 24 & 0xFu, s));
    o4[j + half4] = make_float4(sext(w >> 4 & 0xFu, s), sext(w >> 12 & 0xFu, s), sext(w >> 20 & 0xFu, s),
                                sext(w >> 28, s));
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk (the unpacked row
// width C) that is not a positive multiple of 128.
extern "C" int cml_quantize_int4(const void* x, void* packed, void* scales, long long rows, int chunk,
                                 void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_int4_kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(packed), static_cast<float*>(scales), rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_dequantize_int4(const void* packed, const void* scales, void* out, long long rows, int chunk,
                                   void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const int half4 = chunk / 8;  // 32-bit words a packed row
  const long long n4 = rows * half4;
  // a grid-stride loop: at most 132 SMs x 16 blocks of 256 threads
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  const unsigned int grid = static_cast<unsigned int>(blocks < 132 * 16 ? blocks : 132 * 16);
  dequantize_int4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const float*>(scales), static_cast<float*>(out), n4,
      half4);
  return static_cast<int>(cudaGetLastError());
}
