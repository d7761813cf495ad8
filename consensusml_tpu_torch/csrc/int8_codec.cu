// Stand-alone per-row int8 quantize and dequantize.
//
// Replaces: consensusml_tpu/compress/kernels.py:quantize_int8 (pallas_call
// at :123, kernel body _quant_kernel at :100) and dequantize_int8
// (pallas_call at :156, _dequant_kernel at :142). On the top-k codec's
// path they carry the selected values: (R, C) f32 rows (C a multiple of
// 128; 512 at GPT-2-medium, one worker's value vector zero-padded to
// whole rows) to int8 rows plus one f32 scale a row, and back.
//   quantize:   scale = max|x| * f32(1/127); inv = scale > 0 ? 1/scale : 0;
//               q = clip(rint(x * inv), -127, 127)   (int8_quant.cuh)
//   dequantize: out = float(q) * scale   (one rounding, __fmul_rn)
// Bit-equal to the plain versions (compress/kernels.py) and, through
// them, to the reference as XLA compiles it.
//
// What bounds them on the H100: bytes (quantize reads 4 and writes 1
// byte an element, dequantize the reverse, with a few flops). Design:
// quantize is one warp per row (8 rows a block) with 16-byte float4
// loads, a warp-shuffle row max, and a second pass over the row from
// L1/L2 for the char4 stores, as the fused encode does; dequantize is one
// thread per 4 elements (char4 in, float4 out), the row's scale read
// through the cache.

#include <stdint.h>

#include "int8_quant.cuh"

namespace {

using cml::kWarp;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kWarp * kRowsPerBlock) quantize_int8_kernel(
    const float* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales, long long rows,
    int chunk) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * chunk;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
  const int n4 = chunk / 4;

  float m = 0.f;
  for (int i = lane; i < n4; i += kWarp) {
    const float4 a = x4[i];
    m = cml::max_nan(m, fabsf(a.x));
    m = cml::max_nan(m, fabsf(a.y));
    m = cml::max_nan(m, fabsf(a.z));
    m = cml::max_nan(m, fabsf(a.w));
  }
  m = cml::warp_max_nan(m);
  const float scale = cml::int8_scale(m);
  const float inv = cml::int8_inv(scale);
  if (lane == 0) scales[row] = scale;

  char4* q4 = reinterpret_cast<char4*>(q + base);
  for (int i = lane; i < n4; i += kWarp) {
    const float4 a = x4[i];
    char4 c;
    c.x = static_cast<signed char>(cml::round_clip_int8(__fmul_rn(a.x, inv)));
    c.y = static_cast<signed char>(cml::round_clip_int8(__fmul_rn(a.y, inv)));
    c.z = static_cast<signed char>(cml::round_clip_int8(__fmul_rn(a.z, inv)));
    c.w = static_cast<signed char>(cml::round_clip_int8(__fmul_rn(a.w, inv)));
    q4[i] = c;
  }
}

__global__ void __launch_bounds__(kThreads) dequantize_int8_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scales, float* __restrict__ out,
    long long n4, int chunk4) {
  const char4* q4 = reinterpret_cast<const char4*>(q);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4; i += stride) {
    const float s = __ldg(scales + i / chunk4);
    const char4 c = q4[i];
    o4[i] = make_float4(__fmul_rn(static_cast<float>(c.x), s), __fmul_rn(static_cast<float>(c.y), s),
                        __fmul_rn(static_cast<float>(c.z), s), __fmul_rn(static_cast<float>(c.w), s));
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk that is not a
// positive multiple of 128.
extern "C" int cml_quantize_int8(const void* x, void* q, void* scales, long long rows, int chunk,
                                 void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  quantize_int8_kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales), rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_dequantize_int8(const void* q, const void* scales, void* out, long long rows, int chunk,
                                   void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long n4 = rows * (chunk / 4);
  // a grid-stride loop: at most 132 SMs x 16 blocks of 256 threads
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  const unsigned int grid = static_cast<unsigned int>(blocks < 132 * 16 ? blocks : 132 * 16);
  dequantize_int8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(out), n4,
      chunk / 4);
  return static_cast<int>(cudaGetLastError());
}
