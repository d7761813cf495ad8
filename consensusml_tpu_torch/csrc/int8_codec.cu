// Stand-alone per-row int8 and fp8 (e4m3fn) quantize and dequantize.
//
// Replaces: consensusml_tpu/compress/kernels.py:quantize_int8 (pallas_call
// at :123, kernel body _quant_kernel at :100), quantize_fp8 (pallas_call
// at :282, _quant_fp8_kernel at :263) and dequantize_int8 (pallas_call at
// :156, _dequant_kernel at :142), which dequantize_fp8 (:301) feeds e4m3
// rows. On the top-k codec's path the int8 pair carries the selected
// values; the fp8 pair is the two-step wire of --codec fp8
// (fused_wire=False). (R, C) f32 rows (C a multiple of 128; 512 at
// GPT-2-medium) to one byte an element plus one f32 scale a row, and
// back:
//   quantize:   scale = flush(max|x'| * f32(1/L)); inv = scale > 0 ? 1/scale : 0;
//               y = x' * inv, x' = flush(x); q = clip(rint(y), -127, 127)
//               (int8) or e4m3(y) (fp8)   (int8_quant.cuh)
//   dequantize: out = flush(float(q) * flush(scale))   (one rounding)
// Bit-equal to the plain versions (compress/kernels.py) and, through
// them, to the reference as XLA compiles it.
//
// What bounds them on the H100: bytes (quantize reads 4 and writes 1
// byte an element, dequantize the reverse, with a few flops). Design:
// quantize is one warp per row (8 rows a block) with 16-byte float4
// loads, a warp-shuffle row max, and a second pass over the row from
// L1/L2 for the 4-byte stores, as the fused encode does; dequantize is one
// thread per 4 elements (4 bytes in, float4 out), the row's scale read
// through the cache. One template serves both formats: only the code
// (round-and-clip or the e4m3 cast) and its decode differ.

#include <stdint.h>

#include "int8_quant.cuh"

namespace {

using cml::kWarp;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 256;

// the byte of y's code, and a code byte's value
template <int F>
__device__ __forceinline__ uint32_t code_of(float y) {
  if constexpr (F == cml::kFp8) {
    return cml::e4m3_code(y);
  } else {
    return static_cast<uint32_t>(cml::round_clip_int8(y)) & 0xffu;
  }
}

template <int F>
__device__ __forceinline__ float value_of(uint32_t c) {
  if constexpr (F == cml::kFp8) {
    return cml::e4m3_value(c);
  } else {
    return static_cast<float>(static_cast<int8_t>(c));
  }
}

template <int F>
__device__ __forceinline__ void quantize_rows(const float* __restrict__ x, uint8_t* __restrict__ q,
                                              float* __restrict__ scales, long long rows, int chunk) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * chunk;
  const float4* x4 = reinterpret_cast<const float4*>(x + base);
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
  const float scale = F == cml::kFp8 ? cml::fp8_scale(m) : cml::int8_scale(m);
  const float inv = cml::int8_inv(scale);
  if (lane == 0) scales[row] = scale;

  uint32_t* q4 = reinterpret_cast<uint32_t*>(q + base);
  for (int i = lane; i < n4; i += kWarp) {
    const float4 a = x4[i];
    q4[i] = code_of<F>(__fmul_rn(cml::flush(a.x), inv)) | code_of<F>(__fmul_rn(cml::flush(a.y), inv)) << 8 |
            code_of<F>(__fmul_rn(cml::flush(a.z), inv)) << 16 | code_of<F>(__fmul_rn(cml::flush(a.w), inv)) << 24;
  }
}

template <int F>
__device__ __forceinline__ void dequantize_rows(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                                                float* __restrict__ out, long long n4, int chunk4) {
  const uint32_t* q4 = reinterpret_cast<const uint32_t*>(q);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4; i += stride) {
    const float s = __ldg(scales + i / chunk4);
    const uint32_t c = q4[i];
    o4[i] = make_float4(cml::dequant(value_of<F>(c & 0xffu), s), cml::dequant(value_of<F>(c >> 8 & 0xffu), s),
                        cml::dequant(value_of<F>(c >> 16 & 0xffu), s), cml::dequant(value_of<F>(c >> 24), s));
  }
}

// one kernel name a format, so a profiler trace tells them apart
__global__ void __launch_bounds__(kWarp * kRowsPerBlock) quantize_int8_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scales, long long rows, int chunk) {
  quantize_rows<cml::kInt8>(x, q, scales, rows, chunk);
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock) quantize_fp8_kernel(
    const float* __restrict__ x, uint8_t* __restrict__ q, float* __restrict__ scales, long long rows, int chunk) {
  quantize_rows<cml::kFp8>(x, q, scales, rows, chunk);
}

__global__ void __launch_bounds__(kThreads) dequantize_int8_kernel(
    const uint8_t* __restrict__ q, const float* __restrict__ scales, float* __restrict__ out, long long n4,
    int chunk4) {
  dequantize_rows<cml::kInt8>(q, scales, out, n4, chunk4);
}

__global__ void __launch_bounds__(kThreads) dequantize_fp8_kernel(
    const uint8_t* __restrict__ q, const float* __restrict__ scales, float* __restrict__ out, long long n4,
    int chunk4) {
  dequantize_rows<cml::kFp8>(q, scales, out, n4, chunk4);
}

int quantize(bool fp8, const void* x, void* q, void* scales, long long rows, int chunk, void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto kernel = fp8 ? quantize_fp8_kernel : quantize_int8_kernel;
  kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(q), static_cast<float*>(scales), rows, chunk);
  return static_cast<int>(cudaGetLastError());
}

int dequantize(bool fp8, const void* q, const void* scales, void* out, long long rows, int chunk, void* stream) {
  if (chunk <= 0 || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long n4 = rows * (chunk / 4);
  // a grid-stride loop: at most 132 SMs x 16 blocks of 256 threads
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  const unsigned int grid = static_cast<unsigned int>(blocks < 132 * 16 ? blocks : 132 * 16);
  auto kernel = fp8 ? dequantize_fp8_kernel : dequantize_int8_kernel;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scales), static_cast<float*>(out), n4, chunk / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk that is not a
// positive multiple of 128.
extern "C" int cml_quantize_int8(const void* x, void* q, void* scales, long long rows, int chunk,
                                 void* stream) {
  return quantize(false, x, q, scales, rows, chunk, stream);
}

extern "C" int cml_quantize_fp8(const void* x, void* q, void* scales, long long rows, int chunk,
                                void* stream) {
  return quantize(true, x, q, scales, rows, chunk, stream);
}

extern "C" int cml_dequantize_int8(const void* q, const void* scales, void* out, long long rows, int chunk,
                                   void* stream) {
  return dequantize(false, q, scales, out, rows, chunk, stream);
}

extern "C" int cml_dequantize_fp8(const void* q, const void* scales, void* out, long long rows, int chunk,
                                  void* stream) {
  return dequantize(true, q, scales, out, rows, chunk, stream);
}
