// Per-row symmetric quantization math shared by the int8 codec
// (int8_codec.cu), the fused CHOCO encode (fused_choco_encode.cu) and the
// int4 codec (int4_codec.cu).
//
// The reference is the program XLA compiles from
// consensusml_tpu/compress/kernels.py (_quant_kernel, _fused_quant,
// _quant4_kernel), not the expressions it was written as:
//   scale = absmax * f32(1/L)     L = 127 (int8) or 7 (int4): XLA turns
//                                 absmax / L into a product with the
//                                 constant's f32 reciprocal
//   inv   = scale > 0 ? 1 / scale : 0    a true quotient (__fdiv_rn)
//   q     = clip(rint(y * inv), -L, L)   rintf rounds half to even
// with the row max propagating NaN, as jnp.max does (fmaxf would drop it).
// Every rounding is spelled out with an _rn intrinsic so nvcc contracts
// nothing.

#pragma once

#include <cuda_runtime.h>

namespace cml {

constexpr int kWarp = 32;
constexpr int kRecip127Bits = 0x3c010204;  // f32(1/127), the constant XLA multiplies by
constexpr int kRecip7Bits = 0x3e124925;    // f32(1/7)

__device__ __forceinline__ float max_nan(float m, float a) { return (a > m || a != a) ? a : m; }

__device__ __forceinline__ float warp_max_nan(float m) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float int8_scale(float absmax) {
  return __fmul_rn(absmax, __int_as_float(kRecip127Bits));
}

__device__ __forceinline__ float int4_scale(float absmax) {
  return __fmul_rn(absmax, __int_as_float(kRecip7Bits));
}

// 1 / scale, 0 for a zero (or NaN) scale: the inverse of both codecs
__device__ __forceinline__ float int8_inv(float scale) { return scale > 0.f ? __fdiv_rn(1.f, scale) : 0.f; }

// clip(rint(y), -127, 127) as an int; NaN (only from a non-finite input)
// maps to 0. Through int, a rounded -0.0 decodes as +0, as the
// reference's int8 does.
__device__ __forceinline__ int round_clip_int8(float y) {
  const float r = rintf(y);
  return (r != r) ? 0 : static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

// clip(rint(y), -7, 7) as an int, NaN to 0
__device__ __forceinline__ int round_clip_int4(float y) {
  const float r = rintf(y);
  return (r != r) ? 0 : static_cast<int>(fminf(fmaxf(r, -7.f), 7.f));
}

}  // namespace cml
