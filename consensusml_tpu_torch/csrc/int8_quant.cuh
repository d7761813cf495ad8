// Per-row symmetric int8 quantization math shared by the int8 codec
// (int8_codec.cu) and the fused CHOCO encode (fused_choco_encode.cu).
//
// The reference is the program XLA compiles from
// consensusml_tpu/compress/kernels.py (_quant_kernel, _fused_quant), not
// the expressions it was written as:
//   scale = absmax * f32(1/127)   XLA turns absmax / 127.0 into a product
//                                 with the constant's f32 reciprocal
//   inv   = scale > 0 ? 1 / scale : 0    a true quotient (__fdiv_rn)
//   q     = clip(rint(y * inv), -127, 127)   rintf rounds half to even
// with the row max propagating NaN, as jnp.max does (fmaxf would drop it).
// Every rounding is spelled out with an _rn intrinsic so nvcc contracts
// nothing.

#pragma once

#include <cuda_runtime.h>

namespace cml {

constexpr int kWarp = 32;
constexpr int kRecip127Bits = 0x3c010204;  // f32(1/127), the constant XLA multiplies by

__device__ __forceinline__ float max_nan(float m, float a) { return (a > m || a != a) ? a : m; }

__device__ __forceinline__ float warp_max_nan(float m) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float int8_scale(float absmax) {
  return __fmul_rn(absmax, __int_as_float(kRecip127Bits));
}

__device__ __forceinline__ float int8_inv(float scale) { return scale > 0.f ? __fdiv_rn(1.f, scale) : 0.f; }

// clip(rint(y), -127, 127) as an int; NaN (only from a non-finite input)
// maps to 0. Through int, a rounded -0.0 decodes as +0, as the
// reference's int8 does.
__device__ __forceinline__ int round_clip_int8(float y) {
  const float r = rintf(y);
  return (r != r) ? 0 : static_cast<int>(fminf(fmaxf(r, -127.f), 127.f));
}

}  // namespace cml
