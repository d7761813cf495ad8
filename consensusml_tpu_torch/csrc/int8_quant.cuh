// Per-row symmetric quantization math shared by the int8 and fp8 codecs
// (int8_codec.cu), the int4 codec (int4_codec.cu) and the fused CHOCO
// wire's encode and decode (fused_choco_encode.cu, fused_choco_decode.cu).
//
// The reference is the program XLA compiles from
// consensusml_tpu/compress/kernels.py (_quant_kernel, _quant4_kernel,
// _quant_fp8_kernel, _fused_quant, _fused_dequant), not the expressions it
// was written as:
//   scale = absmax * f32(1/L)     L = 127 (int8), 7 (int4) or 448 (fp8):
//                                 XLA turns absmax / L into a product with
//                                 the constant's f32 reciprocal
//   inv   = scale > 0 ? 1 / scale : 0    a true quotient (__fdiv_rn)
//   q     = clip(rint(y * inv), -L, L)   rintf rounds half to even (int8,
//                                 int4), or the e4m3fn code of y * inv
//                                 (fp8: round half to even, NaN, inf and
//                                 |y| > 464 to the NaN code)
// with the row max propagating NaN, as jnp.max does (fmaxf would drop it).
//
// Subnormals: the reference's compiled program runs with flush-to-zero and
// denormals-are-zero (the CPU sets both for XLA's programs; the TPU has no
// f32 subnormals): a subnormal input of an arithmetic op counts as a zero
// of its sign and a subnormal result is written as one. flush() does that
// explicitly at the points where it changes a result: the rows read by a
// quantize, the scale, a decoded value q * scale, the CHOCO tracking
// update and the decode's sums. The sources build without -ftz, which
// would also change the flash, LayerNorm and BatchNorm kernels.
//
// Every rounding is spelled out with an _rn intrinsic so nvcc contracts
// nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cml {

constexpr int kWarp = 32;
constexpr int kRecip127Bits = 0x3c010204;  // f32(1/127), the constant XLA multiplies by
constexpr int kRecip7Bits = 0x3e124925;    // f32(1/7)
constexpr int kRecip448Bits = 0x3b124925;  // f32(1/448)

// the three codes of the fused wire, as compress/kernels.py numbers them
enum Fmt : int { kInt8 = 0, kInt4 = 1, kFp8 = 2 };

// a subnormal (or zero) as a zero of its sign, anything else unchanged
__device__ __forceinline__ float flush(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x7f800000u) ? v : __uint_as_float(b & 0x80000000u);
}

__device__ __forceinline__ float max_nan(float m, float a) { return (a > m || a != a) ? a : m; }

__device__ __forceinline__ float warp_max_nan(float m) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// absmax * f32(1/L), flushed (a row whose scale would be subnormal gets 0)
__device__ __forceinline__ float row_scale(float absmax, int recip_bits) {
  return flush(__fmul_rn(absmax, __int_as_float(recip_bits)));
}

__device__ __forceinline__ float int8_scale(float absmax) { return row_scale(absmax, kRecip127Bits); }
__device__ __forceinline__ float int4_scale(float absmax) { return row_scale(absmax, kRecip7Bits); }
__device__ __forceinline__ float fp8_scale(float absmax) { return row_scale(absmax, kRecip448Bits); }

// 1 / scale, 0 for a zero (or NaN) scale: the inverse of every codec
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

// f32 -> e4m3fn code as the reference casts: round half to even (onto the
// subnormal codes' 2^-9 grid below 2^-6, by adding 2^14 and reading the
// low bits), NaN, inf and |y| > 464 (the midpoint of 448 and the NaN
// code's 480) to the NaN code 0x7f of y's sign. PyTorch's cast (c10's
// fp8e4m3fn_from_fp32_value) saturates those at 448 instead; the plain
// version masks them, to_e4m3 in compress/reference.py.
__device__ __forceinline__ uint32_t e4m3_code(float y) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t sign = (bits >> 24) & 0x80u;
  uint32_t a = bits & 0x7fffffffu;
  if (a > 0x43e80000u) return sign | 0x7fu;  // NaN, inf, |y| > 464
  if (a < (121u << 23)) {                    // |y| < 2^-6: a subnormal code (or 0x08)
    const float t = __fadd_rn(__uint_as_float(a), 16384.f);
    return sign | (__float_as_uint(t) - (141u << 23));
  }
  a += (static_cast<uint32_t>(7 - 127) << 23) + 0x7ffffu + ((a >> 20) & 1u);
  return sign | ((a >> 20) & 0x7fu);
}

// e4m3fn code -> f32, exact; the NaN codes to the reference's f32 NaN of
// their sign (0x7fc00000 | sign)
__device__ __forceinline__ float e4m3_value(uint32_t c) {
  const uint32_t sign = (c & 0x80u) << 24;
  const uint32_t e = (c >> 3) & 0xfu, m = c & 7u;
  if (e == 15u && m == 7u) return __uint_as_float(sign | 0x7fc00000u);
  if (e == 0u) return __uint_as_float(sign | __float_as_uint(__fmul_rn(static_cast<float>(m), 0.001953125f)));
  return __uint_as_float(sign | ((e + 120u) << 23) | (m << 20));
}

// a decoded value: code * scale, one rounding, the scale read and the
// product written through flush()
__device__ __forceinline__ float dequant(float code, float scale) {
  return flush(__fmul_rn(code, flush(scale)));
}

}  // namespace cml
