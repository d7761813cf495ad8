// Fused CHOCO decode of the bucketed gossip wire (the receive), in its
// three formats: int8, int4 (two codes a byte) and fp8 (e4m3fn).
//
// Replaces: consensusml_tpu/compress/kernels.py:fused_dequantize_accumulate
// (pallas_call at :1016, kernel body _fused_decode_kernel at :912 with
// _fused_dequant at :892). Per element of (R, chunk) f32, for J sources
// (the self payload first, then one per neighbour) with static weights w:
//   d_j  = flush(value(q_j) * flush(scale_j))       one rounding each
//   J=1: s' = flush(fma(w_0, d_0, s~))
//   J>1: r  = flush(fma(w_0, d_0, flush(w_1 * d_1)))
//        r  = flush(fma(w_j, d_j, r))                for j = 2 .. J-1
//        s' = flush(s~ + r)                          s~ = flush(s)
// The reference writes s + (w_0 d_0 + w_1 d_1 + ...): the weighted sum
// first, s last. XLA compiles it with the first product fused into the
// second term's sum and each later term fused too (and a single source
// into one fma with s), and flushes subnormals (int8_quant.cuh); every
// rounding here is spelled out the same way, so the kernel is bit-equal
// to its plain version (compress/kernels.py) and, through it, to the
// reference.
//
// What bounds it on the H100: bytes. Each element reads s (4 bytes) and a
// byte (int4: half a byte) a source and writes 4 bytes; the scales are
// one f32 a row a source. Design: a grid-stride loop in which a thread
// takes one 32-bit word of every source's codes (4 elements; 8 for int4,
// whose word holds columns 4i.. in its low nibbles and chunk/2 + 4i.. in
// its high ones) and the matching float4s of s and out. The sources'
// pointers and weights ride in the kernel's parameters (at most 8).

#include <stdint.h>

#include "int8_quant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSources = 8;

struct Sources {
  const uint32_t* data[kMaxSources];  // each (rows, chunk) bytes, or (rows, chunk / 2) for int4
  const float* scales[kMaxSources];   // each (rows,)
  float w[kMaxSources];
  int n;
};

// the K code values of one 32-bit word of a source
template <int F, int K>
__device__ __forceinline__ void unpack(uint32_t word, float (&v)[K]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t byte = word >> (8 * b) & 0xffu;
    if constexpr (F == cml::kInt4) {
      const int lo = static_cast<int>(byte & 0xfu), hi = static_cast<int>(byte >> 4);
      v[b] = static_cast<float>(lo > 7 ? lo - 16 : lo);
      v[4 + b] = static_cast<float>(hi > 7 ? hi - 16 : hi);
    } else if constexpr (F == cml::kFp8) {
      v[b] = cml::e4m3_value(byte);
    } else {
      v[b] = static_cast<float>(static_cast<int8_t>(byte));
    }
  }
}

template <int F>
__device__ __forceinline__ void decode_words(const float* __restrict__ s, const Sources& src,
                                             float* __restrict__ out, long long words, int chunk) {
  constexpr int K = F == cml::kInt4 ? 8 : 4;  // elements a word
  const int per_row = chunk / K;              // words a row
  const int row4 = chunk / 4;                 // float4s a row
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float4* o4 = reinterpret_cast<float4*>(out);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < words; i += stride) {
    const long long row = i / per_row;
    // the float4 of this word's first 4 elements (and, for int4, the one
    // chunk/2 further on holding its high nibbles' elements)
    const size_t lo = static_cast<size_t>(row) * row4 + static_cast<size_t>(i - row * per_row);
    const size_t hi = lo + row4 / 2;
    float sv[K];
    {
      const float4 a = s4[lo];
      sv[0] = a.x, sv[1] = a.y, sv[2] = a.z, sv[3] = a.w;
      if constexpr (K == 8) {
        const float4 b = s4[hi];
        sv[4] = b.x, sv[5] = b.y, sv[6] = b.z, sv[7] = b.w;
      }
    }
    float first[K] = {}, r[K] = {};
#pragma unroll
    for (int j = 0; j < kMaxSources; ++j) {
      if (j >= src.n) break;
      float d[K];
      unpack<F>(src.data[j][i], d);
      const float sc = __ldg(src.scales[j] + row);
#pragma unroll
      for (int e = 0; e < K; ++e) d[e] = cml::dequant(d[e], sc);
      const float wj = src.w[j];
#pragma unroll
      for (int e = 0; e < K; ++e) {
        if (j == 0) {
          first[e] = d[e];
        } else if (j == 1) {
          r[e] = cml::flush(__fmaf_rn(src.w[0], first[e], cml::flush(__fmul_rn(wj, d[e]))));
        } else {
          r[e] = cml::flush(__fmaf_rn(wj, d[e], r[e]));
        }
      }
    }
#pragma unroll
    for (int e = 0; e < K; ++e) {
      const float base = cml::flush(sv[e]);
      r[e] = src.n == 1 ? cml::flush(__fmaf_rn(src.w[0], first[e], base)) : cml::flush(__fadd_rn(base, r[e]));
    }
    o4[lo] = make_float4(r[0], r[1], r[2], r[3]);
    if constexpr (K == 8) o4[hi] = make_float4(r[4], r[5], r[6], r[7]);
  }
}

// one kernel name a format, so a profiler trace tells them apart
#define CML_DECODE_KERNEL(NAME, F)                                                                          \
  __global__ void __launch_bounds__(kThreads)                                                               \
      NAME(const float* __restrict__ s, const Sources src, float* __restrict__ out, long long words,        \
           int chunk) {                                                                                     \
    decode_words<F>(s, src, out, words, chunk);                                                             \
  }
CML_DECODE_KERNEL(choco_decode_int8_kernel, cml::kInt8)
CML_DECODE_KERNEL(choco_decode_int4_kernel, cml::kInt4)
CML_DECODE_KERNEL(choco_decode_fp8_kernel, cml::kFp8)
#undef CML_DECODE_KERNEL

}  // namespace

// s' = s + sum_j weights[j] * dec(data[j], scales[j]) over (rows, chunk)
// f32 rows; data, scales and weights are host arrays of n entries (device
// pointers in the first two). Returns cudaGetLastError() after the launch
// (0 = launched); cudaErrorInvalidValue without launching for a chunk that
// is not a positive multiple of 128, an unknown format (0 int8, 1 int4,
// 2 fp8) or n outside [1, 8].
extern "C" int cml_fused_choco_decode(const void* s, const void* const* data, const void* const* scales,
                                      const float* weights, int n, void* out, long long rows, int chunk, int fmt,
                                      void* stream) {
  if (chunk <= 0 || chunk % 128 != 0 || fmt < cml::kInt8 || fmt > cml::kFp8 || n < 1 || n > kMaxSources) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0) return 0;
  Sources src{};
  for (int j = 0; j < n; ++j) {
    src.data[j] = static_cast<const uint32_t*>(data[j]);
    src.scales[j] = static_cast<const float*>(scales[j]);
    src.w[j] = weights[j];
  }
  src.n = n;
  const long long words = rows * (chunk / (fmt == cml::kInt4 ? 8 : 4));
  // a grid-stride loop: at most 132 SMs x 16 blocks of 256 threads
  const long long blocks = (words + kThreads - 1) / kThreads;
  const unsigned int grid = static_cast<unsigned int>(blocks < 132 * 16 ? blocks : 132 * 16);
  auto kernel = fmt == cml::kInt8 ? choco_decode_int8_kernel
                : fmt == cml::kInt4 ? choco_decode_int4_kernel
                                    : choco_decode_fp8_kernel;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(s), src,
                                                                   static_cast<float*>(out), words, chunk);
  return static_cast<int>(cudaGetLastError());
}
