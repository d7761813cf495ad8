// Chunked top-k by magnitude.
//
// Replaces: consensusml_tpu/compress/kernels.py:chunked_topk (pallas_call
// at :374, kernel body _topk_kernel at :313). Per row of (R, C) f32 (C a
// multiple of 128 up to 1024; 512 at GPT-2-medium), the k largest |x| (k <= 64; 8
// at GPT-2-medium) in descending order, equal magnitudes to the lower
// index (the jax.lax.top_k order), as (value f32 (R, k), chunk-local
// index int32 (R, k)). The reference's value is a masked row sum, so a
// -0.0 winner comes out +0.0; so it does here. Bit-equal to
// chunked_topk_plain (compress/kernels.py): selection is integer
// compares, the value is copied.
//
// What bounds it on the H100: bytes (4 an element read; the outputs are
// 2k/C of that), provided the k extractions stay on chip. The TPU kernel
// sweeps a VMEM block k times; here one warp owns a row and keeps it in
// registers (C/32 values a lane, loaded once as float4s, neighbouring
// lanes on neighbouring addresses), so the k sweeps cost no memory
// traffic. Each sweep is a warp argmax on a 64-bit key, |x|'s bits above
// the complement of the index: |x| >= 0 orders as an unsigned integer and
// the complement makes the lower index win a tie. A taken element's key
// becomes 0, below every live key. The winner's lane hands its signed
// value over by a shuffle; lane j % 32 keeps winner j and the lanes write
// the k results at the end, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kMaxK = 64;

template <int NJ>  // C = 128 * NJ; a lane holds NJ float4s: elements 128 j + 4 lane + t
__global__ void __launch_bounds__(kWarp * kRowsPerBlock) chunked_topk_kernel(
    const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, long long rows, int k) {
  constexpr int C = 128 * NJ;
  constexpr int E = 4 * NJ;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const float4* x4 = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * C);

  float v[E];
  unsigned long long key[E];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 a = x4[j * kWarp + lane];
    v[4 * j] = a.x;
    v[4 * j + 1] = a.y;
    v[4 * j + 2] = a.z;
    v[4 * j + 3] = a.w;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const unsigned pos = 128u * (e / 4) + 4u * lane + (e % 4);
    key[e] = (static_cast<unsigned long long>(__float_as_uint(fabsf(v[e]))) << 32) | (~pos);
  }

  float out_v[2] = {0.f, 0.f};
  int out_i[2] = {0, 0};
  for (int i = 0; i < k; ++i) {
    unsigned long long best = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) best = key[e] > best ? key[e] : best;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other > best ? other : best;
    }
    const int pos = static_cast<int>(~static_cast<unsigned>(best & 0xffffffffull));
    float wv = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (key[e] == best) {  // keys are unique: only the owner matches
        wv = v[e];
        key[e] = 0;
      }
    }
    wv = __shfl_sync(0xffffffffu, wv, (pos % 128) / 4);
    if (lane == i % kWarp) {
      const float val = wv == 0.f ? 0.f : wv;  // -0.0 -> +0.0, as the masked sum gives
      if (i < kWarp) {
        out_v[0] = val;
        out_i[0] = pos;
      } else {
        out_v[1] = val;
        out_i[1] = pos;
      }
    }
  }
  const size_t base = static_cast<size_t>(row) * k;
  if (lane < k) {
    vals[base + lane] = out_v[0];
    idx[base + lane] = out_i[0];
  }
  if (kWarp + lane < k) {
    vals[base + kWarp + lane] = out_v[1];
    idx[base + kWarp + lane] = out_i[1];
  }
}

template <int NJ>
int launch(const void* x, void* vals, void* idx, long long rows, int k, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  chunked_topk_kernel<NJ><<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(vals), static_cast<int*>(idx), rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk that is not a
// multiple of 128 up to 1024 or a k outside [1, min(64, chunk)].
extern "C" int cml_chunked_topk(const void* x, void* vals, void* idx, long long rows, int chunk, int k,
                                void* stream) {
  if (k < 1 || k > kMaxK || k > chunk || chunk % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk / 128) {
    case 1: return launch<1>(x, vals, idx, rows, k, s);
    case 2: return launch<2>(x, vals, idx, rows, k, s);
    case 3: return launch<3>(x, vals, idx, rows, k, s);
    case 4: return launch<4>(x, vals, idx, rows, k, s);
    case 5: return launch<5>(x, vals, idx, rows, k, s);
    case 6: return launch<6>(x, vals, idx, rows, k, s);
    case 7: return launch<7>(x, vals, idx, rows, k, s);
    case 8: return launch<8>(x, vals, idx, rows, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
