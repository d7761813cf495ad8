// Chunked top-k by magnitude.
//
// Replaces: consensusml_tpu/compress/kernels.py:chunked_topk (pallas_call
// at :374, kernel body _topk_kernel at :313). Per row of (R, C) f32 (C a
// multiple of 128 up to 1024; 512 at GPT-2-medium), the k largest |x| (k <= 64; 8
// at GPT-2-medium) in descending order, equal magnitudes to the lower
// index (the jax.lax.top_k order), as (value f32 (R, k), chunk-local
// index int32 (R, k)). The reference's compiled program reads a subnormal
// as zero, so a subnormal |x| ranks as 0 (it ties with the zeros and the
// lower index wins) and a subnormal winner's value is +0.0; its value is a
// masked row sum, so a -0.0 winner comes out +0.0 too. Bit-equal to
// chunked_topk_plain (compress/kernels.py): selection is integer
// compares, the value is copied (or flushed to +0.0).
//
// What bounds it on the H100: bytes (4 an element read; the outputs are
// 2k/C of that), provided the k extractions stay on chip and cost few
// instructions. The first version (one warp a row, the row in registers)
// made every lane rescan all its C/32 keys, run a 64-bit butterfly and
// sweep its keys again for each of the k winners: ~1000 instructions a
// 2 KB row, issue-bound at 5.6x the byte bound.
//
// The design: one warp a row. Lane l holds the row's elements
// 128 j + 4 l + t (one coalesced float4 load per j), so positions rise
// with its register index e = 4 j + t. Keys are u32: the flushed |x| bits
// plus one (so 0 is free for "taken"); u32 order is magnitude order.
// Each lane keeps its best live key and that key's lowest position. An
// extraction is then O(1) for the warp:
//   - redux.sync max over the lanes' best keys, then redux.sync min over
//     the positions of the lanes holding it: the winner, lowest index on
//     a tie;
//   - its value is read from a copy of the row in shared memory (a
//     broadcast); the owning lane marks it taken in a bit mask;
//   - the owner's new best: its C/32 elements are read by C/32 lanes at
//     once from shared memory (the row is stored with 4 words of padding
//     every 128, so the 32 reads hit 32 banks), keyed against the owner's
//     mask, and two more redux.sync give the new best key and its lowest
//     position.
// Lane j % 32 keeps winner j and the lanes write the k results at the
// end, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // a position no element has
constexpr unsigned kMinNormal = 0x00800000u;  // 2^-126's bits

// |x|'s bits with a subnormal read as zero, plus one: u32 order is the
// magnitude order of the reference's compiled compares, 0 is "taken"
__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned bits = __float_as_uint(x) & 0x7fffffffu;
  return (bits < kMinNormal ? 0u : bits) + 1u;
}

// a row's word for position p: 4 words of padding after every 128
__device__ __forceinline__ int padded(unsigned p) { return static_cast<int>(p + 4u * (p >> 7)); }

template <int NJ>  // C = 128 * NJ; a lane holds NJ float4s: elements 128 j + 4 lane + t
__global__ void __launch_bounds__(kWarp * kRowsPerBlock) chunked_topk_kernel(
    const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, long long rows, int k) {
  constexpr int C = 128 * NJ;
  constexpr int E = 4 * NJ;  // elements a lane
  __shared__ __align__(16) float row_s[kRowsPerBlock][132 * NJ];
  const int warp = threadIdx.x / kWarp;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  const unsigned lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const float4* x4 = reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * C);
  float* rs = row_s[warp];

  // load, keep a copy in shared memory, and find this lane's best
  unsigned bkey = 0, bpos = kNone;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 a = x4[j * kWarp + lane];
    *reinterpret_cast<float4*>(rs + 132 * j + 4 * lane) = a;
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const unsigned key = key_of(v[t]);
      if (key > bkey) {  // strictly greater: the lowest position keeps a tie
        bkey = key;
        bpos = 128u * j + 4u * lane + t;
      }
    }
  }
  __syncwarp();

  unsigned taken = 0;  // bit e: this lane's element e is taken
  float out_v[2] = {0.f, 0.f};
  int out_i[2] = {0, 0};
  // the element of the owner lane that lane q rescans
  const unsigned q = lane;
  for (int i = 0; i < k; ++i) {
    const unsigned best = __reduce_max_sync(kFull, bkey);
    const unsigned pos = __reduce_min_sync(kFull, bkey == best ? bpos : kNone);
    const unsigned owner = (pos & 127u) >> 2;
    const unsigned e = ((pos >> 7) << 2) | (pos & 3u);
    float val = rs[padded(pos)];
    // a flushed (subnormal) or -0.0 winner is +0.0, as the masked sum gives
    val = fabsf(val) < __uint_as_float(kMinNormal) ? 0.f : val;
    if (lane == static_cast<unsigned>(i % kWarp)) {
      if (i < kWarp) {
        out_v[0] = val;
        out_i[0] = static_cast<int>(pos);
      } else {
        out_v[1] = val;
        out_i[1] = static_cast<int>(pos);
      }
    }
    if (lane == owner) taken |= 1u << e;
    const unsigned mask = __shfl_sync(kFull, taken, owner);
    // the owner's new best, its E elements read by lanes 0..E-1
    unsigned key = 0, p = kNone;
    if (q < E) {
      p = 128u * (q >> 2) + 4u * owner + (q & 3u);
      key = (mask >> q) & 1u ? 0u : key_of(rs[padded(p)]);
    }
    const unsigned nbest = __reduce_max_sync(kFull, key);
    const unsigned npos = __reduce_min_sync(kFull, key == nbest ? p : kNone);
    if (lane == owner) {
      bkey = nbest;
      bpos = npos;
    }
  }
  const size_t base = static_cast<size_t>(row) * k;
  if (static_cast<int>(lane) < k) {
    vals[base + lane] = out_v[0];
    idx[base + lane] = out_i[0];
  }
  if (kWarp + static_cast<int>(lane) < k) {
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
