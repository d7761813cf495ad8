// Flash-attention-2 forward, bf16 in / f32 math / bf16 out, head dim 64.
//
// Replaces: consensusml_tpu/models/flash_attention.py:_fwd (pallas_call at
// :193, kernel body _fwd_kernel at :73), reached through flash_attention
// (:478). Same schedule as the reference: q, k, v promoted to f32, logits
// scaled by 1/sqrt(D), keys past the real length and (causal) above the
// diagonal masked out, online softmax with a running row max m and row sum
// l, probabilities kept in f32 for the PV product, out = acc / max(l,
// 1e-30), and the per-row logsumexp m + log(l) saved for a backward pass.
// Tiles wholly above the diagonal are skipped, as the reference's
// nk_eff does. This slice has no kv_mask and no q/k offsets (the
// wrapper refuses them).
//
// Layout: q, k, v, out are (B, S, H, D) contiguous, as the public
// function takes them (no fold/pad copy); lse is (B, H, S).
//
// What bounds it on the H100: operations. At S = 1024, D = 64 a causal
// head does ~2 * 2 * S^2/2 * D = 134 MFLOP against 0.5 MB of q/k/v/out,
// ~256 flop/byte, near the ridge for bf16 tensor cores and far above it for
// the f32 FMA units this first version uses. Design for that: one thread
// block per (64-query tile, batch*head); K and V tiles of 64 keys are
// staged once into shared memory (f32, padded rows: no bank conflicts) and
// reused by all 64 query rows; two threads per query row, each holding the
// full q row and half the output in registers, so the 64x64 score tile and
// the PV product never touch device memory. Not done yet: mma.sync/wgmma
// tensor-core products and TMA loads (a later PR makes it fast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 2 * kBQ;  // two threads per query row
constexpr int kHalf = kD / 2;      // output columns / keys per thread

__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int H, int causal, float scale) {
  // K tile, then (after the scores are taken) the probability tile P
  __shared__ float kp[kBK][kD + 1];
  __shared__ float vs[kBK][kD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int r = threadIdx.x >> 1;     // query row in the tile
  const int half = threadIdx.x & 1;   // keys 2j+half, output cols 2j+half
  const int qi = q0 + r;              // absolute query row
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t head_off = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kD;

  float qf[kD];
  {
    const int qr = min(qi, S - 1);  // padded rows compute on a real row, never written
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(q + head_off + qr * row_stride);
#pragma unroll
    for (int d = 0; d < kD / 2; ++d) {
      const float2 f = __bfloat1622float2(src[d]);
      qf[2 * d] = f.x;
      qf[2 * d + 1] = f.y;
    }
  }
  float acc[kHalf];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) acc[j] = 0.f;
  float m = -1e30f;
  float l = 0.f;

  int n_tiles = (S + kBK - 1) / kBK;
  if (causal) n_tiles = min(n_tiles, (q0 + kBQ - 1) / kBK + 1);  // skip tiles above the diagonal

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // stage K and V: each key row is 32 bf16 pairs, one coalesced 128-byte read
    for (int idx = threadIdx.x; idx < kBK * (kD / 2); idx += kThreads) {
      const int j = idx / (kD / 2);
      const int p = idx % (kD / 2);
      float2 kf = make_float2(0.f, 0.f), vf = make_float2(0.f, 0.f);
      if (k0 + j < S) {
        const size_t off = head_off + (k0 + j) * row_stride + 2 * p;
        kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(k + off));
        vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + off));
      }
      kp[j][2 * p] = kf.x;
      kp[j][2 * p + 1] = kf.y;
      vs[j][2 * p] = vf.x;
      vs[j][2 * p + 1] = vf.y;
    }
    __syncthreads();

    float sc[kHalf];
    float tile_max = -1e30f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      const int kj = 2 * j + half;
      const int key = k0 + kj;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = fmaf(qf[d], kp[kj][d], dot);
      const bool valid = key < S && (!causal || key <= qi);
      sc[j] = valid ? dot * scale : -1e30f;
      tile_max = fmaxf(tile_max, sc[j]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) {
      // masked keys contribute exactly zero (the reference's where-mask)
      sc[j] = sc[j] > -1e30f ? expf(sc[j] - m_new) : 0.f;
      psum += sc[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    __syncthreads();  // every row has read its K scores: reuse kp as P
#pragma unroll
    for (int j = 0; j < kHalf; ++j) kp[r][2 * j + half] = sc[j];
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kHalf; ++j) acc[j] *= corr;
    for (int key = 0; key < kBK; ++key) {
      const float p = kp[r][key];
#pragma unroll
      for (int j = 0; j < kHalf; ++j) acc[j] = fmaf(p, vs[key][2 * j + half], acc[j]);
    }
    __syncthreads();  // the next tile overwrites kp / vs
  }

  if (qi < S) {
    const float l_safe = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = out + head_off + qi * row_stride;
#pragma unroll
    for (int j = 0; j < kHalf; ++j) dst[2 * j + half] = __float2bfloat16(acc[j] / l_safe);
    if (lse != nullptr && half == 0) lse[static_cast<size_t>(bh) * S + qi] = m + logf(l_safe);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for an unsupported head dim.
extern "C" int cml_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                            void* out, void* lse, int B, int S, int H,
                                            int D, int causal, float scale, void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
