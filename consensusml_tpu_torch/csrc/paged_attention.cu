// Fused paged attention for the serving decode step (and its W-token
// window), bf16 in / f32 math / bf16 out.
//
// Replaces: consensusml_tpu/models/paged_attention.py:_fused_call
// (pallas_call at :191, kernel body _make_kernel at :90), reached through
// fused_paged_attention (W = 1) and fused_paged_attention_window (W = k+1).
//
// Computes, for every slot s, window row w and query head h:
//   keys t = 0 .. positions[s, w]   (t < nb * bs), read through the block
//   table: physical block table[s, t / bs], row t % bs, kv head h / rep;
//   logits = (q . k_t) * scale in f32, softmax in f32,
//   probabilities rounded to bf16 (the reference casts them to the compute
//   dtype before the PV product), out = sum_t p_t * v_t accumulated in f32,
//   written as bf16.
// Keys past the position are skipped: the reference gives them exactly
// zero probability (a where-mask to -1e30 before the softmax), so skipping
// is exact and keeps junk in unwritten or trash blocks out of the output.
//
// What bounds it on the H100: bytes. Each (slot, head) reads its K and V
// rows once (2 * (pos + 1) * D * 2 bytes) and does ~4 flops per byte, far
// below the ~295 flop/byte ridge, so the floor is K+V bytes / 3.35 TB/s.
// Design for that: one thread block per (head, slot) so the grid covers the
// card at 8 slots x 16 heads; each warp walks its own run of keys, one key
// per step with each lane reading a bf16 pair (a D = 64 key row is one
// coalesced 128-byte load), and issues the loads of kBatch keys before it
// uses any of them, so 8 warps x kBatch rows are in flight per block — the
// first version loaded one row per warp at a time and was latency-bound at
// ~70x the floor. The block-table row is staged in shared memory once per
// block; the logits (<= nb * bs floats) stay in shared memory.
// Not done yet: split-K across blocks for long caches (a 1024-token slot is
// still walked by one block while short slots' blocks idle), cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 2;  // D <= 2 * 32 * kMaxPairs = 128
constexpr int kBatch = 8;     // key rows each warp loads before using them

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide reductions through kWarps floats of shared scratch
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r += red[i];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const __nv_bfloat16* __restrict__ q,        // (S, W, H, D)
    const __nv_bfloat16* __restrict__ k_pages,  // (N, bs, Hkv, D)
    const __nv_bfloat16* __restrict__ v_pages,  // (N, bs, Hkv, D)
    const int* __restrict__ table,              // (S, nb)
    const int* __restrict__ positions,          // (S, W)
    __nv_bfloat16* __restrict__ out,            // (S, W, H, D)
    int W, int H, int Hkv, int D, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  const int T = nb * bs;
  float* probs = smem;                                   // T
  float* part = probs + T;                               // kWarps * D
  float* red = part + kWarps * D;                        // kWarps
  int* row = reinterpret_cast<int*>(red + kWarps);       // nb

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int kvh = h / (H / Hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t tok = static_cast<size_t>(Hkv) * D;  // elements per token row

  for (int j = threadIdx.x; j < nb; j += kThreads) row[j] = table[s * nb + j];
  __syncthreads();

  for (int w = 0; w < W; ++w) {
    const int last = min(positions[s * W + w], T - 1);  // keys 0..last attend
    const __nv_bfloat16* qrow = q + ((static_cast<size_t>(s) * W + w) * H + h) * D;
    float2 qv[kMaxPairs];
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int d = 2 * lane + 64 * i;
      qv[i] = d < D ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + d))
                    : make_float2(0.f, 0.f);
    }

    // logits: each warp takes runs of kBatch keys, lanes over D
    for (int t0 = warp * kBatch; t0 <= last; t0 += kWarps * kBatch) {
      float2 kv[kBatch][kMaxPairs];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u;
        const size_t base =
            t <= last ? (static_cast<size_t>(row[t / bs]) * bs + t % bs) * tok + kvh * D : 0;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          const int d = 2 * lane + 64 * i;
          kv[u][i] = t <= last && d < D
                         ? __bfloat1622float2(
                               *reinterpret_cast<const __nv_bfloat162*>(k_pages + base + d))
                         : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          acc = fmaf(qv[i].x, kv[u][i].x, acc);
          acc = fmaf(qv[i].y, kv[u][i].y, acc);
        }
        acc = warp_sum(acc);
        if (lane == 0 && t0 + u <= last) probs[t0 + u] = acc * scale;
      }
    }
    __syncthreads();

    // f32 softmax over the attended keys, then bf16-rounded probabilities
    float m = -1e30f;
    for (int t = threadIdx.x; t <= last; t += kThreads) m = fmaxf(m, probs[t]);
    m = block_max(m, red);
    float sum = 0.f;
    for (int t = threadIdx.x; t <= last; t += kThreads) {
      const float e = expf(probs[t] - m);
      probs[t] = e;
      sum += e;
    }
    sum = block_sum(sum, red);
    for (int t = threadIdx.x; t <= last; t += kThreads)
      probs[t] = __bfloat162float(__float2bfloat16(probs[t] / sum));
    __syncthreads();

    // PV: the same runs of kBatch keys per warp; lanes hold output pairs
    float2 o[kMaxPairs];
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) o[i] = make_float2(0.f, 0.f);
    for (int t0 = warp * kBatch; t0 <= last; t0 += kWarps * kBatch) {
      float2 vv[kBatch][kMaxPairs];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u;
        const size_t base =
            t <= last ? (static_cast<size_t>(row[t / bs]) * bs + t % bs) * tok + kvh * D : 0;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          const int d = 2 * lane + 64 * i;
          vv[u][i] = t <= last && d < D
                         ? __bfloat1622float2(
                               *reinterpret_cast<const __nv_bfloat162*>(v_pages + base + d))
                         : make_float2(0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float p = t0 + u <= last ? probs[t0 + u] : 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          o[i].x = fmaf(p, vv[u][i].x, o[i].x);
          o[i].y = fmaf(p, vv[u][i].y, o[i].y);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int d = 2 * lane + 64 * i;
      if (d < D) {
        part[warp * D + d] = o[i].x;
        part[warp * D + d + 1] = o[i].y;
      }
    }
    __syncthreads();
    __nv_bfloat16* orow = out + ((static_cast<size_t>(s) * W + w) * H + h) * D;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float r = part[d];
      for (int i = 1; i < kWarps; ++i) r += part[i * D + d];
      orow[d] = __float2bfloat16(r);
    }
    __syncthreads();  // probs / part are reused by the next window row
  }
}

}  // namespace

extern "C" size_t cml_paged_attention_smem_bytes(int D, int bs, int nb) {
  return sizeof(float) * (static_cast<size_t>(nb) * bs + kWarps * D + kWarps) +
         sizeof(int) * nb;
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int cml_paged_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* positions, void* out, int S, int W, int H, int Hkv, int D, int bs,
    int nb, float scale, void* stream) {
  const size_t smem = cml_paged_attention_smem_bytes(D, bs, nb);
  paged_attention_kernel<<<dim3(H, S), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), W, H, Hkv, D,
      bs, nb, scale);
  return static_cast<int>(cudaGetLastError());
}
