// Flash-attention backward, bf16 in / f32 math / bf16 out, head dim 64.
//
// Replaces: consensusml_tpu/models/flash_attention.py:_bwd_dq (pallas_call
// at :362, kernel body _bwd_dq_kernel at :223) and :_bwd_dkv (pallas_call
// at :400, kernel body _bwd_dkv_kernel at :276), the backward of the
// flash_attention custom VJP. Same math as the reference: the forward's
// per-row logsumexp is saved, so each tile recomputes
//   s  = (q . k) * scale,   p = exp(s - lse)  (0 where masked)
//   dp = do . v,            ds = p * (dp - delta)
// with delta = sum(do * o) per query row (computed by the caller in plain
// ops, as the reference does outside its kernels), then
//   dq = scale * sum_k ds k,   dk = scale * sum_q ds q,   dv = sum_q p do.
// Keys past the real length and (causal) keys after the query are masked
// by absolute position, as the reference's k_local < s_real and q_pos >=
// k_pos masks do; tiles wholly above the diagonal are skipped (the
// reference's nk_eff for dq and i0 for dk/dv).
//
// Layout: q, k, v, do, dq, dk, dv are (B, S, H, D) contiguous, as the
// public function takes them (no fold/pad copy); lse and delta are
// (B, H, S) f32.
//
// What bounds it on the H100: operations. A causal head at S = 1024,
// D = 64 does ~4 products of S^2/2 * D (s, dp, and one of dq / dk+dv) per
// kernel, ~270 MFLOP against ~0.6 MB of operands: far above the ridge for
// the f32 FMA units this first version uses. Design for that: one block of
// 256 threads per (64-row tile, batch*head); four threads share a row,
// each owning 16 of its 64 dims in registers (dims 4t + 16m + e, so the
// four lanes' float4 reads of a staged row hit distinct banks), so a dot
// product is 16 FMAs and two shuffles. The other operand's tile is staged
// once into shared memory as f32 and read back as float4 broadcasts. The
// dq kernel walks key tiles up to the diagonal with its q and do rows in
// registers; the dk/dv kernel walks query tiles from the diagonal down
// with its k and v rows in registers, and reuses each staged q / do
// segment for both the dot products and the dk / dv accumulation. Not done
// yet: mma.sync/wgmma tensor-core products and TMA loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;
constexpr int kRows = 64;            // rows of the block's own tile, and of each staged tile
constexpr int kLanes = 4;            // threads per row
constexpr int kSeg = kD / kLanes;    // dims per thread
constexpr int kThreads = kRows * kLanes;

// dim of element e (0..3) of float4 m (0..3) owned by lane t
__device__ __forceinline__ int dim_of(int t, int m) { return 16 * m + 4 * t; }

__device__ __forceinline__ void load_seg(const __nv_bfloat16* row, int t, float (&out)[kSeg]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row + dim_of(t, m));
    const float2 a = __bfloat1622float2(p[0]);
    const float2 b = __bfloat1622float2(p[1]);
    out[4 * m] = a.x;
    out[4 * m + 1] = a.y;
    out[4 * m + 2] = b.x;
    out[4 * m + 3] = b.y;
  }
}

__device__ __forceinline__ void store_seg(__nv_bfloat16* row, int t, const float (&v)[kSeg], float mul) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(row + dim_of(t, m));
    p[0] = __floats2bfloat162_rn(v[4 * m] * mul, v[4 * m + 1] * mul);
    p[1] = __floats2bfloat162_rn(v[4 * m + 2] * mul, v[4 * m + 3] * mul);
  }
}

// this lane's 16 dims of staged row j (float4 broadcasts, distinct banks per lane)
__device__ __forceinline__ void read_seg(float (*tile)[kD], int j, int t, float (&out)[kSeg]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float4 f = *reinterpret_cast<float4*>(&tile[j][dim_of(t, m)]);
    out[4 * m] = f.x;
    out[4 * m + 1] = f.y;
    out[4 * m + 2] = f.z;
    out[4 * m + 3] = f.w;
  }
}

// stage rows r0..r0+63 of one head of a (B, S, H, D) bf16 tensor as f32;
// rows past S are zero
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ src, size_t head_off,
                                           size_t row_stride, int r0, int S, float (*tile)[kD]) {
  for (int idx = threadIdx.x; idx < kRows * (kD / 8); idx += kThreads) {
    const int j = idx / (kD / 8);
    const int c = 8 * (idx % (kD / 8));
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (r0 + j < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + head_off + (r0 + j) * row_stride + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
      const float2 e = __bfloat1622float2(p[2]), f = __bfloat1622float2(p[3]);
      lo = make_float4(a.x, a.y, b.x, b.y);
      hi = make_float4(e.x, e.y, f.x, f.y);
    }
    *reinterpret_cast<float4*>(&tile[j][c]) = lo;
    *reinterpret_cast<float4*>(&tile[j][c + 4]) = hi;
  }
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int S, int H, int causal, float scale) {
  __shared__ __align__(16) float ks[kRows][kD];
  __shared__ __align__(16) float vs[kRows][kD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int qi = q0 + r;
  const int qr = min(qi, S - 1);  // padded rows compute on a real row, never written
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t head_off = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kD;

  float qf[kSeg], dof[kSeg], acc[kSeg];
  load_seg(q + head_off + qr * row_stride, t, qf);
  load_seg(dout + head_off + qr * row_stride, t, dof);
#pragma unroll
  for (int i = 0; i < kSeg; ++i) acc[i] = 0.f;
  const float lse_r = lse[static_cast<size_t>(bh) * S + qr];
  const float delta_r = delta[static_cast<size_t>(bh) * S + qr];

  int n_tiles = (S + kRows - 1) / kRows;
  if (causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kRows + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kRows;
    stage_tile(k, head_off, row_stride, k0, S, ks);
    stage_tile(v, head_off, row_stride, k0, S, vs);
    __syncthreads();
    for (int j = 0; j < kRows; ++j) {
      float kf[kSeg], vf[kSeg];
      read_seg(ks, j, t, kf);
      read_seg(vs, j, t, vf);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        s = fmaf(qf[i], kf[i], s);
        dp = fmaf(dof[i], vf[i], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int key = k0 + j;
      const bool valid = key < S && (!causal || key <= qi);
      const float p = valid ? expf(s * scale - lse_r) : 0.f;
      const float ds = p * (dp - delta_r);
#pragma unroll
      for (int i = 0; i < kSeg; ++i) acc[i] = fmaf(ds, kf[i], acc[i]);
    }
    __syncthreads();  // the next tile overwrites ks / vs
  }
  if (qi < S) store_seg(dq + head_off + qi * row_stride, t, acc, scale);
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int S, int H, int causal, float scale) {
  __shared__ __align__(16) float qs[kRows][kD];
  __shared__ __align__(16) float dos[kRows][kD];
  __shared__ float lse_s[kRows];
  __shared__ float delta_s[kRows];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * kRows;
  const int r = threadIdx.x / kLanes;
  const int t = threadIdx.x % kLanes;
  const int kj = k0 + r;
  const int kr = min(kj, S - 1);
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t head_off = static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(h) * kD;

  float kf[kSeg], vf[kSeg], dkacc[kSeg], dvacc[kSeg];
  load_seg(k + head_off + kr * row_stride, t, kf);
  load_seg(v + head_off + kr * row_stride, t, vf);
#pragma unroll
  for (int i = 0; i < kSeg; ++i) dkacc[i] = dvacc[i] = 0.f;

  const int nq = (S + kRows - 1) / kRows;
  const int first = causal ? k0 / kRows : 0;  // query tiles above the diagonal never see these keys
  for (int tile = first; tile < nq; ++tile) {
    const int q0 = tile * kRows;
    stage_tile(q, head_off, row_stride, q0, S, qs);
    stage_tile(dout, head_off, row_stride, q0, S, dos);
    if (threadIdx.x < kRows) {
      const int qrow = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qrow < S ? lse[static_cast<size_t>(bh) * S + qrow] : 0.f;
      delta_s[threadIdx.x] = qrow < S ? delta[static_cast<size_t>(bh) * S + qrow] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < kRows; ++i) {
      float qf[kSeg], dof[kSeg];
      read_seg(qs, i, t, qf);
      read_seg(dos, i, t, dof);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kSeg; ++e) {
        s = fmaf(qf[e], kf[e], s);
        dp = fmaf(dof[e], vf[e], dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int qrow = q0 + i;
      const bool valid = qrow < S && kj < S && (!causal || qrow >= kj);
      const float p = valid ? expf(s * scale - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int e = 0; e < kSeg; ++e) {
        dvacc[e] = fmaf(p, dof[e], dvacc[e]);
        dkacc[e] = fmaf(ds, qf[e], dkacc[e]);
      }
    }
    __syncthreads();  // the next tile overwrites qs / dos / lse_s / delta_s
  }
  if (kj < S) {
    store_seg(dk + head_off + kj * row_stride, t, dkacc, scale);
    store_seg(dv + head_off + kj * row_stride, t, dvacc, 1.f);
  }
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for an unsupported head dim.
extern "C" int cml_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* delta,
                                               void* dq, int B, int S, int H, int D, int causal,
                                               float scale, void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dk, void* dv, int B,
                                                int S, int H, int D, int causal, float scale,
                                                void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
