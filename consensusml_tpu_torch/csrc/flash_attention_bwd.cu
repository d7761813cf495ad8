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
// D = 64 does three products of S^2/2 * D multiply-adds (s, dp, and dq or
// dk + dv) per kernel, ~200-270 MFLOP against ~0.6 MB of operands.
//
// dq (flash_bwd_dq_kernel) runs them on the tensor cores, with the
// forward's skeleton (flash_sm90.cuh): one warpgroup per (64-query tile,
// batch*head); its Q and dO tiles loaded once by TMA, its rows' lse and
// delta in registers; K and V tiles of 64 keys streaming through a
// two-stage ring up to the diagonal. Per tile: S = Q K^T and dP = dO V^T
// (both operands in shared memory, K-major), p and ds on the accumulator
// layout in registers (masked only on the diagonal and ragged tail tiles),
// then dQ += ds K with ds from registers and K with the transpose bit. ds
// goes in as two bf16 halves, hi = bf16(ds) and lo = bf16(ds - hi): one
// bf16 rounding of ds reaches up to 1.7x the gate this kernel is held to
// (atol 3e-3, rtol 2^-6 against the plain f32 version, chip_smoke.py) on
// sharp rows; the split stays within 0.37 of it in an f32 emulation
// (tests/test_torch_flash_attention.py), at 4/3 the tensor-core work.
//
// dk/dv (flash_bwd_dkv_kernel) is still the first version, scalar f32 on
// the CUDA cores: one block of 256 threads per (64-row tile,
// batch*head); four threads share a row, each owning 16 of its 64 dims in
// registers (dims 4t + 16m + e, so the four lanes' float4 reads of a
// staged row hit distinct banks), so a dot product is 16 FMAs and two
// shuffles. It walks query tiles from the diagonal down with its k and v
// rows in registers, staging each q / do tile once into shared memory as
// f32 and reusing it for both the dot products and the dk / dv
// accumulation.

#include "flash_sm90.cuh"

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

namespace sm90 = cml_sm90;

constexpr int kDqStages = 2;
constexpr int kDqThreads = 128;
constexpr int kDqStageBytes = 2 * sm90::kTileBytes;  // K then V
constexpr int kDqSmemBytes = 1024 + 2 * sm90::kTileBytes + kDqStages * kDqStageBytes;

__global__ void __launch_bounds__(kDqThreads) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int S, int H, int causal, float scale) {
  using namespace cml_sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kDqStages + 1];  // one per stage, then Q and dO's

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sQ_ptr = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sDO = base + kTileBytes;
  const uint32_t sKV = base + 2 * kTileBytes;
  const uint32_t bar0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = (S + kTileRows - 1) / kTileRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kTileRows;
  int n_tiles = nq;
  if (causal) n_tiles = min(n_tiles, qt + 1);  // skip tiles above the diagonal

  auto issue_kv = [&](int tile, int st) {
    const uint32_t bar = bar0 + 8 * st;
    const uint32_t dst = sKV + st * kDqStageBytes;
    mbar_expect_tx(bar, kDqStageBytes);
    tma_load_rows(dst, &tk, bar, h, tile * kTileRows, b);
    tma_load_rows(dst + kTileBytes, &tv, bar, h, tile * kTileRows, b);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kDqStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t qbar = bar0 + 8 * kDqStages;
    mbar_expect_tx(qbar, 2 * kTileBytes);
    tma_load_rows(sQ, &tq, qbar, h, q0, b);
    tma_load_rows(sDO, &tdo, qbar, h, q0, b);
    for (int t = 0; t < min(kDqStages, n_tiles); ++t) issue_kv(t, t);
  }

  const int row0 = q0 + 16 * warp + lane / 4;  // query row of accumulator half i = 0; +8 for i = 1
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = static_cast<size_t>(bh) * S + min(row0 + 8 * i, S - 1);  // padded rows: never written
    lse2[i] = lse[r] * kLog2e;
    dl[i] = delta[r];
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  mbar_wait(bar0 + 8 * kDqStages, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kDqStages;
    const uint32_t sK = sKV + st * kDqStageBytes;
    const uint32_t sV = sK + kTileBytes;
    mbar_wait(bar0 + 8 * st, (t / kDqStages) & 1);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_ss(s, kmajor_desc(sQ, k), kmajor_desc(sK, k), k);
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_ss(dp, kmajor_desc(sDO, k), kmajor_desc(sV, k), k);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    const int k0 = t * kTileRows;
    const bool edge = k0 + kTileRows > S || (causal && k0 + kTileRows - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float p = exp2f(s[e] * scale_log2 - lse2[i]);
          if (edge) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            if (key >= S || (causal && key > row0 + 8 * i)) p = 0.f;
          }
          s[e] = p * (dp[e] - dl[i]);  // ds
        }
      }
    }
    uint32_t dsh[4][4], dsl[4][4];
    split_hi_lo(s, dsh, dsl);

    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(acc, dsh[k], mnmajor_desc(sK, k));
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(acc, dsl[k], mnmajor_desc(sK, k));
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && t + kDqStages < n_tiles) issue_kv(t + kDqStages, st);
  }

  // the Q tile is no longer read: stage dq there
  const float mul[2] = {scale, scale};
  const size_t row_stride = static_cast<size_t>(H) * kD;
  store_tile_bf16(acc, mul, sQ_ptr,
                  dq + (static_cast<size_t>(b) * S + q0) * row_stride + static_cast<size_t>(h) * kD,
                  row_stride, min(kTileRows, S - q0), 1);
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

// Both return 0 once launched, else a CUDA error code: without launching,
// cudaErrorInvalidValue for an unsupported head dim or (dq) a tensor map
// the driver refuses (e.g. a base address not 16-byte aligned); after the
// launch, cudaGetLastError().
extern "C" int cml_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* delta,
                                               void* dq, int B, int S, int H, int D, int causal,
                                               float scale, void* stream) {
  if (D != kD) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int rc = sm90::encode_bshd(&tq, q, B, S, H, sm90::kTileRows);
  if (rc == 0) rc = sm90::encode_bshd(&tk, k, B, S, H, sm90::kTileRows);
  if (rc == 0) rc = sm90::encode_bshd(&tv, v, B, S, H, sm90::kTileRows);
  if (rc == 0) rc = sm90::encode_bshd(&tdo, dout, B, S, H, sm90::kTileRows);
  if (rc != 0) return rc;
  // per launch: the attribute belongs to the current device
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + sm90::kTileRows - 1) / sm90::kTileRows, B * H);
  flash_bwd_dq_kernel<<<grid, kDqThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
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
