// Fused LayerNorm for training: the forward and backward passes over a
// contiguous (M, H) view, normalised over H, for f32 or bf16 input and
// f32 or bf16 output (forward) or cotangent (backward), all arithmetic in
// f32.
//
// Replaces the two Pallas kernels of consensusml_tpu/models/fused_ln.py:
//   ln_fwd <- _ln_fwd_kernel (:91) via the pallas_call at :150:
//             mu = mean(x), xc = x - mu, var = mean(xc^2) (two passes over
//             the resident row), y = xc * rsqrt(var + eps) * gamma + beta
//   ln_bwd <- _ln_bwd_kernel (:96) via the pallas_call at :181: the row
//             statistics again, xhat = xc * rsig, g = dy * gamma,
//             dx = rsig * ((g - mean(g)) - xhat * mean(g * xhat)) in x's
//             dtype; dgamma = sum dy * xhat and dbeta = sum dy over rows
//
// What bounds them on the H100: bytes. The forward reads x and writes y
// once; the backward reads dy and x and writes dx once, plus (M, H)-free
// per-column vectors. At GPT-2-medium's (8192, 1024) bf16 the bounds are
// 0.0100 ms and 0.0150 ms at 3.35 TB/s.
//
// Design, for the bound:
// - A block of 128 threads (256 past H = 1024) owns a row: each thread
//   holds 8 consecutive columns (one 16-byte bf16 load, or two of f32) in
//   registers, two for H past 2048, so the row is read from device memory
//   once and both statistics come from the registers. Row sums are
//   warp-shuffle trees, then the warps' totals in a fixed order through
//   shared memory (each sum its own slot, one barrier each).
// - The forward is one row a block (M blocks).
// - The backward's column sums are deterministic without atomics, as on
//   the TPU's sequential grid: a block walks a stripe of rows (the caller
//   plans about 1024 stripes, consensusml_tpu_torch/models/fused_ln.py:
//   _stripes), carries each of its columns' dgamma and dbeta partials in
//   registers, and writes one partial a column for its stripe; a second
//   small launch folds the stripes in a fixed order. A rerun gives the
//   same bits. The partials cost 2 * 4 * H bytes a stripe written and
//   read again (8 MB at (8192, 1024), against the pass's 50 MB).
// - Elementwise steps round on their own (__fmul_rn, __fsub_rn, __fadd_rn)
//   in the plain versions' order; the row sums run in another order than
//   torch.mean, and rsqrtf is within 2 ulp, so the kernels are held to a
//   tolerance, not to the bit.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;
constexpr int kWarp = 32;
constexpr int kFoldX = 32;
constexpr int kFoldY = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// 8 consecutive elements as f32 (16-byte aligned): one or two 16-byte loads
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, float (&out)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < kVec / kPer; ++q) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) out[q * kPer + j] = to_f32(e[j]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, const float (&v)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < kVec / kPer; ++q) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = from_f32<T>(v[q * kPer + j]);
    reinterpret_cast<uint4*>(p)[q] = raw;
  }
}

// 8 per-column f32 values from column c0, through the read-only cache
__device__ __forceinline__ void load_param(const float* __restrict__ p, int c0, float (&out)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + c0) + q);
    out[4 * q] = a.x;
    out[4 * q + 1] = a.y;
    out[4 * q + 2] = a.z;
    out[4 * q + 3] = a.w;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the block's total of v, in the same fixed order on every thread; slot
// holds NT / 32 floats and is not written again before every thread has
// passed a later barrier
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* slot) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) slot[threadIdx.x / kWarp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / kWarp; ++w) s += slot[w];
  return s;
}

// row statistics of the resident row: v becomes xc (0 past the row's end);
// returns rsig
template <int NV, int NT>
__device__ __forceinline__ float row_stats(float (&v)[NV][kVec], const bool (&active)[NV], int h, float eps,
                                           float* slot_sum, float* slot_sq) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < kVec; ++j) s += v[k][j];
  const float mu = __fdiv_rn(block_sum<NT>(s, slot_sum), static_cast<float>(h));
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[k][j] = active[k] ? __fsub_rn(v[k][j], mu) : 0.f;
      q += v[k][j] * v[k][j];
    }
  const float var = __fdiv_rn(block_sum<NT>(q, slot_sq), static_cast<float>(h));
  return rsqrtf(__fadd_rn(var, eps));
}

template <typename TX, typename TY, int NV, int NT>
__global__ void __launch_bounds__(NT) ln_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                                                    const float* __restrict__ beta, TY* __restrict__ y, int h,
                                                    float eps) {
  __shared__ float red[2][NT / kWarp];
  const long long base = static_cast<long long>(blockIdx.x) * h;
  float v[NV][kVec];
  bool active[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (k * NT + threadIdx.x) * kVec;
    active[k] = c0 < h;
    if (active[k]) {
      load8(x + base + c0, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[k][j] = 0.f;
    }
  }
  const float rsig = row_stats<NV, NT>(v, active, h, eps, red[0], red[1]);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!active[k]) continue;
    const int c0 = (k * NT + threadIdx.x) * kVec;
    float g[kVec], b[kVec], out[kVec];
    load_param(gamma, c0, g);
    load_param(beta, c0, b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = __fadd_rn(__fmul_rn(__fmul_rn(v[k][j], rsig), g[j]), b[j]);
    store8(y + base + c0, out);
  }
}

template <typename TX, typename TD, int NV, int NT>
__global__ void __launch_bounds__(NT) ln_bwd_kernel(const TD* __restrict__ dy, const TX* __restrict__ x,
                                                    const float* __restrict__ gamma, TX* __restrict__ dx,
                                                    long long m, int h, float eps, long long rows_per_stripe,
                                                    float* __restrict__ partials) {
  __shared__ float red[4][NT / kWarp];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_stripe;
  const long long r1 = min(m, r0 + rows_per_stripe);
  float gm[NV][kVec], pg[NV][kVec], pb[NV][kVec];
  bool active[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c0 = (k * NT + threadIdx.x) * kVec;
    active[k] = c0 < h;
#pragma unroll
    for (int j = 0; j < kVec; ++j) gm[k][j] = pg[k][j] = pb[k][j] = 0.f;
    if (active[k]) load_param(gamma, c0, gm[k]);
  }
  for (long long r = r0; r < r1; ++r) {
    const long long base = r * h;
    float v[NV][kVec], d[NV][kVec];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c0 = (k * NT + threadIdx.x) * kVec;
      if (active[k]) {
        load8(x + base + c0, v[k]);
        load8(dy + base + c0, d[k]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[k][j] = d[k][j] = 0.f;
      }
    }
    const float rsig = row_stats<NV, NT>(v, active, h, eps, red[0], red[1]);
    // v becomes xhat, d stays dy; the row sums of g and g * xhat
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[k][j] = __fmul_rn(v[k][j], rsig);
        const float g = __fmul_rn(d[k][j], gm[k][j]);
        a += g;
        b += __fmul_rn(g, v[k][j]);
      }
    a = warp_sum(a);
    b = warp_sum(b);
    if (threadIdx.x % kWarp == 0) {
      red[2][threadIdx.x / kWarp] = a;
      red[3][threadIdx.x / kWarp] = b;
    }
    __syncthreads();
    a = b = 0.f;
#pragma unroll
    for (int w = 0; w < NT / kWarp; ++w) {
      a += red[2][w];
      b += red[3][w];
    }
    const float m1 = __fdiv_rn(a, static_cast<float>(h));
    const float m2 = __fdiv_rn(b, static_cast<float>(h));
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      if (!active[k]) continue;
      float out[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g = __fmul_rn(d[k][j], gm[k][j]);
        out[j] = __fmul_rn(rsig, __fsub_rn(__fsub_rn(g, m1), __fmul_rn(v[k][j], m2)));
        pg[k][j] += d[k][j] * v[k][j];
        pb[k][j] += d[k][j];
      }
      store8(dx + base + (k * NT + threadIdx.x) * kVec, out);
    }
  }
  float* out = partials + static_cast<long long>(blockIdx.x) * 2 * h;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!active[k]) continue;
    const int c0 = (k * NT + threadIdx.x) * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      out[c0 + j] = pg[k][j];
      out[h + c0 + j] = pb[k][j];
    }
  }
}

// out[i] = sum over stripes of partials[k][i], i < n = 2H, in a fixed
// order: group ty sums stripes ty, ty + 8, ... in turn, then a tree over
// the groups
__global__ void __launch_bounds__(kFoldX * kFoldY) ln_bwd_fold_kernel(const float* __restrict__ partials,
                                                                       int stripes, int n,
                                                                       float* __restrict__ out) {
  __shared__ float red[kFoldY][kFoldX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.x * kFoldX + tx;
  float s = 0.f;
  if (i < n) {
#pragma unroll 8
    for (int k = ty; k < stripes; k += kFoldY) s += partials[static_cast<long long>(k) * n + i];
  }
  red[ty][tx] = s;
  __syncthreads();
  for (int half = kFoldY / 2; half > 0; half >>= 1) {
    if (ty < half) red[ty][tx] += red[ty + half][tx];
    __syncthreads();
  }
  if (ty == 0 && i < n) out[i] = red[0][tx];
}

// ---- launch plans -----------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1 };

bool valid(int dt1, int dt2, long long m, int h) {
  const bool dtypes = (dt1 == kF32 || dt1 == kBF16) && (dt2 == kF32 || dt2 == kBF16);
  return dtypes && m >= 1 && m <= 0x7fffffffLL && h >= kVec && h <= 4096 && h % kVec == 0;
}

// threads a row and 8-column vectors a thread: H <= 1024 -> (128, 1),
// <= 2048 -> (256, 1), <= 4096 -> (256, 2)
template <typename TX, typename TY>
void launch_fwd(const void* x, const float* gamma, const float* beta, void* y, long long m, int h, float eps,
                cudaStream_t st) {
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
  const unsigned int grid = static_cast<unsigned int>(m);
  if (h <= 1024)
    ln_fwd_kernel<TX, TY, 1, 128><<<grid, 128, 0, st>>>(xt, gamma, beta, yt, h, eps);
  else if (h <= 2048)
    ln_fwd_kernel<TX, TY, 1, 256><<<grid, 256, 0, st>>>(xt, gamma, beta, yt, h, eps);
  else
    ln_fwd_kernel<TX, TY, 2, 256><<<grid, 256, 0, st>>>(xt, gamma, beta, yt, h, eps);
}

template <typename TX, typename TD>
void launch_bwd(const void* dy, const void* x, const float* gamma, void* dx, long long m, int h, float eps,
                int stripes, float* partials, cudaStream_t st) {
  const TD* dyt = static_cast<const TD*>(dy);
  const TX* xt = static_cast<const TX*>(x);
  TX* dxt = static_cast<TX*>(dx);
  const long long rps = (m + stripes - 1) / stripes;
  const unsigned int grid = static_cast<unsigned int>(stripes);
  if (h <= 1024)
    ln_bwd_kernel<TX, TD, 1, 128><<<grid, 128, 0, st>>>(dyt, xt, gamma, dxt, m, h, eps, rps, partials);
  else if (h <= 2048)
    ln_bwd_kernel<TX, TD, 1, 256><<<grid, 256, 0, st>>>(dyt, xt, gamma, dxt, m, h, eps, rps, partials);
  else
    ln_bwd_kernel<TX, TD, 2, 256><<<grid, 256, 0, st>>>(dyt, xt, gamma, dxt, m, h, eps, rps, partials);
}

}  // namespace

// Both return cudaGetLastError() after their launches (0 = launched), or
// cudaErrorInvalidValue without launching for what the kernels do not
// take: a dtype code other than 0 (f32) or 1 (bf16), M < 1, H not a
// multiple of 8 in [8, 4096], stripes outside [1, M]. Every pointer must
// be 16-byte aligned (the Python wrappers check).
//
// ln_bwd writes dgamma into out[0:H] and dbeta into out[H:2H]; partials
// is (stripes, 2, H) f32 scratch.

extern "C" int cml_ln_fwd(const void* x, int x_dtype, const void* gamma, const void* beta, void* y, int y_dtype,
                          long long m, int h, float eps, void* stream) {
  if (!valid(x_dtype, y_dtype, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (x_dtype == kF32) {
    if (y_dtype == kF32) launch_fwd<float, float>(x, g, b, y, m, h, eps, st);
    else launch_fwd<float, __nv_bfloat16>(x, g, b, y, m, h, eps, st);
  } else {
    if (y_dtype == kF32) launch_fwd<__nv_bfloat16, float>(x, g, b, y, m, h, eps, st);
    else launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, g, b, y, m, h, eps, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_ln_bwd(const void* dy, int dy_dtype, const void* x, int x_dtype, const void* gamma, void* dx,
                          long long m, int h, float eps, int stripes, void* partials, void* out, void* stream) {
  if (!valid(x_dtype, dy_dtype, m, h) || stripes < 1 || stripes > m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* part = static_cast<float*>(partials);
  if (x_dtype == kF32) {
    if (dy_dtype == kF32) launch_bwd<float, float>(dy, x, g, dx, m, h, eps, stripes, part, st);
    else launch_bwd<float, __nv_bfloat16>(dy, x, g, dx, m, h, eps, stripes, part, st);
  } else {
    if (dy_dtype == kF32) launch_bwd<__nv_bfloat16, float>(dy, x, g, dx, m, h, eps, stripes, part, st);
    else launch_bwd<__nv_bfloat16, __nv_bfloat16>(dy, x, g, dx, m, h, eps, stripes, part, st);
  }
  ln_bwd_fold_kernel<<<static_cast<unsigned int>((2 * h + kFoldX - 1) / kFoldX), dim3(kFoldX, kFoldY), 0, st>>>(
      part, stripes, 2 * h, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
