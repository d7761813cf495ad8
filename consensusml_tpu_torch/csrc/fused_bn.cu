// Fused BatchNorm(+ReLU) for training: the statistics, normalize, backward
// reduce and backward dx passes over a contiguous (M, C) view (channels
// last, C fastest), for f32 or bf16 input, all arithmetic in f32.
//
// Replaces the four Pallas kernels of consensusml_tpu/models/fused_bn.py,
// all launched through _grid_call's pl.pallas_call (fused_bn.py:175):
//   bn_stats       <- _stats_kernel (:118) via _stats (:196): per-channel
//                     f32 sum x and sum x^2
//   bn_norm        <- _norm_kernel (:130) via _normalize (:212):
//                     y = x * scale + shift (then max(., 0) with relu),
//                     y in x's dtype
//   bn_bwd_reduce  <- _bwd_reduce_kernel (:145) via _bwd_reduce (:230):
//                     g = dy, zeroed where x * scale + shift <= 0 with
//                     relu; per-channel sum g and sum g * xhat,
//                     xhat = (x - mean) * rsqrt
//   bn_bwd_dx      <- _bwd_dx_kernel (:159) via _bwd_dx (:250):
//                     dx = scale * ((g - c1) - xhat * c2), dx in x's dtype
//
// What bounds them on the H100: bytes. Each reads its (M, C) operands
// once (stats: x; norm: x, writes y; bwd_reduce: dy and x; bwd_dx: dy and
// x, writes dx) at a few flops an element; the per-channel vectors are C
// floats each. At ResNet-50's largest BN, (131072, 256) bf16, the bounds
// are 0.020 / 0.040 / 0.040 / 0.060 ms at 3.35 TB/s.
//
// Design, for the bound:
// - 16-byte vector loads and stores (8 bf16 or 4 f32 channels a thread)
//   wherever C is a multiple of the vector width and every pointer is
//   16-byte aligned; one element a thread otherwise (any C >= 1).
// - The reductions (stats, bwd_reduce): a block of 256 threads owns a tile
//   of up to 32 vector columns (neighbouring threads on neighbouring
//   channels, so a warp's loads are one contiguous run) and walks a stripe
//   of rows, several rows in flight a thread; it folds its rows in a fixed
//   shared-memory tree and writes one partial a channel for its stripe. A
//   second small launch folds the stripes' partials in a fixed order too,
//   so a rerun gives the same bits (no float atomics). Stripes are sized
//   (by the caller, consensusml_tpu_torch/models/fused_bn.py:_stripes) so
//   the grid fills the card (>= 528 blocks) or each thread walks >= 32
//   rows, whichever needs fewer stripes.
// - The elementwise passes (norm, bwd_dx): a grid-stride loop, one vector
//   a thread an iteration, the per-channel vectors read through the cache.
// - Roundings: every elementwise step rounds on its own (__fmul_rn,
//   __fadd_rn, __fsub_rn), in the plain versions' order, so norm and dx
//   equal their plain PyTorch versions bit for bit given the same
//   per-channel vectors, and the ReLU mask of the backward
//   (x * scale + shift > 0) is computed exactly as the forward cut it.
//   Only the reductions' summation order differs from the plain versions.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;
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

// V consecutive elements as f32: one 16-byte load when V * sizeof(T) == 16
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f32(p[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = from_f32<T>(v[j]);
  }
}

// V per-channel f32 values from channel c0 (a multiple of V; 16-byte
// aligned vectors when V >= 4), through the read-only cache
template <int V>
__device__ __forceinline__ void load_param(const float* __restrict__ p, int c0, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + c0) + q);
      out[4 * q] = a.x;
      out[4 * q + 1] = a.y;
      out[4 * q + 2] = a.z;
      out[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = __ldg(p + c0 + j);
  }
}

// x * scale + shift with two roundings, as the plain version computes it
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fadd_rn(__fmul_rn(x, scale), shift);
}

// relu that keeps a NaN (as torch.relu does)
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

// One stripe of rows of one channel tile: per channel (a, b) = (sum x,
// sum x^2) or, with BWD, (sum g, sum g * xhat). Block (tx, ty): tx walks
// the tile's vector columns, ty the stripe's rows. Writes the stripe's
// partials [stripe][0][c] and [stripe][1][c].
template <typename T, int V, bool BWD, bool RELU>
__device__ __forceinline__ void reduce_stripe(const T* __restrict__ x, const T* __restrict__ dy,
                                              const float* __restrict__ scale, const float* __restrict__ shift,
                                              const float* __restrict__ mean, const float* __restrict__ rsqrt,
                                              long long m, int c, long long rows_per_stripe,
                                              float* __restrict__ partials) {
  __shared__ float red[2][kThreads * kMaxVec];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + tx) * V;
  const bool active = c0 < c;  // V > 1 only when V divides C: a vector is all in or all out
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_stripe;
  const long long r1 = min(m, r0 + rows_per_stripe);
  float a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
  if (active) {
    float sc[V], sh[V], mu[V], rs[V];
    if constexpr (BWD) {
      load_param<V>(scale, c0, sc);
      load_param<V>(shift, c0, sh);
      load_param<V>(mean, c0, mu);
      load_param<V>(rsqrt, c0, rs);
    }
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += blockDim.y) {
      float xv[V];
      load_vec<T, V>(x + r * c + c0, xv);
      if constexpr (!BWD) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a[j] += xv[j];
          b[j] += xv[j] * xv[j];
        }
      } else {
        float g[V];
        load_vec<T, V>(dy + r * c + c0, g);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (RELU && !(affine(xv[j], sc[j], sh[j]) > 0.f)) g[j] = 0.f;
          const float xhat = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
          a[j] += g[j];
          b[j] += g[j] * xhat;
        }
      }
    }
  }
  const int slot = (ty * blockDim.x + tx) * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][slot + j] = a[j];
    red[1][slot + j] = b[j];
  }
  __syncthreads();
  // fixed-order tree over the rows of the block (blockDim.y is a power of two)
  for (int s = blockDim.y / 2; s > 0; s >>= 1) {
    if (ty < s) {
      const int other = ((ty + s) * blockDim.x + tx) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[0][slot + j] += red[0][other + j];
        red[1][slot + j] += red[1][other + j];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && active) {
    float* out = partials + static_cast<long long>(blockIdx.x) * 2 * c;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[c0 + j] = red[0][slot + j];
      out[c + c0 + j] = red[1][slot + j];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const T* __restrict__ x, long long m, int c,
                                                            long long rows_per_stripe,
                                                            float* __restrict__ partials) {
  reduce_stripe<T, V, false, false>(x, nullptr, nullptr, nullptr, nullptr, nullptr, m, c, rows_per_stripe,
                                    partials);
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads) bn_bwd_reduce_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ mean, const float* __restrict__ rsqrt,
    long long m, int c, long long rows_per_stripe, float* __restrict__ partials) {
  reduce_stripe<T, V, true, RELU>(x, dy, scale, shift, mean, rsqrt, m, c, rows_per_stripe, partials);
}

// out[i] = sum over stripes of partials[k][i], i < 2C, in a fixed order:
// group ty sums stripes ty, ty + 8, ... in turn, then a tree over groups
__device__ __forceinline__ void fold_stripes(const float* __restrict__ partials, int stripes, int n,
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
  for (int h = kFoldY / 2; h > 0; h >>= 1) {
    if (ty < h) red[ty][tx] += red[ty + h][tx];
    __syncthreads();
  }
  if (ty == 0 && i < n) out[i] = red[0][tx];
}

__global__ void __launch_bounds__(kFoldX * kFoldY) bn_stats_fold_kernel(const float* __restrict__ partials,
                                                                         int stripes, int n,
                                                                         float* __restrict__ out) {
  fold_stripes(partials, stripes, n, out);
}

__global__ void __launch_bounds__(kFoldX * kFoldY) bn_bwd_reduce_fold_kernel(
    const float* __restrict__ partials, int stripes, int n, float* __restrict__ out) {
  fold_stripes(partials, stripes, n, out);
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads) bn_norm_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ scale,
                                                           const float* __restrict__ shift, long long nvec,
                                                           int c, T* __restrict__ y) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < nvec; v += stride) {
    const long long i = v * V;
    const int c0 = static_cast<int>(i % c);
    float xv[V], sc[V], sh[V], out[V];
    load_vec<T, V>(x + i, xv);
    load_param<V>(scale, c0, sc);
    load_param<V>(shift, c0, sh);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = affine(xv[j], sc[j], sh[j]);
      out[j] = RELU ? relu(z) : z;
    }
    store_vec<T, V>(y + i, out);
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads) bn_bwd_dx_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const float* __restrict__ mean, const float* __restrict__ rsqrt,
    const float* __restrict__ c1, const float* __restrict__ c2, long long nvec, int c, T* __restrict__ dx) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; v < nvec; v += stride) {
    const long long i = v * V;
    const int c0 = static_cast<int>(i % c);
    float xv[V], g[V], sc[V], mu[V], rs[V], k1[V], k2[V], out[V];
    load_vec<T, V>(x + i, xv);
    load_vec<T, V>(dy + i, g);
    load_param<V>(scale, c0, sc);
    load_param<V>(mean, c0, mu);
    load_param<V>(rsqrt, c0, rs);
    load_param<V>(c1, c0, k1);
    load_param<V>(c2, c0, k2);
    if constexpr (RELU) {
      float sh[V];
      load_param<V>(shift, c0, sh);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (!(affine(xv[j], sc[j], sh[j]) > 0.f)) g[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(xv[j], mu[j]), rs[j]);
      out[j] = __fmul_rn(sc[j], __fsub_rn(__fsub_rn(g[j], k1[j]), __fmul_rn(xhat, k2[j])));
    }
    store_vec<T, V>(dx + i, out);
  }
}

// ---- launch plans -----------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1 };

bool valid_shape(int dtype, long long m, int c, int vec) {
  if (m < 1 || c < 1) return false;
  if (dtype != kF32 && dtype != kBF16) return false;
  const int wide = dtype == kF32 ? 4 : 8;
  return vec == 1 || (vec == wide && c % vec == 0);
}

struct ReducePlan {
  dim3 grid, block;
  long long rows_per_stripe;
};

// tx = vector columns of a tile (a power of two <= 32), ty = 256 / tx rows
ReducePlan reduce_plan(long long m, int c, int vec, int stripes) {
  const int cols = (c + vec - 1) / vec;
  int tx = 1;
  while (tx < cols && tx < 32) tx <<= 1;
  const int ty = kThreads / tx;
  const int tiles = (cols + tx - 1) / tx;
  ReducePlan p;
  p.grid = dim3(static_cast<unsigned int>(stripes), static_cast<unsigned int>(tiles));
  p.block = dim3(tx, ty);
  p.rows_per_stripe = (m + stripes - 1) / stripes;
  return p;
}

unsigned int elementwise_grid(long long nvec) {
  const long long blocks = (nvec + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

unsigned int fold_grid(int n) { return static_cast<unsigned int>((n + kFoldX - 1) / kFoldX); }

template <typename T, int V>
void launch_stats(const void* x, long long m, int c, const ReducePlan& p, float* partials, cudaStream_t st) {
  bn_stats_kernel<T, V><<<p.grid, p.block, 0, st>>>(static_cast<const T*>(x), m, c, p.rows_per_stripe,
                                                     partials);
}

template <typename T, int V>
void launch_bwd_reduce(const void* dy, const void* x, const float* scale, const float* shift, const float* mean,
                       const float* rsqrt, int relu, long long m, int c, const ReducePlan& p, float* partials,
                       cudaStream_t st) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  if (relu)
    bn_bwd_reduce_kernel<T, V, true><<<p.grid, p.block, 0, st>>>(dyt, xt, scale, shift, mean, rsqrt, m, c,
                                                                  p.rows_per_stripe, partials);
  else
    bn_bwd_reduce_kernel<T, V, false><<<p.grid, p.block, 0, st>>>(dyt, xt, scale, shift, mean, rsqrt, m, c,
                                                                   p.rows_per_stripe, partials);
}

template <typename T, int V>
void launch_norm(const void* x, const float* scale, const float* shift, int relu, long long nvec, int c, void* y,
                 cudaStream_t st) {
  const unsigned int grid = elementwise_grid(nvec);
  if (relu)
    bn_norm_kernel<T, V, true><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), scale, shift, nvec, c,
                                                           static_cast<T*>(y));
  else
    bn_norm_kernel<T, V, false><<<grid, kThreads, 0, st>>>(static_cast<const T*>(x), scale, shift, nvec, c,
                                                            static_cast<T*>(y));
}

template <typename T, int V>
void launch_bwd_dx(const void* dy, const void* x, const float* scale, const float* shift, const float* mean,
                   const float* rsqrt, const float* c1, const float* c2, int relu, long long nvec, int c, void* dx,
                   cudaStream_t st) {
  const unsigned int grid = elementwise_grid(nvec);
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  if (relu)
    bn_bwd_dx_kernel<T, V, true><<<grid, kThreads, 0, st>>>(dyt, xt, scale, shift, mean, rsqrt, c1, c2, nvec, c,
                                                             static_cast<T*>(dx));
  else
    bn_bwd_dx_kernel<T, V, false><<<grid, kThreads, 0, st>>>(dyt, xt, scale, shift, mean, rsqrt, c1, c2, nvec,
                                                              c, static_cast<T*>(dx));
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launches (0 =
// launched), or cudaErrorInvalidValue without launching for a shape the
// kernels do not take: M < 1, C < 1, dtype other than 0 (f32) or 1 (bf16),
// vec other than 1 or the dtype's 16-byte width (4 for f32, 8 for bf16;
// then C must be a multiple of it and every pointer 16-byte aligned, which
// the Python wrappers check), stripes < 1.
//
// The reductions write (sum, second sum) into out[0:C] and out[C:2C];
// partials is (stripes, 2, C) f32 scratch.

extern "C" int cml_bn_stats(const void* x, int dtype, long long m, int c, int vec, int stripes, void* partials,
                            void* out, void* stream) {
  if (!valid_shape(dtype, m, c, vec) || stripes < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ReducePlan p = reduce_plan(m, c, vec, stripes);
  float* part = static_cast<float*>(partials);
  if (dtype == kF32) {
    if (vec == 1) launch_stats<float, 1>(x, m, c, p, part, st);
    else launch_stats<float, 4>(x, m, c, p, part, st);
  } else {
    if (vec == 1) launch_stats<__nv_bfloat16, 1>(x, m, c, p, part, st);
    else launch_stats<__nv_bfloat16, 8>(x, m, c, p, part, st);
  }
  bn_stats_fold_kernel<<<fold_grid(2 * c), dim3(kFoldX, kFoldY), 0, st>>>(part, stripes, 2 * c,
                                                                           static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_bn_norm(const void* x, int dtype, long long m, int c, int vec, const void* scale,
                           const void* shift, int relu, void* y, void* stream) {
  if (!valid_shape(dtype, m, c, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const long long nvec = m * c / vec;
  if (dtype == kF32) {
    if (vec == 1) launch_norm<float, 1>(x, sc, sh, relu, nvec, c, y, st);
    else launch_norm<float, 4>(x, sc, sh, relu, nvec, c, y, st);
  } else {
    if (vec == 1) launch_norm<__nv_bfloat16, 1>(x, sc, sh, relu, nvec, c, y, st);
    else launch_norm<__nv_bfloat16, 8>(x, sc, sh, relu, nvec, c, y, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_bn_bwd_reduce(const void* dy, const void* x, int dtype, long long m, int c, int vec,
                                 int stripes, const void* scale, const void* shift, const void* mean,
                                 const void* rsqrt, int relu, void* partials, void* out, void* stream) {
  if (!valid_shape(dtype, m, c, vec) || stripes < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ReducePlan p = reduce_plan(m, c, vec, stripes);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rsqrt);
  float* part = static_cast<float*>(partials);
  if (dtype == kF32) {
    if (vec == 1) launch_bwd_reduce<float, 1>(dy, x, sc, sh, mu, rs, relu, m, c, p, part, st);
    else launch_bwd_reduce<float, 4>(dy, x, sc, sh, mu, rs, relu, m, c, p, part, st);
  } else {
    if (vec == 1) launch_bwd_reduce<__nv_bfloat16, 1>(dy, x, sc, sh, mu, rs, relu, m, c, p, part, st);
    else launch_bwd_reduce<__nv_bfloat16, 8>(dy, x, sc, sh, mu, rs, relu, m, c, p, part, st);
  }
  bn_bwd_reduce_fold_kernel<<<fold_grid(2 * c), dim3(kFoldX, kFoldY), 0, st>>>(part, stripes, 2 * c,
                                                                                static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_bn_bwd_dx(const void* dy, const void* x, int dtype, long long m, int c, int vec,
                             const void* scale, const void* shift, const void* mean, const void* rsqrt,
                             const void* c1, const void* c2, int relu, void* dx, void* stream) {
  if (!valid_shape(dtype, m, c, vec)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rsqrt);
  const float* k1 = static_cast<const float*>(c1);
  const float* k2 = static_cast<const float*>(c2);
  const long long nvec = m * c / vec;
  if (dtype == kF32) {
    if (vec == 1) launch_bwd_dx<float, 1>(dy, x, sc, sh, mu, rs, k1, k2, relu, nvec, c, dx, st);
    else launch_bwd_dx<float, 4>(dy, x, sc, sh, mu, rs, k1, k2, relu, nvec, c, dx, st);
  } else {
    if (vec == 1) launch_bwd_dx<__nv_bfloat16, 1>(dy, x, sc, sh, mu, rs, k1, k2, relu, nvec, c, dx, st);
    else launch_bwd_dx<__nv_bfloat16, 8>(dy, x, sc, sh, mu, rs, k1, k2, relu, nvec, c, dx, st);
  }
  return static_cast<int>(cudaGetLastError());
}
