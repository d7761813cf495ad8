// Fused BatchNorm(+ReLU) for training: the statistics and normalize
// passes of the forward and the whole backward, over a contiguous (M, C)
// view (channels last, C fastest), for f32 or bf16 input, all arithmetic
// in f32.
//
// Replaces the four Pallas kernels of consensusml_tpu/models/fused_bn.py,
// all launched through _grid_call's pl.pallas_call (fused_bn.py:175):
//   bn_stats  <- _stats_kernel (:118) via _stats (:196): per-channel f32
//                sum x and sum x^2, and from them the forward's
//                per-channel vectors (mean, var, scale, shift, rsqrt:
//                the reference's jnp ops of _bn_train_fwd (:270) between
//                its two kernels) in its second launch
//   bn_norm   <- _norm_kernel (:130) via _normalize (:212):
//                y = x * scale + shift (then max(., 0) with relu), y in
//                x's dtype
//   bn_bwd    <- _bwd_reduce_kernel (:145) via _bwd_reduce (:230) AND
//                _bwd_dx_kernel (:159) via _bwd_dx (:250), with the
//                division between them: the reference's whole
//                _bn_train_bwd (:280) in one launch:
//                g = dy, zeroed where x * scale + shift <= 0 with relu;
//                xhat = (x - mean) * rsqrt; db = sum g, dg = sum g * xhat;
//                c1 = db / M, c2 = dg / M (as products with f32(1/M));
//                dx = scale * ((g - c1) - xhat * c2), dx in x's dtype;
//                db and dg written as the (2, C) f32 output.
//
// What bounds them on the H100: bytes. stats reads x; norm reads x and
// writes y; bwd reads dy and x and writes dx (3 passes of an (M, C)
// tensor), at a few flops an element; the per-channel vectors are C
// floats each. At ResNet-50's largest BN, (131072, 256) bf16, the bounds
// are 0.020 / 0.040 / 0.060 ms at 3.35 TB/s.
//
// stats and norm:
// - 16-byte vector loads and stores (8 bf16 or 4 f32 channels a thread)
//   wherever C is a multiple of the vector width and every pointer is
//   16-byte aligned; one element a thread otherwise (any C >= 1).
// - stats: a block of 256 threads owns a tile of up to 32 vector columns
//   and walks a stripe of rows, folds its rows in a fixed shared-memory
//   tree and writes one partial a channel for its stripe; a second small
//   launch folds the stripes' partials in a fixed order too, so a rerun
//   gives the same bits (no float atomics), and computes the five
//   per-channel vectors from the sums, so no plain op runs
//   between the forward's two kernels. Stripes are sized by the caller
//   (consensusml_tpu_torch/models/fused_bn.py:_stripes).
// - norm: a grid-stride loop, one vector a thread an iteration.
//
// bwd, one launch (the design; the plan's numbers come from
// consensusml_tpu_torch/models/fused_bn.py:bn_bwd_plan):
// - A thread block cluster of S <= 16 blocks owns one channel tile (a
//   power of two of 16-byte vectors, up to 256 channels) across all M
//   rows; block r of the cluster takes rows [r * rows, (r + 1) * rows).
//   Grid = (S, tiles), cluster = (S, 1, 1).
// - The vector path stages dy and x through shared memory with TMA
//   (cp.async.bulk.tensor.2d, completion on an mbarrier a buffer) in
//   chunks of up to 256 rows. Where the block's whole stripe fits
//   (nbuf >= chunks), every chunk is loaded once, up front, and stays:
//   dy and x are read from HBM once. Where it does not, the buffers form
//   a ring that streams the stripe (pass 1), and pass 2 walks the chunks
//   in reverse, so the last nbuf chunks are still in shared memory and
//   only the others are loaded again (from L2 where dy and x fit there).
// - Pass 1: each thread sums g and g * xhat for one vector of channels
//   over its rows in registers; the block folds its threads in a fixed
//   shared-memory tree. Then barrier.cluster (release/acquire), and every
//   block reads the S blocks' partials through distributed shared memory
//   (mapa + ld.shared::cluster) and sums them in rank order 0..S-1: every
//   block gets the same bits, a rerun too, and no float atomics, partials
//   in global memory or second launch are needed. c1 and c2 are the sums
//   times f32(1 / M), on the chip (the reference's db / M is a division
//   by a constant, which XLA compiles into that product); block 0 writes
//   db and dg.
// - Pass 2: dx from the staged tiles, 16-byte stores. A final
//   barrier.cluster.wait keeps each block's partials alive until the
//   cluster has read them.
// - The one-element path (C not a multiple of the vector width, or a
//   pointer not 16-byte aligned) is the same cluster and fold with plain
//   loads from global memory in both passes.
//
// Roundings: every elementwise step rounds on its own, in the plain
// versions' order, so norm equals its plain PyTorch version bit for bit
// given the same per-channel vectors, and dx equals bn_bwd_dx_plain given
// the kernel's own db * f32(1/M) and dg * f32(1/M). The backward's mask
// (x * scale + shift > 0) takes the forward's two roundings. Only the
// reductions' summation order differs from the plain versions.
//
// Subnormals: the reference's compiled program runs with flush-to-zero
// and denormals-are-zero, so a subnormal x, dy, product or sum counts as
// a zero of its sign. Every f32 operation of the three kernels (and of
// the statistics' fold) is the PTX instruction's .ftz form
// (mul/add/sub.rn.ftz.f32), which does exactly that at no cost; the
// sources build without the -ftz flag, which would change the other
// kernels too. The forward's per-channel vectors (the statistics' fold)
// flush the same way, as their plain version does (models/fused_bn.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;
constexpr int kFoldX = 32;
constexpr int kFoldY = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxBoxRows = 256;  // TMA: at most 256 elements a box dimension
constexpr int kMaxTile = 256;
constexpr int kMaxBufs = 64;      // one parity bit a buffer in a 64-bit word
constexpr int kSmemLimit = 232448;  // an H100 block's dynamic shared memory

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

// relu that keeps a NaN (as torch.relu does)
__device__ __forceinline__ float relu(float z) { return z < 0.f ? 0.f : z; }

// ---- f32 operations with the reference's flush -------------------------------
// a subnormal operand reads as a zero of its sign, a subnormal result is
// written as one; round to nearest even, as __fmul_rn & co.

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ---- clusters and TMA (bwd) ---------------------------------------------------

using cml_sm90::cluster_arrive;
using cml_sm90::cluster_rank;
using cml_sm90::cluster_wait;
using cml_sm90::ld_cluster;
using cml_sm90::wait_or_trap;

// a (box rows x box cols) tile from (col, row) of a 2-D tensor map; rows
// and columns past the tensor read as zeros, and the barrier is credited
// with the whole box's bytes either way
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// ---- stats ------------------------------------------------------------------

// One stripe of rows of one channel tile: per channel (sum x, sum x^2).
// Block (tx, ty): tx walks the tile's vector columns, ty the stripe's
// rows. Writes the stripe's partials [stripe][0][c] and [stripe][1][c].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const T* __restrict__ x, long long m, int c,
                                                            long long rows_per_stripe,
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
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += blockDim.y) {
      float xv[V];
      load_vec<T, V>(x + r * c + c0, xv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] = add_ftz(a[j], xv[j]);
        b[j] = add_ftz(b[j], mul_ftz(xv[j], xv[j]));
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
        red[0][slot + j] = add_ftz(red[0][slot + j], red[0][other + j]);
        red[1][slot + j] = add_ftz(red[1][slot + j], red[1][other + j]);
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

// The fold: per channel c, both sums over the stripes' partials, then the
// forward's per-channel vectors from them (the reference's jnp ops
// between its two kernels, flushed as its compiled program does): mean =
// s * f32(1/M), var = max(sq * f32(1/M) - mean^2, 0), rsqrt = rsqrt(var +
// eps), scale = gamma * rsqrt, shift = beta - mean * scale. Writes out[k *
// C + c], k = 0..6 in the order (s, sq, mean, var, scale, shift, rsqrt).
struct FoldParams {
  const float* gamma;
  const float* beta;
  float inv_m;  // f32(1 / f32(M))
  float eps;
};

// Column tx owns channel c; each sum is taken in a fixed order: group ty
// sums stripes ty, ty + 8, ... in turn, then a tree over groups.
__global__ void __launch_bounds__(kFoldX * kFoldY) bn_stats_fold_kernel(const float* __restrict__ partials,
                                                                         int stripes, int c,
                                                                         float* __restrict__ out,
                                                                         const FoldParams fp) {
  __shared__ float red[2][kFoldY][kFoldX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int n = 2 * c;
  const int i0 = blockIdx.x * kFoldX + tx;  // the channel
  const bool valid = i0 < c;
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int i = i0 + part * c;
    float s = 0.f;
    if (valid) {
#pragma unroll 8
      for (int k = ty; k < stripes; k += kFoldY) s = add_ftz(s, partials[static_cast<long long>(k) * n + i]);
    }
    red[part][ty][tx] = s;
  }
  __syncthreads();
  for (int h = kFoldY / 2; h > 0; h >>= 1) {
    if (ty < h)
#pragma unroll
      for (int part = 0; part < 2; ++part) red[part][ty][tx] = add_ftz(red[part][ty][tx], red[part][ty + h][tx]);
    __syncthreads();
  }
  if (ty != 0 || !valid) return;
  const float s = red[0][0][tx], sq = red[1][0][tx];
  const float mean = mul_ftz(s, fp.inv_m);
  float var = sub_ftz(mul_ftz(sq, fp.inv_m), mul_ftz(mean, mean));
  var = var < 0.f ? 0.f : var;  // keeps a NaN, as torch.clamp_min
  const float rs = rsqrtf(__fadd_rn(var, fp.eps));
  const float scale = mul_ftz(fp.gamma[i0], rs);
  const float shift = sub_ftz(fp.beta[i0], mul_ftz(mean, scale));
  out[i0] = s;
  out[c + i0] = sq;
  out[2 * c + i0] = mean;
  out[3 * c + i0] = var;
  out[4 * c + i0] = scale;
  out[5 * c + i0] = shift;
  out[6 * c + i0] = rs;
}

// ---- norm -------------------------------------------------------------------

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
      const float z = add_ftz(mul_ftz(xv[j], sc[j]), sh[j]);
      out[j] = RELU ? relu(z) : z;
    }
    store_vec<T, V>(y + i, out);
  }
}

// ---- bwd --------------------------------------------------------------------

struct BwdArgs {
  const void* dy;
  const void* x;
  void* dx;
  const float* scale;
  const float* shift;
  const float* mean;
  const float* rsqrt;
  float* out;      // (2, C): db, dg
  float inv_m;     // f32(1 / f32(M))
  long long m;
  int c;
  int tile;        // channels a tile: V * (a power of two <= 32), <= 256
  long long rows;  // rows a block
  int chunk;       // rows a staged chunk (TMA box rows), vector path only
  int nbuf;        // chunk buffers of dy and x, vector path only
};

// dynamic shared memory: [red: 2 x kThreads*V f32][consts: 2 x tile f32]
// [bars: nbuf u64], then from a 128-byte boundary nbuf x (dy chunk, x chunk)
// buffers, each 128-byte aligned
__host__ __device__ constexpr long long align128(long long b) { return (b + 127) / 128 * 128; }

__host__ __device__ inline long long bwd_buf_bytes(int chunk, int tile, int elem) {
  return align128(static_cast<long long>(chunk) * tile * elem);
}

__host__ __device__ inline long long bwd_head_bytes(int vec, int tile, int nbuf) {
  return align128((2LL * kThreads * vec + 2LL * tile) * 4 + 8LL * nbuf);
}

__host__ inline long long bwd_smem_bytes(int vec, int tile, int chunk, int nbuf, int elem) {
  const long long head = bwd_head_bytes(vec, tile, nbuf);
  return vec > 1 ? head + 2LL * nbuf * bwd_buf_bytes(chunk, tile, elem) : head;
}

// g (masked) and xhat of V channels of one row, flushed as the reference
template <int V, bool RELU>
__device__ __forceinline__ void bwd_operands(float (&g)[V], const float (&xv)[V], const float (&sc)[V],
                                             const float (&sh)[V], const float (&mu)[V],
                                             const float (&rs)[V], float (&xhat)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (RELU && !(add_ftz(mul_ftz(xv[j], sc[j]), sh[j]) > 0.f)) g[j] = 0.f;
    xhat[j] = mul_ftz(sub_ftz(xv[j], mu[j]), rs[j]);
  }
}

template <typename T, int V, bool RELU, bool TMA>
__global__ void __launch_bounds__(kThreads) bn_bwd_kernel(const __grid_constant__ CUtensorMap tdy,
                                                          const __grid_constant__ CUtensorMap tx_map,
                                                          const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [2][kThreads * V]
  float* consts = red + 2 * kThreads * V;       // [2][tile]: c1, c2
  const uint32_t bars = cml_sm90::smem_u32(consts + 2 * a.tile);
  unsigned char* bufs = smem + bwd_head_bytes(V, a.tile, a.nbuf);
  const long long buf_bytes = TMA ? bwd_buf_bytes(a.chunk, a.tile, sizeof(T)) : 0;

  const int tid = threadIdx.x;
  const int wv = a.tile / V;  // vector columns of the tile (a power of two <= 32)
  const int tx = tid % wv, ty = tid / wv, rows_step = kThreads / wv;
  const int cbase = blockIdx.y * a.tile;
  const int c0 = cbase + tx * V;
  const bool active = c0 < a.c;  // V > 1 only when V divides C
  const long long row0 = static_cast<long long>(blockIdx.x) * a.rows;
  const long long nrows = max(0LL, min(a.m, row0 + a.rows) - row0);
  const T* dy = static_cast<const T*>(a.dy);
  const T* x = static_cast<const T*>(a.x);

  float sc[V], sh[V], mu[V], rs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sc[j] = sh[j] = mu[j] = rs[j] = 0.f;
  if (active) {
    load_param<V>(a.scale, c0, sc);
    load_param<V>(a.shift, c0, sh);
    load_param<V>(a.mean, c0, mu);
    load_param<V>(a.rsqrt, c0, rs);
  }

  // ---- staging (vector path) ----
  const int nchunks = TMA ? static_cast<int>((nrows + a.chunk - 1) / a.chunk) : 0;
  const int nbuf = a.nbuf;
  auto dy_buf = [&](int b) { return reinterpret_cast<const T*>(bufs + 2 * b * buf_bytes); };
  auto x_buf = [&](int b) { return reinterpret_cast<const T*>(bufs + (2 * b + 1) * buf_bytes); };
  const CUtensorMap* map_dy = &tdy;
  const CUtensorMap* map_x = &tx_map;
  auto issue = [&](int k) {  // thread 0: chunk k into buffer k % nbuf
    const int b = k % nbuf;
    const uint32_t bar = bars + 8 * b;
    const int row = static_cast<int>(row0 + static_cast<long long>(k) * a.chunk);
    cml_sm90::mbar_expect_tx(bar, static_cast<uint32_t>(2 * a.chunk * a.tile * sizeof(T)));
    tma_load_2d(cml_sm90::smem_u32(dy_buf(b)), map_dy, bar, cbase, row);
    tma_load_2d(cml_sm90::smem_u32(x_buf(b)), map_x, bar, cbase, row);
  };
  uint64_t parity = 0;  // bit b: the parity of buffer b's next completion
  auto wait = [&](int b) {
    wait_or_trap(bars + 8 * b, static_cast<uint32_t>((parity >> b) & 1));
    parity ^= 1ull << b;
  };
  if constexpr (TMA) {
    if (tid == 0) {
      for (int b = 0; b < nbuf; ++b) cml_sm90::mbar_init(bars + 8 * b, 1);
      cml_sm90::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int k = 0; k < min(nbuf, nchunks); ++k) issue(k);
  }

  // ---- pass 1: per-thread sums of g and g * xhat ----
  float sa[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.f;
  auto accumulate = [&](const T* pdy, const T* px) {
    float g[V], xv[V], xhat[V];
    load_vec<T, V>(pdy, g);
    load_vec<T, V>(px, xv);
    bwd_operands<V, RELU>(g, xv, sc, sh, mu, rs, xhat);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sa[j] = add_ftz(sa[j], g[j]);
      sb[j] = add_ftz(sb[j], mul_ftz(g[j], xhat[j]));
    }
  };
  if constexpr (TMA) {
    for (int k = 0; k < nchunks; ++k) {
      const int b = k % nbuf;
      wait(b);
      const int n = static_cast<int>(min(static_cast<long long>(a.chunk), nrows - static_cast<long long>(k) * a.chunk));
      if (active) {
        const T* sdy = dy_buf(b);
        const T* sx = x_buf(b);
#pragma unroll 4
        for (int r = ty; r < n; r += rows_step) accumulate(sdy + r * a.tile + tx * V, sx + r * a.tile + tx * V);
      }
      if (k + nbuf < nchunks) {  // streaming: refill this buffer once every thread is done with it
        __syncthreads();
        if (tid == 0) issue(k + nbuf);
      }
    }
  } else if (active) {
#pragma unroll 4
    for (long long r = row0 + ty; r < row0 + nrows; r += rows_step) accumulate(dy + r * a.c + c0, x + r * a.c + c0);
  }

  // ---- the block's partials: a fixed-order tree over its rows ----
  const int slot = tid * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[slot + j] = sa[j];
    red[kThreads * V + slot + j] = sb[j];
  }
  __syncthreads();
  for (int s = rows_step / 2; s > 0; s >>= 1) {
    if (ty < s) {
      const int other = slot + s * wv * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[slot + j] = add_ftz(red[slot + j], red[other + j]);
        red[kThreads * V + slot + j] = add_ftz(red[kThreads * V + slot + j], red[kThreads * V + other + j]);
      }
    }
    __syncthreads();
  }
  // red[i] and red[kThreads * V + i], i < tile: the block's sums for channel cbase + i

  // ---- the cluster's sums, in rank order, in every block ----
  cluster_arrive();
  cluster_wait();
  if (tid < a.tile) {
    const uint32_t la = cml_sm90::smem_u32(red + tid), lb = cml_sm90::smem_u32(red + kThreads * V + tid);
    float db = 0.f, dg = 0.f;
    for (uint32_t q = 0; q < gridDim.x; ++q) {
      db = add_ftz(db, ld_cluster(la, q));
      dg = add_ftz(dg, ld_cluster(lb, q));
    }
    consts[tid] = mul_ftz(db, a.inv_m);
    consts[a.tile + tid] = mul_ftz(dg, a.inv_m);
    if (cluster_rank() == 0 && cbase + tid < a.c) {
      a.out[cbase + tid] = db;
      a.out[a.c + cbase + tid] = dg;
    }
  }
  cluster_arrive();  // this block is done reading the others' partials
  __syncthreads();

  // ---- pass 2: dx ----
  float k1[V], k2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    k1[j] = consts[tx * V + j];
    k2[j] = consts[a.tile + tx * V + j];
  }
  T* dx = static_cast<T*>(a.dx);
  auto write_dx = [&](const T* pdy, const T* px, long long r) {
    float g[V], xv[V], xhat[V], o[V];
    load_vec<T, V>(pdy, g);
    load_vec<T, V>(px, xv);
    bwd_operands<V, RELU>(g, xv, sc, sh, mu, rs, xhat);
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = mul_ftz(sc[j], sub_ftz(sub_ftz(g[j], k1[j]), mul_ftz(xhat[j], k2[j])));
    store_vec<T, V>(dx + r * a.c + c0, o);
  };
  if constexpr (TMA) {
    // reverse order: the last nbuf chunks are still staged
    for (int k = nchunks - 1; k >= 0; --k) {
      const int b = k % nbuf;
      if (k < nchunks - nbuf) wait(b);
      const long long base = row0 + static_cast<long long>(k) * a.chunk;
      const int n = static_cast<int>(min(static_cast<long long>(a.chunk), nrows - static_cast<long long>(k) * a.chunk));
      if (active) {
        const T* sdy = dy_buf(b);
        const T* sx = x_buf(b);
#pragma unroll 4
        for (int r = ty; r < n; r += rows_step) write_dx(sdy + r * a.tile + tx * V, sx + r * a.tile + tx * V, base + r);
      }
      if (k >= nbuf) {  // streaming: chunk k - nbuf goes into this buffer again
        __syncthreads();
        if (tid == 0) issue(k - nbuf);
      }
    }
  } else if (active) {
#pragma unroll 4
    for (long long r = row0 + ty; r < row0 + nrows; r += rows_step) write_dx(dy + r * a.c + c0, x + r * a.c + c0, r);
  }
  cluster_wait();  // the cluster has read this block's partials
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

// a plan the kernel takes (the Python plan makes only these)
bool valid_bwd_plan(int vec, long long m, int c, int elem, int cluster, int tile, long long rows, int chunk,
                    int nbuf) {
  if (cluster < 1 || cluster > kMaxCluster || rows < 1 || rows * cluster < m || (cluster - 1) * rows >= m)
    return false;
  if (tile < vec || tile % vec || tile > kMaxTile) return false;
  const int wv = tile / vec;
  if (wv > 32 || (wv & (wv - 1))) return false;
  if ((c + tile - 1) / tile > 65535) return false;
  if (vec > 1 && (chunk < 1 || chunk > kMaxBoxRows || nbuf < 1 || nbuf > kMaxBufs)) return false;
  return bwd_smem_bytes(vec, tile, chunk, nbuf, elem) <= kSmemLimit;
}

template <typename T, int V, bool RELU, bool TMA>
int launch_bwd_kernel(const CUtensorMap& tdy, const CUtensorMap& tx, const BwdArgs& a, int cluster, int tiles,
                      long long smem, cudaStream_t st) {
  auto kernel = bn_bwd_kernel<T, V, RELU, TMA>;
  // per device, once: the attributes belong to the current device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 0 && dev < 64) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster), static_cast<unsigned int>(tiles), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tdy, tx, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int V, bool TMA>
int launch_bwd(const CUtensorMap& tdy, const CUtensorMap& tx, const BwdArgs& a, int relu, int cluster, int tiles,
               long long smem, cudaStream_t st) {
  return relu ? launch_bwd_kernel<T, V, true, TMA>(tdy, tx, a, cluster, tiles, smem, st)
              : launch_bwd_kernel<T, V, false, TMA>(tdy, tx, a, cluster, tiles, smem, st);
}

// a (C, M) tensor map over a contiguous (M, C) view, (tile x chunk) boxes
int encode_rows(CUtensorMap* map, const void* ptr, int dtype, long long m, int c, int tile, int chunk) {
  const cml_sm90::EncodeTiledFn fn = cml_sm90::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const int elem = dtype == kF32 ? 4 : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(tile), static_cast<cuuint32_t>(chunk)};
  const cuuint32_t one[2] = {1, 1};
  const CUresult rc = fn(map, dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launches (0 =
// launched), or cudaErrorInvalidValue without launching for a shape the
// kernels do not take: M < 1, C < 1, dtype other than 0 (f32) or 1 (bf16),
// vec other than 1 or the dtype's 16-byte width (4 for f32, 8 for bf16;
// then C must be a multiple of it and every pointer 16-byte aligned, which
// the Python wrappers check).
//
// cml_bn_stats writes out ((7, C) f32): the two sums and the forward's
// five per-channel vectors from gamma and beta ((C,) f32), in the order of
// FoldParams; partials is (stripes, 2, C) f32 scratch (stripes >= 1).

extern "C" int cml_bn_stats(const void* x, int dtype, long long m, int c, int vec, int stripes, void* partials,
                            const void* gamma, const void* beta, float eps, void* out, void* stream) {
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
  // the reference's mean = s / M as XLA compiles it: a product with f32(1 / M)
  const FoldParams fp{static_cast<const float*>(gamma), static_cast<const float*>(beta),
                      static_cast<float>(1.0 / static_cast<double>(static_cast<float>(m))), eps};
  bn_stats_fold_kernel<<<fold_grid(c), dim3(kFoldX, kFoldY), 0, st>>>(part, stripes, c, static_cast<float*>(out),
                                                                      fp);
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

// The whole backward in one launch (see the header): dx (M, C) in x's
// dtype, out = (2, C) f32 (db, dg). The plan (cluster, tile, rows, chunk,
// nbuf) comes from consensusml_tpu_torch/models/fused_bn.py:bn_bwd_plan;
// cudaErrorInvalidValue for a plan the kernel does not take (chunk and
// nbuf are read only when vec > 1).
extern "C" int cml_bn_bwd(const void* dy, const void* x, int dtype, long long m, int c, int vec,
                          const void* scale, const void* shift, const void* mean, const void* rsqrt, int relu,
                          int cluster, int tile, long long rows, int chunk, int nbuf, void* dx, void* out,
                          void* stream) {
  const int elem = dtype == kF32 ? 4 : 2;
  if (!valid_shape(dtype, m, c, vec) || !valid_bwd_plan(vec, m, c, elem, cluster, tile, rows, chunk, nbuf))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);  // TMA row coordinates are int
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the reference's db / M as XLA compiles it: a product with f32(1 / M)
  const float inv_m = static_cast<float>(1.0 / static_cast<double>(static_cast<float>(m)));
  BwdArgs a{dy, x, dx, static_cast<const float*>(scale), static_cast<const float*>(shift),
            static_cast<const float*>(mean), static_cast<const float*>(rsqrt), static_cast<float*>(out),
            inv_m, m, c, tile, rows, vec > 1 ? chunk : 0, vec > 1 ? nbuf : 0};
  const int tiles = (c + tile - 1) / tile;
  const long long smem = bwd_smem_bytes(vec, tile, chunk, nbuf, elem);
  CUtensorMap tdy{}, tx{};
  if (vec > 1) {
    int rc = encode_rows(&tdy, dy, dtype, m, c, tile, chunk);
    if (rc == 0) rc = encode_rows(&tx, x, dtype, m, c, tile, chunk);
    if (rc != 0) return rc;
  }
  if (dtype == kF32)
    return vec == 1 ? launch_bwd<float, 1, false>(tdy, tx, a, relu, cluster, tiles, smem, st)
                    : launch_bwd<float, 4, true>(tdy, tx, a, relu, cluster, tiles, smem, st);
  return vec == 1 ? launch_bwd<__nv_bfloat16, 1, false>(tdy, tx, a, relu, cluster, tiles, smem, st)
                  : launch_bwd<__nv_bfloat16, 8, true>(tdy, tx, a, relu, cluster, tiles, smem, st);
}

// How many clusters of the plan's shape the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 = the launch would fail), or a
// negative CUDA error code. The bf16 relu kernel of the vector path.
extern "C" int cml_bn_bwd_max_active_clusters(int cluster, int tile, int chunk, int nbuf) {
  const long long smem = bwd_smem_bytes(8, tile, chunk, nbuf, 2);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = bn_bwd_kernel<__nv_bfloat16, 8, true, true>;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
