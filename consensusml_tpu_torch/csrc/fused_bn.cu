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
//                its two kernels), in one launch
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
// stats, one launch (its plan's numbers come from
// consensusml_tpu_torch/models/fused_bn.py:bn_stats_plan; the sweep is
// consensusml_tpu_torch/tools/bn_stats_sweep.py): bwd's geometry below,
// one pass. A thread block cluster of S <= 16 blocks owns a channel tile
// across all M rows, block r of the cluster rows [r * rows, (r + 1) *
// rows), staged by TMA through a ring of chunk buffers or read with
// 16-byte loads from global memory (the plan's choice; one element a
// thread where C or a pointer does not take 16 bytes). Each thread sums x
// and x^2 for one vector of channels over its rows in registers, the block
// folds its threads in a fixed shared-memory tree, and after
// barrier.cluster block 0 sums the S blocks' partials through distributed
// shared memory in rank order and computes the five per-channel vectors
// from the sums, so no plain op runs between the forward's two kernels.
// No partials in global memory, no second launch, no float atomics: a
// rerun gives the same bits.
//
// norm: a grid-stride loop, 16-byte vector loads and stores (8 bf16 or 4
// f32 channels a thread) wherever C is a multiple of the vector width and
// every pointer is 16-byte aligned, one element a thread otherwise.
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

#include <utility>

#include "flash_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;
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

// f32 operations with the reference's flush (a subnormal operand reads as
// a zero of its sign, a subnormal result is written as one)
using cml_sm90::add_ftz;
using cml_sm90::mul_ftz;
using cml_sm90::sub_ftz;

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

__host__ __device__ constexpr long long align128(long long b) { return (b + 127) / 128 * 128; }

// The statistics and their fold, one launch: per channel c, sum x and
// sum x^2 over all M rows, then the forward's per-channel vectors from
// them (the reference's jnp ops between its two kernels, flushed as its
// compiled program does): mean = s * f32(1/M), var = max(sq * f32(1/M) -
// mean^2, 0), rsqrt = rsqrt(var + eps), scale = gamma * rsqrt, shift =
// beta - mean * scale. Writes out[k * C + c], k = 0..6 in the order (s,
// sq, mean, var, scale, shift, rsqrt).
struct StatsArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  float* out;      // (7, C)
  float* partials;        // (splits, 2, C): each cluster's sums, with splits > 1
  unsigned int* tickets;  // one a channel tile, zero between launches, with splits > 1
  float inv_m;     // f32(1 / f32(M))
  float eps;
  long long m;
  int c;
  int tile;        // channels a tile: V * (a power of two <= 32), <= 256
  long long rows;  // rows a block
  int chunk;       // rows a staged chunk (TMA box rows), vector path only
  int nbuf;        // chunk buffers of x, vector path only
};

// dynamic shared memory: [red: 2 x kThreads*V f32][bars: nbuf u64], then
// from a 128-byte boundary nbuf x-chunk buffers, each 128-byte aligned
__host__ __device__ inline long long stats_head_bytes(int vec, int nbuf) {
  return align128(2LL * kThreads * vec * 4 + 8LL * nbuf);
}

__host__ inline long long stats_smem_bytes(int vec, int tile, int chunk, int nbuf, int elem) {
  const long long head = stats_head_bytes(vec, nbuf);
  return vec > 1 ? head + nbuf * align128(static_cast<long long>(chunk) * tile * elem) : head;
}

// A thread block cluster of S blocks owns one channel tile across all M
// rows (bn_bwd's geometry): block r of the cluster sums rows [r * rows,
// (r + 1) * rows), staged through a ring of TMA chunk buffers or read
// from global memory (nbuf = 0, and the one-element path), in per-thread
// registers; the block folds its threads in a fixed shared-memory tree;
// barrier.cluster; block 0 sums the S blocks' partials in rank order
// through distributed shared memory and writes the tile's seven rows. No
// partials in global memory, no second launch, no float atomics: a rerun
// gives the same bits.
template <typename T, int V, bool TMA>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const __grid_constant__ CUtensorMap tx_map,
                                                            const StatsArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [2][kThreads * V]
  const uint32_t bars = cml_sm90::smem_u32(red + 2 * kThreads * V);
  unsigned char* bufs = smem + stats_head_bytes(V, a.nbuf);
  const long long buf_bytes = TMA ? align128(static_cast<long long>(a.chunk) * a.tile * sizeof(T)) : 0;

  const int tid = threadIdx.x;
  const int wv = a.tile / V;  // vector columns of the tile (a power of two <= 32)
  const int tx = tid % wv, ty = tid / wv, rows_step = kThreads / wv;
  const int cbase = blockIdx.y * a.tile;
  const int c0 = cbase + tx * V;
  const bool active = c0 < a.c;  // V > 1 only when V divides C
  const long long row0 = (static_cast<long long>(blockIdx.z) * gridDim.x + blockIdx.x) * a.rows;
  const long long nrows = max(0LL, min(a.m, row0 + a.rows) - row0);
  const T* x = static_cast<const T*>(a.x);

  const int nchunks = TMA ? static_cast<int>((nrows + a.chunk - 1) / a.chunk) : 0;
  const int nbuf = a.nbuf;
  auto x_buf = [&](int b) { return reinterpret_cast<const T*>(bufs + b * buf_bytes); };
  const CUtensorMap* map_x = &tx_map;
  auto issue = [&](int k) {  // thread 0: chunk k into buffer k % nbuf
    const int b = k % nbuf;
    const uint32_t bar = bars + 8 * b;
    cml_sm90::mbar_expect_tx(bar, static_cast<uint32_t>(a.chunk * a.tile * sizeof(T)));
    tma_load_2d(cml_sm90::smem_u32(x_buf(b)), map_x, bar, cbase,
                static_cast<int>(row0 + static_cast<long long>(k) * a.chunk));
  };
  uint64_t parity = 0;  // bit b: the parity of buffer b's next completion
  if constexpr (TMA) {
    if (tid == 0) {
      for (int b = 0; b < nbuf; ++b) cml_sm90::mbar_init(bars + 8 * b, 1);
      cml_sm90::mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int k = 0; k < min(nbuf, nchunks); ++k) issue(k);
  }

  float sa[V], sb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sa[j] = sb[j] = 0.f;
  auto accumulate = [&](const T* px) {
    float xv[V];
    load_vec<T, V>(px, xv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sa[j] = add_ftz(sa[j], xv[j]);
      sb[j] = add_ftz(sb[j], mul_ftz(xv[j], xv[j]));
    }
  };
  if constexpr (TMA) {
    for (int k = 0; k < nchunks; ++k) {
      const int b = k % nbuf;
      wait_or_trap(bars + 8 * b, static_cast<uint32_t>((parity >> b) & 1));
      parity ^= 1ull << b;
      const int n = static_cast<int>(min(static_cast<long long>(a.chunk), nrows - static_cast<long long>(k) * a.chunk));
      if (active) {
        const T* sx = x_buf(b);
#pragma unroll 4
        for (int r = ty; r < n; r += rows_step) accumulate(sx + r * a.tile + tx * V);
      }
      if (k + nbuf < nchunks) {  // refill this buffer once every thread is done with it
        __syncthreads();
        if (tid == 0) issue(k + nbuf);
      }
    }
  } else if (active) {
#pragma unroll 8
    for (long long r = row0 + ty; r < row0 + nrows; r += rows_step) accumulate(x + r * a.c + c0);
  }

  // ---- the block's sums: a fixed-order tree over its rows ----
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

  // ---- block 0: the cluster's sums in rank order ----
  cluster_arrive();
  cluster_wait();
  const int ch = cbase + tid;
  const bool mine = tid < a.tile && ch < a.c;
  float s = 0.f, sq = 0.f;
  if (cluster_rank() == 0 && mine) {
    const uint32_t la = cml_sm90::smem_u32(red + tid), lb = cml_sm90::smem_u32(red + kThreads * V + tid);
    // every block's two partials first, all loads in flight together, then
    // the sums in rank order
    float ps[kMaxCluster], pq[kMaxCluster];
#pragma unroll
    for (uint32_t q = 0; q < kMaxCluster; ++q) {
      const bool in = q < gridDim.x;
      ps[q] = in ? ld_cluster(la, q) : 0.f;
      pq[q] = in ? ld_cluster(lb, q) : 0.f;
    }
#pragma unroll
    for (uint32_t q = 0; q < kMaxCluster; ++q) {
      if (q < gridDim.x) {
        s = add_ftz(s, ps[q]);
        sq = add_ftz(sq, pq[q]);
      }
    }
  }
  // ---- several clusters a tile: the last to arrive folds them in order ----
  bool last = true;
  if (gridDim.z > 1 && cluster_rank() == 0) {
    __shared__ unsigned int ticket;
    float* part = a.partials + static_cast<long long>(blockIdx.z) * 2 * a.c;
    if (mine) {
      part[ch] = s;
      part[a.c + ch] = sq;
    }
    __threadfence();  // this cluster's sums are visible before its ticket
    __syncthreads();
    if (tid == 0) ticket = atomicAdd(a.tickets + blockIdx.y, 1u);
    __syncthreads();
    last = ticket == gridDim.z - 1;
    if (last) {
      __threadfence();
      if (mine) {
        s = sq = 0.f;
        for (uint32_t k = 0; k < gridDim.z; ++k) {
          s = add_ftz(s, __ldcg(a.partials + static_cast<long long>(k) * 2 * a.c + ch));
          sq = add_ftz(sq, __ldcg(a.partials + static_cast<long long>(k) * 2 * a.c + a.c + ch));
        }
      }
      if (tid == 0) atomicExch(a.tickets + blockIdx.y, 0u);  // zero for the next launch
    }
  }
  // ---- then the forward's per-channel vectors ----
  if (cluster_rank() == 0 && last && mine) {
    const float mean = mul_ftz(s, a.inv_m);
    float var = sub_ftz(mul_ftz(sq, a.inv_m), mul_ftz(mean, mean));
    var = var < 0.f ? 0.f : var;  // keeps a NaN, as torch.clamp_min
    const float rs = rsqrtf(__fadd_rn(var, a.eps));
    const float scale = mul_ftz(a.gamma[ch], rs);
    const float shift = sub_ftz(a.beta[ch], mul_ftz(mean, scale));
    float* out = a.out;
    out[ch] = s;
    out[a.c + ch] = sq;
    out[2 * a.c + ch] = mean;
    out[3 * a.c + ch] = var;
    out[4 * a.c + ch] = scale;
    out[5 * a.c + ch] = shift;
    out[6 * a.c + ch] = rs;
  }
  cluster_arrive();  // block 0 is done reading the others' partials
  cluster_wait();
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

unsigned int elementwise_grid(long long nvec) {
  const long long blocks = (nvec + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 132 * 32 ? blocks : 132 * 32);
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

// a cluster plan the kernels take (the Python plans make only these):
// the cluster's blocks cover M with none empty, a tile of a power of two
// <= 32 of vectors, chunks within TMA's box, `smem` within a block's limit
bool valid_cluster_plan(int vec, long long m, int c, int cluster, int splits, int tile, long long rows, int chunk,
                        int nbuf, long long smem, bool staged) {
  const long long blocks = static_cast<long long>(cluster) * splits;  // along the rows
  if (cluster < 1 || cluster > kMaxCluster || splits < 1 || splits > 65535 || rows < 1 || rows * blocks < m ||
      (blocks - 1) * rows >= m)
    return false;
  if (tile < vec || tile % vec || tile > kMaxTile) return false;
  const int wv = tile / vec;
  if (wv > 32 || (wv & (wv - 1))) return false;
  if ((c + tile - 1) / tile > 65535) return false;
  if (staged && (chunk < 1 || chunk > kMaxBoxRows || nbuf < 1 || nbuf > kMaxBufs)) return false;
  return smem <= kSmemLimit;
}

// `tiles` x `splits` clusters of `cluster` blocks (grid (cluster, tiles,
// splits)) of `kernel`, its attributes set once per device (they belong to
// the current device)
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), bool (&ready)[64], int cluster, int tiles, int splits,
                    long long smem, cudaStream_t st, Args&&... args) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64 || !ready[dev]) {
    // the block's limit less the kernel's static shared memory
    cudaFuncAttributes fa{};
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - static_cast<int>(fa.sharedSizeBytes));
    if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 0 && dev < 64) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(cluster), static_cast<unsigned int>(tiles),
                     static_cast<unsigned int>(splits));
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
  e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int V, bool RELU, bool TMA>
int launch_bwd_kernel(const CUtensorMap& tdy, const CUtensorMap& tx, const BwdArgs& a, int cluster, int tiles,
                      long long smem, cudaStream_t st) {
  static bool ready[64] = {};
  return launch_clusters(bn_bwd_kernel<T, V, RELU, TMA>, ready, cluster, tiles, 1, smem, st, tdy, tx, a);
}

template <typename T, int V, bool TMA>
int launch_bwd(const CUtensorMap& tdy, const CUtensorMap& tx, const BwdArgs& a, int relu, int cluster, int tiles,
               long long smem, cudaStream_t st) {
  return relu ? launch_bwd_kernel<T, V, true, TMA>(tdy, tx, a, cluster, tiles, smem, st)
              : launch_bwd_kernel<T, V, false, TMA>(tdy, tx, a, cluster, tiles, smem, st);
}

template <typename T, int V, bool TMA>
int launch_stats(const CUtensorMap& tx, const StatsArgs& a, int cluster, int tiles, int splits, long long smem,
                 cudaStream_t st) {
  static bool ready[64] = {};
  return launch_clusters(bn_stats_kernel<T, V, TMA>, ready, cluster, tiles, splits, smem, st, tx, a);
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
// StatsArgs, in one launch. The plan (cluster, splits, tile, rows, chunk,
// nbuf) comes from consensusml_tpu_torch/models/fused_bn.py:bn_stats_plan;
// cudaErrorInvalidValue for a plan the kernel does not take (chunk and
// nbuf are read only when vec > 1). With splits > 1, partials is (splits,
// 2, C) f32 scratch and tickets one uint32 a channel tile, zero before the
// launch and left zero by it (one set per stream: launches on one stream
// run one at a time).

extern "C" int cml_bn_stats(const void* x, int dtype, long long m, int c, int vec, int cluster, int splits, int tile,
                            long long rows, int chunk, int nbuf, const void* gamma, const void* beta, float eps,
                            void* partials, void* tickets, void* out, void* stream) {
  const int elem = dtype == kF32 ? 4 : 2;
  const bool staged = vec > 1 && nbuf > 0;  // TMA chunks; else 16-byte loads from global memory
  const long long smem = stats_smem_bytes(vec, tile, staged ? chunk : 0, staged ? nbuf : 0, elem);
  if (!valid_shape(dtype, m, c, vec) ||
      !valid_cluster_plan(vec, m, c, cluster, splits, tile, rows, chunk, nbuf, smem, staged) ||
      (splits > 1 && (partials == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);  // TMA row coordinates are int
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the reference's mean = s / M as XLA compiles it: a product with f32(1 / M)
  const StatsArgs a{x, static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<float*>(out),
                    static_cast<float*>(partials), static_cast<unsigned int*>(tickets),
                    static_cast<float>(1.0 / static_cast<double>(static_cast<float>(m))), eps, m, c, tile, rows,
                    staged ? chunk : 0, staged ? nbuf : 0};
  const int tiles = (c + tile - 1) / tile;
  CUtensorMap tx{};
  if (staged) {
    const int rc = encode_rows(&tx, x, dtype, m, c, tile, chunk);
    if (rc != 0) return rc;
  }
  if (dtype == kF32) {
    if (vec == 1) return launch_stats<float, 1, false>(tx, a, cluster, tiles, splits, smem, st);
    return staged ? launch_stats<float, 4, true>(tx, a, cluster, tiles, splits, smem, st)
                  : launch_stats<float, 4, false>(tx, a, cluster, tiles, splits, smem, st);
  }
  if (vec == 1) return launch_stats<__nv_bfloat16, 1, false>(tx, a, cluster, tiles, splits, smem, st);
  return staged ? launch_stats<__nv_bfloat16, 8, true>(tx, a, cluster, tiles, splits, smem, st)
                : launch_stats<__nv_bfloat16, 8, false>(tx, a, cluster, tiles, splits, smem, st);
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
  if (!valid_shape(dtype, m, c, vec) ||
      !valid_cluster_plan(vec, m, c, cluster, 1, tile, rows, chunk, nbuf, bwd_smem_bytes(vec, tile, chunk, nbuf, elem),
                          vec > 1))
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
