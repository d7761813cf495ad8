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
// The reference's arithmetic as XLA compiles it: a mean over the row is
// its sum times f32(1 / H) (the compiled jnp.mean; at H = 1000 the
// quotient differs from that product in half the rows), and f32
// subnormals are flushed: a subnormal operand reads as a zero of its
// sign, a subnormal result is written as one. Every f32 operation here is
// the PTX instruction's .ftz form (flash_sm90.cuh: mul_ftz, add_ftz,
// sub_ftz), which does exactly that; the plain versions
// (consensusml_tpu_torch/models/fused_ln.py) flush after each operation.
// Elementwise steps round on their own in the plain versions' order; the
// row and column sums run in another order than torch's sums, and rsqrtf
// is within 2 ulp, so the kernels are held to a tolerance, not to the bit.
//
// Forward: a block of 128 threads (256 past H = 1024) owns a row: each
// thread holds 8 consecutive columns (one 16-byte bf16 load, or two of
// f32) in registers, two for H past 2048, so the row is read from device
// memory once and both statistics come from the registers. Row sums are
// warp-shuffle trees, then the warps' totals in a fixed order through
// shared memory. One row a block (M blocks).
//
// Backward, one launch (the plan's numbers come from
// consensusml_tpu_torch/models/fused_ln.py:ln_bwd_plan):
// - A persistent grid of one block of 8 warps an SM (fewer blocks for
//   few rows). A row belongs to a group of G warps (G = 1 up to H = 1024,
//   2 up to 2048, 4 up to 4096), so a thread holds at most four 8-column
//   vectors of the row; group k of the grid takes rows k, k + groups,
//   k + 2 * groups, ...
// - Each thread stages its own vectors of the group's next rows with
//   cp.async (16 bytes a copy) into a ring of `slots` rows of x and dy in
//   shared memory, so `slots - 1` rows of every warp are in flight while
//   it reduces the current one; a thread reads back only what it copied,
//   so the ring needs no barrier.
// - The row's sums (x, then xc^2, then g and g * xhat together) are
//   xor-shuffle trees, which give every lane the same bits; with G > 1 the
//   group's warps add their totals in a fixed order through shared memory
//   (one named barrier of the group's warps a sum, no block barrier).
// - Every thread keeps its columns' dgamma and dbeta partials in
//   registers over its group's rows. At the end the block adds its
//   groups' partials in group order and writes one (2, H) partial a block;
//   each block then takes an integer ticket (atomicAdd). The last F blocks
//   to arrive (F = min(blocks, 2H / 32)) wait until every block has
//   written its partial and fold the blocks' partials in block order, each
//   a slice of 32 sums at a time, eight threads a sum over eighths of the
//   blocks, then those eight in order: the sums do not depend on the order
//   in which blocks ran, so a rerun gives the same bits, and no float
//   atomics are used. The last folder zeroes the ticket for the next
//   launch. The partials cost 8 * H bytes a block written and read again
//   (1 MB at H = 1024 on 132 SMs, against the pass's 50 MB; in L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using cml_sm90::add_ftz;
using cml_sm90::mul_ftz;
using cml_sm90::sub_ftz;

constexpr int kVec = 8;
constexpr int kWarp = 32;
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / kWarp;
constexpr int kBwdNV = 4;  // 8-column vectors of a row a thread holds, at most
constexpr int kFoldSums = 32;  // sums of one fold task
constexpr int kFoldParts = kBwdThreads / kFoldSums;
constexpr int kMaxSlots = 8;
// an H100 block's shared memory (232448 bytes), less room for the static
// ticket word
constexpr int kSmemLimit = 232448 - 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// 8 consecutive elements as f32 (16-byte aligned, global or shared): one or
// two 16-byte loads
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

// the warp's total of v, the same bits on every lane (each xor step adds
// the same two values on both partners)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v = add_ftz(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---- forward ------------------------------------------------------------------

// the block's total of v, in the same fixed order on every thread; slot
// holds NT / 32 floats and is not written again before every thread has
// passed a later barrier
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* slot) {
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) slot[threadIdx.x / kWarp] = v;
  __syncthreads();
  float s = slot[0];
#pragma unroll
  for (int w = 1; w < NT / kWarp; ++w) s = add_ftz(s, slot[w]);
  return s;
}

template <typename TX, typename TY, int NV, int NT>
__global__ void __launch_bounds__(NT) ln_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                                                    const float* __restrict__ beta, TY* __restrict__ y, int h,
                                                    float eps, float inv_h) {
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
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < kVec; ++j) s = add_ftz(s, v[k][j]);
  const float mu = mul_ftz(block_sum<NT>(s, red[0]), inv_h);
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[k][j] = active[k] ? sub_ftz(v[k][j], mu) : 0.f;
      q = add_ftz(q, mul_ftz(v[k][j], v[k][j]));
    }
  const float rsig = rsqrtf(mul_ftz(block_sum<NT>(q, red[1]), inv_h) + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (!active[k]) continue;
    const int c0 = (k * NT + threadIdx.x) * kVec;
    float g[kVec], b[kVec], out[kVec];
    load_param(gamma, c0, g);
    load_param(beta, c0, b);
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = add_ftz(mul_ftz(mul_ftz(v[k][j], rsig), g[j]), b[j]);
    store8(y + base + c0, out);
  }
}

// ---- backward -------------------------------------------------------------------

struct BwdArgs {
  const void* dy;
  const void* x;
  const float* gamma;
  void* dx;
  float* partials;        // (blocks, 2, H): each block's dgamma, dbeta partials
  unsigned int* ticket;   // [2], zero between launches
  float* out;             // (2, H): dgamma, dbeta
  long long m;
  int h;
  float eps;
  float inv_h;            // f32(1 / f32(H))
  int slots;              // ring slots of a row group
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(cml_sm90::smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  // the ring's depth is a launch argument: wait_group takes an immediate
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the row group's totals of u and v (n = 1 or 2 of them), the same bits on
// every thread of the group: the warps' xor trees, then (G > 1) the warps'
// totals in warp order through red ([2 parities][2][G] floats of this
// group), behind one barrier of the group's warps; `parity` alternates
// from one call to the next, so a slot is never written while a warp may
// still read it
template <int G>
__device__ __forceinline__ void group_sum(float& u, float& v, int n, float* red, int parity, int group,
                                          int warp_in_group) {
  u = warp_sum(u);
  if (n > 1) v = warp_sum(v);
  if constexpr (G > 1) {
    float* r = red + parity * 2 * G;
    if (threadIdx.x % kWarp == 0) {
      r[warp_in_group] = u;
      r[G + warp_in_group] = v;
    }
    named_barrier(1 + group, kWarp * G);
    u = r[0];
    v = r[G];
#pragma unroll
    for (int w = 1; w < G; ++w) {
      u = add_ftz(u, r[w]);
      if (n > 1) v = add_ftz(v, r[G + w]);
    }
  }
}

template <typename TX, typename TD, int G>
__global__ void __launch_bounds__(kBwdThreads, 1) ln_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int ticket;
  constexpr int kGroups = kBwdWarps / G;
  constexpr int kT = kWarp * G;  // threads of a row group
  const int tid = threadIdx.x;
  const int group = tid / kT, gl = tid % kT, warp_in_group = gl / kWarp;
  const int h = a.h, nvec = h / kVec;
  const long long row_x = static_cast<long long>(h) * sizeof(TX);
  const long long slot_bytes = row_x + static_cast<long long>(h) * sizeof(TD);
  unsigned char* ring = smem + static_cast<long long>(group) * a.slots * slot_bytes;
  float* red = reinterpret_cast<float*>(smem + static_cast<long long>(kGroups) * a.slots * slot_bytes) +
               group * 4 * G;
  const TX* x = static_cast<const TX*>(a.x);
  const TD* dy = static_cast<const TD*>(a.dy);
  TX* dx = static_cast<TX*>(a.dx);

  bool active[kBwdNV];
  float gm[kBwdNV][kVec], pg[kBwdNV][kVec], pb[kBwdNV][kVec];
#pragma unroll
  for (int k = 0; k < kBwdNV; ++k) {
    active[k] = gl + kT * k < nvec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) gm[k][j] = pg[k][j] = pb[k][j] = 0.f;
    if (active[k]) load_param(a.gamma, (gl + kT * k) * kVec, gm[k]);
  }

  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  const long long first = static_cast<long long>(blockIdx.x) * kGroups + group;
  // row r of this group into ring slot `slot`: this thread's own vectors
  // of x and dy; always one commit group (empty past the last row)
  auto stage = [&](long long r, int slot) {
    if (r < a.m) {
      unsigned char* sx = ring + slot * slot_bytes;
      unsigned char* sd = sx + row_x;
#pragma unroll
      for (int k = 0; k < kBwdNV; ++k) {
        if (!active[k]) continue;
        const long long c0 = static_cast<long long>(gl + kT * k) * kVec;
#pragma unroll
        for (int q = 0; q < kVec * static_cast<int>(sizeof(TX)) / 16; ++q)
          cp_async16(sx + c0 * sizeof(TX) + 16 * q, reinterpret_cast<const unsigned char*>(x + r * h + c0) + 16 * q);
#pragma unroll
        for (int q = 0; q < kVec * static_cast<int>(sizeof(TD)) / 16; ++q)
          cp_async16(sd + c0 * sizeof(TD) + 16 * q, reinterpret_cast<const unsigned char*>(dy + r * h + c0) + 16 * q);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < a.slots; ++s) stage(first + s * stride, s);

  int parity = 0;
  int slot = 0;
  for (long long r = first; r < a.m; r += stride) {
    cp_async_wait_dyn(a.slots - 1);  // this thread's copies of row r have landed
    const unsigned char* sx = ring + slot * slot_bytes;
    const unsigned char* sd = sx + row_x;
    float v[kBwdNV][kVec], d[kBwdNV][kVec];
#pragma unroll
    for (int k = 0; k < kBwdNV; ++k) {
      if (active[k]) {
        const int c0 = (gl + kT * k) * kVec;
        load8(reinterpret_cast<const TX*>(sx) + c0, v[k]);
        load8(reinterpret_cast<const TD*>(sd) + c0, d[k]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[k][j] = d[k][j] = 0.f;
      }
    }
    // mean, then the variance of the centred row
    float s = 0.f, unused = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdNV; ++k)
#pragma unroll
      for (int j = 0; j < kVec; ++j) s = add_ftz(s, v[k][j]);
    group_sum<G>(s, unused, 1, red, parity, group, warp_in_group);
    parity ^= 1;
    const float mu = mul_ftz(s, a.inv_h);
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdNV; ++k)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[k][j] = active[k] ? sub_ftz(v[k][j], mu) : 0.f;
        q = add_ftz(q, mul_ftz(v[k][j], v[k][j]));
      }
    group_sum<G>(q, unused, 1, red, parity, group, warp_in_group);
    parity ^= 1;
    const float rsig = rsqrtf(mul_ftz(q, a.inv_h) + a.eps);
    // v becomes xhat; the row sums of g = dy * gamma and g * xhat
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdNV; ++k)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        v[k][j] = mul_ftz(v[k][j], rsig);
        const float g = mul_ftz(d[k][j], gm[k][j]);
        sa = add_ftz(sa, g);
        sb = add_ftz(sb, mul_ftz(g, v[k][j]));
      }
    group_sum<G>(sa, sb, 2, red, parity, group, warp_in_group);
    parity ^= 1;
    const float m1 = mul_ftz(sa, a.inv_h), m2 = mul_ftz(sb, a.inv_h);
#pragma unroll
    for (int k = 0; k < kBwdNV; ++k) {
      if (!active[k]) continue;
      float out[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g = mul_ftz(d[k][j], gm[k][j]);
        out[j] = mul_ftz(rsig, sub_ftz(sub_ftz(g, m1), mul_ftz(v[k][j], m2)));
        pg[k][j] = add_ftz(pg[k][j], mul_ftz(d[k][j], v[k][j]));
        pb[k][j] = add_ftz(pb[k][j], d[k][j]);
      }
      store8(dx + r * h + (gl + kT * k) * kVec, out);
    }
    // the slot's values are in registers and used: refill it
    stage(r + static_cast<long long>(a.slots) * stride, slot);
    slot = slot + 1 == a.slots ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // ---- the block's partials: its groups in order ----
  __syncthreads();  // every group is done with the ring
  float* part = reinterpret_cast<float*>(smem);  // [kGroups][2][H]
#pragma unroll
  for (int k = 0; k < kBwdNV; ++k) {
    if (!active[k]) continue;
    const int c0 = (gl + kT * k) * kVec;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      part[group * 2 * h + c0 + j] = pg[k][j];
      part[group * 2 * h + h + c0 + j] = pb[k][j];
    }
  }
  __syncthreads();
  float* mine = a.partials + static_cast<long long>(blockIdx.x) * 2 * h;
  for (int c = tid; c < 2 * h; c += kBwdThreads) {
    float t = part[c];
#pragma unroll
    for (int gi = 1; gi < kGroups; ++gi) t = add_ftz(t, part[gi * 2 * h + c]);
    mine[c] = t;
  }
  __threadfence();  // this block's partials are visible before its ticket
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(a.ticket, 1u);
  __syncthreads();

  // ---- the last F blocks fold every block's partials in block order ----
  const unsigned int nb = gridDim.x;
  const int tasks = (2 * h + kFoldSums - 1) / kFoldSums;
  const unsigned int nfold = min(nb, static_cast<unsigned int>(tasks));
  if (ticket < nb - nfold) return;
  const int f = static_cast<int>(ticket - (nb - nfold));
  if (tid == 0) {
    for (uint32_t polls = 0; ld_acquire(a.ticket) < nb; ++polls)
      if (polls == (1u << 26)) __trap();  // a block that never arrives: trap, do not hang the card
  }
  __syncthreads();
  float* fred = part;  // [kFoldParts][kFoldSums]
  const int lane = tid % kFoldSums, j = tid / kFoldSums;
  const unsigned int b0 = j * nb / kFoldParts, b1 = (j + 1) * nb / kFoldParts;
  for (int t = f; t < tasks; t += static_cast<int>(nfold)) {
    const int c = t * kFoldSums + lane;
    float acc = 0.f;
    if (c < 2 * h) {
#pragma unroll 8
      for (unsigned int b = b0; b < b1; ++b) acc = add_ftz(acc, __ldcg(a.partials + static_cast<long long>(b) * 2 * h + c));
    }
    fred[j * kFoldSums + lane] = acc;
    __syncthreads();
    if (tid < kFoldSums && c < 2 * h) {
      float total = fred[lane];
#pragma unroll
      for (int p = 1; p < kFoldParts; ++p) total = add_ftz(total, fred[p * kFoldSums + lane]);
      a.out[c] = total;
    }
    __syncthreads();
  }
  if (tid == 0) {  // the last folder to finish zeroes the ticket for the next launch
    __threadfence();
    if (atomicAdd(a.ticket + 1, 1u) == nfold - 1) {
      atomicExch(a.ticket, 0u);
      atomicExch(a.ticket + 1, 0u);
    }
  }
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
                float inv_h, cudaStream_t st) {
  const TX* xt = static_cast<const TX*>(x);
  TY* yt = static_cast<TY*>(y);
  const unsigned int grid = static_cast<unsigned int>(m);
  if (h <= 1024)
    ln_fwd_kernel<TX, TY, 1, 128><<<grid, 128, 0, st>>>(xt, gamma, beta, yt, h, eps, inv_h);
  else if (h <= 2048)
    ln_fwd_kernel<TX, TY, 1, 256><<<grid, 256, 0, st>>>(xt, gamma, beta, yt, h, eps, inv_h);
  else
    ln_fwd_kernel<TX, TY, 2, 256><<<grid, 256, 0, st>>>(xt, gamma, beta, yt, h, eps, inv_h);
}

long long bwd_smem_bytes(int g, int h, int slots, int x_elem, int dy_elem) {
  const long long groups = kBwdWarps / g;
  const long long ring = groups * slots * static_cast<long long>(h) * (x_elem + dy_elem);
  const long long part = groups * 2LL * h * 4;
  const long long fold = kFoldParts * kFoldSums * 4;
  long long most = ring > part ? ring : part;
  most = most > fold ? most : fold;
  return most + groups * 4LL * g * 4;
}

template <typename TX, typename TD, int G>
int launch_bwd_kernel(const BwdArgs& a, int blocks, long long smem, cudaStream_t st) {
  auto kernel = ln_bwd_kernel<TX, TD, G>;
  // per device, once: the attribute belongs to the current device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 0 && dev < 64) ready[dev] = true;
  }
  kernel<<<static_cast<unsigned int>(blocks), kBwdThreads, static_cast<size_t>(smem), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TD>
int launch_bwd(const BwdArgs& a, int g, int blocks, long long smem, cudaStream_t st) {
  if (g == 1) return launch_bwd_kernel<TX, TD, 1>(a, blocks, smem, st);
  if (g == 2) return launch_bwd_kernel<TX, TD, 2>(a, blocks, smem, st);
  return launch_bwd_kernel<TX, TD, 4>(a, blocks, smem, st);
}

}  // namespace

// Both return cudaGetLastError() after their launch (0 = launched), or
// cudaErrorInvalidValue without launching for what the kernels do not
// take: a dtype code other than 0 (f32) or 1 (bf16), M < 1, H not a
// multiple of 8 in [8, 4096], or (ln_bwd) a plan the kernel does not take.
// Every pointer must be 16-byte aligned (the Python wrappers check).
//
// cml_ln_bwd's plan (consensusml_tpu_torch/models/fused_ln.py:ln_bwd_plan):
// `group` warps a row (1, 2 or 4, with H <= 1024 * group), `blocks`
// blocks, `slots` ring slots a row group; it writes dgamma into out[0:H]
// and dbeta into out[H:2H]; partials is (blocks, 2, H) f32 scratch and
// ticket two uint32 that are zero before the launch and are left zero by
// it (one ticket per stream: launches on one stream run one at a time).

extern "C" int cml_ln_fwd(const void* x, int x_dtype, const void* gamma, const void* beta, void* y, int y_dtype,
                          long long m, int h, float eps, void* stream) {
  if (!valid(x_dtype, y_dtype, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  // the reference's mean as XLA compiles it: the sum times f32(1 / H)
  const float inv_h = static_cast<float>(1.0 / static_cast<double>(static_cast<float>(h)));
  if (x_dtype == kF32) {
    if (y_dtype == kF32) launch_fwd<float, float>(x, g, b, y, m, h, eps, inv_h, st);
    else launch_fwd<float, __nv_bfloat16>(x, g, b, y, m, h, eps, inv_h, st);
  } else {
    if (y_dtype == kF32) launch_fwd<__nv_bfloat16, float>(x, g, b, y, m, h, eps, inv_h, st);
    else launch_fwd<__nv_bfloat16, __nv_bfloat16>(x, g, b, y, m, h, eps, inv_h, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cml_ln_bwd(const void* dy, int dy_dtype, const void* x, int x_dtype, const void* gamma, void* dx,
                          long long m, int h, float eps, int group, int blocks, int slots, void* partials,
                          void* ticket, void* out, void* stream) {
  if (!valid(x_dtype, dy_dtype, m, h)) return static_cast<int>(cudaErrorInvalidValue);
  if ((group != 1 && group != 2 && group != 4) || h > 1024 * group || blocks < 1 || slots < 1 ||
      slots > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  const int x_elem = x_dtype == kF32 ? 4 : 2, dy_elem = dy_dtype == kF32 ? 4 : 2;
  const long long smem = bwd_smem_bytes(group, h, slots, x_elem, dy_elem);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{dy, x, static_cast<const float*>(gamma), dx, static_cast<float*>(partials),
            static_cast<unsigned int*>(ticket), static_cast<float*>(out), m, h, eps,
            static_cast<float>(1.0 / static_cast<double>(static_cast<float>(h))), slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return dy_dtype == kF32 ? launch_bwd<float, float>(a, group, blocks, smem, st)
                            : launch_bwd<float, __nv_bfloat16>(a, group, blocks, smem, st);
  return dy_dtype == kF32 ? launch_bwd<__nv_bfloat16, float>(a, group, blocks, smem, st)
                          : launch_bwd<__nv_bfloat16, __nv_bfloat16>(a, group, blocks, smem, st);
}
