// Hopper (sm_90a) building blocks shared by the flash, fused-BN and paged
// attention kernels: TMA tile and bulk loads completed on mbarriers,
// thread block clusters (barriers, distributed shared memory), warpgroup
// matrix multiplies (wgmma) on 128-byte-swizzled shared-memory tiles, and
// the host-side tensor maps over a (B, S, H, D) bf16 tensor, D = 64 or 128.
//
// Tiles. Every tile is 64 rows (query or key positions) of one head's D
// dims, held as D / 64 atoms of 64 dims: an atom is 64 rows of 128
// bytes, 8 KB, written by TMA with the 128-byte swizzle (16-byte chunk c
// of row r lands at chunk c ^ (r % 8)), at a 1024-byte-aligned address;
// the swizzle spans one 128-byte row, so a 128-wide row is two atoms,
// dims [64a, 64a + 64) in atom a, the atoms back to back. Rows past S
// read as zeros (TMA's out-of-bounds fill), which covers the ragged tail.
//
// Products (m64n64k16, bf16 in, f32 accumulators). Each warpgroup of 128
// threads owns 64 rows. Thread t of the warpgroup (warp w = t / 32, lane
// l = t % 32) holds accumulator element d[4j + 2i + c] at row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c. Columns [16k, 16k+16) of an
// accumulator are exactly the A-register fragment of one k16 step:
// a_k[r] = bf16x2(d[8k + 2r], d[8k + 2r + 1]) (FA3's identity), so a
// probability tile goes from the first product to the second without
// touching shared memory.
//
// A tile as operand. Rows x dims with the dims contiguous is "K-major"
// when the dims are the reduction (S = Q K^T: Q and K; dP = dO V^T: dO
// and V; dk/dv's S^T = K Q^T and dP^T = V dO^T likewise): descriptor
// start + 32 bytes per k16 step within an atom, the next atom after four
// steps (D / 16 steps in all), 1024 bytes between groups of 8 rows. The
// same tile is "MN-major" (transpose bit) when the rows are the reduction
// (O += P V, dQ += dS K, dV += P^T dO, dK += dS^T Q): each atom is the B
// operand of its own m64n64 product, its 64 dims the N columns of one
// accumulator: start + 2048 bytes (16 rows) per k16 step, 1024 bytes
// between groups of 8 reduction rows.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace cml_sm90 {

constexpr int kAtomCols = 64;       // dims of one swizzle atom: one 128-byte bf16 row
constexpr int kTileRows = 64;       // rows of a staged tile and of a warpgroup's block
constexpr int kTileBytes = kTileRows * kAtomCols * 2;  // one atom of a tile, 8 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

// f32 a * b, a + b, a - b rounded to nearest even, a subnormal operand
// read and a subnormal result written as a zero of its sign (the PTX
// instructions' .ftz forms): the reference's compiled program runs with
// flush-to-zero and denormals-are-zero
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

// x, or a zero of its sign where x is subnormal
__device__ __forceinline__ float ftz(float x) { return mul_ftz(x, 1.f); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// spin until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// spin until the barrier's phase with this parity has completed; a phase
// that never completes (a copy the barrier was not credited for) traps
// after 2^26 polls instead of hanging the card
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// ---- subnormal operands ---------------------------------------------------

// two bf16 with every subnormal (exponent field 0) turned into a zero of its sign
__device__ __forceinline__ uint32_t daz_bf16x2(uint32_t w) {
  return w & (__vcmpne2(w & 0x7F807F80u, 0u) | 0x80008000u);
}

// The reference's compiled program reads a subnormal operand as zero; the
// tensor cores take a bf16 subnormal as it is. So every tile that TMA
// stages for a product is flushed once, after its barrier and before its
// first wgmma: `n_tiles` consecutive 8 KB atoms at `tiles`, element-wise
// over 16-byte chunks (the swizzle only permutes chunks), each of the
// block's 128 threads taking every 128th chunk and writing back only a
// chunk that changed. The generic-proxy writes are then fenced for the
// async proxy (the wgmma that reads the tiles and the TMA load that
// later refills them) and the block synchronises; every caller runs one
// warpgroup a block. The pass costs shared-memory bandwidth, which these
// products are bound by (an m64n64 wgmma with both operands in shared
// memory reads ~32 KB a tile; the pass reads 16 KB more): overlapping it
// with the products instead saved nothing (PERF.md).
__device__ __forceinline__ void flush_staged_subnormals(uint8_t* tiles, int n_tiles) {
  uint4* const p = reinterpret_cast<uint4*>(tiles);
  const int n = n_tiles * kTileBytes / 16;
  for (int c = threadIdx.x; c < n; c += 128) {
    const uint4 v = p[c];
    const uint4 f = make_uint4(daz_bf16x2(v.x), daz_bf16x2(v.y), daz_bf16x2(v.z), daz_bf16x2(v.w));
    if (f.x != v.x || f.y != v.y || f.z != v.z || f.w != v.w) p[c] = f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// ---- thread block clusters --------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the same shared-memory word of block `rank` of this cluster
__device__ __forceinline__ float ld_cluster(uint32_t local, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}
__device__ __forceinline__ double ld_cluster_f64(uint32_t local, uint32_t rank) {
  uint32_t remote;
  double v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f64 %0, [%1];" : "=d"(v) : "r"(remote) : "memory");
  return v;
}

// ---- TMA ------------------------------------------------------------------

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned) as one bulk copy; completion (bytes) is reported to `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of the 4-D map (D, H, S, B) at (col, h, row, b) into shared
// memory: one atom; completion (bytes) is reported to `bar`
__device__ __forceinline__ void tma_load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int h, int row, int b, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

// the whole tile of rows [row, row + 64) of head h, batch b: its `atoms`
// atoms, one box each, back to back from `dst` (atoms * kTileBytes bytes)
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                              int h, int row, int b, int atoms) {
  for (int a = 0; a < atoms; ++a) tma_load_rows(dst + a * kTileBytes, map, bar, h, row, b, a * kAtomCols);
}

// ---- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator registers across an issue/wait
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// k16 step `k` of a tile whose dims are the reduction: dims [16k, 16k + 16),
// in atom k / 4
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  return smem_desc(tile + (k / 4) * kTileBytes + 32 * (k % 4), 16, 1024);
}
// k16 step `k` of an atom whose rows are the reduction
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int k) {
  return smem_desc(tile + 2048 * k, kTileBytes, 1024);
}

#define CML_WGMMA_D32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define CML_WGMMA_D32_OPERANDS                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31])

// d (+)= A B, A and B both in shared memory, both K-major; accumulate = 0
// overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CML_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : CML_WGMMA_D32_OPERANDS
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, A from registers (bf16x2 fragment), B in shared memory MN-major
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " CML_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : CML_WGMMA_D32_OPERANDS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef CML_WGMMA_D32
#undef CML_WGMMA_D32_OPERANDS

// the 64 x 64 f32 tile x (accumulator layout) as two bf16 A fragments per
// k16 step, x = hi + lo to ~2^-16: hi = bf16(x), lo = bf16(x - hi) (x - hi
// is exact in f32). Where x is normal, hi is normal too (bf16 and f32
// share their exponent range); lo may be subnormal, and is kept.
__device__ __forceinline__ void split_hi_lo(const float (&x)[32], uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * k + 2 * r], x1 = x[8 * k + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      hi[k][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[k][r] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// Write a warpgroup's 64 x 64 f32 accumulator tile, times mul[i] for its
// row half i, as bf16 rows [0, n_rows) of 64 dims of one head of a (B, S,
// H, D) tensor starting at `dst` (row stride `row_stride` elements),
// staging it in the 8 KB shared atom `stage` (swizzled: conflict-free writes) so
// that each thread stores whole 16-byte chunks. The caller's barrier
// `bar_id` syncs the warpgroup's 128 threads.
__device__ __forceinline__ void store_tile_bf16(const float (&d)[32], const float (&mul)[2],
                                                uint8_t* stage, __nv_bfloat16* __restrict__ dst,
                                                size_t row_stride, int n_rows, int bar_id) {
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + lane / 4 + 8 * i;
      const int off = r * 128 + ((j ^ (r & 7)) << 4) + (lane % 4) * 4;
      *reinterpret_cast<__nv_bfloat162*>(stage + off) =
          __floats2bfloat162_rn(mul_ftz(d[4 * j + 2 * i], mul[i]), mul_ftz(d[4 * j + 2 * i + 1], mul[i]));
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
#pragma unroll
  for (int it = 0; it < kTileRows * 8 / 128; ++it) {
    const int c = t + 128 * it;
    const int r = c / 8, ch = c % 8;
    if (r < n_rows) {
      const uint4 v = *reinterpret_cast<const uint4*>(stage + r * 128 + ((ch ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(dst + r * row_stride + ch * 8) = v;
    }
  }
}

// ---- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already loaded, so
// the library needs no link against libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A map over a contiguous (B, S, H, D) bf16 tensor as the 4-D box grid
// (D, H, S, B), box (64, 1, box_rows, 1): one atom, 128-byte swizzle,
// zero fill past the edges. Returns 0, or a CUDA runtime error code.
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kAtomCols), 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cml_sm90
