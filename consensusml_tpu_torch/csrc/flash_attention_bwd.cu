// Flash-attention backward on Hopper's tensor cores, bf16 in / f32
// accumulators / bf16 out, head dim 64 or 128 (a template form each).
//
// Replaces: consensusml_tpu/models/flash_attention.py:_bwd_dq (pallas_call
// at :362, kernel body _bwd_dq_kernel at :223) and :_bwd_dkv (pallas_call
// at :400, kernel body _bwd_dkv_kernel at :277), the backward of the
// flash_attention custom VJP. Same math as the reference: the forward's
// per-row logsumexp is saved, so each tile recomputes
//   s  = (q . k) * scale,   p = exp(s - lse)  (0 where masked)
//   dp = do . v,            ds = p * (dp - delta)
// with delta = sum(do * o) per query row (computed by the caller in plain
// ops, as the reference does outside its kernels), then
//   dq = scale * sum_k ds k,   dk = scale * sum_q ds q,   dv = sum_q p do.
// (Causal) keys after the query are masked by absolute position, as the
// reference's q_pos >= k_pos mask does, and so are positions past the
// real length: keys in dq (the reference's k_local < s_real), queries in
// dk/dv (which writes no row of a key past it). Tiles wholly above the
// diagonal are skipped (the reference's nk_eff for dq and i0 for dk/dv).
//
// q/k offsets (the reference's q_offset, k_offset, _offsets_smem at :338,
// read by both kernel bodies): the absolute positions of query row 0 and
// key row 0, runtime arguments. The causal mask is q_off + query >= k_off
// + key, i.e. key > query + shift masked with shift = q_off - k_off, and
// the skips follow it: dq walks the key tiles up to the diagonal of its
// last row (none when that row is before key 0, and dq is then 0), dk/dv
// starts at the query tile of its first key's diagonal (past the last,
// and dk, dv are then 0). A skipped tile gives p = 0 to every pair, so
// the result is the reference's, which walks every block once offsets are
// given. A row that attends to no key (lse -1e30 from the forward) lies
// only in tiles that hold the diagonal, which mask per element: p = 0.
//
// kv_mask (the per-key padding mask, (B, S) f32, >0 = attend; nullptr for
// none) selects each kernel's kHasMask instantiation, so the no-mask form
// GPT-2 runs is the code it was. A masked key gets p = 0 by a select, as
// in the reference (flash_attention.py:257-260 for dq, :313-316 for
// dk/dv), never by a -1e30 score: a row that attends to no key has lse =
// -1e30 (the forward's), where exp2(s - lse) would be inf, and the select
// gives it no gradient, as the reference does. One mask row of S floats a
// batch, shared by the heads: dq stages the 64 floats of each key tile in
// a double-buffered shared array during the previous tile's products, as
// the forward does; dk/dv's keys are its resident rows, so each thread
// reads the mask of its two key rows once.
//
// Layout: q, k, v, do, dq, dk, dv are (B, S, H, D) contiguous, as the
// public function takes them (no fold/pad copy), read through 4-D TMA
// maps (D, H, S, B); lse and delta are (B, H, S) f32.
//
// What bounds it on the H100: operations. A causal head at S = 1024,
// D = 64 does three products of S^2/2 * D multiply-adds (s, dp, and dq) or
// four (s, dp, dk, dv), ~200-270 MFLOP against ~0.6 MB of operands. Both
// kernels run every product as wgmma m64n64k16 (bf16 in, f32
// accumulators) on tiles that TMA stages into 128-byte-swizzled shared
// memory (flash_sm90.cuh): one warpgroup of 128 threads per (64-row tile,
// batch*head), its own tiles loaded once, the other side's tiles of 64
// rows streaming through a two-stage mbarrier ring (thread 0 refills a
// stage as soon as every warp is done with it, so the next tile's copy
// overlaps this tile's math; several blocks share an SM). p and ds live
// on the accumulator layout in registers, masked per element only on the
// diagonal and ragged tail tiles, and enter the accumulating products as
// two bf16 halves, hi = bf16(x) and lo = bf16(x - hi). One bf16 rounding
// instead misses the gate these kernels are held to (atol 3e-3, rtol 2^-6
// against the plain f32 version, chip_smoke.py) in an f32 emulation of
// this rounding (tests/test_torch_flash_attention.py): ds by up to 1.7x
// for dq and 3.5x for dk, p by up to 2.2x for dv; split, the worst is 0.40
// of the gate.
//
// dq (flash_bwd_dq_kernel): the Q and dO tiles resident, K and V tiles
// streaming up to the diagonal. Per tile S = Q K^T and dP = dO V^T (both
// operands in shared memory, K-major), then dQ += dS K with dS from
// registers and K with the transpose bit.
//
// dk/dv (flash_bwd_dkv_kernel): the same skeleton turned round. The K and
// V tiles stay resident, and Q and dO tiles stream past them from the
// diagonal (causal) or the first tile to the last. The first two products
// are taken transposed, S^T = K Q^T and dP^T = V dO^T, so the accumulator
// rows are keys and its columns queries: dV += P^T dO and dK += dS^T Q
// reduce over the accumulator's columns, which makes P^T and dS^T their
// register A fragments as they stand (dO and Q enter with the transpose
// bit), with no transpose and no trip through shared memory. All four
// (P and dS as hi and lo) go out in one commit group. lse and delta now
// index columns, 16 of each a thread a tile: the 128 threads stage a
// tile's 64 + 64 values in shared memory, one plain load each, issued
// during the previous tile's products (a bulk copy would need S % 4 ==
// 0). Two live accumulators make it the heaviest kernel in registers: it
// is held to three blocks an SM (kDkvMinBlocks). No atomics: dq is its
// own kernel, and the backward is deterministic.
//
// Subnormals: the reference's compiled program flushes them (a subnormal
// operand reads as zero, a subnormal result is written as zero). The
// tensor cores take a bf16 subnormal operand as it is, so every staged
// tile (dq: the resident Q and dO, each stage's K and V; dk/dv: the
// resident K and V, each stage's Q and dO) is flushed in shared memory
// once, after its barrier and before its first product
// (flash_sm90.cuh:flush_staged_subnormals); K, which feeds both S = Q K^T
// and dQ += dS K, is flushed once a stage. The register operands: the
// reference multiplies p and ds in f32, its exp and product flushing a
// subnormal one to 0; so do these kernels (ftz after exp2f, the .ftz
// forms of ds = p * (dp - delta)), so hi = bf16(x) is never subnormal,
// while lo = bf16(x - hi) may be where x is normal and is kept, as the
// reference uses the whole normal x. Both kernels flush what they store,
// dq = scale * acc, dk = scale * acc and dv = acc, at the f32 -> bf16
// step (the .ftz multiply of flash_sm90.cuh:store_tile_bf16), as the
// plain version flushes its results.
//
// Head dim 128 (kD, Llama-2-7B's): each tile is two 64-dim atoms
// (flash_sm90.cuh), and S, dP (or S^T, dP^T) take eight k16 steps
// across both. dq keeps both halves of dQ in one block: two m64n64
// products a step, one an atom of K, into two 32-register accumulators
// that share dS's fragments (64 registers a thread). dk/dv cannot: dK and
// dV whole are 128 registers beside S^T, dP^T and their four bf16
// fragment sets, past the 255 a thread may hold. So each dk/dv block
// computes one 64-dim half of dK and dV (grid z = D / 64): it recomputes
// S^T and dP^T over all 128 dims, then takes its atom of Q and dO in the
// accumulating products. Its registers are the D = 64 form's; S^T and
// dP^T are done twice, 1.5x the form's tensor-core work, which a later
// design that shares them between two warpgroups would save. Shared
// memory: dq and dk/dv 32 KB resident + two 32 KB stages.

#include "flash_sm90.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace sm90 = cml_sm90;

constexpr int kDqStages = 2;
constexpr int kDqThreads = 128;
constexpr int kDkvStages = 2;

// one tile of the head-dim-kD form: 64 rows of kD dims
__host__ __device__ constexpr int tile_bytes(int kD) { return (kD / sm90::kAtomCols) * sm90::kTileBytes; }
// dq: Q and dO resident, kDqStages stages of K then V; + alignment slack
__host__ __device__ constexpr int dq_smem_bytes(int kD) { return 1024 + 2 * tile_bytes(kD) + kDqStages * 2 * tile_bytes(kD); }
// dk/dv: K and V resident, kDkvStages stages of Q then dO; + alignment slack
__host__ __device__ constexpr int dkv_smem_bytes(int kD) { return 1024 + 2 * tile_bytes(kD) + kDkvStages * 2 * tile_bytes(kD); }

template <int kD, bool kHasMask>
__global__ void __launch_bounds__(kDqThreads) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ dq, int S, int H, int causal, float scale, int shift) {
  using namespace cml_sm90;
  constexpr int kAtoms = kD / kAtomCols;
  constexpr int kTile = tile_bytes(kD);
  constexpr int kDqStageBytes = 2 * kTile;  // K then V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kDqStages + 1];  // one per stage, then Q and dO's
  // kHasMask: the kv_mask of a key tile, double-buffered (tile t in t & 1)
  __shared__ __align__(16) float smask[kHasMask ? 2 * kTileRows : 1];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sQ_ptr = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sDO = base + kTile;
  const uint32_t sKV = base + 2 * kTile;
  const uint32_t bar0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = (S + kTileRows - 1) / kTileRows;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kTileRows;
  int n_tiles = nq;
  if (causal) {  // skip the tiles after the diagonal of the tile's last row
    const int last = q0 + kTileRows - 1 + shift;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kTileRows + 1);
  }
  // kHasMask, thread tid < 64: key tid of tile t's mask (0 past S)
  auto load_mask = [&](int t) {
    const int key = t * kTileRows + tid;
    return key < S ? kv_mask[static_cast<size_t>(b) * S + key] : 0.f;
  };

  auto issue_kv = [&](int tile, int st) {
    const uint32_t bar = bar0 + 8 * st;
    const uint32_t dst = sKV + st * kDqStageBytes;
    mbar_expect_tx(bar, kDqStageBytes);
    tma_load_tile(dst, &tk, bar, h, tile * kTileRows, b, kAtoms);
    tma_load_tile(dst + kTile, &tv, bar, h, tile * kTileRows, b, kAtoms);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kDqStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  if (kHasMask && tid < kTileRows) smask[tid] = load_mask(0);
  __syncthreads();
  if (tid == 0) {
    const uint32_t qbar = bar0 + 8 * kDqStages;
    mbar_expect_tx(qbar, 2 * kTile);
    tma_load_tile(sQ, &tq, qbar, h, q0, b, kAtoms);
    tma_load_tile(sDO, &tdo, qbar, h, q0, b, kAtoms);
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
  // acc[a]: dQ's dims [64a, 64a + 64)
  float acc[kAtoms][32];
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  mbar_wait(bar0 + 8 * kDqStages, 0);
  flush_staged_subnormals(sQ_ptr, 2 * kAtoms);  // Q then dO

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kDqStages;
    const uint32_t sK = sKV + st * kDqStageBytes;
    const uint32_t sV = sK + kTile;
    mbar_wait(bar0 + 8 * st, (t / kDqStages) & 1);
    flush_staged_subnormals(smem_raw + (sK - raw), 2 * kAtoms);  // K then V

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4 * kAtoms; ++k) wgmma_ss(s, kmajor_desc(sQ, k), kmajor_desc(sK, k), k);
#pragma unroll
    for (int k = 0; k < 4 * kAtoms; ++k) wgmma_ss(dp, kmajor_desc(sDO, k), kmajor_desc(sV, k), k);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    const int k0 = t * kTileRows;
    const bool edge = kHasMask || k0 + kTileRows > S || (causal && k0 + kTileRows - 1 > q0 + shift);
    const float* const tmask = smask + (kHasMask ? (t & 1) * kTileRows : 0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float p = exp2f(s[e] * scale_log2 - lse2[i]);
          if (edge) {
            const int col = 8 * j + 2 * (lane % 4) + c;
            const int key = k0 + col;
            if (key >= S || (causal && key > row0 + 8 * i + shift) || (kHasMask && !(tmask[col] > 0.f))) p = 0.f;
          }
          s[e] = mul_ftz(p, sub_ftz(dp[e], dl[i]));  // ds; reads a subnormal p as 0
        }
      }
    }
    uint32_t dsh[4][4], dsl[4][4];
    split_hi_lo(s, dsh, dsl);

#pragma unroll
    for (int a = 0; a < kAtoms; ++a) pin(acc[a]);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(acc[a], dsh[k], mnmajor_desc(sK + a * kTileBytes, k));
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(acc[a], dsl[k], mnmajor_desc(sK + a * kTileBytes, k));
    }
    wgmma_commit();
    // the next tile's mask, in flight during these products
    const float next_mask = kHasMask && tid < kTileRows && t + 1 < n_tiles ? load_mask(t + 1) : 0.f;
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) pin(acc[a]);

    // nobody reads the other mask buffer until after the barrier below
    if (kHasMask && tid < kTileRows) smask[((t + 1) & 1) * kTileRows + tid] = next_mask;
    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && t + kDqStages < n_tiles) issue_kv(t + kDqStages, st);
  }

  // the Q tile is no longer read: stage dq there, an atom at a time
  const float mul[2] = {scale, scale};
  const size_t row_stride = static_cast<size_t>(H) * kD;
  __nv_bfloat16* const dst = dq + (static_cast<size_t>(b) * S + q0) * row_stride + static_cast<size_t>(h) * kD;
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
    store_tile_bf16(acc[a], mul, sQ_ptr + a * kTileBytes, dst + a * kAtomCols, row_stride,
                    min(kTileRows, S - q0), 1);
}

constexpr int kDkvThreads = 128;
// D = 64: three blocks an SM, at most 168 registers a thread (ptxas spills
// 16 bytes); left alone ptxas takes 174, which fits two blocks and runs
// ~21% longer (PERF.md). D = 128: its shared memory fits two blocks an SM,
// which leaves the registers free.
__host__ __device__ constexpr int dkv_min_blocks(int kD) { return kD == 64 ? 3 : 2; }

template <int kD, bool kHasMask>
__global__ void __launch_bounds__(kDkvThreads, dkv_min_blocks(kD)) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, const float* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H, int causal,
    float scale, int shift) {
  using namespace cml_sm90;
  constexpr int kAtoms = kD / kAtomCols;
  constexpr int kTile = tile_bytes(kD);
  constexpr int kDkvStageBytes = 2 * kTile;  // Q then dO
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kDkvStages + 1];  // one per stage, then K and V's
  // a query tile's lse * log2(e) (0-63) then delta (64-127), double-buffered
  __shared__ __align__(16) float stats[2][2 * kTileRows];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sK_ptr = smem_raw + (base - raw);
  const uint32_t sK = base;
  const uint32_t sV = base + kTile;
  const uint32_t sQDO = base + 2 * kTile;
  const uint32_t bar0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = (S + kTileRows - 1) / kTileRows;
  const int kt = blockIdx.x;  // causal: block 0 walks the most query tiles, and starts first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  // the dims [64 half, 64 half + 64) of dK and dV this block writes (D = 64: 0, a constant)
  const int half = kAtoms > 1 ? static_cast<int>(blockIdx.z) : 0;
  const int k0 = kt * kTileRows;
  // query tiles above the diagonal never see these keys: causal, the first
  // tile walked holds query k0 - shift (none past the last: dk, dv are 0)
  const int first = !causal || k0 - shift <= 0 ? 0 : min(nq, (k0 - shift) / kTileRows);
  const int n_tiles = nq - first;

  auto issue_qdo = [&](int i, int st) {
    const uint32_t bar = bar0 + 8 * st;
    const uint32_t dst = sQDO + st * kDkvStageBytes;
    mbar_expect_tx(bar, kDkvStageBytes);
    tma_load_tile(dst, &tq, bar, h, (first + i) * kTileRows, b, kAtoms);
    tma_load_tile(dst + kTile, &tdo, bar, h, (first + i) * kTileRows, b, kAtoms);
  };
  // this thread's entry of query tile i's stats (0 past S)
  auto load_stat = [&](int i) {
    const int q = (first + i) * kTileRows + tid % kTileRows;
    if (q >= S) return 0.f;
    const size_t r = static_cast<size_t>(bh) * S + q;
    return tid < kTileRows ? lse[r] * kLog2e : delta[r];
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kDkvStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  stats[0][tid] = load_stat(0);
  __syncthreads();
  if (tid == 0) {
    const uint32_t kvbar = bar0 + 8 * kDkvStages;
    mbar_expect_tx(kvbar, 2 * kTile);
    tma_load_tile(sK, &tk, kvbar, h, k0, b, kAtoms);
    tma_load_tile(sV, &tv, kvbar, h, k0, b, kAtoms);
    for (int i = 0; i < min(kDkvStages, n_tiles); ++i) issue_qdo(i, i);
  }

  const int key0 = k0 + 16 * warp + lane / 4;  // key row of accumulator half r = 0; +8 for r = 1
  const float scale_log2 = scale * kLog2e;
  // kHasMask: whether this thread's two key rows are attended to (not past S)
  bool keep[2] = {true, true};
  if (kHasMask) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      keep[r] = key < S && kv_mask[static_cast<size_t>(b) * S + key] > 0.f;
    }
  }
  float dka[32], dva[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
  mbar_wait(bar0 + 8 * kDkvStages, 0);
  flush_staged_subnormals(sK_ptr, 2 * kAtoms);  // K then V

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kDkvStages;
    const uint32_t sQ = sQDO + st * kDkvStageBytes;
    const uint32_t sDO = sQ + kTile;
    const int q0 = (first + i) * kTileRows;
    mbar_wait(bar0 + 8 * st, (i / kDkvStages) & 1);
    flush_staged_subnormals(smem_raw + (sQ - raw), 2 * kAtoms);  // Q then dO

    float s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
    pin(s);
    pin(dp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4 * kAtoms; ++k) wgmma_ss(s, kmajor_desc(sK, k), kmajor_desc(sQ, k), k);
#pragma unroll
    for (int k = 0; k < 4 * kAtoms; ++k) wgmma_ss(dp, kmajor_desc(sV, k), kmajor_desc(sDO, k), k);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // element 4j + 2r + c: key key0 + 8r, query q0 + 8j + 2(lane % 4) + c
    const bool edge = q0 + kTileRows > S || (causal && q0 + shift < k0 + kTileRows - 1);
    const float* const lse2 = stats[i & 1];
    const float* const dl = lse2 + kTileRows;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * r + c;
          float p = ftz(exp2f(s[e] * scale_log2 - (c ? l2.y : l2.x)));
          if (edge) {
            const int query = q0 + col + c;
            if (query >= S || (causal && query + shift < key0 + 8 * r)) p = 0.f;
          }
          if (kHasMask && !keep[r]) p = 0.f;
          s[e] = p;
          dp[e] = mul_ftz(p, sub_ftz(dp[e], c ? d2.y : d2.x));  // ds
        }
      }
    }
    uint32_t ph[4][4], pl[4][4], dsh[4][4], dsl[4][4];
    split_hi_lo(s, ph, pl);
    split_hi_lo(dp, dsh, dsl);

    // this block's atom of dO and of Q
    const uint32_t sDOh = sDO + half * kTileBytes, sQh = sQ + half * kTileBytes;
    pin(dka);
    pin(dva);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(dva, ph[k], mnmajor_desc(sDOh, k));
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(dva, pl[k], mnmajor_desc(sDOh, k));
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(dka, dsh[k], mnmajor_desc(sQh, k));
#pragma unroll
    for (int k = 0; k < 4; ++k) wgmma_rs_mn(dka, dsl[k], mnmajor_desc(sQh, k));
    wgmma_commit();
    // the next tile's stats, in flight during these products (s and dp are dead)
    const float next = i + 1 < n_tiles ? load_stat(i + 1) : 0.f;
    wgmma_wait_all();
    pin(dka);
    pin(dva);

    // nobody reads the other stats buffer until after the barrier below
    stats[(i + 1) & 1][tid] = next;
    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && i + kDkvStages < n_tiles) issue_qdo(i + kDkvStages, st);
  }

  // the K and V tiles are no longer read: stage dk and dv in their first
  // two atoms
  const size_t row_stride = static_cast<size_t>(H) * kD;
  const size_t off = (static_cast<size_t>(b) * S + k0) * row_stride + static_cast<size_t>(h) * kD +
                     static_cast<size_t>(half) * kAtomCols;
  const int n_rows = min(kTileRows, S - k0);
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_tile_bf16(dka, mul_k, sK_ptr, dk + off, row_stride, n_rows, 1);
  store_tile_bf16(dva, mul_v, sK_ptr + kTileBytes, dv + off, row_stride, n_rows, 1);
}

// the four tensor maps of q, k, v, do; 0 or a CUDA error code
int encode_qkvdo(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                 const void* dout, int B, int S, int H, int D) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int rc = sm90::encode_bshd(&m[i], ptrs[i], B, S, H, D, sm90::kTileRows);
    if (rc != 0) return rc;
  }
  return 0;
}

template <int kD, bool kHasMask>
int launch_dq(const CUtensorMap (&m)[4], const float* lse, const float* delta, const float* kv_mask,
              void* dq, int B, int S, int H, int causal, float scale, int shift, void* stream) {
  // per launch: the attribute belongs to the current device
  constexpr int kDqSmemBytes = dq_smem_bytes(kD);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<kD, kHasMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + sm90::kTileRows - 1) / sm90::kTileRows, B * H);
  flash_bwd_dq_kernel<kD, kHasMask><<<grid, kDqThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], lse, delta, kv_mask, static_cast<__nv_bfloat16*>(dq), S, H, causal, scale, shift);
  return static_cast<int>(cudaGetLastError());
}

template <int kD, bool kHasMask>
int launch_dkv(const CUtensorMap (&m)[4], const float* lse, const float* delta, const float* kv_mask,
               void* dk, void* dv, int B, int S, int H, int causal, float scale, int shift, void* stream) {
  // per launch: the attribute belongs to the current device
  constexpr int kDkvSmemBytes = dkv_smem_bytes(kD);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<kD, kHasMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // z: the 64-dim halves of dK and dV (one at D = 64)
  dim3 grid((S + sm90::kTileRows - 1) / sm90::kTileRows, B * H, kD / sm90::kAtomCols);
  flash_bwd_dkv_kernel<kD, kHasMask><<<grid, kDkvThreads, kDkvSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], lse, delta, kv_mask, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, causal, scale, shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int kD>
int launch_dq_masked_or_not(const CUtensorMap (&m)[4], const float* lse, const float* delta,
                            const float* mask, void* dq, int B, int S, int H, int causal, float scale,
                            int shift, void* stream) {
  return mask != nullptr ? launch_dq<kD, true>(m, lse, delta, mask, dq, B, S, H, causal, scale, shift, stream)
                         : launch_dq<kD, false>(m, lse, delta, mask, dq, B, S, H, causal, scale, shift, stream);
}

template <int kD>
int launch_dkv_masked_or_not(const CUtensorMap (&m)[4], const float* lse, const float* delta,
                             const float* mask, void* dk, void* dv, int B, int S, int H, int causal,
                             float scale, int shift, void* stream) {
  return mask != nullptr
             ? launch_dkv<kD, true>(m, lse, delta, mask, dk, dv, B, S, H, causal, scale, shift, stream)
             : launch_dkv<kD, false>(m, lse, delta, mask, dk, dv, B, S, H, causal, scale, shift, stream);
}

// Both return 0 once launched, else a CUDA error code: without launching,
// cudaErrorInvalidValue for a head dim other than 64 and 128 or a tensor
// map the driver refuses (e.g. a base address not 16-byte aligned); after
// the launch, cudaGetLastError(). kv_mask: nullptr, or (B, S) f32.
// q_offset, k_offset: the absolute positions of query and key row 0 (both
// 0 in the reference's aligned form).
extern "C" int cml_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse, const void* delta,
                                               const void* kv_mask, void* dq, int B, int S, int H,
                                               int D, int causal, float scale, int q_offset,
                                               int k_offset, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  const int rc = encode_qkvdo(m, q, k, v, dout, B, S, H, D);
  if (rc != 0) return rc;
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  const float* mask = static_cast<const float*>(kv_mask);
  const int shift = q_offset - k_offset;
  return D == 64 ? launch_dq_masked_or_not<64>(m, l, dl, mask, dq, B, S, H, causal, scale, shift, stream)
                 : launch_dq_masked_or_not<128>(m, l, dl, mask, dq, B, S, H, causal, scale, shift, stream);
}

extern "C" int cml_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, const void* kv_mask, void* dk,
                                                void* dv, int B, int S, int H, int D, int causal,
                                                float scale, int q_offset, int k_offset, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[4];
  const int rc = encode_qkvdo(m, q, k, v, dout, B, S, H, D);
  if (rc != 0) return rc;
  const float *l = static_cast<const float*>(lse), *dl = static_cast<const float*>(delta);
  const float* mask = static_cast<const float*>(kv_mask);
  const int shift = q_offset - k_offset;
  return D == 64 ? launch_dkv_masked_or_not<64>(m, l, dl, mask, dk, dv, B, S, H, causal, scale, shift, stream)
                 : launch_dkv_masked_or_not<128>(m, l, dl, mask, dk, dv, B, S, H, causal, scale, shift, stream);
}
