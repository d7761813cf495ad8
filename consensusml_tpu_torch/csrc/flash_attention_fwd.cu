// Flash-attention forward on Hopper's tensor cores, bf16 in / f32
// accumulators / bf16 out, head dim 64 or 128 (a template form each).
//
// Replaces: consensusml_tpu/models/flash_attention.py:_fwd (pallas_call at
// :193, kernel body _fwd_kernel at :73), reached through flash_attention
// (:478). Same function as the reference: logits q.k scaled by 1/sqrt(D),
// keys past the real length and (causal) above the diagonal masked out,
// online softmax with a running row max m and row sum l over key tiles,
// out = acc / max(l, 1e-30), and the per-row logsumexp m + log(l) saved
// for the backward. Tiles wholly above the diagonal are skipped, as the
// reference's nk_eff does.
//
// q/k offsets (the reference's q_offset, k_offset: _offsets_smem at :338,
// read by _fwd_kernel's q_pos and koff): the absolute positions of query
// row 0 and key row 0, runtime arguments, so one instantiation serves
// every block of a ring (parallel/ring_attention.py). The causal mask is
// then q_off + row >= k_off + key, i.e. key > row + shift is masked, with
// shift = q_off - k_off (0 in the aligned form). As in the reference, a
// call given offsets is not "aligned": every masked key scores -1e30
// (kMaskedScore) and a row that attends to no key (a whole block of keys
// after its query, under a causal ring) gets the sum of the values over
// the reference's visited count, which is then every key of the padded
// sequence, ceil(S / 512) * 512, and lse -1e30; a ring's logsumexp merge
// weighs such a block by exp(-1e30 - m) = 0. The reference walks every
// key block then; this kernel skips the tiles after the diagonal of the
// query tile's last row whenever its first row sees key 0 (so no row of
// the tile is empty, and the skipped keys would give p = 0 to every row),
// and walks them all otherwise. With kv_mask and offsets it walks every
// tile (an empty row can then be anywhere).
//
// kv_mask (the per-key padding mask, (B, S) f32, >0 = attend; nullptr for
// none) selects the kHasMask instantiation, so the no-mask form GPT-2 runs
// is the code it was. One row of S floats a batch, shared by the H heads
// (the reference repeats it per head on the host, :159): thread t < 64
// loads key t of the next tile's row into a double-buffered shared array
// while the current tile's P V products run, as the dk/dv kernel stages
// its lse and delta. In this form every masked key (kv_mask, causal,
// past S) scores -1e30, the reference's _NEG_INF, not -inf, which is what
// a row that attends to no key needs: its running max stays at -1e30, so
// every visited key gets p = exp2(0) = 1 and the accumulator holds the
// sum of their values, as in the reference. That row's out is then that
// sum over the reference's count of visited keys (flash_attention.py:
// 124-134 with its 512-key blocks: ceil(S / 512) * 512, or under causal
// 512 * (row / 512 + 1), padding included; flash_attention_plain
// documents it), and its lse is -1e30. Under causal the kernel walks the
// key tiles up to the end of the row's 512-key block, not only to the
// diagonal, so that the sum covers the keys the reference visits; the
// tiles past the diagonal give every other row p = exp2(-1e30 - m) = 0.
//
// Head dim 128 (kD, Llama-2-7B's) is the same kernel with each tile two
// 64-dim atoms (flash_sm90.cuh): S = Q K^T takes eight k16 steps across
// both atoms, and O = P V is two m64n64 products, one an atom of V, into
// two 32-register accumulators (64 a thread), which share P's fragments.
// Shared memory grows to Q 16 KB + two stages of K and V at 32 KB.
//
// Layout: q, k, v, out are (B, S, H, D) contiguous, as the public function
// takes them (no fold/pad copy), read through 4-D TMA maps (D, H, S, B);
// lse is (B, H, S) f32.
//
// What bounds it on the H100: operations, on the tensor cores. At S =
// 1024, D = 64 a causal head does 2 * 2 * S^2/2 * D = 134 MFLOP against
// 0.5 MB of q/k/v/out, ~256 flop/byte, near the bf16 ridge (~295). So both
// products run as wgmma (flash_sm90.cuh): one block of one warpgroup per
// (64-query tile, batch*head), its Q tile loaded once by TMA, K and V
// tiles of 64 keys streaming through a two-stage ring of swizzled shared
// memory (thread 0 issues each load as soon as its stage is free, so the
// next tile's copy overlaps this tile's math; several blocks share an SM).
// S = Q K^T is one m64n64 product over four k16 steps, both operands in
// shared memory. The online softmax runs in registers on the accumulator
// layout (quad shuffles for the row max; l is kept per thread and summed
// once at the end). Masking is per element only on the diagonal tile and
// the ragged tail tile: masked logits are -inf, so their probabilities are
// exactly 0. O += P V takes P from registers (the accumulator fragment is
// the A fragment) and V with the transpose bit.
//
// P in two bf16 halves. The tensor cores multiply bf16, and one bf16
// rounding of P (FA2/FA3's choice) moves outputs by 2.9-15x the gate this
// kernel is held to (atol 1e-4, rtol 2^-6 against the plain f32 version,
// chip_smoke.py), worst on short rows with small |o|; TF32 P misses it
// too. So P = hi + lo with hi = bf16(p), lo = bf16(p - hi), and O += hi V
// + lo V in one f32 accumulator: within 0.49 of the gate in an f32
// emulation of this rounding (tests/test_torch_flash_attention.py), at
// 1.5x the tensor-core work of one bf16 product.
//
// Subnormals: the reference's compiled program flushes them (a subnormal
// operand reads as zero, a subnormal result is written as zero). The
// tensor cores take a bf16 subnormal operand as it is, so the Q tile and
// each stage's K and V tiles are flushed in shared memory once, after
// their barrier and before their first product
// (flash_sm90.cuh:flush_staged_subnormals): q at 1e-39 against k at 1e38,
// whose products are normal, reads as q = 0, as in the reference. The
// reference multiplies P in f32, its exp flushing a subnormal p (and the
// rescale factor) to 0: so does this kernel (ftz after exp2f), and hi =
// bf16(p) is then never subnormal; lo = bf16(p - hi) may be where p is
// normal, and is kept, as the reference uses the whole normal p. The
// epilogue flushes what this kernel stores (out = acc * (1 / l) and the
// lse, with the .ftz forms), as the plain version flushes its results.

#include "flash_sm90.cuh"

namespace {

using namespace cml_sm90;

constexpr int kBQ = kTileRows;  // query rows of a block: one warpgroup
constexpr int kBK = kTileRows;  // keys of a streamed tile
constexpr int kRefBlock = 512;  // the reference kernel's key block (_BK), which fixes its visited keys
constexpr float kMaskedScore = -1e30f;  // the reference's _NEG_INF, in log2 units here
constexpr int kStages = 2;
constexpr int kThreads = 128;

// the shared memory of the head-dim-kD form: the Q tile, then kStages
// stages of a K and a V tile (each tile kD / 64 atoms), + alignment slack
__host__ __device__ constexpr int smem_bytes(int kD) { return 1024 + (kD / kAtomCols) * kTileBytes * (1 + 2 * kStages); }

template <int kD, bool kHasMask>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ kv_mask,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int H, int causal,
    float scale_log2, int shift, int aligned) {
  constexpr int kAtoms = kD / kAtomCols;
  constexpr int kTile = kAtoms * kTileBytes;  // one tile: 64 rows of kD dims
  constexpr int kStageBytes = 2 * kTile;      // K then V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[kStages + 1];  // one per stage, then Q's
  // kHasMask: the kv_mask of a key tile, double-buffered (tile t in t & 1)
  __shared__ __align__(16) float smask[kHasMask ? 2 * kBK : 1];

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sQ_ptr = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sKV = base + kTile;
  const uint32_t bar0 = smem_u32(bars);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x);  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = qt * kBQ;
  int n_tiles = (S + kBK - 1) / kBK;
  // skip tiles above the diagonal; with a mask, those past the row's
  // 512-key block of the reference (see above); with offsets, those past
  // the last row's diagonal when no row of the tile is empty
  if (causal && aligned)
    n_tiles = min(n_tiles, kHasMask ? (q0 / kRefBlock + 1) * (kRefBlock / kBK) : (q0 + kBQ - 1) / kBK + 1);
  else if (causal && !kHasMask && q0 + shift >= 0)
    n_tiles = min(n_tiles, (q0 + kBQ - 1 + shift) / kBK + 1);
  // the score of a masked key: -1e30 where a row may attend to no key
  const float masked = kHasMask || !aligned ? kMaskedScore : neg_inf();
  // kHasMask, thread tid < kBK: key tid of tile t's mask (0 past S)
  auto load_mask = [&](int t) {
    const int key = t * kBK + tid;
    return key < S ? kv_mask[static_cast<size_t>(b) * S + key] : 0.f;
  };

  auto issue_kv = [&](int tile, int st) {
    const uint32_t bar = bar0 + 8 * st;
    const uint32_t dst = sKV + st * kStageBytes;
    mbar_expect_tx(bar, kStageBytes);
    tma_load_tile(dst, &tk, bar, h, tile * kBK, b, kAtoms);
    tma_load_tile(dst + kTile, &tv, bar, h, tile * kBK, b, kAtoms);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= kStages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init_fence();
  }
  if (kHasMask && tid < kBK) smask[tid] = load_mask(0);
  __syncthreads();
  if (tid == 0) {
    const uint32_t qbar = bar0 + 8 * kStages;
    mbar_expect_tx(qbar, kTile);
    tma_load_tile(sQ, &tq, qbar, h, q0, b, kAtoms);
    for (int t = 0; t < min(kStages, n_tiles); ++t) issue_kv(t, t);
  }

  const int row0 = q0 + 16 * warp + lane / 4;  // query row of accumulator half i = 0; +8 for i = 1
  // o[a]: the output's dims [64a, 64a + 64)
  float o[kAtoms][32], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
  mbar_wait(bar0 + 8 * kStages, 0);
  flush_staged_subnormals(sQ_ptr, kAtoms);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t sK = sKV + st * kStageBytes;
    const uint32_t sV = sK + kTile;
    mbar_wait(bar0 + 8 * st, (t / kStages) & 1);
    flush_staged_subnormals(smem_raw + (sK - raw), 2 * kAtoms);  // K then V

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4 * kAtoms; ++k) wgmma_ss(s, kmajor_desc(sQ, k), kmajor_desc(sK, k), k);
    wgmma_commit();
    wgmma_wait_all();
    pin(s);

    const int k0 = t * kBK;
    const bool edge = kHasMask || k0 + kBK > S || (causal && k0 + kBK - 1 > q0 + shift);
    const float* const tmask = smask + (kHasMask ? (t & 1) * kBK : 0);
    float mx[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[4 * j + 2 * i + c] * scale_log2;
          if (edge) {
            const int col = 8 * j + 2 * (lane % 4) + c;
            const int key = k0 + col;
            if (key >= S || (causal && key > row0 + 8 * i + shift) || (kHasMask && !(tmask[col] > 0.f)))
              x = masked;
          }
          s[4 * j + 2 * i + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = ftz(exp2f(m[i] - m_new));
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          // masked: exp2(-inf) = 0, or exp2(-1e30 - m) = 0 unless m is -1e30 too
          const float p = ftz(exp2f(s[4 * j + 2 * i + c] - m[i]));
          s[4 * j + 2 * i + c] = p;
          l[i] += p;
#pragma unroll
          for (int a = 0; a < kAtoms; ++a) o[a][4 * j + 2 * i + c] *= corr[i];
        }
      }
    }
    uint32_t ph[4][4], pl[4][4];
    split_hi_lo(s, ph, pl);

#pragma unroll
    for (int a = 0; a < kAtoms; ++a) pin(o[a]);
    wgmma_fence();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) {
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(o[a], ph[k], mnmajor_desc(sV + a * kTileBytes, k));
#pragma unroll
      for (int k = 0; k < 4; ++k) wgmma_rs_mn(o[a], pl[k], mnmajor_desc(sV + a * kTileBytes, k));
    }
    wgmma_commit();
    // the next tile's mask, in flight during these products
    const float next_mask = kHasMask && tid < kBK && t + 1 < n_tiles ? load_mask(t + 1) : 0.f;
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < kAtoms; ++a) pin(o[a]);

    // nobody reads the other mask buffer until after the barrier below
    if (kHasMask && tid < kBK) smask[((t + 1) & 1) * kBK + tid] = next_mask;
    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && t + kStages < n_tiles) issue_kv(t + kStages, st);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = row0 + 8 * i;
    // a row that attends to no key: the reference's count of visited keys
    const bool empty = (kHasMask || !aligned) && m[i] == kMaskedScore;
    const int visited =
        causal && aligned ? kRefBlock * (qi / kRefBlock + 1) : kRefBlock * ((S + kRefBlock - 1) / kRefBlock);
    const float l_safe = empty ? static_cast<float>(visited) : fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l_safe;
    if (lse != nullptr && lane % 4 == 0 && qi < S)
      lse[static_cast<size_t>(bh) * S + qi] =
          empty ? kMaskedScore : mul_ftz(add_ftz(m[i], log2f(l_safe)), kLn2);
  }
  // the Q tile is no longer read: stage the output there, an atom at a time
  const size_t row_stride = static_cast<size_t>(H) * kD;
  __nv_bfloat16* const dst = out + (static_cast<size_t>(b) * S + q0) * row_stride + static_cast<size_t>(h) * kD;
#pragma unroll
  for (int a = 0; a < kAtoms; ++a)
    store_tile_bf16(o[a], inv, sQ_ptr + a * kTileBytes, dst + a * kAtomCols, row_stride, min(kBQ, S - q0), 1);
}

template <int kD, bool kHasMask>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const float* kv_mask, void* out, void* lse, int B, int S, int H, int causal,
               float scale, int shift, int aligned, void* stream) {
  // per launch: the attribute belongs to the current device
  constexpr int kSmemBytes = smem_bytes(kD);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<kD, kHasMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<kD, kHasMask><<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, kv_mask, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S, H, causal,
      scale * kLog2e, shift, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

template <int kD>
int launch_fwd_masked_or_not(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                             const float* mask, void* out, void* lse, int B, int S, int H, int causal,
                             float scale, int shift, int aligned, void* stream) {
  return mask != nullptr
             ? launch_fwd<kD, true>(tq, tk, tv, mask, out, lse, B, S, H, causal, scale, shift, aligned, stream)
             : launch_fwd<kD, false>(tq, tk, tv, mask, out, lse, B, S, H, causal, scale, shift, aligned, stream);
}

// Returns 0 once launched, else a CUDA error code without launching:
// cudaErrorInvalidValue for a head dim other than 64 and 128 or a tensor
// map the driver refuses (e.g. a base address not 16-byte aligned); then
// cudaGetLastError() after the launch. kv_mask: nullptr, or (B, S) f32.
// q_offset, k_offset: the absolute positions of query and key row 0;
// aligned: 1 for the reference's call without offsets (both then 0).
extern "C" int cml_flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                            const void* kv_mask, void* out, void* lse, int B,
                                            int S, int H, int D, int causal, float scale,
                                            int q_offset, int k_offset, int aligned, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = encode_bshd(&tq, q, B, S, H, D, kBQ);
  if (rc == 0) rc = encode_bshd(&tk, k, B, S, H, D, kTileRows);
  if (rc == 0) rc = encode_bshd(&tv, v, B, S, H, D, kTileRows);
  if (rc != 0) return rc;
  const float* mask = static_cast<const float*>(kv_mask);
  const int shift = q_offset - k_offset;
  return D == 64
             ? launch_fwd_masked_or_not<64>(tq, tk, tv, mask, out, lse, B, S, H, causal, scale, shift, aligned, stream)
             : launch_fwd_masked_or_not<128>(tq, tk, tv, mask, out, lse, B, S, H, causal, scale, shift, aligned,
                                             stream);
}
