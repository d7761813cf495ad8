// Fused paged attention for the serving decode step (and its W-token
// window), bf16 in / f32 math / bf16 out.
//
// Replaces: consensusml_tpu/models/paged_attention.py:_fused_call
// (pallas_call at :191, kernel body _make_kernel at :90), reached through
// fused_paged_attention (W = 1) and fused_paged_attention_window (W = k+1).
//
// Computes, for every slot s, window row w and query head h:
//   keys t = 0 .. positions[s, w]   (t < nb * bs), read through the block
//   table: physical block table[s, t / bs], row t % bs, kv head h / rep;
//   logits = (q . k_t) * scale in f32, softmax in f32 (max, then the sum
//   of exp(logit - max), then each exp divided by the sum), probabilities
//   rounded to bf16 (the reference casts them to the compute dtype before
//   the PV product), out = sum_t p_t * v_t accumulated in f32, written as
//   bf16. It is not an online softmax: the rounded probabilities are the
//   normalised ones, as in the reference.
// Keys past the position are skipped: the reference gives them exactly
// zero probability (a where-mask to -1e30 before the softmax), so skipping
// is exact and keeps junk in unwritten or trash blocks out of the output.
//
// What bounds it on the H100: bytes. Each slot's attended K and V rows
// are read once (2 * keys * Hkv * D * 2 bytes) for ~4 flops a byte per
// query head and window row, far below the ~295 flop/byte ridge, so the
// floor is K+V bytes / 3.35 TB/s (3.3 us at the serving check's 2717
// keys). The first version (one block per (head, slot), 128-byte rows)
// read each K and V row once per query head and per window row, and let
// one block walk a whole 1024-key slot while the short slots' blocks
// idled: 42x the bound at W = 1, 118x at W = 4.
//
// The design (the plan's numbers come from
// consensusml_tpu_torch/models/paged_attention.py:paged_plan):
// - Grid (splits, S, Hkv / G); a thread block cluster of `splits` blocks
//   (<= 16) owns one (slot, head group): G kv heads and their G * rep
//   query heads, G the most kv heads whose query heads fit the block's
//   threads (G * rep * D <= 1024 and W * G * rep <= 256; all heads at
//   GPT-2-medium's 16 x 64, 8 of Llama-2-7B's 32 x 128). G = Hkv is the
//   kernel's kGroups = false form: whole pages, its head offsets constant
//   zero, the kernel as it was before head groups; G < Hkv is its kGroups
//   form, which places the group's heads in q, the pages and the output.
//   Block r owns the slot's pages [r * pages, (r + 1) * pages) up to the
//   last page any of its window rows attends, for its group's heads. A
//   page of one layer, (bs, Hkv, D), is contiguous: where G = Hkv each
//   page is one bulk copy (cp.async.bulk, completion on an mbarrier),
//   else its bs
//   rows of the group's G * D contiguous values are one bulk copy each,
//   all completing on the same mbarrier, into a ring of `ring` page
//   buffers of (bs, G, D), K pages first, then V pages, refilled as pages
//   are consumed. Every query head of a kv head's group and every window
//   row read that one copy; each K and V row of the cache is read once,
//   by one head group's cluster. Blocks past the slot's last page load
//   nothing; the keys of the call are spread over the card by pages.
// - Per K page, thread (head, group of 4 keys, quarter of D) takes the
//   dot products of its 4 key rows with the head's W query rows over its
//   quarter in f64 (q staged once as f64; each K chunk read once for the
//   W rows, each q chunk once for the 4 keys), and the quarters are summed
//   across lanes; the logits of the block's keys stay in shared memory.
//   The products of bf16 values are exact in f64 and so, in practice, is
//   their sum: each logit is the dot product rounded once to f32, whatever
//   the order, as paged_attention_plain computes it. The softmax's sum is
//   taken in f64 and rounded once too. So the probabilities, which are
//   rounded to bf16, are the plain version's to the bit: an f32 sum in
//   another order moves a sum by an ulp or two, which flips the bf16
//   rounding of a probability now and then, and one flipped probability
//   near 1 moves its row's output by several bf16 ulps (one such flip
//   missed the 1-ulp gate on the card). Only the P V sums differ in order.
// - Exact normalisation across the cluster, through distributed shared
//   memory: each block's max per (row, head) (threads split its keys and
//   fold their partials in a fixed order); barrier.cluster; every
//   block takes the max over the cluster's blocks, then exp(logit - max)
//   and its block sum (f64); barrier.cluster; every block sums the
//   cluster's block sums in rank order (the same bits in every block, no
//   atomics), rounds the sum to f32 and rounds exp / sum to bf16.
// - Per V page, thread (head, 4 dims) accumulates p * v for the W rows in
//   f32 registers, over its keys in order (four keys' loads in flight
//   together; a row that does not attend a key of the page, which another
//   row does, multiplies it by p = 0); the block's partial output
//   goes to shared memory, barrier.cluster, and block r folds the r-th
//   slice of the (W, H, D) outputs over the cluster's partials in rank
//   order and writes it as bf16. A last barrier.cluster keeps each
//   block's shared memory alive until the cluster has read it.
// The cache-length limit: nb <= 16 * pages, with the ring, q, the
// block's logits and its partial output in one block's shared memory;
// a plan with fewer kv heads a block holds fewer logits a key, so takes
// a longer cache (paged_plan falls back to one where the most heads do
// not fit, and raises past G = 1).
//
// Subnormals: the reference's compiled program flushes f32 subnormals (a
// subnormal operand reads as zero, a subnormal result is written as
// zero), and so does this kernel wherever it produces an f32 value: the
// logit where its f64 dot product is rounded to f32 and scaled, exp, the
// f64 sum where it is rounded to f32, the probability, every P V
// multiply-add (a subnormal V reads as zero) and the folded output (the
// .ftz forms; PTX has none for f64, whose sums are exact here). The
// plain version flushes at the same places.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

using cml_sm90::add_ftz;
using cml_sm90::mul_ftz;
using cml_sm90::sub_ftz;

__device__ __forceinline__ float div_ftz(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float fma_ftz(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}

constexpr int kThreads = 256;
constexpr int kMaxW = 8;
constexpr int kMaxSplits = 16;  // blocks of a cluster: H100's non-portable most
constexpr int kMaxRing = 8;
constexpr int kSmemLimit = 232448;  // an H100 block's dynamic shared memory

struct PagedArgs {
  const __nv_bfloat16* q;  // (S, W, H, D)
  const __nv_bfloat16* k;  // (N, bs, Hkv, D)
  const __nv_bfloat16* v;  // (N, bs, Hkv, D)
  const int* table;        // (S, nb)
  const int* pos;          // (S, W)
  __nv_bfloat16* out;      // (S, W, H, D)
  long long n_pages;       // N
  int H, Hkv, D, bs, nb;
  int pages;  // pages a block
  int ring;   // page buffers a block
  int G;      // kv heads a block (a divisor of Hkv)
  float scale;
};

__host__ __device__ constexpr long long align128(long long b) { return (b + 127) / 128 * 128; }

// q's layout in shared memory: each row (w, h) of D as f64 in nq parts of
// D / nq (a multiple of 8), each part followed by 2 doubles of padding, so
// the nq lanes that read one row's parts at once hit distinct banks
__host__ __device__ inline int q_parts(int d) { return d % 32 == 0 ? 4 : d % 16 == 0 ? 2 : 1; }
__host__ __device__ inline int q_row(int d) { return d + 2 * q_parts(d); }

// dynamic shared memory of a block of h query heads and hkv kv heads
// (its group's: G * rep and G), each part 128-byte aligned: ring page
// buffers (bs, hkv, D); q as f64 (W, h, q_row(D)), later the block's
// partial output (W, h, D) f32; the block's logits (W, pages * bs, h) f32;
// the block's sums (W * h f64), a fold scratch (one f64 a thread), the
// block's maxima and the slot's max or sum (W * h f32 each), the W rows'
// last keys and the block's block-table entries; one mbarrier a ring
// buffer
struct Layout {
  long long page, qs, logits, stats, bars, total;
};

__host__ __device__ inline Layout layout(int w, int h, int hkv, int d, int bs, int pages, int ring) {
  Layout l;
  l.page = align128(static_cast<long long>(bs) * hkv * d * 2);
  l.qs = ring * l.page;
  l.logits = l.qs + align128(static_cast<long long>(w) * h * q_row(d) * 8);
  l.stats = l.logits + align128(static_cast<long long>(w) * pages * bs * h * 4);
  l.bars = l.stats + align128((static_cast<long long>(w) * h + kThreads) * 8 + (2LL * w * h + kMaxW + pages) * 4);
  l.total = l.bars + 8LL * ring;
  return l;
}

__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int W, bool kGroups>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(const PagedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int rep = a.H / a.Hkv;
  const int G = kGroups ? a.G : a.Hkv;
  const int H = kGroups ? G * rep : a.H;  // the block's query heads, [h0, h0 + H) of a.H
  const Layout lay = layout(W, H, G, a.D, a.bs, a.pages, a.ring);
  const int tid = threadIdx.x;
  const int D = a.D, bs = a.bs;
  const int wh = W * H;
  const int nq = q_parts(D), dpart = D / nq, qpart = dpart + 2, qrow = q_row(D);
  double* qs = reinterpret_cast<double*>(smem + lay.qs);
  float* part = reinterpret_cast<float*>(qs);  // the partial output takes q's place after the K pages
  float* lg = reinterpret_cast<float*>(smem + lay.logits);
  double* bsum = reinterpret_cast<double*>(smem + lay.stats);
  double* red = bsum + wh;
  float* bmax = reinterpret_cast<float*>(red + kThreads);
  float* gstat = bmax + wh;
  int* lastw = reinterpret_cast<int*>(gstat + wh);
  int* phys = lastw + kMaxW;  // the block's pages' physical blocks
  const uint32_t bars = cml_sm90::smem_u32(smem + lay.bars);

  const uint32_t rank = blockIdx.x;  // the cluster spans the grid's x extent
  const int splits = static_cast<int>(gridDim.x);
  const int s = blockIdx.y;
  const int g0 = kGroups ? static_cast<int>(blockIdx.z) * G : 0;  // the group's first kv head
  const int h0 = g0 * rep;                                         // and first query head
  const int kb = a.pages * bs;  // keys a block holds
  const long long page_elems = static_cast<long long>(bs) * a.Hkv * D;
  // a key's G * D values of the group's kv heads: contiguous in a page,
  // and a key's stride in a ring buffer of (bs, G, D)
  const int stride = G * D;

  // the positions, the block's table entries and q, all loads in flight at once
  const int p0 = static_cast<int>(rank) * a.pages;
  if (tid < W) lastw[tid] = min(a.pos[s * W + tid], a.nb * bs - 1);
  for (int j = (tid + kThreads - 32) % kThreads; j < a.pages; j += kThreads)  // warp 0 reads the positions
    phys[j] = p0 + j < a.nb ? a.table[static_cast<long long>(s) * a.nb + p0 + j] : -1;
  if (tid == 0) {
    for (int b = 0; b < a.ring; ++b) cml_sm90::mbar_init(bars + 8 * b, 1);
    cml_sm90::mbar_init_fence();
  }
  const __nv_bfloat16* qsrc = a.q + (static_cast<long long>(s) * W * a.H + h0) * D;
  for (int ci = tid; ci < wh * D / 8; ci += kThreads) {  // q as f64, 16 bytes a thread at a time
    const int r = ci / (D / 8), d = 8 * (ci % (D / 8));  // r = (w, head of the block)
    const int rq = kGroups ? r / H * a.H + r % H : r;      // its row of the slot's (W, a.H)
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(qsrc + static_cast<long long>(rq) * D + d), f);
    double2* dst = reinterpret_cast<double2*>(qs + r * qrow + d / dpart * qpart + d % dpart);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = make_double2(f[2 * j], f[2 * j + 1]);
  }
  __syncthreads();
  int lw[W];  // each window row's last key
#pragma unroll
  for (int w = 0; w < W; ++w) lw[w] = lastw[w];
  int last = lw[0];
#pragma unroll
  for (int w = 1; w < W; ++w) last = max(last, lw[w]);
  const int n = max(0, min(p0 + a.pages, last / bs + 1) - p0);  // pages this block loads
  const int loads = 2 * n;                                        // n K pages, then n V pages
  const int k0 = p0 * bs;                                         // the block's first key

  auto issue = [&](int li) {  // thread 0: load li into ring buffer li % ring
    const int block = phys[li < n ? li : li - n];
    if (block < 0 || block >= a.n_pages) __trap();  // a block-table entry outside the pool
    const __nv_bfloat16* src = (li < n ? a.k : a.v) + static_cast<long long>(block) * page_elems + g0 * D;
    const uint32_t bar = bars + 8 * (li % a.ring);
    const uint32_t dst = cml_sm90::smem_u32(smem + (li % a.ring) * lay.page);
    cml_sm90::mbar_expect_tx(bar, static_cast<uint32_t>(bs * stride * 2));
    if (!kGroups) {  // the whole page: one copy
      cml_sm90::bulk_load(dst, src, static_cast<uint32_t>(page_elems * 2), bar);
    } else {  // the group's G * D values of each of the page's bs keys: one copy a key
      for (int t = 0; t < bs; ++t)
        cml_sm90::bulk_load(dst + t * stride * 2, src + static_cast<long long>(t) * a.Hkv * D,
                            static_cast<uint32_t>(stride * 2), bar);
    }
  };
  auto wait = [&](int li) { cml_sm90::wait_or_trap(bars + 8 * (li % a.ring), (li / a.ring) & 1); };
  auto buffer = [&](int li) { return reinterpret_cast<const __nv_bfloat16*>(smem + (li % a.ring) * lay.page); };
  // keys of row w in this block: [k0, k0 + nkeys(w))
  auto nkeys = [&](int w) { return max(0, min(lastw[w] - k0 + 1, n * bs)); };

  if (tid == 0)
    for (int li = 0; li < min(a.ring, loads); ++li) issue(li);

  // ---- logits, one K page at a time ----
  // item (head, group of kg keys, part dq of D): kg x W dot products over
  // D / nq dims in f64, the nq parts summed across lanes (exact sums)
  const int kg = bs % 4 == 0 ? 4 : bs % 2 == 0 ? 2 : 1;
  const int groups_k = bs / kg;
  const int items = H * groups_k * nq;
  const int nchq = dpart / 8;  // 16-byte chunks of K in a part
  for (int i = 0; i < n; ++i) {
    wait(i);
    const __nv_bfloat16* kp = buffer(i);
    for (int base = 0; base < items; base += kThreads) {
      const int item = base + tid;
      const bool valid = item < items;
      const int dq = item % nq, g = valid ? item / nq % groups_k : 0, h = valid ? item / nq / groups_k : 0;
      double acc[4][W];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[j][w] = 0.0;
      const __nv_bfloat16* krow = kp + static_cast<long long>(g * kg) * stride + (h / rep) * D + dq * dpart;
      const double* qrow_h = qs + h * qrow + dq * qpart;
      for (int c0 = 0; c0 < nchq; ++c0) {
        int c = c0 + (g & 1);  // neighbouring key groups read other chunks: other banks
        if (c >= nchq) c -= nchq;
        double kd[4][8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < kg) {
            float f[8];
            unpack8(*reinterpret_cast<const uint4*>(krow + static_cast<long long>(j) * stride + 8 * c), f);
#pragma unroll
            for (int e = 0; e < 8; ++e) kd[j][e] = f[e];
          }
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const double2* qp = reinterpret_cast<const double2*>(qrow_h + w * H * qrow + 8 * c);
          double qv[8];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const double2 t = qp[e];
            qv[2 * e] = t.x;
            qv[2 * e + 1] = t.y;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < kg)
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[j][w] = fma(qv[e], kd[j][e], acc[j][w]);
        }
      }
      for (int off = 1; off < nq; off <<= 1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int w = 0; w < W; ++w) acc[j][w] += __shfl_xor_sync(0xffffffffu, acc[j][w], off);
      if (valid && dq == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tb = i * bs + g * kg + j;  // the key's place in the block
#pragma unroll
          for (int w = 0; w < W; ++w)
            if (j < kg && k0 + tb <= lw[w]) lg[(w * kb + tb) * H + h] = mul_ftz(__double2float_rn(acc[j][w]), a.scale);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer
    if (tid == 0 && i + a.ring < loads) issue(i + a.ring);
  }

  // ---- exact softmax across the cluster ----
  // thread (pair, sub), pair = (row, head): keys sub, sub + tpp, ... of
  // the block; its partials folded in sub order through `red`
  const int tpp = kThreads / wh;
  const int pr = tid % wh, sub = tid / wh;
  const int pw = pr / H, ph = pr % H;
  const int pnk = sub < tpp ? nkeys(pw) : 0;
  float m = cml_sm90::neg_inf();
#pragma unroll 4
  for (int t = sub; t < pnk; t += tpp) m = fmaxf(m, lg[(pw * kb + t) * H + ph]);
  reinterpret_cast<float*>(red)[tid] = m;
  __syncthreads();
  if (tid < wh) {
#pragma unroll 8
    for (int j = 1; j < tpp; ++j) m = fmaxf(m, reinterpret_cast<float*>(red)[j * wh + tid]);
    bmax[tid] = m;
  }
  cml_sm90::cluster_arrive();
  cml_sm90::cluster_wait();
  if (tid < wh) {  // every block's maximum, all loads in flight at once
    const uint32_t la = cml_sm90::smem_u32(bmax + tid);
    float v[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) v[r] = r < splits ? cml_sm90::ld_cluster(la, r) : cml_sm90::neg_inf();
    m = v[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r) m = fmaxf(m, v[r]);
    gstat[tid] = m;  // the max over the slot's keys
  }
  __syncthreads();
  double sum = 0.0;
  if (pnk > 0) {
    const float mx = gstat[pr];
#pragma unroll 4
    for (int t = sub; t < pnk; t += tpp) {
      float* p = lg + (pw * kb + t) * H + ph;
      const float e = mul_ftz(expf(sub_ftz(*p, mx)), 1.f);  // a subnormal exp is flushed
      *p = e;
      sum += static_cast<double>(e);
    }
  }
  red[tid] = sum;
  __syncthreads();
  if (tid < wh) {
#pragma unroll 8
    for (int j = 1; j < tpp; ++j) sum += red[j * wh + tid];
    bsum[tid] = sum;
  }
  cml_sm90::cluster_arrive();
  cml_sm90::cluster_wait();
  if (tid < wh) {  // every block's sum, in rank order
    const uint32_t la = cml_sm90::smem_u32(bsum + tid);
    double v[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) v[r] = r < splits ? cml_sm90::ld_cluster_f64(la, r) : 0.0;
    sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r) sum += v[r];
    gstat[tid] = mul_ftz(__double2float_rn(sum), 1.f);  // the slot's sum, rounded once: the same bits in every block
  }
  __syncthreads();
  if (pnk > 0) {
    const float total = gstat[pr];
#pragma unroll 4
    for (int t = sub; t < pnk; t += tpp) {
      float* p = lg + (pw * kb + t) * H + ph;
      *p = __bfloat162float(__float2bfloat16_rn(div_ftz(*p, total)));
    }
  }
  __syncthreads();

  // ---- P V, one V page at a time: thread (head, 4 dims) ----
  const int groups = H * D / 4;  // <= kThreads (the wrapper's limit)
  const int hv = tid / (D / 4), d0 = 4 * (tid % (D / 4));
  float o[W][4];
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[w][c] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int li = n + i;
    wait(li);
    const int nk = min(bs, last - (k0 + i * bs) + 1);  // keys of this page any row attends
    if (tid < groups) {
      const __nv_bfloat16* vp = buffer(li) + static_cast<long long>(hv / rep) * D + d0;
      const float* pp = lg + (i * bs) * H + hv;
      for (int tl0 = 0; tl0 < nk; tl0 += 4) {  // four keys' loads in flight, then their products
        uint2 raw[4];
        float pk[4][W];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tl = tl0 + j;
          raw[j] = tl < nk ? *reinterpret_cast<const uint2*>(vp + static_cast<long long>(tl) * stride)
                           : make_uint2(0u, 0u);
#pragma unroll
          for (int w = 0; w < W; ++w)  // a row that does not attend the key takes p = 0: o is unchanged
            pk[j][w] = tl < nk && k0 + i * bs + tl <= lw[w] ? pp[(w * kb + tl) * H] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 va = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[j].x));
          const float2 vb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[j].y));
#pragma unroll
          for (int w = 0; w < W; ++w) {
            o[w][0] = fma_ftz(pk[j][w], va.x, o[w][0]);
            o[w][1] = fma_ftz(pk[j][w], va.y, o[w][1]);
            o[w][2] = fma_ftz(pk[j][w], vb.x, o[w][2]);
            o[w][3] = fma_ftz(pk[j][w], vb.y, o[w][3]);
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0 && li + a.ring < loads) issue(li + a.ring);
  }
  if (tid < groups) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      *reinterpret_cast<float4*>(part + (w * H + hv) * D + d0) = make_float4(o[w][0], o[w][1], o[w][2], o[w][3]);
  }

  // ---- fold the cluster's partial outputs, block r the r-th slice ----
  cml_sm90::cluster_arrive();
  cml_sm90::cluster_wait();
  const int total = wh * D;  // the block's (W, H, D) of the slot's (W, a.H, D)
  const int per = (total + splits - 1) / splits;
  const int e1 = min(total, (static_cast<int>(rank) + 1) * per);
  __nv_bfloat16* orow = a.out + (static_cast<long long>(s) * W * a.H + h0) * D;
  for (int e = static_cast<int>(rank) * per + tid; e < e1; e += kThreads) {
    const uint32_t la = cml_sm90::smem_u32(part + e);
    float v[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) v[r] = r < splits ? cml_sm90::ld_cluster(la, r) : 0.f;
    float acc = v[0];
#pragma unroll
    for (int r = 1; r < kMaxSplits; ++r)
      if (r < splits) acc = add_ftz(acc, v[r]);
    orow[kGroups ? e / (H * D) * a.H * D + e % (H * D) : e] = __float2bfloat16_rn(mul_ftz(acc, 1.f));
  }
  cml_sm90::cluster_arrive();  // this block is done reading the others' partials
  cml_sm90::cluster_wait();    // and the others are done reading its own
}

template <int W, bool kGroups>
int launch_w(const PagedArgs& a, int s, int splits, long long smem, cudaStream_t st) {
  auto kernel = paged_attention_kernel<W, kGroups>;
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
  cfg.gridDim = dim3(static_cast<unsigned int>(splits), static_cast<unsigned int>(s),
                     static_cast<unsigned int>(a.Hkv / a.G));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <bool kGroups>
int launch_g(const PagedArgs& a, int s, int w, int splits, long long smem, cudaStream_t st) {
  switch (w) {
    case 1: return launch_w<1, kGroups>(a, s, splits, smem, st);
    case 2: return launch_w<2, kGroups>(a, s, splits, smem, st);
    case 3: return launch_w<3, kGroups>(a, s, splits, smem, st);
    case 4: return launch_w<4, kGroups>(a, s, splits, smem, st);
    case 5: return launch_w<5, kGroups>(a, s, splits, smem, st);
    case 6: return launch_w<6, kGroups>(a, s, splits, smem, st);
    case 7: return launch_w<7, kGroups>(a, s, splits, smem, st);
    case 8: return launch_w<8, kGroups>(a, s, splits, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch(const PagedArgs& a, int s, int w, int splits, long long smem, cudaStream_t st) {
  return a.G < a.Hkv ? launch_g<true>(a, s, w, splits, smem, st) : launch_g<false>(a, s, w, splits, smem, st);
}

}  // namespace

// Dynamic shared memory of a block of the plan (bytes): g kv heads of
// hkv a block, and their g * h / hkv query heads.
extern "C" long long cml_paged_attention_smem_bytes(int w, int h, int hkv, int d, int bs, int pages, int ring,
                                                    int g) {
  if (hkv < 1 || g < 1 || h % hkv) return -1;
  return layout(w, g * (h / hkv), g, d, bs, pages, ring).total;
}

// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue without launching for a shape or plan the kernel
// does not take: W outside 1..8, H not a multiple of Hkv, D not a
// multiple of 8, a head group of g kv heads that does not divide Hkv or
// whose query heads exceed the block's threads (g * rep * D > 4 * 256 or
// W * g * rep > 256, rep = H / Hkv), a plan whose splits (<= 16) x pages
// do not cover the nb pages exactly (no block without a page at full
// length), a ring outside 1..8, or more shared memory than a block has.
// The pools' pointers must be 16-byte aligned (the wrapper checks).
extern "C" int cml_paged_attention_bf16(const void* q, const void* k_pages, const void* v_pages, const void* table,
                                        const void* positions, void* out, long long n_pages, int s, int w, int h,
                                        int hkv, int d, int bs, int nb, int pages, int splits, int ring, int g,
                                        float scale, void* stream) {
  if (w < 1 || w > kMaxW || s < 1 || s > 65535 || h < 1 || hkv < 1 || h % hkv || d < 8 || d % 8 || g < 1 ||
      hkv % g || g * (h / hkv) * d > 4 * kThreads || w * g * (h / hkv) > kThreads || bs < 1 || nb < 1 ||
      n_pages < 1 || pages < 1 || splits < 1 || splits > kMaxSplits || static_cast<long long>(splits) * pages < nb ||
      (splits - 1) * pages >= nb || ring < 1 || ring > kMaxRing)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = layout(w, g * (h / hkv), g, d, bs, pages, ring).total;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
                    static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(table),
                    static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), n_pages, h, hkv, d, bs, nb,
                    pages, ring, g, scale};
  return launch(a, s, w, splits, smem, static_cast<cudaStream_t>(stream));
}

// How many clusters of the plan the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 = the launch would fail), or a
// negative CUDA error code: the whole-page form (grouped = 0) or the
// head-group form (grouped = 1) at W = 1 or 4, with the plan's shared
// memory (cml_paged_attention_smem_bytes, which takes its G).
extern "C" int cml_paged_attention_max_active_clusters(int w, int splits, long long smem, int grouped) {
  if ((w != 1 && w != 4) || (grouped != 0 && grouped != 1)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(splits), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = grouped ? (w == 1 ? paged_attention_kernel<1, true> : paged_attention_kernel<4, true>)
                        : (w == 1 ? paged_attention_kernel<1, false> : paged_attention_kernel<4, false>);
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(cudaErrorInvalidValue);
}
