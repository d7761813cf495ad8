// Chunk-local scatter: the top-k codec's decode.
//
// Replaces: consensusml_tpu/compress/kernels.py:chunk_scatter (pallas_call
// at :481, kernel body _scatter_kernel at :398). (R, k) f32 values at
// distinct int32 chunk-local indices, densified into (R, C) f32 rows (C a
// multiple of 128), on top of acc (R, C) or of zeros:
//   out[r, c]        = acc[r, c] + 0                 where no pair lands
//   out[r, idx[r,j]] = (acc + 0) + ((w * v[r, j]) + 0)
// The reference pre-scales the values (v * w, one rounding) and then adds
// them (a second): a product, then a sum, never an FMA. Its kernel adds
// a masked +0.0 to every element k times, so a -0.0 in acc, or a -0.0
// value, comes out +0.0; the "+ 0" above does the same. The reference's
// compiled program flushes f32 subnormals (a subnormal operand reads as a
// zero of its sign, a subnormal result is written as one), so every
// product and sum here is the PTX instruction's .ftz form. The
// reference's lane compare drops an index outside [0, C); so does this.
// Bit-equal to chunk_scatter_plain (compress/kernels.py).
//
// What bounds it on the H100: bytes, the dense row written (4 bytes an
// element) and, with acc, read (4 more); the pairs are k/C of that.
// Design: one warp per row (8 rows a block): the lanes first write the
// whole row (acc + 0, or zeros) as float4s, then, after __syncwarp()
// (which orders the warp's global writes), lane j writes pair j (k/32
// rounds). Indices are distinct, so no two lanes write one element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float plus_zero(float a) { return add_ftz(a, 0.f); }

__global__ void __launch_bounds__(kWarp * kRowsPerBlock) chunk_scatter_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx, const float* __restrict__ acc,
    float* __restrict__ out, long long rows, int k, int chunk, float w) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= rows) return;  // the whole warp leaves together
  const size_t base = static_cast<size_t>(row) * chunk;
  const float* a = acc != nullptr ? acc + base : nullptr;
  float* o = out + base;
  float4* o4 = reinterpret_cast<float4*>(o);
  const int n4 = chunk / 4;
  for (int i = lane; i < n4; i += kWarp) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a != nullptr) {
      t = reinterpret_cast<const float4*>(a)[i];
      t = make_float4(plus_zero(t.x), plus_zero(t.y), plus_zero(t.z), plus_zero(t.w));
    }
    o4[i] = t;
  }
  __syncwarp();
  const size_t pb = static_cast<size_t>(row) * k;
  for (int j = lane; j < k; j += kWarp) {
    const int c = idx[pb + j];
    if (static_cast<unsigned>(c) >= static_cast<unsigned>(chunk)) continue;
    const float v = plus_zero(mul_ftz(vals[pb + j], w));
    o[c] = add_ftz(a != nullptr ? plus_zero(a[c]) : 0.f, v);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue without launching for a chunk that is not a
// positive multiple of 128 or a k below 1. acc may be null.
extern "C" int cml_chunk_scatter(const void* vals, const void* idx, const void* acc, void* out, long long rows,
                                 int k, int chunk, float weight, void* stream) {
  if (chunk <= 0 || chunk % 128 != 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  chunk_scatter_kernel<<<static_cast<unsigned int>(blocks), kWarp * kRowsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(idx), static_cast<const float*>(acc),
      static_cast<float*>(out), rows, k, chunk, weight);
  return static_cast<int>(cudaGetLastError());
}
