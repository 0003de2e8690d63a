// Hash-grid backward scan: the two kernels behind
// naruto_tpu_torch.ops.kernels.{chunk_totals, outer_cumsum}.
//
// Replaces the Pallas TPU kernels naruto_tpu/ops/pallas_kernels.py::
//   _chunk_totals_kernel  (K2)  and  _outer_cumsum_kernel  (K1).
//
// Inputs are the sorted bf16 factor rows of the segment-sum backward:
// sa [M, ka] (trilinear corner weights) and sb [M, kb] (per-level embedding
// cotangents), M a multiple of CHUNK = 512. Row i's update is the a-major
// flattened outer product p[i, c*kb + f] = bf16(sa[i, c] * sb[i, f]); the
// product is rounded ONCE to bf16 (the f32 product of two bf16 values is
// exact, so this equals a bf16*bf16 multiply) and accumulated in f32.
//
//   K2 chunk_totals: tot[k, col]  = sum of p[i, col] over rows of chunk k.
//   K1 outer_cumsum: out[i, col]  = offs[i / CHUNK, col]
//                                   + (sum_{j <= i, j in chunk(i)} p[j, col])
//
// The caller turns K2's totals into K1's chunk offsets with an exclusive
// cumsum over the tiny [M / CHUNK, ka*kb] array, so no block of K1 depends
// on another: every block scans its own chunk.
//
// What bounds them on an H100: bytes. K1 reads M*(ka+kb)*2 bytes and writes
// M*ka*kb*4 (at ka = kb = 8 that is 32x more written than read), so it is
// bound by the store stream. Its design keeps the store side coalesced:
// thread `col` of a block owns one output column, so the block's threads
// write one whole output row (ka*kb floats, 256 bytes at 8x8) per step, and
// the chunk's factors are staged once in shared memory so the scan's loads
// never touch device memory. K2 stages the same factors and writes only
// ka*kb floats per chunk; it spreads each chunk over (column, row-group)
// pairs and reduces the row groups through shared memory in a fixed order,
// so its result does not depend on scheduling.
//
// K2 must round exactly like K1 (same product, same bf16 rounding, f32
// accumulation) so that the chunk offsets carry the same values K1 would
// have reached by scanning across chunk boundaries.
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 512;
constexpr int TOTALS_THREADS = 256;

__device__ __forceinline__ float outer_term(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(a) * __bfloat162float(b)));
}

// Stage chunk blockIdx.x's factors in shared memory with 16-byte copies
// (CHUNK * k * 2 bytes is a multiple of 16 for every k, and chunk starts
// are 1024-byte aligned); returns the b block's start.
__device__ __forceinline__ const __nv_bfloat16* stage_chunk(
    const __nv_bfloat16* __restrict__ sa, const __nv_bfloat16* __restrict__ sb,
    __nv_bfloat16* a_s, int ka, int kb) {
  __nv_bfloat16* b_s = a_s + CHUNK * ka;
  const int64_t row0 = (int64_t)blockIdx.x * CHUNK;
  const uint4* a_g = reinterpret_cast<const uint4*>(sa + row0 * ka);
  const uint4* b_g = reinterpret_cast<const uint4*>(sb + row0 * kb);
  uint4* a_v = reinterpret_cast<uint4*>(a_s);
  uint4* b_v = reinterpret_cast<uint4*>(b_s);
  for (int i = threadIdx.x; i < CHUNK * ka / 8; i += blockDim.x) a_v[i] = a_g[i];
  for (int i = threadIdx.x; i < CHUNK * kb / 8; i += blockDim.x) b_v[i] = b_g[i];
  __syncthreads();
  return b_s;
}

__global__ void chunk_totals_kernel(const __nv_bfloat16* __restrict__ sa,
                                    const __nv_bfloat16* __restrict__ sb,
                                    float* __restrict__ tot, int ka, int kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float partial[TOTALS_THREADS];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* b_s = stage_chunk(sa, sb, a_s, ka, kb);
  const int ncol = ka * kb;
  const int groups = TOTALS_THREADS / ncol;
  const int t = threadIdx.x;
  if (t < ncol * groups) {
    const int col = t % ncol;
    const int g = t / ncol;
    const int c = col / kb;
    const int f = col % kb;
    float s = 0.0f;
    for (int r = g; r < CHUNK; r += groups) {
      s += outer_term(a_s[r * ka + c], b_s[r * kb + f]);
    }
    partial[t] = s;
  }
  __syncthreads();
  if (t < ncol) {
    float s = 0.0f;
    for (int g = 0; g < groups; ++g) s += partial[g * ncol + t];
    tot[(int64_t)blockIdx.x * ncol + t] = s;
  }
}

__global__ void outer_cumsum_kernel(const __nv_bfloat16* __restrict__ sa,
                                    const __nv_bfloat16* __restrict__ sb,
                                    const float* __restrict__ offs,
                                    float* __restrict__ out, int ka, int kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  const __nv_bfloat16* b_s = stage_chunk(sa, sb, a_s, ka, kb);
  const int ncol = ka * kb;
  const int t = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * CHUNK;

  // the scan runs from 0 and the chunk offset is added to each output, as
  // the TPU kernel adds it to its in-chunk sums: starting the running sum
  // at the (large) offset would round every step at the offset's scale
  const int c = t / kb;
  const int f = t % kb;
  const float base = offs[(int64_t)blockIdx.x * ncol + t];
  float run = 0.0f;
  float* o = out + row0 * ncol + t;
#pragma unroll 8
  for (int r = 0; r < CHUNK; ++r) {
    run += outer_term(a_s[r * ka + c], b_s[r * kb + f]);
    o[(int64_t)r * ncol] = base + run;
  }
}

}  // namespace

extern "C" int naruto_chunk_totals(const void* sa, const void* sb, void* tot,
                                   int64_t m, int ka, int kb, void* stream) {
  const int nch = (int)(m / CHUNK);
  const size_t smem = (size_t)CHUNK * (ka + kb) * sizeof(__nv_bfloat16);
  chunk_totals_kernel<<<nch, TOTALS_THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)sa, (const __nv_bfloat16*)sb, (float*)tot, ka, kb);
  return (int)cudaGetLastError();
}

extern "C" int naruto_outer_cumsum(const void* sa, const void* sb,
                                   const void* offs, void* out, int64_t m,
                                   int ka, int kb, void* stream) {
  const int nch = (int)(m / CHUNK);
  const size_t smem = (size_t)CHUNK * (ka + kb) * sizeof(__nv_bfloat16);
  outer_cumsum_kernel<<<nch, ka * kb, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)sa, (const __nv_bfloat16*)sb, (const float*)offs,
      (float*)out, ka, kb);
  return (int)cudaGetLastError();
}
