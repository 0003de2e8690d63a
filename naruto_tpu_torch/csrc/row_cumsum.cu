// Inclusive cumsum over the rows of [M, F] f32: the kernels behind
// naruto_tpu_torch.ops.primitives.row_cumsum.
//
//   out[i, f] = sum over j <= i of x[j, f]       (exact f32 adds)
//
// Replaces the Pallas TPU kernel scripts/microbench_primitives.py::cs_kernel
// (P4), which scans 1024-row blocks by a lower-triangular matmul and carries
// the last row from one grid step to the next. Not carried over: the matmul
// (at the TPU's default precision it rounds its f32 inputs to bf16, while
// the script's own oracle is jnp.cumsum), the 1024-row blocking, and the
// grid of M // 1024 blocks, which leaves the tail of a ragged M unscanned.
//
// What bounds it on an H100: bytes. At [3,000,000, 8] the data is 96 MB in
// and 96 MB out. The card's blocks run in no order, so nothing can carry a
// sum from one block to the next as the TPU grid does. The design is the
// block decoupling of outer_cumsum.cu (K2 then K1), in three launches:
//   1. chunk_totals: per chunk of CH = (256 / F) * SEG rows, the column sums;
//   2. scan_totals:  one block per column turns the [nch, F] totals into
//                    exclusive chunk offsets (a fixed-order block scan);
//   3. scan_chunks:  every chunk scans itself from 0 and adds its offset to
//                    each output, so no step rounds at the offset's scale.
// In a chunk, thread t owns column t % F and a segment of SEG consecutive
// rows, g = t / F; it holds its segment in registers, the segments' sums go
// through shared memory, and each thread adds the sums of the segments
// before its own in a fixed order. Every sum is taken in a fixed order, so
// the result does not depend on scheduling. Phases 1 and 3 both read x, so
// 288 MB move where a single-pass (decoupled look-back) scan would move
// 192 MB: that is later work.
//
// F must lie in [1, 256]; M is any size, the last chunk is masked.
//
// Plain C interface (loaded with ctypes): the entry points launch on the
// given stream, allocate nothing (the caller passes the [nch, F] scratch
// arrays tot and offs, nch from naruto_row_cumsum_chunks), and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SEG = 32;            // rows each thread holds in registers
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int64_t chunk_rows(int nf) {
  return (int64_t)(THREADS / nf) * SEG;
}

__global__ void chunk_totals_kernel(const float* __restrict__ x,
                                    float* __restrict__ tot, int64_t m,
                                    int nf) {
  __shared__ float part[THREADS];
  const int t = threadIdx.x;
  const int f = t % nf;
  const int g = t / nf;
  float s = 0.0f;
  if (g < THREADS / nf) {
    const int64_t row0 = blockIdx.x * chunk_rows(nf) + (int64_t)g * SEG;
#pragma unroll
    for (int r = 0; r < SEG; ++r) {
      if (row0 + r < m) s += __ldg(x + (row0 + r) * nf + f);
    }
  }
  part[t] = s;
  __syncthreads();
  if (t < nf) {
    float a = 0.0f;
    for (int k = 0; k < THREADS / nf; ++k) a += part[k * nf + t];
    tot[(int64_t)blockIdx.x * nf + t] = a;
  }
}

// exclusive scan over the block of one value per thread, in a fixed order
__device__ float block_exclusive_scan(float v, float* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  float inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float n = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += n;
  }
  float exc = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) exc = 0.0f;
  if (lane == 31) warp_sums[w] = inc;
  __syncthreads();
  if (w == 0) {
    const float s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    float si = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float n = __shfl_up_sync(FULL, si, d);
      if (lane >= d) si += n;
    }
    float se = __shfl_up_sync(FULL, si, 1);
    if (lane == 0) se = 0.0f;
    warp_sums[lane] = se;
  }
  __syncthreads();
  return warp_sums[w] + exc;
}

// block f: offs[:, f] = exclusive cumsum of tot[:, f]; each thread scans a
// contiguous span of chunks from the block-scanned sum of the spans before
__global__ void scan_totals_kernel(const float* __restrict__ tot,
                                   float* __restrict__ offs, int64_t nch,
                                   int nf) {
  __shared__ float warp_sums[32];
  const int f = blockIdx.x;
  const int64_t per = (nch + SCAN_THREADS - 1) / SCAN_THREADS;
  const int64_t a = threadIdx.x * per;
  const int64_t b = a + per < nch ? a + per : nch;
  float s = 0.0f;
  for (int64_t k = a; k < b; ++k) s += tot[k * nf + f];
  float run = block_exclusive_scan(s, warp_sums);
  for (int64_t k = a; k < b; ++k) {
    const float v = tot[k * nf + f];
    offs[k * nf + f] = run;
    run += v;
  }
}

__global__ void scan_chunks_kernel(const float* __restrict__ x,
                                   const float* __restrict__ offs,
                                   float* __restrict__ out, int64_t m,
                                   int nf) {
  __shared__ float part[THREADS];
  const int t = threadIdx.x;
  const int f = t % nf;
  const int g = t / nf;
  const bool active = g < THREADS / nf;
  const int64_t row0 = blockIdx.x * chunk_rows(nf) + (int64_t)g * SEG;
  float v[SEG];
  float s = 0.0f;
#pragma unroll
  for (int r = 0; r < SEG; ++r) {
    v[r] = active && row0 + r < m ? __ldg(x + (row0 + r) * nf + f) : 0.0f;
    s += v[r];
  }
  part[t] = s;
  __syncthreads();
  if (!active) return;
  float local = 0.0f;
  for (int k = 0; k < g; ++k) local += part[k * nf + f];
  const float base = offs[(int64_t)blockIdx.x * nf + f];
#pragma unroll
  for (int r = 0; r < SEG; ++r) {
    local += v[r];
    if (row0 + r < m) out[(row0 + r) * nf + f] = base + local;
  }
}

}  // namespace

extern "C" int64_t naruto_row_cumsum_chunks(int64_t m, int nf) {
  const int64_t ch = (int64_t)(THREADS / nf) * SEG;
  return (m + ch - 1) / ch;
}

extern "C" int naruto_row_cumsum(const void* x, void* tot, void* offs,
                                 void* out, int64_t m, int nf, void* stream) {
  const int64_t nch = naruto_row_cumsum_chunks(m, nf);
  cudaStream_t s = (cudaStream_t)stream;
  chunk_totals_kernel<<<(unsigned)nch, THREADS, 0, s>>>(
      (const float*)x, (float*)tot, m, nf);
  scan_totals_kernel<<<nf, SCAN_THREADS, 0, s>>>(
      (const float*)tot, (float*)offs, nch, nf);
  scan_chunks_kernel<<<(unsigned)nch, THREADS, 0, s>>>(
      (const float*)x, (const float*)offs, (float*)out, m, nf);
  return (int)cudaGetLastError();
}
