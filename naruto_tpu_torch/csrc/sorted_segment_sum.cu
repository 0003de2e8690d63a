// Segment sum of sorted keys: the kernel behind
// naruto_tpu_torch.ops.primitives.sorted_segment_sum.
//
//   out[s, f] = sum over i with si[i] == s of r(vals[i, f])
//   si [M] int32 sorted ascending, vals [M, F] f32, out [size, F] f32,
//   r = round to bf16 (ROUND_BF16) or the identity; sums in f32, row order.
//
// Replaces the Pallas TPU kernels that accumulate sorted updates through a
// one-hot matmul window into a table held in VMEM:
//   scripts/microbench_primitives.py::seg_kernel         (P1; bf16 one-hot
//                                                          product: ROUND_BF16)
//   scripts/microbench_round2.py::make_seg.<seg_kernel>  (P7; f32 HIGHEST)
// Their block and window sizes are the TPU's tiling and are not carried
// over; so are not their faults: the grids there cover M // BK blocks and
// leave the tail unread, a window can start past the output's end, P1 drops
// keys outside its block's window and P7 counts its window overlap twice.
// This kernel computes what those scripts check against, a segment sum,
// over all M rows.
//
// What bounds it on an H100: bytes. At the scripts' shape (3,000,000 keys
// into 201,088 x 8 slots) it reads 12 MB of keys and 96 MB of values and
// writes 6.4 MB. Design, deterministic and with no atomics: a group of F
// consecutive threads owns one output slot; each thread finds the slot's
// run [lo, hi) by two binary searches over si (the keys sit in L2 after the
// first levels; the F threads of a group search the same addresses) and sums
// its column of the run in row order. Neighbouring groups own neighbouring
// runs, so a warp's value loads walk one contiguous stretch of rows. Every
// slot is written, empty ones with 0, so the output needs no memset.
//
// Limits: one very long run is summed by its F threads alone and serializes
// that slot (a split of long runs across threads is later work). Keys
// outside [0, size) fall in no slot and are dropped, as jax.ops.segment_sum
// drops them; unsorted keys give wrong sums and are not detected.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// first position in si[lo, hi) whose key is >= key
__device__ __forceinline__ int64_t lower_bound(const int* __restrict__ si,
                                               int64_t lo, int64_t hi,
                                               int key) {
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (__ldg(si + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool ROUND_BF16>
__global__ void sorted_segment_sum_kernel(const int* __restrict__ si,
                                          const float* __restrict__ vals,
                                          float* __restrict__ out, int64_t m,
                                          int64_t n_out, int nf) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_out) return;
  const int s = (int)(t / nf);
  const int f = (int)(t - (int64_t)s * nf);
  const int64_t lo = lower_bound(si, 0, m, s);
  const int64_t hi = lower_bound(si, lo, m, s + 1);
  float acc = 0.0f;
  for (int64_t i = lo; i < hi; ++i) {
    float v = __ldg(vals + i * nf + f);
    if (ROUND_BF16) v = __bfloat162float(__float2bfloat16_rn(v));
    acc += v;
  }
  out[t] = acc;
}

}  // namespace

extern "C" int naruto_sorted_segment_sum(const void* si, const void* vals,
                                         void* out, int64_t m, int size,
                                         int nf, int round_bf16,
                                         void* stream) {
  const int64_t n_out = (int64_t)size * nf;
  const unsigned blocks = (unsigned)((n_out + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (round_bf16) {
    sorted_segment_sum_kernel<true><<<blocks, THREADS, 0, s>>>(
        (const int*)si, (const float*)vals, (float*)out, m, n_out, nf);
  } else {
    sorted_segment_sum_kernel<false><<<blocks, THREADS, 0, s>>>(
        (const int*)si, (const float*)vals, (float*)out, m, n_out, nf);
  }
  return (int)cudaGetLastError();
}
