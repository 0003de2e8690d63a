// Hash-grid backward scan: the one kernel behind
// naruto_tpu_torch.ops.kernels.{outer_cumsum_scan, outer_cumsum_slots}.
//
// Replaces the two Pallas TPU kernels of naruto_tpu/ops/pallas_kernels.py:
//   :57 _outer_cumsum_kernel  (K1, the chunk scan from given offsets) and
//   :78 _chunk_totals_kernel  (K2, the chunk totals behind those offsets),
// and the exclusive cumsum of the totals between them, with one launch.
//
// Inputs are the sorted bf16 factor rows of the segment-sum backward:
// sa [M, ka] (trilinear corner weights) and sb [M, kb] (per-level embedding
// cotangents), M a multiple of CHUNK = 512. Row i's update is the a-major
// flattened outer product p[i, c*kb + f] = bf16(sa[i, c] * sb[i, f]); the
// product is rounded ONCE to bf16 (the f32 product of two bf16 values is
// exact, so this equals a bf16*bf16 multiply) and accumulated in f32.
// cs[i, col] = sum over j <= i of p[j, col]. Two store epilogues, template
// instances of one body:
//   rows:  out = cs, [M, ka*kb] f32 (the contract of
//          pallas_kernels.outer_cumsum);
//   slots: from the sorted keys si [M] int32 and `size`, hi [size, ka*kb]
//          f32 with hi[t] = cs[ub[t] - 1], ub[t] = #{i: si[i] <= t}, and 0
//          where ub[t] = 0: the total of every update with key <= t, whose
//          adjacent differences are the per-slot sums. A row r whose key
//          a = si[r] differs from the next key b writes its running sum to
//          hi[max(a, 0) .. min(b, size)) (the last row's next key is
//          INT32_MAX), and chunk 0 writes zeros to hi[0 .. si[0]): each slot
//          row is written exactly once, so hi needs no memset, and the
//          INT32_MAX pad keys never write. The [M, ka*kb] cs never reaches
//          device memory.
//
// What bounds it on an H100: bytes. At the BA's shape (M = 493,568, 8x8,
// 204,089 slots) the rows epilogue must read 15.8 MB of factors and write
// 126 MB (~42 us at 3.35 TB/s); the slots epilogue reads 2.0 MB of keys and
// the factors and writes 52.2 MB (~21 us). The arithmetic (a multiply and
// an add per output) is ~1% of that. What the design does about it:
//   * one launch, reading each factor once: the chain it replaces read the
//     factors twice (K2, then K1) and added a scan launch and a subtraction
//     between them; the slots epilogue also drops the [M, 64] f32 round trip
//     through device memory, the boundary gather that read it back, and the
//     rank search, clamp and select around that gather.
//   * one block of 128 threads per 512-row chunk stages the chunk's factors
//     (and keys) in shared memory with 16-byte cp.async copies. Thread
//     (p, g) owns W = 4 adjacent columns (one a column, four b columns; W =
//     2 where kb is not a multiple of 4) over a segment g of consecutive
//     rows: per row it makes its products with W / 2 bf16x2 multiplies from
//     one 2-byte and one 8-byte shared load, each product once, in
//     registers, and a warp stores whole 256-byte output rows with 16-byte
//     stores.
//   * blocks cannot carry a sum to the next one, so the chunk offset comes
//     from the deterministic look-back of lookback.cuh (ticketed tiles,
//     published chunk totals, fixed-order group sums, a per-call epoch that
//     the last block advances): one launch, no reset kernel, and two calls
//     on one input agree bit for bit.
//   * the products are built twice: once for the chunk's totals, which the
//     look-back needs before the chunk's first store, and once in the
//     storing pass; both read shared memory only.
//   * in-chunk sums: each segment sums its rows from 0, the segment sums are
//     scanned across the block in a fixed order, and each segment's running
//     sum starts at its exclusive prefix; the chunk offset is added to each
//     output, never used as the start of the running sum (starting at the
//     large offset would round every step at the offset's scale).
//   * at most 64 registers a thread (8 blocks of 128 threads an SM), so the
//     BA's 964 chunks fit on the card in one wave: a chunk left to a second
//     wave pays the whole chain of load, look-back and stores again.
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; device time from
// scripts/probe_outer_scan.py, which also stamps each block's phases with
// the global timer): rows ~0.061 ms, slots ~0.043 ms. The look-back is the
// cost: every chunk's offset waits for the totals of every chunk before it,
// which arrive over ~3-16 us (staging, then the first pass, under the load
// of the whole wave), so a chunk's stores start 11-52 us in (median ~25
// us); with its offsets set to 0 the same kernel takes 0.052 / 0.033 ms,
// and without its stores 0.027 / 0.034 ms. Tried and not kept: 256 threads
// of column pairs with f32 products (40 registers, so 6 blocks an SM and a
// second wave: 0.072 / 0.072 ms; capped at 32 registers it spilled and was
// no faster), eight columns a thread (two 16-byte stores, each half-filling
// every 32-byte sector: rows 0.103 ms), a look-back that loads 16 published
// rows at once (spills: 0.096 / 0.079 ms).
//
// Constraints: ka*kb <= 128, kb even, ka + kb <= 32, M a positive multiple
// of 512 with M / 512 <= the state's capacity; sa, sb, si 16-byte aligned; si sorted ascending (any int32;
// unsorted keys give wrong sums but never a store outside hi).
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 8;     // so the BA's 964 chunks fit in one wave
constexpr int CHUNK = 512;
constexpr int MAX_KAB = 32;          // ka + kb
constexpr int KEY_END = 0x7fffffff;  // the key after the last row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

// W consecutive bf16 of b, read from shared memory in one load
template <int W> struct Lanes;
template <> struct Lanes<2> { using T = unsigned; };
template <> struct Lanes<4> { using T = uint2; };

// v[j] = bf16(a * b[j]) in f32, j < W: W / 2 bf16x2 multiplies, each
// rounding the exact product once
template <int W>
__device__ __forceinline__ void outer_terms(__nv_bfloat16 a,
                                            const __nv_bfloat16* b,
                                            float (&v)[W]) {
  const __nv_bfloat162 a2 = __bfloat162bfloat162(a);
  const typename Lanes<W>::T raw =
      *reinterpret_cast<const typename Lanes<W>::T*>(b);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < W / 2; ++j) {
    const float2 p = __bfloat1622float2(__hmul2(a2, b2[j]));
    v[2 * j] = p.x;
    v[2 * j + 1] = p.y;
  }
}

// W floats to dst (4W-byte aligned) in one store
template <int W>
__device__ __forceinline__ void store_row(float* dst, const float (&o)[W]) {
  if constexpr (W == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
  else
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}

template <int W, bool SLOTS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
outer_scan_kernel(const __nv_bfloat16* __restrict__ sa,
                  const __nv_bfloat16* __restrict__ sb,
                  const int* __restrict__ si, float* __restrict__ out,
                  unsigned* __restrict__ state, int64_t cap, int64_t nch,
                  int ka, int kb, int size) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float seg[THREADS * W];
  __shared__ float part[THREADS];
  __shared__ float offs[THREADS];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = a_s + CHUNK * ka;
  int* k_s = reinterpret_cast<int*>(b_s + CHUNK * kb);   // CHUNK + 1 keys

  const int tid = threadIdx.x;
  const lookback::Ticket tk = lookback::take_ticket(state);
  const int64_t t = tk.tile;
  const int64_t row0 = t * CHUNK;

  // the chunk's factors and keys, with the next chunk's first key after
  // them, by 16-byte cp.async (no registers held, all of them in flight;
  // CHUNK * k * 2 bytes is a multiple of 16 for every k, so chunk starts
  // stay 16-byte aligned)
  {
    const uint4* a_g = reinterpret_cast<const uint4*>(sa + row0 * ka);
    const uint4* b_g = reinterpret_cast<const uint4*>(sb + row0 * kb);
    uint4* a_v = reinterpret_cast<uint4*>(a_s);
    uint4* b_v = reinterpret_cast<uint4*>(b_s);
    for (int i = tid; i < CHUNK * ka / 8; i += THREADS)
      cp_async16(a_v + i, a_g + i);
    for (int i = tid; i < CHUNK * kb / 8; i += THREADS)
      cp_async16(b_v + i, b_g + i);
    if constexpr (SLOTS) {
      const uint4* k_g = reinterpret_cast<const uint4*>(si + row0);
      for (int i = tid; i < CHUNK / 4; i += THREADS)
        cp_async16(reinterpret_cast<uint4*>(k_s) + i, k_g + i);
      if (tid == 0) k_s[CHUNK] = t + 1 < nch ? si[row0 + CHUNK] : KEY_END;
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  }
  __syncthreads();

  // thread: the W columns col0.. (one a column c, b columns f0..), over
  // segment g of rpg consecutive rows
  const int ncol = ka * kb;
  const int tpr = ncol / W;           // threads a row
  const int ngr = THREADS / tpr;
  const int rpg = (CHUNK + ngr - 1) / ngr;
  const int p = tid % tpr;
  const int g = tid / tpr;
  const bool active = g < ngr;
  const int col0 = p * W;
  const int c = col0 / kb;
  const int f0 = col0 % kb;
  const int r0 = min(g * rpg, CHUNK);
  const int r1 = min(r0 + rpg, CHUNK);
  float v[W];

  // the segment's sums, scanned across segments in a fixed order
  float run[W];
#pragma unroll
  for (int j = 0; j < W; ++j) run[j] = 0.0f;
  if (active) {
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      outer_terms<W>(a_s[r * ka + c], b_s + r * kb + f0, v);
#pragma unroll
      for (int j = 0; j < W; ++j) run[j] += v[j];
    }
  }
  float* mine = seg + tid * W;
#pragma unroll
  for (int j = 0; j < W; ++j) mine[j] = run[j];
  __syncthreads();
  for (int d = 1; d < ngr; d <<= 1) {
    const bool take = active && g >= d;
    if (take) {
#pragma unroll
      for (int j = 0; j < W; ++j) v[j] = mine[j - d * tpr * W];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int j = 0; j < W; ++j) mine[j] += v[j];
    }
    __syncthreads();
  }
  // each segment's running sums start at its exclusive prefix
#pragma unroll
  for (int j = 0; j < W; ++j)
    run[j] = active && g > 0 ? mine[j - tpr * W] : 0.0f;
  // the chunk's totals: the last segment's inclusive sums, column tid
  const float agg = tid < ncol ? seg[(ngr - 1) * tpr * W + tid] : 0.0f;

  const float off = lookback::exclusive_offset(state, cap, nch, t, tk.mark,
                                               ncol, agg, part);
  if (tid < ncol) offs[tid] = off;
  __syncthreads();

  if (active) {
    float base[W], o[W];
#pragma unroll
    for (int j = 0; j < W; ++j) base[j] = offs[col0 + j];
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      outer_terms<W>(a_s[r * ka + c], b_s + r * kb + f0, v);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        run[j] += v[j];
        o[j] = base[j] + run[j];
      }
      if constexpr (!SLOTS) {
        store_row<W>(out + (row0 + r) * ncol + col0, o);
      } else {
        const int a = k_s[r];
        const int b = k_s[r + 1];
        if (a != b) {
          const int end = min(b, size);
          for (int u = max(a, 0); u < end; ++u)
            store_row<W>(out + (int64_t)u * ncol + col0, o);
        }
      }
    }
  }
  if constexpr (SLOTS) {
    if (t == 0) {
      // the slots before the first key hold no update
      float zero[W];
#pragma unroll
      for (int j = 0; j < W; ++j) zero[j] = 0.0f;
      const int64_t z = (int64_t)min(max(k_s[0], 0), size) * tpr;
      for (int64_t e = tid; e < z; e += THREADS)
        store_row<W>(out + (e / tpr) * ncol + (e % tpr) * W, zero);
    }
  }

  if (tid == 0) lookback::finish(state, nch, tk.mark);
}

template <bool SLOTS>
int launch_scan(const void* si, const void* sa, const void* sb, void* out,
                void* state, int64_t cap, int64_t words, int64_t m, int ka,
                int kb, int size, void* stream) {
  const int64_t nch = m / CHUNK;
  if (m < CHUNK || m % CHUNK || ka < 1 || kb < 2 || kb % 2 ||
      ka * kb > THREADS || ka + kb > MAX_KAB || nch > cap ||
      nch > 0x7fffffff || size < 0 ||
      lookback::state_words(cap, nch, ka * kb) > words ||
      ((uintptr_t)sa | (uintptr_t)sb | (uintptr_t)si) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)CHUNK * (ka + kb) * sizeof(__nv_bfloat16) +
                      (SLOTS ? (CHUNK + 1) * sizeof(int) : 0);
  // a thread owns 4 columns where it can: a warp then stores whole output
  // rows with 16-byte stores (8 columns, as two 16-byte stores a thread,
  // left every 32-byte sector half written by each store: 45% slower)
  auto go = [&](auto kernel) {
    kernel<<<(unsigned)nch, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)sa, (const __nv_bfloat16*)sb, (const int*)si,
        (float*)out, (unsigned*)state, cap, nch, ka, kb, size);
  };
  if (kb % 4 == 0)
    go(outer_scan_kernel<4, SLOTS>);
  else
    go(outer_scan_kernel<2, SLOTS>);
  return (int)cudaGetLastError();
}

}  // namespace

// out [m, ka*kb] f32 = cs. state: `words` int32 of the caller's look-back
// buffer (zeroed when it was made), with room for `cap` tile flags.
extern "C" int naruto_outer_scan_rows(const void* sa, const void* sb,
                                      void* out, void* state, int64_t cap,
                                      int64_t words, int64_t m, int ka,
                                      int kb, void* stream) {
  return launch_scan<false>(nullptr, sa, sb, out, state, cap, words, m, ka,
                            kb, 0, stream);
}

// hi [size, ka*kb] f32 from the sorted keys si [m] int32.
extern "C" int naruto_outer_scan_slots(const void* si, const void* sa,
                                       const void* sb, void* hi, void* state,
                                       int64_t cap, int64_t words, int64_t m,
                                       int ka, int kb, int size,
                                       void* stream) {
  return launch_scan<true>(si, sa, sb, hi, state, cap, words, m, ka, kb,
                           size, stream);
}
