// Inclusive cumsum over the rows of [M, F] f32: the kernel behind
// naruto_tpu_torch.ops.primitives.row_cumsum.
//
//   out[i, f] = sum over j <= i of x[j, f]       (f32 adds in a fixed order)
//
// Replaces the Pallas TPU kernel scripts/microbench_primitives.py::cs_kernel
// (P4), which scans 1024-row blocks by a lower-triangular matmul and carries
// the last row from one grid step to the next. Not carried over: the matmul
// (at the TPU's default precision it rounds its f32 inputs to bf16, while
// the script's own oracle is jnp.cumsum), the 1024-row blocking, and the
// grid of M // 1024 blocks, which leaves the tail of a ragged M unscanned.
// On the port's BA path it is the scan of the trilinear VJP's segment sum
// ([93,568, 8]).
//
// What bounded the first design (three launches: chunk totals, a scan of
// them, an offset rescan; NVIDIA H100 80GB HBM3, 700 W): at [3,000,000, 8]
// it read x twice, moving 288 MB where one pass moves 192 MB (~57 us at
// 3.35 TB/s), and took 0.1258 ms on the device (0.1821 ms by CUDA events);
// its rescan held 32 rows a thread in registers, 127 registers by ptxas, so
// two blocks fitted on an SM; and each call cost three launches and a
// second host call for the scratch size.
//
// This design: one launch that reads x once. Each block takes a tile id
// from the atomic ticket of lookback.cuh (so a tile waits only on tiles
// already resident), copies its tile of R rows (R * F <= 8192 floats, 32 KB)
// into shared memory with cp.async (no registers held), and scans it there:
// thread t owns column t % F and a segment of consecutive rows; the
// segments' sums are scanned across the block in a fixed (Hillis-Steele)
// order. The tile's column totals then go through the deterministic
// look-back of lookback.cuh (published aggregates, fixed-order group sums,
// a per-call epoch), which gives its exclusive offset, and the tile writes
// offset + its local inclusive scan, so nothing rounds at the offset's
// scale (as outer_cumsum.cu does). A tile reads at most M / (R * GROUP) +
// GROUP - 1 published rows of F floats (123 at [3M, 8]). Shared memory
// (35,848 bytes a block; ptxas: 40 registers) bounds residency at six
// blocks per SM.
//
// What bounds it now (same card): [3M, 8] takes ~0.101 ms on the device,
// where a copy of x through the same tiles takes 0.068 ms and torch's own
// copy 0.068 ms, and the same kernel without the look-back 0.074 ms: the
// waits of the look-back cost ~0.03 ms. A tile's life is a chain of
// dependent global round trips (ticket, load, publish, flag polls, offset
// reads, stores, done count), and six tiles an SM hide too little of each
// other. Measured and not kept: tiles of 4,096 floats (30% slower); of
// 12,288-24,576 floats (no faster); every thread polling its own flags
// (4-8% slower); a longest backoff of 1,024 ns (5% slower than 128 ns); a
// persistent block per SM slot that loads its next tile into a second
// buffer while it scans the current one (12% slower: three waiting tiles
// an SM instead of six); each tile summing the last complete group itself
// instead of waiting for its closer (no faster at [3M, 8], 30% slower at
// F = 256).
//
// State: the per-stream buffer of lookback.cuh, shared with outer_cumsum.cu.
//
// F must lie in [1, 256]; M is any size, the last tile is masked.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue when the state buffer is too small.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 8192;        // floats per tile at most

__host__ __device__ __forceinline__ int tile_rows(int nf) {
  const int r = (TILE / nf) & ~3;   // a multiple of 4: tiles stay 16-byte aligned
  return r < 4 ? 4 : r;
}

// 4 pad floats after every 128: a column segment's rows fall in other
// banks, and 16-byte groups stay aligned for cp.async and vector stores
__device__ __forceinline__ int px(int e) { return e + ((e >> 7) << 2); }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__global__ void __launch_bounds__(THREADS)
row_cumsum_kernel(const float* __restrict__ x, float* __restrict__ out,
                  unsigned* __restrict__ state, int64_t cap, int64_t m,
                  int nf, bool vec) {
  __shared__ __align__(16) float tile[TILE + TILE / 32];
  __shared__ float part[THREADS];
  __shared__ float offs[THREADS];

  const int tid = threadIdx.x;
  const int rows = tile_rows(nf);
  const int64_t ntiles = (m + rows - 1) / rows;
  const lookback::Ticket tk = lookback::take_ticket(state);
  const int64_t t = tk.tile;

  // the tile, zero past row m
  const int64_t row0 = t * rows;
  const int n_el = (int)((m - row0 < rows ? m - row0 : rows) * nf);
  const int tile_el = rows * nf;               // a multiple of 4
  const float* src = x + row0 * nf;
  if (vec) {
    for (int q = tid * 4; q < tile_el; q += THREADS * 4) {
      const int have = n_el - q;
      cp_async16(tile + px(q), have > 0 ? src + q : x,
                 have >= 4 ? 16 : (have > 0 ? 4 * have : 0));
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  } else {
    for (int e = tid; e < tile_el; e += THREADS)
      tile[px(e)] = e < n_el ? src[e] : 0.0f;
  }
  __syncthreads();

  // thread: column f, segment g of rpg consecutive rows
  const int ngr = THREADS / nf;
  const int rpg = (rows + ngr - 1) / ngr;
  const int f = tid % nf;
  const int g = tid / nf;
  const bool active = g < ngr;
  const int r0 = g * rpg;
  const int r1 = r0 + rpg < rows ? r0 + rpg : rows;
  float s = 0.0f;
  if (active)
    for (int r = r0; r < r1; ++r) s += tile[px(r * nf + f)];
  part[tid] = active ? s : 0.0f;
  __syncthreads();
  lookback::scan_groups(part, nf, ngr, g, active);
  const float excl = active && g > 0 ? part[tid - nf] : 0.0f;
  const float agg = tid < nf ? part[(ngr - 1) * nf + tid] : 0.0f;

  // 1-3. publish the aggregate, close a group, sum the tiles before
  const float off = lookback::exclusive_offset(state, cap, ntiles, t, tk.mark,
                                               nf, agg, part);
  if (tid < nf) offs[tid] = off;
  __syncthreads();

  // 4. offset + local inclusive scan, in place, then out
  if (active) {
    const float o = offs[f];
    float run = excl;
    for (int r = r0; r < r1; ++r) {
      float* p = tile + px(r * nf + f);
      run += *p;
      *p = o + run;
    }
  }
  __syncthreads();
  float* dst = out + row0 * nf;
  if (vec) {
    for (int q = tid * 4; q < n_el; q += THREADS * 4) {
      const float4 v = *reinterpret_cast<const float4*>(tile + px(q));
      if (q + 4 <= n_el) {
        *reinterpret_cast<float4*>(dst + q) = v;
      } else {
        dst[q] = v.x;
        if (q + 1 < n_el) dst[q + 1] = v.y;
        if (q + 2 < n_el) dst[q + 2] = v.z;
      }
    }
  } else {
    for (int e = tid; e < n_el; e += THREADS) dst[e] = tile[px(e)];
  }

  // the last block to finish readies the state for the next call
  if (tid == 0) lookback::finish(state, ntiles, tk.mark);
}

}  // namespace

// state: `words` int32 of the caller's buffer (zeroed when it was made),
// with room for `cap` tile flags.
extern "C" int naruto_row_cumsum(const void* x, void* out, void* state,
                                 int64_t cap, int64_t words, int64_t m,
                                 int nf, void* stream) {
  const int64_t ntiles = (m + tile_rows(nf) - 1) / tile_rows(nf);
  if (nf < 1 || nf > THREADS || m < 1 || ntiles > cap ||
      lookback::state_words(cap, ntiles, nf) > words ||
      ntiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  row_cumsum_kernel<<<(unsigned)ntiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (unsigned*)state, cap, m, nf, vec);
  return (int)cudaGetLastError();
}
