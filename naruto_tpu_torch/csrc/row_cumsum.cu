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
// ([93,568, 8]) and of the hash backward's chunk offsets ([964, 64]).
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
// from an atomic ticket (so a tile waits only on tiles already resident),
// copies its tile of R rows (R * F <= 8192 floats, 32 KB) into shared memory
// with cp.async (no registers held), and scans it there: thread t owns
// column t % F and a segment of consecutive rows; the segments' sums are
// scanned across the block in a fixed (Hillis-Steele) order. The tile then
//   1. publishes its column totals (its aggregate) with a release flag;
//   2. if it closes a group of GROUP tiles, waits for the group's
//      aggregates and publishes their sum, in a fixed order, the same way;
//   3. waits for the sums of all complete groups before it and the
//      aggregates of the earlier tiles of its own group (one warp polls the
//      flags, backing off between reads, so that waiting blocks leave L2
//      to the loads of the others), and adds them in a fixed order into
//      its exclusive offset;
//   4. writes offset + its local inclusive scan, so nothing rounds at the
//      offset's scale (as K1 in outer_cumsum.cu does).
// A classic decoupled look-back stops at the first inclusive prefix it
// finds, which depends on timing; here every sum is a fixed function of the
// input, so the result depends on the input alone, not on scheduling. A
// tile reads at most M / (R * GROUP) + GROUP - 1 published rows of F
// floats (123 at [3M, 8]). Shared memory (35,848 bytes a block; ptxas: 40
// registers) bounds residency at six blocks per SM.
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
// State: the caller keeps one zeroed int32 buffer per stream and passes it
// to every call: [ticket, done, epoch, -, tile flags (cap), group flags
// (cap / GROUP + 1), then the published floats]. A flag is current when it
// equals epoch + 1. The last block to finish resets the ticket and the done
// count and advances the epoch, so the next call needs no reset launch.
//
// F must lie in [1, 256]; M is any size, the last tile is masked.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue when the state buffer is too small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 8192;        // floats per tile at most
constexpr int GROUP = 32;         // tiles per published group sum
constexpr int HEADER = 4;         // state words before the tile flags

__host__ __device__ __forceinline__ int tile_rows(int nf) {
  const int r = (TILE / nf) & ~3;   // a multiple of 4: tiles stay 16-byte aligned
  return r < 4 ? 4 : r;
}

// 4 pad floats after every 128: a column segment's rows fall in other
// banks, and 16-byte groups stay aligned for cp.async and vector stores
__device__ __forceinline__ int px(int e) { return e + ((e >> 7) << 2); }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// part[g * nf + f] becomes the inclusive sum over g' <= g of the column-f
// values of groups g', for g < ngr, in a fixed order. All threads call it.
__device__ void scan_groups(float* part, int nf, int ngr, int g, bool active) {
  const int tid = threadIdx.x;
  for (int d = 1; d < ngr; d <<= 1) {
    float v = 0.0f;
    const bool take = active && g >= d;
    if (take) v = part[tid - d * nf];
    __syncthreads();
    if (take) part[tid] += v;
    __syncthreads();
  }
}

// Wait until the flags of entries 0..n-1 (flag(e) points at entry e's)
// read mark: warp 0 polls, lane l the entries l, l + 32, ..., backing off
// between reads so that waiting blocks leave L2 to the others; then the
// block's barrier hands the entries on to every thread. All threads call it.
template <typename Flag>
__device__ void wait_published(int64_t n, Flag flag, unsigned mark) {
  if (threadIdx.x < 32) {
    for (int64_t e = threadIdx.x; e < n; e += 32) {
      unsigned ns = 32;
      while (ld_acquire(flag(e)) != mark) {
        __nanosleep(ns);
        ns = ns < 128 ? 2 * ns : ns;
      }
    }
  }
  __syncthreads();
}

// Column sums of n published rows of nf floats, read(e, f) returning the
// value of row e in column f: lane g sums rows g, g + ngr, ... in order,
// then the lanes are scanned. Valid in threads t < nf (column t). All
// threads call it.
template <typename Read>
__device__ float sum_published(int64_t n, Read read, float* part, int nf,
                               int ngr, int f, int g, bool active) {
  const int tid = threadIdx.x;
  float s = 0.0f;
  if (active)
    for (int64_t e = g; e < n; e += ngr) s += read(e, f);
  part[tid] = active ? s : 0.0f;
  __syncthreads();
  scan_groups(part, nf, ngr, g, active);
  const float total = tid < nf ? part[(ngr - 1) * nf + tid] : 0.0f;
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(THREADS)
row_cumsum_kernel(const float* __restrict__ x, float* __restrict__ out,
                  unsigned* __restrict__ state, int64_t cap, int64_t m,
                  int nf, bool vec) {
  __shared__ __align__(16) float tile[TILE + TILE / 32];
  __shared__ float part[THREADS];
  __shared__ float offs[THREADS];
  __shared__ unsigned ticket_mark[2];

  const int tid = threadIdx.x;
  const int rows = tile_rows(nf);
  const int64_t ntiles = (m + rows - 1) / rows;
  unsigned* flags = state + HEADER;
  unsigned* gflags = flags + cap;
  float* aggs = reinterpret_cast<float*>(gflags + cap / GROUP + 1);
  float* gsums = aggs + ntiles * nf;

  if (tid == 0) {
    ticket_mark[0] = atomicAdd(state, 1u);
    ticket_mark[1] = *(volatile unsigned*)(state + 2) + 1u;
  }
  __syncthreads();
  const int64_t t = ticket_mark[0];
  const unsigned mark = ticket_mark[1];

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
  scan_groups(part, nf, ngr, g, active);
  const float excl = active && g > 0 ? part[tid - nf] : 0.0f;

  // 1. publish the aggregate
  if (tid < nf) {
    aggs[t * nf + tid] = part[(ngr - 1) * nf + tid];
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) st_release(flags + t, mark);

  // 2. close a group
  if (t % GROUP == GROUP - 1) {
    const int64_t first = t - (GROUP - 1);
    wait_published(GROUP, [&](int64_t e) { return flags + first + e; }, mark);
    const float gs = sum_published(
        GROUP,
        [&](int64_t e, int c) { return __ldcg(aggs + (first + e) * nf + c); },
        part, nf, ngr, f, g, active);
    if (tid < nf) {
      gsums[(t / GROUP) * nf + tid] = gs;
      __threadfence();
    }
    __syncthreads();
    if (tid == 0) st_release(gflags + t / GROUP, mark);
  }

  // 3. the exclusive offset: complete groups, then this group's tiles
  const int64_t gt = t / GROUP;
  const int64_t base = gt * GROUP - gt;   // tile of entry e >= gt: base + e
  const int64_t entries = gt + (t - gt * GROUP);
  wait_published(
      entries,
      [&](int64_t e) { return e < gt ? gflags + e : flags + base + e; },
      mark);
  const float off = sum_published(
      entries,
      [&](int64_t e, int c) {
        return e < gt ? __ldcg(gsums + e * nf + c)
                      : __ldcg(aggs + (base + e) * nf + c);
      },
      part, nf, ngr, f, g, active);
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
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(state + 1, 1u) == (unsigned)(ntiles - 1)) {
      atomicExch(state, 0u);
      atomicExch(state + 1, 0u);
      atomicExch(state + 2, mark);
    }
  }
}

}  // namespace

// state: `words` int32 of the caller's buffer (zeroed when it was made),
// with room for `cap` tile flags.
extern "C" int naruto_row_cumsum(const void* x, void* out, void* state,
                                 int64_t cap, int64_t words, int64_t m,
                                 int nf, void* stream) {
  const int64_t ntiles = (m + tile_rows(nf) - 1) / tile_rows(nf);
  const int64_t need = HEADER + cap + cap / GROUP + 1 +
                       (ntiles + ntiles / GROUP) * nf;
  if (nf < 1 || nf > THREADS || m < 1 || ntiles > cap || need > words ||
      ntiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  row_cumsum_kernel<<<(unsigned)ntiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, (unsigned*)state, cap, m, nf, vec);
  return (int)cudaGetLastError();
}
