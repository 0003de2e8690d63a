// The deterministic look-back of the port's one-pass scans (row_cumsum.cu,
// outer_cumsum.cu): how a tile of a scan learns the sum of every tile
// before it within the same launch, with a result that depends on the
// input alone, never on the order in which blocks ran.
//
// Blocks on the card run in no fixed order and cannot carry a sum from
// one to the next, as the TPU's sequential grid does. A classic decoupled
// look-back stops at the first inclusive prefix it finds, which depends on
// timing. Here every block (of any size; nf <= its threads)
//   0. takes its tile id from an atomic ticket (take_ticket), so a tile
//      waits only on tiles already resident;
//   1. publishes its tile's column totals (its aggregate) with a release
//      flag;
//   2. if it closes a group of GROUP tiles, waits for the group's
//      aggregates and publishes their sum, in a fixed order, the same way;
//   3. waits for the sums of all complete groups before it and the
//      aggregates of the earlier tiles of its own group (one warp polls the
//      flags, backing off between reads, so that waiting blocks leave L2 to
//      the loads of the others), and adds them in a fixed order into its
//      exclusive offset (exclusive_offset does 1-3);
//   4. the last block to finish resets the ticket and the done count and
//      advances the epoch (finish), so the next call needs no reset launch.
// A tile reads at most ntiles / GROUP + GROUP - 1 published rows of nf
// floats, BATCH rows a thread at a time, so that BATCH round trips to L2
// are in flight.
//
// Measured and not kept (NVIDIA H100 80GB HBM3, 700 W, the fused scan of
// outer_cumsum.cu at the BA's shape, scripts/probe_outer_scan.py): each
// float published in one 64-bit word with the call's mark, no flags or
// fences, every reading thread polling its own words: 0.066 / 0.051 ms
// (rows / slots) against 0.061 / 0.043 ms with the flags, in one call;
// row_cumsum at [3M, 8] took 0.0895 ms with it and 0.0929-0.0951 ms with
// the flags, in other calls.
//
// State: the caller keeps one zeroed int32 buffer per stream and passes it
// to every call of every scan on that stream (calls on one stream run one
// after another): [ticket, done, epoch, -, tile flags (cap), group flags
// (cap / GROUP + 1), then the published floats]. A flag is current when it
// equals epoch + 1. state_words says how many words a call needs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lookback {

constexpr int GROUP = 32;         // tiles per published group sum
constexpr int HEADER = 4;         // state words before the tile flags

// int32 words of state for `cap` tile flags and ntiles tiles of nf floats
__host__ __device__ inline int64_t state_words(int64_t cap, int64_t ntiles,
                                               int nf) {
  return HEADER + cap + cap / GROUP + 1 + (ntiles + ntiles / GROUP) * nf;
}

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

// part[g * nf + f] becomes the inclusive sum over g' <= g of the column-f
// values of groups g', for g < ngr, in a fixed order. All threads call it.
__device__ inline void scan_groups(float* part, int nf, int ngr, int g,
                                   bool active) {
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
// value of row e in column f: lane g sums rows g, g + ngr, ... in order
// (loading BATCH of them before adding, so that BATCH round trips to L2
// are in flight), then the lanes are scanned. Valid in threads t < nf
// (column t). All threads call it.
constexpr int BATCH = 8;
template <typename Read>
__device__ float sum_published(int64_t n, Read read, float* part, int nf,
                               int ngr, int f, int g, bool active) {
  const int tid = threadIdx.x;
  float s = 0.0f;
  if (active) {
    int64_t e = g;
    for (; e + (BATCH - 1) * ngr < n; e += BATCH * ngr) {
      float v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) v[k] = read(e + k * ngr, f);
#pragma unroll
      for (int k = 0; k < BATCH; ++k) s += v[k];
    }
    for (; e < n; e += ngr) s += read(e, f);
  }
  part[tid] = active ? s : 0.0f;
  __syncthreads();
  scan_groups(part, nf, ngr, g, active);
  const float total = tid < nf ? part[(ngr - 1) * nf + tid] : 0.0f;
  __syncthreads();
  return total;
}

struct Ticket {
  int64_t tile;    // this block's tile, in the order blocks started
  unsigned mark;   // the flag value that is current in this call
};

// Step 0. All threads call it.
__device__ inline Ticket take_ticket(unsigned* state) {
  __shared__ unsigned ticket_mark[2];
  if (threadIdx.x == 0) {
    ticket_mark[0] = atomicAdd(state, 1u);
    ticket_mark[1] = *(volatile unsigned*)(state + 2) + 1u;
  }
  __syncthreads();
  return {(int64_t)ticket_mark[0], ticket_mark[1]};
}

// Steps 1-3 for tile t of ntiles, whose aggregate `agg` is valid in threads
// tid < nf (column tid), nf <= blockDim.x. Returns the tile's exclusive
// offset, valid in threads tid < nf. part: blockDim.x floats of shared
// scratch, which the caller may read before the call and must not read
// after it. All threads call it.
__device__ inline float exclusive_offset(unsigned* state, int64_t cap,
                                         int64_t ntiles, int64_t t,
                                         unsigned mark, int nf, float agg,
                                         float* part) {
  const int tid = threadIdx.x;
  const int ngr = blockDim.x / nf;
  const int f = tid % nf;
  const int g = tid / nf;
  const bool active = g < ngr;
  unsigned* flags = state + HEADER;
  unsigned* gflags = flags + cap;
  float* aggs = reinterpret_cast<float*>(gflags + cap / GROUP + 1);
  float* gsums = aggs + ntiles * nf;

  // 1. publish the aggregate
  if (tid < nf) {
    aggs[t * nf + tid] = agg;
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
  return sum_published(
      entries,
      [&](int64_t e, int c) {
        return e < gt ? __ldcg(gsums + e * nf + c)
                      : __ldcg(aggs + (base + e) * nf + c);
      },
      part, nf, ngr, f, g, active);
}

// Step 4: thread 0 of every block calls it after the block's stores.
__device__ inline void finish(unsigned* state, int64_t ntiles, unsigned mark) {
  __threadfence();
  if (atomicAdd(state + 1, 1u) == (unsigned)(ntiles - 1)) {
    atomicExch(state, 0u);
    atomicExch(state + 1, 0u);
    atomicExch(state + 2, mark);
  }
}

}  // namespace lookback
