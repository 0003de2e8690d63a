// Segment sum of sorted keys: the kernel behind
// naruto_tpu_torch.ops.primitives.sorted_segment_sum.
//
//   out[s, f] = sum over i with si[i] == s of r(vals[i, f])
//   si [M] int32 sorted ascending, vals [M, F] f32, out [size, F] f32,
//   r = round to bf16 (ROUND) or the identity; sums in f32.
//
// Replaces the Pallas TPU kernels that accumulate sorted updates through a
// one-hot matmul window into a table held in VMEM:
//   scripts/microbench_primitives.py::seg_kernel         (P1; bf16 one-hot
//                                                          product: ROUND)
//   scripts/microbench_round2.py::make_seg.<seg_kernel>  (P7; f32 HIGHEST)
// Their block and window sizes are the TPU's tiling and are not carried
// over; so are not their faults: the grids there cover M // BK blocks and
// leave the tail unread, a window can start past the output's end, P1 drops
// keys outside its block's window and P7 counts its window overlap twice.
// This kernel computes what those scripts check against, a segment sum,
// over all M rows. On the port's BA path it is the segment sum of the
// uncertainty grid's trilinear VJP ([93,568, 8] into [89,760, 8]).
//
// What bounds it on an H100: bytes. At the scripts' shape (3,000,000 keys
// into 201,088 x 8 slots) it reads 12 MB of keys and 96 MB of values and
// writes 6.4 MB: 0.034 ms at 3.35 TB/s. The first design gave every output
// slot its own threads, which found the slot's run by two binary searches
// over all keys (~70M dependent loads) and summed it with 4-byte loads; one
// long run was summed by F threads alone. It took 0.086-0.087 ms (NVIDIA
// H100 80GB HBM3, 700 W), and 3+ ms with one key on 60% of the rows.
//
// This design is row-parallel: one launch reads keys and values once, in
// order, and searches nothing.
//   * A block takes a tile of R consecutive rows (R = 512..2,048 at F = 8,
//     by M; the id comes from the ticket of lookback.cuh) and stages its
//     values (16-byte cp.async) and keys, with the first key of the next
//     tile, in shared memory. All copies of a tile are in flight at once,
//     and the SM's other blocks work meanwhile.
//   * Thread (j, g) owns W = 4 adjacent columns (W = 1 where F is not a
//     multiple of 4 or a pointer is not 16-byte aligned) over stretch g of L
//     consecutive rows (L = 4, 8 or 16): one 16-byte shared load and W adds
//     a row, four rows' loads placed before their sums. One pad row after
//     every stretch keeps the loads of a quarter warp on distinct banks.
//     Run boundaries are key[r] != key[r + 1], read from the tile.
//   * The write rule: a row whose key a differs from the next key b (the
//     last of all M rows: always) closes a run. It writes the run's sum to
//     out[a] if 0 <= a < size, and zeros to the slots strictly between a
//     and b. The slots before the first key of all and after the last,
//     which every block knows from si[0] and si[M - 1], are shared out
//     among all tiles (at the BA's shape they are most of the output, and
//     one SM stores only ~0.1 TB/s). Every slot is written exactly once,
//     full rows at a time, so out needs no memset, and keys outside
//     [0, size) are dropped, as jax.ops.segment_sum drops them. Gaps longer
//     than SMALL_GAP slots go to a queue in shared memory that the whole
//     block fills at the end; a long gap between two neighbouring keys is
//     still one block's work.
//   * A run inside a stretch is summed and written by its thread. A run
//     that crosses stretches is closed by the stretch that holds its last
//     row, whose head sum is joined to the sums of the stretches before it
//     by a segmented scan over the block's stretches (flag: the stretch
//     closes a run; value: the sum after its last closing row): by
//     shuffles within each warp and then over the eight warps' sums where
//     the threads of a row divide a warp, else Hillis-Steele in shared
//     memory. Either way a fixed order.
//   * A run that crosses tiles is joined across blocks: every tile
//     publishes one record, the sum of its rows after its last closing row
//     (all its rows if it closes none), each float in one 64-bit word with
//     the call's mark, so publishing takes no flag, no fence and no
//     barrier. The tile that holds the run's last row adds the records of
//     the tiles before it that the run covers. Which these are it reads
//     from the keys alone (tile u lies inside the run iff si[u * R] equals
//     the key), so it waits for exactly those tiles, and those started
//     before it (the ticket) and wait for nobody before publishing: no
//     chain, no deadlock. The records are added in a fixed order
//     (lookback::sum_published). This, not a second launch over the tiles'
//     edges, because the BA's step is bound by its count of launches, and a
//     record here never depends on an earlier one, unlike a scan's prefix.
//     One long run is thus split over stretches and tiles like any rows.
//   * No float atomics: the order of every addition depends on M, F and the
//     keys alone, so two calls on the same input agree bit for bit.
//   * F: a launch takes up to 256 columns, so a wider F is cut into column
//     blocks, one launch each; F = 8 is the designed shape.
//
// What bounds it now (same card; device time, and a per-block timeline of
// global-timer stamps, from scripts/probe_segment_sum.py and chip_smoke.py):
// 0.058-0.060 ms at the scripts' shape (57-59% of the bound), 0.057-0.060
// ms with one key on 60% of the rows, 0.0068 ms at the BA's shape with
// uniform keys and 0.011 ms with the BA's own (launch-bound: 0.0019 ms of
// bytes; a kernel that stores nothing takes 0.0058). A tile of 2,048 rows
// lives ~7.5 us: ticket 0.5, staging 3.1 (median; 6.7 at the 90th
// percentile, when a wave of blocks loads at once), walk 1.8, scan 0.8,
// the wait for the neighbour's record 1.0 (2.3 at the 90th percentile),
// stores 0.3; two tiles an SM (78 KB each) leave device memory idle while
// both walk.
// Measured and not kept: a halo, the 32 rows before a tile staged with it,
// so that only a run longer than that waits for another block (0.053-0.054
// against 0.060-0.061 ms at the scripts' shape, but 0.0075 against 0.0075
// ms at the BA's, the only shape the mapper runs, for a second way to join
// runs); the record behind a flag with a fence (the fence waits for the
// thread's stores: +0.004 ms); the scan over stretches as Hillis-Steele in
// shared memory (14 barriers: +0.005 ms); stretches of at most 8 rows
// (0.055 ms on uniform keys but 0.072 with one key on 60% of the rows) and
// of 4 (0.074 and 0.109 ms); the gap code out of line (80 registers, no
// faster); an L2 prefetch of the tile one wave ahead (slower); the tile id
// from blockIdx instead of the ticket (0.060-0.062 ms, and a waiting tile
// could then hold the SM its neighbour needs); the leading and trailing
// empty slots left to the first and last tile (0.037 against 0.0066 ms
// where the keys crowd on 25,000 of the BA's 89,760 slots); SMALL_GAP = 8
// (0.0085 against 0.0066 ms with keys in every 20th of the BA's slots);
// every gap zeroed by its row's threads, with no queue (the same at the
// BA's shape, but one thread a column group for a gap of 100,000 slots); a
// warp to each queued gap (no faster); no queue, but the block's threads
// sharing all empty slots evenly by a scan of the gaps' lengths (each slot
// then searches the running totals: the BA's cells 0.018 ms, and 0.35
// against 0.08 ms where three gaps hold all 200,000 slots).
//
// State: the per-stream buffer of lookback.cuh (ticket, done count,
// epoch), shared with row_cumsum.cu and outer_cumsum.cu; the records lie
// where those publish their aggregates.
//
// Unsorted keys give wrong sums but never a store outside out.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_LSH = 2;          // a stretch has at least 4 rows,
constexpr int MAX_LSH = 4;          // at most 16 where tiles stay plenty
constexpr int MIN_ROWS = 32;        // a tile owns at least this many rows
constexpr int TARGET_TILES = 1056;  // 8 tiles an SM before stretches grow
constexpr int SMALL_GAP = 32;       // longer gaps are filled by the block
constexpr int QCAP = 128;           // queued gaps a tile
constexpr int MAX_SMEM = 96 * 1024;
constexpr int NO_STOP = 0x7fffffff;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(s), "l"(gmem) : "memory");
}

// W floats from src / to dst (4W-byte aligned) in one access
template <int W>
__device__ __forceinline__ void load_row(const float* src, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *src;
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* dst, const float (&o)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  else
    *dst = o[0];
}

// Columns col0 .. col0 + ncols of the sum; ncols a multiple of W, at most
// THREADS. A tile has (THREADS / (ncols / W)) << lsh rows.
template <int W, bool ROUND>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const int* __restrict__ si, const float* __restrict__ vals,
                   float* __restrict__ out, unsigned* __restrict__ state,
                   int64_t cap, int64_t m, int size, int nf, int col0,
                   int ncols, int lsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float xs[THREADS * W];
  __shared__ int fl[THREADS];
  __shared__ float part[THREADS];     // scratch of the join
  __shared__ float carry[THREADS];
  __shared__ int gaps[QCAP][2];
  __shared__ int ngaps, stop, edge[2];

  const int tid = threadIdx.x;
  const int tpr = ncols / W;              // threads a row
  const int ngr = THREADS / tpr;          // stretches a tile
  const int L = 1 << lsh;                 // rows a stretch
  const int R = ngr << lsh;               // rows a tile
  const int64_t ntiles = m > 0 ? (m + R - 1) / R : 1;
  const lookback::Ticket tk = lookback::take_ticket(state);
  const int64_t t = tk.tile;
  const int64_t row0 = t * R;             // its first row
  const int r_hi = (int)(m - row0 < R ? m - row0 : R);   // rows it holds
  float* tile = reinterpret_cast<float*>(smem);   // R + ngr rows
  int* keys = reinterpret_cast<int*>(tile + (size_t)(R + ngr) * ncols);
  // the tiles' records: 64-bit words where the scans publish their floats
  volatile unsigned long long* recs =
      reinterpret_cast<volatile unsigned long long*>(
          ((uintptr_t)lookback::published_floats(state, cap) + 7) &
          ~(uintptr_t)7);
  const int j = tid % tpr;
  const int g = tid / tpr;
  const bool active = g < ngr;
  // row r of the tile lies at row prow(r) of shared memory: one pad row after
  // every stretch
  auto prow = [&](int r) { return r + (r >> lsh); };

  // stage the rows
  if (active) {
    const float* src = vals + row0 * nf + col0 + j * W;
    for (int r = g; r < r_hi; r += ngr)
      cp_async<4 * W>(tile + (size_t)prow(r) * ncols + j * W,
                      src + (int64_t)r * nf);
  }
  for (int r = tid; r <= r_hi && row0 + r < m; r += THREADS)
    cp_async<4>(keys + prow(r), si + row0 + r);
  if (tid == 0) {
    ngaps = 0;
    edge[0] = t > 0 ? si[row0 - 1] : 0;   // the tile before: its last key
    edge[1] = t > 0 ? si[row0 - R] : 0;   // and its first
  }
  asm volatile("cp.async.commit_group;" ::: "memory");

  float zero[W];
#pragma unroll
  for (int w = 0; w < W; ++w) zero[w] = 0.0f;
  auto put = [&](int64_t slot, const float (&v)[W]) {
    store_row<W>(out + slot * nf + col0 + j * W, v);
  };
  // While the copies fly: the slots before the first key of all and after
  // the last hold no update, and may be most of the output (the BA's rays
  // cross a part of the grid), so every tile zeroes its share of them.
  {
    const int first = m > 0 ? __ldg(si) : 0;
    const int final = m > 0 ? __ldg(si + m - 1) : 0;
    const unsigned lead = m > 0 ? min(max(first, 0), size) : size;
    const unsigned trail =
        m > 0 ? (final < 0 ? 0 : final < size ? final + 1 : size) : size;
    const unsigned empty = lead + size - trail;
    const unsigned share = (empty + (unsigned)ntiles - 1) / (unsigned)ntiles;
    const int64_t hi = min((t + 1) * share, (int64_t)empty);
    if (active) {
      for (int64_t i = t * share + g; i < hi; i += ngr)
        put(i < lead ? i : trail + (i - lead), zero);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const int key0 = keys[0];               // its first key (m > 0)
  // slots lo .. end hold no update: queue them for the block, or, the queue
  // full, zero them here (one thread, every column)
  auto push_gap = [&](int lo, int end) {
    const int q = atomicAdd(&ngaps, 1);
    if (q < QCAP) {
      gaps[q][0] = lo;
      gaps[q][1] = end;
    } else {
      for (int64_t u = lo; u < end; ++u)
        for (int c = 0; c < ncols; ++c) out[u * nf + col0 + c] = 0.0f;
    }
  };
  // the write rule for a closing row with key a, the next key clamped to
  // `end` (gap: whether there may be slots between them), and the run's sum
  auto emit = [&](int a, int end, bool gap, const float (&sum)[W]) {
    if (a >= 0 && a < size) put(a, sum);
    if (!gap) return;
    const int64_t lo = a < 0 ? 0 : (int64_t)a + 1;
    const int64_t n = end - lo;
    if (n <= 0) return;
    if (n <= SMALL_GAP) {
      for (int64_t u = lo; u < end; ++u) put(u, zero);
    } else if (j == 0) {
      push_gap((int)lo, end);
    }
  };

  // the stretch: runs inside it are written at once; its first closing row
  // waits for the sums of the stretches before (head), and what follows
  // its last closing row is handed on (acc).
  float acc[W], head[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = head[w] = 0.0f;
  bool closes = false;
  int head_key = 0, head_end = 0;
  bool head_gap = false;
  const int last_r = m - 1 - row0 < r_hi ? (int)(m - 1 - row0) : -1;
  // one row: its key a, the next key b, its values v
  auto row = [&](int r, int a, int b, float (&v)[W]) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (ROUND) v[w] = __bfloat162float(__float2bfloat16_rn(v[w]));
      acc[w] += v[w];
    }
    const bool last = r == last_r;
    if (a != b || last) {
      const int end = min(b, size);
      const bool gap = !last && (unsigned)b - (unsigned)a != 1u;
      if (!closes) {
        closes = true;
        head_key = a;
        head_end = end;
        head_gap = gap;
#pragma unroll
        for (int w = 0; w < W; ++w) head[w] = acc[w];
      } else {
        emit(a, end, gap, acc);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    }
  };
  if (active) {
    const int g0 = g << lsh;
    const int r1 = min(g0 + L, r_hi);
    const float* vrow = tile + (size_t)(g0 + g) * ncols + j * W;
    const int* krow = keys + g0 + g;
    if (r1 == g0 + L) {
      // a whole stretch, four rows at a time: their loads before their sums
#pragma unroll 1
      for (int c = 0; c < L; c += 4) {
        int k[5];
        float v[4][W];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          k[i] = krow[c + i];
          load_row<W>(vrow + (size_t)(c + i) * ncols, v[i]);
        }
        k[4] = c + 4 < L ? krow[c + 4] : krow[L + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) row(g0 + c + i, k[i], k[i + 1], v[i]);
      }
    } else {
      for (int r = g0; r < r1; ++r) {
        float v[W];
        load_row<W>(tile + (size_t)prow(r) * ncols + j * W, v);
        row(r, keys[prow(r)], keys[prow(r + 1)], v);
      }
    }
  }

  // Segmented scan over the stretches, in a fixed order. Afterwards:
  // before = what the stretches before hand to this one, open = whether
  // that reaches back to the tile's first row; and in the last stretch,
  // rec = the tile's record; tile_closes = whether the tile closes a run.
  float before[W], rec[W];
  bool open = true, tile_closes;
#pragma unroll
  for (int w = 0; w < W; ++w) before[w] = rec[w] = 0.0f;
  if (32 % tpr == 0) {
    // within each warp by shuffles, then over the warps' sums
    const int lane = tid & 31, wid = tid >> 5;
    int f = closes;
    for (int d = tpr; d < 32; d <<= 1) {
      float pv[W];
      const int pf = __shfl_up_sync(0xffffffffu, f, d);
#pragma unroll
      for (int w = 0; w < W; ++w)
        pv[w] = __shfl_up_sync(0xffffffffu, acc[w], d);
      if (lane >= d) {
        if (!f) {
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] += pv[w];
        }
        f |= pf;
      }
    }
    int ef = __shfl_up_sync(0xffffffffu, f, tpr);
#pragma unroll
    for (int w = 0; w < W; ++w)
      before[w] = __shfl_up_sync(0xffffffffu, acc[w], tpr);
    if (lane < tpr) {
      ef = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) before[w] = 0.0f;
    }
    if (lane >= 32 - tpr) {
#pragma unroll
      for (int w = 0; w < W; ++w) xs[wid * ncols + j * W + w] = acc[w];
      if (j == 0) fl[wid] = f;
    }
    tile_closes = __syncthreads_or(closes);
    float pre[W];
    int pref = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) pre[w] = 0.0f;
    for (int k = wid - 1; k >= 0 && !pref; --k) {
#pragma unroll
      for (int w = 0; w < W; ++w) pre[w] += xs[k * ncols + j * W + w];
      pref = fl[k];
    }
    open = !ef && !pref;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      rec[w] = acc[w] + (f ? 0.0f : pre[w]);
      before[w] += ef ? 0.0f : pre[w];
    }
  } else {
    // Hillis-Steele in shared memory
#pragma unroll
    for (int w = 0; w < W; ++w) xs[tid * W + w] = acc[w];
    fl[tid] = closes;
    tile_closes = __syncthreads_or(closes);
    for (int d = 1; d < ngr; d <<= 1) {
      const bool take = active && g >= d;
      const int from = tid - d * tpr;
      float pv[W];
      int pf = 0;
      if (take) {
        pf = fl[from];
#pragma unroll
        for (int w = 0; w < W; ++w) pv[w] = xs[from * W + w];
      }
      __syncthreads();
      if (take) {
        if (!fl[tid]) {
#pragma unroll
          for (int w = 0; w < W; ++w) xs[tid * W + w] += pv[w];
        }
        fl[tid] |= pf;
      }
      __syncthreads();
    }
    if (active && g > 0) {
      open = !fl[tid - tpr];
#pragma unroll
      for (int w = 0; w < W; ++w) before[w] = xs[(tid - tpr) * W + w];
    }
    if (active) {
#pragma unroll
      for (int w = 0; w < W; ++w) rec[w] = xs[tid * W + w];
    }
  }

  // The tile's record, published before any wait: each float in one
  // 64-bit word with the call's mark, so that it needs no flag, no fence
  // and no barrier here (a fence would wait for this thread's stores of
  // finished runs), and costs nothing where no tile reads it.
  if (active && g == ngr - 1) {
#pragma unroll
    for (int w = 0; w < W; ++w)
      recs[t * ncols + j * W + w] =
          (unsigned long long)tk.mark << 32 | __float_as_uint(rec[w]);
  }
  // column c of tile u's record, once it is there
  auto record = [&](int64_t u, int c) {
    const volatile unsigned long long* p = recs + u * ncols + c;
    unsigned long long v;
    for (unsigned ns = 32; (unsigned)((v = *p) >> 32) != tk.mark;
         ns = ns < 128 ? 2 * ns : ns)
      __nanosleep(ns);
    return __uint_as_float((unsigned)v);
  };

  // runs that began in this tile
  if (active && closes && !open) {
#pragma unroll
    for (int w = 0; w < W; ++w) head[w] += before[w];
    emit(head_key, head_end, head_gap, head);
  }

  // The run that was open at the tile's first row: if the row before has
  // its key, add the records of the tiles before that the run covers.
  const bool joins = tile_closes && t > 0 && edge[0] == key0;
  if (joins) {
    int64_t nrec = 1;
    if (edge[1] == key0) {
      // tile t - 1 lies inside the run: count the tiles that do, THREADS
      // of them a step
      if (tid == 0) stop = NO_STOP;
      __syncthreads();
      int s;
      for (int64_t base = 0;;) {
        const int64_t e = base + tid;
        if (e < t && si[(t - 1 - e) * R] != key0) atomicMin(&stop, (int)e);
        __syncthreads();
        s = stop;
        __syncthreads();
        base += THREADS;
        if (s != NO_STOP || base >= t) break;
      }
      const int64_t inside = s != NO_STOP ? s : t;
      nrec = inside;
      if (inside < t && si[(t - inside) * R - 1] == key0) ++nrec;
    }
    if (nrec == 1) {
      if (tid < ncols) carry[tid] = record(t - 1, tid);
    } else {
      const int cg = THREADS / ncols;
      const float tot = lookback::sum_published(
          nrec, [&](int64_t e, int c) { return record(t - 1 - e, c); }, part,
          ncols, cg, tid % ncols, tid / ncols, tid / ncols < cg);
      if (tid < ncols) carry[tid] = tot;
    }
    __syncthreads();
  }
  if (active && closes && open) {
    float c[W];
#pragma unroll
    for (int w = 0; w < W; ++w) c[w] = joins ? carry[j * W + w] : 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) head[w] += before[w] + c[w];
    emit(head_key, head_end, head_gap, head);
  }

  // the queued gaps, one after another, by the whole block
  __syncthreads();
  const int ng = min(ngaps, QCAP);
  if (active) {
    for (int i = 0; i < ng; ++i)
      for (int64_t u = (int64_t)gaps[i][0] + g; u < gaps[i][1]; u += ngr)
        put(u, zero);
  }

  if (tid == 0) lookback::finish(state, ntiles, tk.mark);
}

template <int W, bool ROUND>
int launch_columns(const int* si, const float* vals, float* out,
                   unsigned* state, int64_t cap, int64_t words, int64_t m,
                   int size, int nf, int col0, int ncols,
                   cudaStream_t stream) {
  const int ngr = THREADS / (ncols / W);
  auto rows = [&](int lsh) { return (int64_t)ngr << lsh; };
  int lsh = MIN_LSH;
  while (rows(lsh) < MIN_ROWS) ++lsh;
  while (lsh < MAX_LSH && m / rows(lsh + 1) >= TARGET_TILES) ++lsh;
  const int64_t R = rows(lsh);
  const int64_t ntiles = m > 0 ? (m + R - 1) / R : 1;
  const size_t smem = ((size_t)(R + ngr) * ncols + R + ngr + 1) *
                      sizeof(float);
  if (ntiles > cap || ntiles > 0x7fffffff || smem > MAX_SMEM ||
      lookback::state_words(cap, ntiles, 2 * ncols) + 2 > words)
    return (int)cudaErrorInvalidValue;
  auto kernel = segment_sum_kernel<W, ROUND>;
  // static and dynamic shared memory together may pass 48 KB only by leave
  if (smem > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)ntiles, THREADS, smem, stream>>>(
      si, vals, out, state, cap, m, size, nf, col0, ncols, lsh);
  return (int)cudaGetLastError();
}

}  // namespace

// out [size, nf] f32, every row written. state: `words` int32 of the
// caller's look-back buffer (zeroed when it was made), with room for `cap`
// tile flags; a tile owns at least MIN_ROWS rows.
extern "C" int naruto_sorted_segment_sum(const void* si, const void* vals,
                                         void* out, void* state, int64_t cap,
                                         int64_t words, int64_t m, int size,
                                         int nf, int round_bf16,
                                         void* stream) {
  if (m < 0 || size < 1 || nf < 1) return (int)cudaErrorInvalidValue;
  const bool vec =
      nf % 4 == 0 && ((uintptr_t)vals | (uintptr_t)out) % 16 == 0;
  for (int col0 = 0; col0 < nf; col0 += THREADS) {
    const int ncols = nf - col0 < THREADS ? nf - col0 : THREADS;
    auto go = [&](auto launch) {
      return launch((const int*)si, (const float*)vals, (float*)out,
                    (unsigned*)state, cap, words, m, size, nf, col0, ncols,
                    (cudaStream_t)stream);
    };
    const int rc =
        vec ? (round_bf16 ? go(launch_columns<4, true>)
                          : go(launch_columns<4, false>))
            : (round_bf16 ? go(launch_columns<1, true>)
                          : go(launch_columns<1, false>));
    if (rc != 0) return rc;
  }
  return 0;
}
