// Row gather: the kernel behind naruto_tpu_torch.ops.primitives.gather_rows.
//
//   out[i, :] = tbl[idx[i], :]    tbl [TS, W] of bf16, f32 or int32 (a byte
//                                 copy), idx [M] int32 or int64
//
// Replaces the Pallas TPU kernels that gather from a table held in VMEM:
//   scripts/microbench_primitives.py::take_kernel   (P2, take_along_axis)
//   scripts/microbench_primitives.py::take_kernel2  (P3, jnp.take)
//   scripts/microbench_round2.py::k_taa_bcast       (P5, broadcast indices)
//   scripts/microbench_round2.py::k_take_1d         (P6, one column, W = 1)
// The four differ only in how the TPU compiler lowers the gather; they all
// compute the function above. Their 2048-row blocking is the TPU's tiling
// and is not carried over. On the port's BA path the same kernel gathers
// the hash grid's rows ([204,089, 64] bf16, 128-byte rows), the sort
// permutation's payloads ([M, 1] int32, [M, 8] bf16) and the scan's
// boundary rows ([M, 64] f32, 256-byte rows), with the int64 indices
// torch.sort and the index arithmetic give.
//
// What bounded the first design (one thread per 1..16-byte piece of an
// output row; NVIDIA H100 80GB HBM3, 700 W):
//   * a one-wide bf16 column, [65,536, 1] x 3,000,000, took 0.0116 ms on
//     the device against index_select's 0.0135: 18 MB of index and output
//     streams at 1.55 TB/s, 46% of 3.35 TB/s. A thread moved 2 bytes, so a
//     warp stored 64 bytes, and each random 2-byte table read cost a whole
//     32-byte L2 sector;
//   * rows wider than 16 bytes divided in int64 per thread (t / pieces),
//     the piece count being a runtime value;
//   * [65,536, 8] bf16 x 3M read 1.99 TB/s (0.0302 ms for 60 MB); its
//     random 16-byte table reads take a 32-byte L2 sector each, so L2, not
//     device memory, carries most of the bytes.
// What this design does about each:
//   * rows of 2 or 4 bytes: a thread gathers 16 / row_bytes consecutive rows
//     (8 bf16 or 4 four-byte values), reads their indices with 16-byte loads
//     and writes one 16-byte store, so a warp stores 512 bytes at a time;
//   * such a table of at most STAGE_MAX_BYTES, gathered at least
//     STAGE_MIN_RATIO times over, is first copied into each SM's shared
//     memory (one 1,024-thread block per SM), so the random reads never
//     reach L2: the [65,536] bf16 column (128 KB) x 3M takes 0.0062 ms on
//     the device against 0.0095 ms read through L1/L2 and 0.0134 ms for
//     index_select. Each SM copies the whole table, so at M = 4 x TS the
//     copy cost more than it saved (0.0042 against 0.0034 ms) and at
//     16 x TS it paid (0.0042 against 0.0061 ms);
//   * the piece count of the path's row widths (16, 32, 128 and 256 bytes)
//     is a template parameter, so the row of a piece is a shift; other
//     widths take a generic instantiation whose division is 32-bit unless
//     M * pieces passes 2^32;
//   * a grid of at most BLOCKS_PER_SM blocks per SM loops over the units
//     (16-byte pieces or output words); a narrow thread has its R table
//     reads in flight at once. Keeping 2 or 4 wide pieces a thread in
//     flight over 32 or 8 blocks per SM measured 3-13% slower at the
//     path's shapes than one piece a thread over up to 64 blocks per SM,
//     which covers up to ~2.2M pieces in one pass: more warps in flight
//     hide the dependent index-then-row loads better than more loads a warp.
//
// The copy is bit-exact. An index outside [0, TS) is a device-side assert,
// as in PyTorch's own index kernels: checking it on the host would need a
// synchronisation.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <cassert>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 64;  // eight waves of the 8 resident blocks
constexpr int STAGE_THREADS = 1024;
constexpr uint64_t STAGE_MAX_BYTES = 192 * 1024;  // of the SM's 227 KB
constexpr uint64_t STAGE_MIN_RATIO = 16;          // M / TS at least

int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
    if (cached[dev] <= 0) cached[dev] = 1;
  }
  return cached[dev];
}

unsigned grid_for(uint64_t units) {
  const uint64_t want = (units + THREADS - 1) / THREADS;
  const uint64_t cap = (uint64_t)sm_count() * BLOCKS_PER_SM;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

// table row of an index; an index outside [0, ts) (negative ones included)
// fails the assert
template <typename Idx>
__device__ __forceinline__ uint64_t row_of(Idx r, uint64_t ts) {
  const uint64_t q = (uint64_t)(int64_t)r;
  assert(q < ts);
  return q;
}

// Rows of K 16-byte pieces, K a compile-time constant (the path's widths).
template <typename Idx, int K>
__global__ void __launch_bounds__(THREADS)
gather_pieces(const uint4* __restrict__ tbl, const Idx* __restrict__ idx,
              uint4* __restrict__ out, uint64_t n, uint64_t ts) {
  const uint64_t stride = (uint64_t)gridDim.x * THREADS;
  for (uint64_t u = (uint64_t)blockIdx.x * THREADS + threadIdx.x; u < n;
       u += stride) {
    const uint64_t i = u / K;
    out[u] = __ldg(tbl + row_of(__ldg(idx + i), ts) * K + (u - i * K));
  }
}

// Any other width: k pieces of type P per row, k a runtime value.
template <typename Idx, typename P>
__global__ void __launch_bounds__(THREADS)
gather_generic(const P* __restrict__ tbl, const Idx* __restrict__ idx,
               P* __restrict__ out, uint64_t n, uint32_t k, uint64_t ts) {
  const uint64_t stride = (uint64_t)gridDim.x * THREADS;
  const bool narrow_n = n <= 0xffffffffull;
  for (uint64_t u = (uint64_t)blockIdx.x * THREADS + threadIdx.x; u < n;
       u += stride) {
    const uint64_t i = narrow_n ? (uint64_t)((uint32_t)u / k) : u / k;
    out[u] = __ldg(tbl + row_of(__ldg(idx + i), ts) * k + (u - i * k));
  }
}

// Rows of one E (2 or 4 bytes): R = 16 / sizeof(E) rows per output word.
// STAGED: the whole table is first copied into shared memory.
template <typename Idx, typename E, bool STAGED>
__global__ void __launch_bounds__(STAGED ? STAGE_THREADS : THREADS)
gather_narrow(const E* __restrict__ tbl, const Idx* __restrict__ idx,
              E* __restrict__ out, uint64_t m, uint64_t ts, bool vec_idx) {
  constexpr int R = 16 / sizeof(E);
  constexpr int IV = R * sizeof(Idx) / 16;   // 16-byte index loads per word
  extern __shared__ uint4 staged[];
  E* stbl = reinterpret_cast<E*>(staged);
  if constexpr (STAGED) {
    const uint64_t vecs = (uintptr_t)tbl % 16 == 0 ? ts / R : 0;
    for (uint64_t v = threadIdx.x; v < vecs; v += blockDim.x)
      staged[v] = __ldg(reinterpret_cast<const uint4*>(tbl) + v);
    for (uint64_t e = vecs * R + threadIdx.x; e < ts; e += blockDim.x)
      stbl[e] = __ldg(tbl + e);
    __syncthreads();
  }
  auto row = [&](Idx r) -> E {
    if constexpr (STAGED) return stbl[row_of(r, ts)];
    else return __ldg(tbl + row_of(r, ts));
  };
  const uint64_t words = m / R;
  const uint64_t tid = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t w = tid; w < words; w += stride) {
    const Idx* p = idx + w * R;
    union { uint4 q[IV]; Idx i[R]; } ids;
    if (vec_idx) {
#pragma unroll
      for (int c = 0; c < IV; ++c)
        ids.q[c] = __ldg(reinterpret_cast<const uint4*>(p) + c);
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) ids.i[r] = __ldg(p + r);
    }
    union { uint4 q; E e[R]; } vals;
#pragma unroll
    for (int r = 0; r < R; ++r) vals.e[r] = row(ids.i[r]);
    reinterpret_cast<uint4*>(out)[w] = vals.q;
  }
  // the last m % R rows, one per thread
  const uint64_t r = words * R + tid;
  if (r < m) out[r] = row(__ldg(idx + r));
}

template <typename Idx, int K>
void launch_pieces(const void* tbl, const Idx* idx, void* out, uint64_t m,
                   uint64_t ts, cudaStream_t s) {
  const uint64_t n = m * K;
  gather_pieces<Idx, K><<<grid_for(n), THREADS, 0, s>>>(
      (const uint4*)tbl, idx, (uint4*)out, n, ts);
}

template <typename Idx, typename P>
void launch_generic(const void* tbl, const Idx* idx, void* out, uint64_t m,
                    uint64_t ts, int row_bytes, cudaStream_t s) {
  const uint32_t k = (uint32_t)(row_bytes / (int)sizeof(P));
  const uint64_t n = m * k;
  gather_generic<Idx, P><<<grid_for(n), THREADS, 0, s>>>(
      (const P*)tbl, idx, (P*)out, n, k, ts);
}

template <typename Idx, typename E>
void launch_narrow(const void* tbl, const Idx* idx, void* out, uint64_t m,
                   uint64_t ts, cudaStream_t s) {
  constexpr int R = 16 / sizeof(E);
  const bool vec_idx = (uintptr_t)idx % 16 == 0;
  const uint64_t stage_bytes = (ts * sizeof(E) + 15) / 16 * 16;
  if (stage_bytes <= STAGE_MAX_BYTES && m >= STAGE_MIN_RATIO * ts) {
    static bool sized[64];   // per device: the kernel may take the bytes
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64 || !sized[dev]) {
      cudaFuncSetAttribute(gather_narrow<Idx, E, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)STAGE_MAX_BYTES);
      if (dev >= 0 && dev < 64) sized[dev] = true;
    }
    gather_narrow<Idx, E, true><<<sm_count(), STAGE_THREADS, stage_bytes, s>>>(
        (const E*)tbl, idx, (E*)out, m, ts, vec_idx);
    return;
  }
  gather_narrow<Idx, E, false><<<grid_for(m / R + 1), THREADS, 0, s>>>(
      (const E*)tbl, idx, (E*)out, m, ts, vec_idx);
}

template <typename Idx>
void dispatch(const void* tbl, const Idx* idx, void* out, uint64_t m,
              uint64_t ts, int row_bytes, cudaStream_t s) {
  const uintptr_t tb = (uintptr_t)tbl, ob = (uintptr_t)out;
  if ((row_bytes == 2 || row_bytes == 4) && tb % row_bytes == 0 &&
      ob % 16 == 0) {
    if (row_bytes == 2) return launch_narrow<Idx, uint16_t>(tbl, idx, out, m, ts, s);
    return launch_narrow<Idx, uint32_t>(tbl, idx, out, m, ts, s);
  }
  const uintptr_t a = tb | ob | (uintptr_t)row_bytes;
  if (a % 16 == 0) {
    switch (row_bytes / 16) {
      case 1: return launch_pieces<Idx, 1>(tbl, idx, out, m, ts, s);
      case 2: return launch_pieces<Idx, 2>(tbl, idx, out, m, ts, s);
      case 8: return launch_pieces<Idx, 8>(tbl, idx, out, m, ts, s);
      case 16: return launch_pieces<Idx, 16>(tbl, idx, out, m, ts, s);
      default: return launch_generic<Idx, uint4>(tbl, idx, out, m, ts, row_bytes, s);
    }
  }
  if (a % 8 == 0) return launch_generic<Idx, uint2>(tbl, idx, out, m, ts, row_bytes, s);
  if (a % 4 == 0) return launch_generic<Idx, uint32_t>(tbl, idx, out, m, ts, row_bytes, s);
  if (a % 2 == 0) return launch_generic<Idx, uint16_t>(tbl, idx, out, m, ts, row_bytes, s);
  launch_generic<Idx, uint8_t>(tbl, idx, out, m, ts, row_bytes, s);
}

}  // namespace

// idx64: the indices are int64 (else int32). m >= 1, ts >= 1, row_bytes >= 1.
extern "C" int naruto_gather_rows(const void* tbl, const void* idx, void* out,
                                  int64_t m, int64_t ts, int row_bytes,
                                  int idx64, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    dispatch<long long>(tbl, (const long long*)idx, out, (uint64_t)m,
                        (uint64_t)ts, row_bytes, s);
  else
    dispatch<int>(tbl, (const int*)idx, out, (uint64_t)m, (uint64_t)ts,
                  row_bytes, s);
  return (int)cudaGetLastError();
}
