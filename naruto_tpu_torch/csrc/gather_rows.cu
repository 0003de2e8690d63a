// Row gather: the kernel behind naruto_tpu_torch.ops.primitives.gather_rows.
//
//   out[i, :] = tbl[idx[i], :]     tbl [TS, W] (bf16 or f32), idx [M] int32
//
// Replaces the Pallas TPU kernels that gather from a table held in VMEM:
//   scripts/microbench_primitives.py::take_kernel   (P2, take_along_axis)
//   scripts/microbench_primitives.py::take_kernel2  (P3, jnp.take)
//   scripts/microbench_round2.py::k_taa_bcast       (P5, broadcast indices)
//   scripts/microbench_round2.py::k_take_1d         (P6, one column, W = 1)
// The four differ only in how the TPU compiler lowers the gather; they all
// compute the function above. Their 2048-row blocking is the TPU's tiling
// and is not carried over: the grid covers any M and masks its tail.
//
// What bounds it on an H100: bytes. At the scripts' shape (3,000,000 int32
// indices into a [65,536, 8] bf16 table) it reads 12 MB of indices and
// writes 48 MB; the 1 MiB table stays in the 50 MB L2 after its first touch,
// so its reads cost L2 bandwidth, not device memory. The design keeps both
// streams coalesced: one thread per P-byte piece of an output row, P the
// largest of 16, 8, 4, 2, 1 that divides the row's bytes and both base
// addresses. A bf16 row of 8 is then one 16-byte load and one 16-byte
// store per thread, and consecutive threads store to consecutive addresses.
// A one-wide bf16 column moves 2 bytes per thread.
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

template <typename Piece>
__global__ void gather_rows_kernel(const Piece* __restrict__ tbl,
                                   const int* __restrict__ idx,
                                   Piece* __restrict__ out, int64_t n,
                                   int pieces, int ts) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const int64_t i = pieces == 1 ? t : t / pieces;
  const int j = (int)(t - i * pieces);
  const int r = __ldg(idx + i);
  assert((unsigned)r < (unsigned)ts);
  out[t] = tbl[(int64_t)r * pieces + j];
}

template <typename Piece>
int launch(const void* tbl, const void* idx, void* out, int64_t m, int ts,
           int row_bytes, cudaStream_t stream) {
  const int pieces = row_bytes / (int)sizeof(Piece);
  const int64_t n = m * pieces;
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  gather_rows_kernel<Piece><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const Piece*)tbl, (const int*)idx, (Piece*)out, n, pieces, ts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int naruto_gather_rows(const void* tbl, const void* idx, void* out,
                                  int64_t m, int ts, int row_bytes,
                                  void* stream) {
  const uintptr_t a = (uintptr_t)tbl | (uintptr_t)out | (uintptr_t)row_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  if (a % 16 == 0) return launch<uint4>(tbl, idx, out, m, ts, row_bytes, s);
  if (a % 8 == 0) return launch<uint2>(tbl, idx, out, m, ts, row_bytes, s);
  if (a % 4 == 0) return launch<uint32_t>(tbl, idx, out, m, ts, row_bytes, s);
  if (a % 2 == 0) return launch<uint16_t>(tbl, idx, out, m, ts, row_bytes, s);
  return launch<uint8_t>(tbl, idx, out, m, ts, row_bytes, s);
}
