// The uncertainty grid's trilinear sample and its volume gradient, on the
// [X, Y, Z] grid itself: the kernels behind
// naruto_tpu_torch.ops.grid_sample.trilerp_forward and trilerp_vjp.
//
//   forward, one thread a sample p of coords [N, 3] (voxel units):
//     key[p]      the flat index in vol of the first corner of p's cell
//     w[p, k]     corner k's trilinear weight, (t_x * t_y) * t_z
//     frac[p, :]  p's place inside its cell
//     vals[p, k]  vol at corner k of p's cell
//   (the sample itself, sum_k vals * w, and the coordinate gradient are
//   the caller's torch ops, as before this kernel);
//
//   vjp, one thread a (row, corner) of si [N], the keys sorted: for the
//   first row of each run of equal keys (a touched cell u) and corner k,
//   the vertex v = u + offset(k) gets
//     d_vol[v] = ((((0 + a_0) + a_1) + ...) + a_7),
//   a_j = d_cell[rank of cell v - offset(j), j] over v's neighbouring
//   cells that the samples touched, in corner order; d_cell [N, 8] holds
//   each touched cell's summed weighted cotangent in the row of its run's
//   rank (primitives.sorted_segment_sum keyed by the ranks). d_vol comes
//   zeroed; vertices of no touched cell keep their zero.
//
// Replaces no Pallas kernel: on the TPU, XLA fuses the JAX package's
// naruto_tpu/ops/grid_sample.py gather and its scatter-add transpose. The
// port packed the grid into cells, [(X-1)(Y-1)(Z-1), 8] (a strided copy
// of every voxel eight times), gathered a sample's row from it, and
// summed the VJP's rows into a dense [(X-1)(Y-1)(Z-1), 8] before adding
// its eight corner planes into the grid. At jiraiya's 306^3 grid (114.6
// MB) each of those is a 908 MB tensor, made every BA iteration, for the
// ~93.6k samples the iteration takes: ~55 ms of packs, ~32 ms of dense
// sums and ~30-40 ms of corner-plane adds and fills a mapping step.
//
// Bound: bytes, and only those the samples need. The forward reads 12
// bytes and 8 corner values a sample and writes 80 bytes (key, weights,
// fraction, values); at the BA's 93,568 samples that is ~10 MB, 0.003 ms
// at 3.35 TB/s. The backward's only grid-sized work is the zero fill of
// d_vol (the caller's, 114.6 MB at jiraiya: 0.034 ms); the vertex pass
// reads the N keys, ranks and cell rows and writes at most 8 values a
// touched cell.
//
// Design:
//   * forward: one thread a sample; the clamp, floor, fraction and weight
//     are those of grid_sample._corner_data, each f32 op pinned with an
//     intrinsic so that nvcc's contraction cannot move a bit (the clamp as
//     torch's, NaN kept); the 8 corners are read through the read-only
//     path straight from the grid, the values a cell pack would have held;
//     weights and values leave in 16-byte stores. The sum and its product
//     stay the two torch ops they were, so the sample is theirs bit for bit;
//   * vjp: the per-cell sums are sorted_segment_sum's (the same sort, the
//     same rows in the same order, keyed by run ranks: the same sums); a
//     thread finds each neighbouring cell of its vertex by a binary search
//     over the sorted keys (N int32, L2-resident), before its own row for
//     a smaller key and after it for a larger one; the seven searches step
//     together, so a step's loads are in flight at once. A vertex has
//     exactly one writer, the first of its touched cells in corner order:
//     a thread that finds a touched cell before its own corner stops. No
//     atomics, so two calls agree bit for bit; an untouched or outside
//     cell adds nothing, where the dense sum added +0, which moves no
//     nonzero sum (a zero sum may differ in its sign only).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; profiler; 32 and 40 registers):
// at a BA iteration's 93,568 samples along rays, the forward 0.0087 ms on
// jiraiya's grid (the pack and gather it replaced 5.128 ms) and 0.0056 ms
// on office0's (0.0547); the vertex pass 0.1183 ms at jiraiya's 92,799
// touched cells and 0.0647 ms at office0's 25,614 (the searches one after
// another: 0.1872 and 0.0921 ms, latency-bound); the whole grid gradient
// (sort, ranks, segment sum, zero fill, vertex pass) 0.1874 ms at jiraiya
// against the dense path's 17.31 ms, 0.1285 ms at office0 against 0.0772.
// PERF.md's kernel table keeps the readings.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a grid it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// torch.minimum(torch.clamp(x, min=0), hi): a NaN stays NaN
__device__ __forceinline__ float clamp_to(float x, float hi) {
  if (x != x) return x;
  return fminf(fmaxf(x, 0.0f), hi);
}

__global__ void __launch_bounds__(THREADS)
trilerp_forward_kernel(const float* __restrict__ vol,
                       const float* __restrict__ coords, int64_t n, int X,
                       int Y, int Z, int* __restrict__ key,
                       float* __restrict__ w, float* __restrict__ frac,
                       float* __restrict__ vals) {
  const int64_t p = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= n) return;
  const int dims[3] = {X, Y, Z};
  float f[3];
  int i0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = clamp_to(coords[3 * p + d], float(dims[d] - 1));
    long long i = static_cast<long long>(floorf(c));
    i = i < 0 ? 0 : (i > dims[d] - 2 ? dims[d] - 2 : i);
    i0[d] = static_cast<int>(i);
    f[d] = __fsub_rn(c, static_cast<float>(i));
  }
  const int yz = Y * Z;
  const int base = i0[0] * yz + i0[1] * Z + i0[2];
  float t[2][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    t[0][d] = __fsub_rn(1.0f, f[d]);
    t[1][d] = f[d];
  }
  float wk[8], vk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    wk[k] = __fmul_rn(__fmul_rn(t[dx][0], t[dy][1]), t[dz][2]);
    vk[k] = __ldg(vol + base + dx * yz + dy * Z + dz);
  }
  key[p] = base;
  float4* wr = reinterpret_cast<float4*>(w + 8 * p);
  float4* vr = reinterpret_cast<float4*>(vals + 8 * p);
  wr[0] = make_float4(wk[0], wk[1], wk[2], wk[3]);
  wr[1] = make_float4(wk[4], wk[5], wk[6], wk[7]);
  vr[0] = make_float4(vk[0], vk[1], vk[2], vk[3]);
  vr[1] = make_float4(vk[4], vk[5], vk[6], vk[7]);
#pragma unroll
  for (int d = 0; d < 3; ++d) frac[3 * p + d] = f[d];
}

__global__ void __launch_bounds__(THREADS)
trilerp_vjp_kernel(const int* __restrict__ si, const int* __restrict__ rank,
                   const float* __restrict__ d_cell, int n, int X, int Y,
                   int Z, float* __restrict__ d_vol) {
  const int64_t t = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= 8 * int64_t(n)) return;
  const int i = static_cast<int>(t >> 3);
  const int k = static_cast<int>(t & 7);
  const int u = si[i];
  if (i > 0 && si[i - 1] == u) return;     // not the first row of its run
  const int yz = Y * Z;
  const int vx = u / yz + (k >> 2), vy = u / Z % Y + ((k >> 1) & 1),
            vz = u % Z + (k & 1);
  const int v = u + (k >> 2) * yz + ((k >> 1) & 1) * Z + (k & 1);
  // v's other cells, each looked for in the sorted keys by a binary search
  // over [lo, hi): rows before i hold smaller keys, rows after i's run
  // larger ones; a cell outside the grid gets the empty range at n
  int c[8], lo[8], hi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dx = j >> 2, dy = (j >> 1) & 1, dz = j & 1;
    const int cx = vx - dx, cy = vy - dy, cz = vz - dz;
    c[j] = v - (dx * yz + dy * Z + dz);
    const bool cell = j != k && cx >= 0 && cy >= 0 && cz >= 0 &&
                      cx <= X - 2 && cy <= Y - 2 && cz <= Z - 2;
    lo[j] = !cell ? n : (c[j] < u ? 0 : i + 1);
    hi[j] = !cell ? n : (c[j] < u ? i : n);
  }
  // the seven searches step together, their loads in flight at once
  for (bool open = true; open;) {
    int mid[8], key[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mid[j] = (lo[j] + hi[j]) >> 1;
      key[j] = lo[j] < hi[j] ? __ldg(si + mid[j]) : 0;
    }
    open = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (lo[j] < hi[j]) {
        if (key[j] < c[j])
          lo[j] = mid[j] + 1;
        else
          hi[j] = mid[j];
      }
      open |= lo[j] < hi[j];
    }
  }
  bool hit[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    hit[j] = j == k || (lo[j] < n && __ldg(si + lo[j]) == c[j]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (j < k && hit[j]) return;           // that cell's thread writes v
  float a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    a[j] = hit[j] ? d_cell[int64_t(j == k ? rank[i] : __ldg(rank + lo[j])) *
                               8 + j]
                  : 0.0f;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (hit[j]) s = __fadd_rn(s, a[j]);    // untouched cells add nothing
  d_vol[v] = s;
}

bool grid_ok(int X, int Y, int Z) {
  return X >= 2 && Y >= 2 && Z >= 2 &&
         int64_t(X) * Y * Z <= int64_t(0x7fffffff);
}

unsigned blocks(int64_t threads) {
  return static_cast<unsigned>((threads + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// vol [X, Y, Z] f32; coords [n, 3] f32; key [n] int32; w, vals [n, 8] f32,
// 16-byte aligned; frac [n, 3] f32
int naruto_trilerp_forward(const float* vol, const float* coords, int64_t n,
                           int X, int Y, int Z, int* key, float* w,
                           float* frac, float* vals, cudaStream_t stream) {
  if (!grid_ok(X, Y, Z) || n < 0 || (uintptr_t)w % 16 ||
      (uintptr_t)vals % 16)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  trilerp_forward_kernel<<<blocks(n), THREADS, 0, stream>>>(
      vol, coords, n, X, Y, Z, key, w, frac, vals);
  return cudaGetLastError();
}

// si [n] int32 sorted ascending (the forward's keys); rank [n] int32, the
// run rank of each row; d_cell [n, 8] f32, row r the sum of run r; d_vol
// [X, Y, Z] f32, zeroed by the caller
int naruto_trilerp_vjp(const int* si, const int* rank, const float* d_cell,
                       int64_t n, int X, int Y, int Z, float* d_vol,
                       cudaStream_t stream) {
  if (!grid_ok(X, Y, Z) || n < 0 || n > int64_t(0x7fffffff) / 8)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  trilerp_vjp_kernel<<<blocks(8 * n), THREADS, 0, stream>>>(
      si, rank, d_cell, static_cast<int>(n), X, Y, Z, d_vol);
  return cudaGetLastError();
}

}  // extern "C"
