// The SDF decoder's input on the vertex grid in one pass: the kernel behind
// naruto_tpu_torch.ops.encoding.vertex_query_inputs on a card.
//
//   out[p, 2l + k]         the hash grid's feature k of level l at x[p]: the
//                          level's 8 cell corners, their table rows gathered
//                          and blended trilinearly
//   out[p, 2L + d*B + i]   the one-blob's bin i of coordinate d
//
// that is torch.cat([hash_encode(table, x), one_blob_encode(x, B)], -1) on
// the "vertex" layout (tcnn's: 2 features a level) with a float32 table,
// where no gradient is asked (the map volumes, the mesh, predict_sdf).
//
// Replaces no Pallas kernel: XLA fuses the JAX package's
// naruto_tpu/ops/encoding.py:460 _encode_impl with one_blob_encode (and
// the concatenation) into a few loop fusions on the TPU. The port ran them
// as ~40 PyTorch ops, whose intermediates (the int64 [N, L, 8] corner
// coordinates and rows, the [N, L, 8, 3] weight factors, the gathered and
// weighted [N, L, 8, 2] rows, the one-blob's [N, 3, B + 1] chain) crossed
// device memory at ~8.5 KB a point: at jiraiya (306^3 voxels) the map
// query took ~667 ms of an ~856 ms mapping step, nearly all of it in
// elementwise kernels.
//
// Bound: a point reads 12 bytes and writes (2L + 3B) * 4, 320 bytes at
// 16 levels and 16 bins; the table (814,897 x 2 f32 at jiraiya, 6.5 MB) is
// read once into the 50 MB L2 and stays there. A 2^20-point chunk moves
// 348 MB, 0.104 ms at 3.35 TB/s. The 8 x L corner rows a point are L1/L2
// reads, not device-memory traffic.
//
// Design:
//   * one thread a point, in the volume's order: a warp's 32 points are
//     neighbours along z and share their cell at the coarse levels, so one
//     L1 line serves the warp's corner read there; the hashed fine levels
//     scatter, and L2 serves them;
//   * a level's 8 corner rows are read through the read-only path (__ldg),
//     all 8 in flight before the blend; the levels' sizes, strides and
//     offsets come in a __grid_constant__ parameter table;
//   * no intermediate leaves the registers: a thread writes its row with
//     16-byte stores, two levels a store (L even, B a multiple of 4,
//     checked by the wrapper);
//   * every f32 op is rounded as PyTorch's CUDA chain rounds it, each
//     pinned with an intrinsic so that nvcc's contraction cannot move a
//     bit: x * R; pos - i0 and its clamp to [0, 1]; 1 - f; the weight as
//     (t_x * t_y) * t_z; each corner's row times its weight; the 8-corner
//     sum in the order of torch's reduction kernel (four accumulators, the
//     corners c and c + 4 in accumulator c, then combined in order); the
//     one-blob's (e - x) times the f32 reciprocal of sigma * sqrt(2)
//     (torch divides by a host scalar so), erff, 0.5 * (1 + erf) and the
//     difference of neighbouring edges. The SDF decoder's GEMM then reads
//     the same bits at the same shape, strides and alignment.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; 44 registers): at
// jiraiya's 2^20-point chunk 0.974 ms on the device (profiler) against its
// 0.106 ms bound (11%: the hashed levels' corner reads are scattered L2
// sectors) and the chain's 23.15 ms; jiraiya's chunked map query 61.6 ms
// against 666.8 (events), its peak over the query 1.73 GiB against 9.69,
// both volumes the chain's bit for bit. PERF.md's kernel table keeps the
// readings.
//
// Plain C interface (loaded with ctypes): the entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a level or bin count it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_LEVELS = 32;
// instant-ngp's hash primes of y and z (x's is 1)
constexpr uint32_t PRIME_Y = 2654435761u;
constexpr uint32_t PRIME_Z = 805459861u;

struct Levels {
  float res[MAX_LEVELS];        // R: the level's cells a side
  int top[MAX_LEVELS];          // R - 1: the largest cell base
  uint32_t stride[MAX_LEVELS];  // R + 1 on a dense level, 0 on a hashed one
  uint32_t offset[MAX_LEVELS];  // the level's first table row
  uint32_t mask;                // a hashed level's rows - 1
  int n;
};

// _cell_pos: the cell base i0 = clamp(floor(x * R), 0, R - 1) and the
// fraction clamp(x * R - i0, 0, 1), as torch's clamp computes it
__device__ __forceinline__ void cell(float x, float r, int top, uint32_t& i0,
                                     float& f) {
  const float pos = __fmul_rn(x, r);
  long long i = static_cast<long long>(floorf(pos));
  i = i < 0 ? 0 : (i > top ? top : i);
  i0 = static_cast<uint32_t>(i);
  f = fminf(fmaxf(__fsub_rn(pos, static_cast<float>(i)), 0.0f), 1.0f);
}

// _level_slots: a dense level's x + y*s + z*s^2, a hashed level's
// instant-ngp hash (32-bit wrap-around) masked to its rows; plus the
// level's offset
__device__ __forceinline__ uint32_t slot(const Levels& lv, int l, uint32_t cx,
                                         uint32_t cy, uint32_t cz) {
  const uint32_t s = lv.stride[l];
  const uint32_t row = s ? cx + (cy + cz * s) * s
                         : (cx ^ (cy * PRIME_Y) ^ (cz * PRIME_Z)) & lv.mask;
  return row + lv.offset[l];
}

// torch's sum over the 8 corners of [N, L, 8, 2] (Reduce.cuh's
// thread_reduce: one thread an output, four accumulators from 0, corner c
// into accumulator c % 4, then accumulators 1-3 added to 0 in order)
__device__ __forceinline__ float corner_sum(const float* e) {
  float a[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = __fadd_rn(__fadd_rn(0.0f, e[j]), e[j + 4]);
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// one level's 2 features at (x, y, z); corner c = cx*4 + cy*2 + cz
__device__ __forceinline__ float2 level(const Levels& lv, int l, float x,
                                        float y, float z,
                                        const float2* __restrict__ table) {
  uint32_t i[3];
  float f[3], g[3];
  cell(x, lv.res[l], lv.top[l], i[0], f[0]);
  cell(y, lv.res[l], lv.top[l], i[1], f[1]);
  cell(z, lv.res[l], lv.top[l], i[2], f[2]);
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = __fsub_rn(1.0f, f[a]);
  float2 rows[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    rows[c] = __ldg(table + slot(lv, l, i[0] + (c >> 2),
                                 i[1] + ((c >> 1) & 1), i[2] + (c & 1)));
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
    w[c] = __fmul_rn(__fmul_rn((c & 4) ? f[0] : g[0], (c & 2) ? f[1] : g[1]),
                     (c & 1) ? f[2] : g[2]);
  float ex[8], ey[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    ex[c] = __fmul_rn(rows[c].x, w[c]);
    ey[c] = __fmul_rn(rows[c].y, w[c]);
  }
  return make_float2(corner_sum(ex), corner_sum(ey));
}

// one_blob_encode's Phi((e - x) / sigma) = 0.5 * (1 + erf((e - x) * inv))
__device__ __forceinline__ float cdf(float e, float x, float inv) {
  return __fmul_rn(0.5f, __fadd_rn(erff(__fmul_rn(__fsub_rn(e, x), inv)),
                                   1.0f));
}

__global__ void __launch_bounds__(THREADS)
query_inputs_kernel(const float* __restrict__ x,
                    const float2* __restrict__ table,
                    const float* __restrict__ edges, float* __restrict__ out,
                    int64_t n, int bins, float inv,
                    const __grid_constant__ Levels lv) {
  const int64_t p = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= n) return;
  const float pt[3] = {x[3 * p], x[3 * p + 1], x[3 * p + 2]};
  float4* row = reinterpret_cast<float4*>(out + p * (2 * lv.n + 3 * bins));
  int q = 0;
  for (int l = 0; l < lv.n; l += 2) {
    const float2 a = level(lv, l, pt[0], pt[1], pt[2], table);
    const float2 b = level(lv, l + 1, pt[0], pt[1], pt[2], table);
    row[q++] = make_float4(a.x, a.y, b.x, b.y);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float prev = cdf(__ldg(edges), pt[d], inv);
    for (int i = 0; i < bins; i += 4) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float next = cdf(__ldg(edges + i + j + 1), pt[d], inv);
        b[j] = __fsub_rn(next, prev);
        prev = next;
      }
      row[q++] = make_float4(b[0], b[1], b[2], b[3]);
    }
  }
}

}  // namespace

extern "C" {

// x [n, 3] f32; table [rows, 2] f32, 8-byte aligned; edges [bins + 1] f32
// (torch.linspace on the card); out [n, 2L + 3*bins] f32, 16-byte aligned;
// levels: host int32 [L][3] of (R, dense, offset); mask: a hashed level's
// rows - 1; inv: the f32 reciprocal of the one-blob's sigma * sqrt(2)
int naruto_vertex_query_inputs(const float* x, const float* table,
                               const float* edges, float* out, int64_t n,
                               const int32_t* levels, int n_levels,
                               int64_t mask, int bins, float inv,
                               cudaStream_t stream) {
  if (n_levels < 2 || n_levels > MAX_LEVELS || n_levels % 2 || bins < 4 ||
      bins % 4)
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  Levels lv;
  for (int l = 0; l < n_levels; ++l) {
    const int r = levels[3 * l];
    lv.res[l] = static_cast<float>(r);
    lv.top[l] = r - 1;
    lv.stride[l] = levels[3 * l + 1] ? static_cast<uint32_t>(r + 1) : 0u;
    lv.offset[l] = static_cast<uint32_t>(levels[3 * l + 2]);
  }
  lv.mask = static_cast<uint32_t>(mask);
  lv.n = n_levels;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  query_inputs_kernel<<<blocks, THREADS, 0, stream>>>(
      x, reinterpret_cast<const float2*>(table), edges, out, n, bins, inv,
      lv);
  return cudaGetLastError();
}

}  // extern "C"
