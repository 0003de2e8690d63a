// The mapper's optimizer steps, one launch per optimizer: the kernels behind
// naruto_tpu_torch.mapping.optim.EmbedAdam.step and Adam.step on a card.
//
//   embed_adam   the hash table's Adam (betas 0.9 / 0.99, eps 1e-15, the
//                corrections 1 / (1 - b^t) applied to the moments);
//   adam         torch.optim.Adam's update (coupled weight decay, no
//                amsgrad): the decoders', the uncertainty grid's and each
//                pose group's.
//
// Replaces no Pallas kernel: the JAX package steps its optimizers with optax
// (and its own EmbedAdam) inside the jitted BA, where XLA fuses the update
// into one pass over each leaf on the TPU. The port ran each step as a chain
// of PyTorch elementwise ops (the plain versions in mapping/optim.py): for
// the hybrid table about 25 tensor-sized reads and writes over its 36 MB
// f32 master, and for the small optimizers ~40 launches an iteration. This
// file gives the card what XLA gave the TPU.
//
// Bound: an update reads p, g, m and v and writes p, m and v, 28 bytes a
// parameter, nothing to compute worth counting. The hybrid table (hash rows
// [131,072, 64] and the dense grids [17^3, 8] and [42^3, 8]: 9,020,616
// parameters) moves 252.6 MB, 0.0754 ms at 3.35 TB/s; the parity table
// ([814,897, 2]) 45.6 MB, 0.0136 ms.
//
// Design:
//   * multi-tensor: one launch takes up to MAX_SEGS leaves as a table of
//     segments passed by value in the kernel's parameters (p, g, m, v
//     pointers, length, first chunk; __grid_constant__, so that a thread
//     indexes it where it lies instead of copying it), and walks one flat
//     range of 4-element chunks across them with a grid stride; a thread's
//     segment only moves forward, so it finds its leaf by stepping, not by
//     a search;
//   * a chunk of a segment whose four pointers are 16-byte aligned is read
//     and written with 16-byte vector loads and stores; the ragged last
//     chunk of a leaf whose length is no multiple of 4, and every chunk of a
//     misaligned leaf, go element by element;
//   * one wave of THREADS-thread blocks (BLOCKS_PER_SM resident per SM):
//     at the hybrid table a thread has ~8 chunks in turn, with 64 bytes of
//     loads in flight each;
//   * the step's corrections are read through device pointers (a row of the
//     BA call's scalars), so a captured graph's replays take each call's
//     step counts; the betas, eps, the learning rate and the weight decay
//     are the optimizer's constants and come as arguments;
//   * every op is rounded as the PyTorch chain on the card rounds it, each
//     pinned with an intrinsic so that nvcc's contraction cannot move a
//     bit: torch's add_ / sub_ with alpha, addcmul_, lerp_ and the update's
//     addcdiv compute a + alpha * b as one fused multiply-add; its sqrt and
//     divisions are IEEE-rounded; nothing is flushed to zero.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; profiler device time, steps back
// to back): the hybrid table 0.0908 ms against its 0.0754 ms bound (83%;
// the plain chain 0.3237 ms in 30 launches); the parity table 0.0096 ms,
// under its 0.0136 ms bound because its 26 MB stay in the 50 MB L2 from
// one step to the next (chip_smoke.py also times it with L2 flushed); the
// decoders 0.0020 ms and the uncertainty grid 0.0022 ms, launch-bound
// (their chains 0.0546 and 0.1234 ms in 35 and 34 launches). PERF.md's
// kernel table keeps the readings.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SEGS = 16;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2,048 resident threads an SM

struct Segment {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t numel;
  int64_t chunk0;    // the segment's first chunk in the flat range
  int vec;           // all four pointers 16-byte aligned
};

struct Segments {
  Segment s[MAX_SEGS];
  int64_t end[MAX_SEGS];   // one past each segment's last chunk
  int n;
  int64_t chunks;
};

// EmbedAdam.step's chain: m.mul_(b1).add_(g, alpha=1 - b1);
// v.mul_(b2).addcmul_(g, g, value=1 - b2);
// p.sub_((m * bc1) / (sqrt(v * bc2) + eps), alpha=lr)
struct EmbedAdamOp {
  float b1, a1, b2, a2, neg_lr, eps;
  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v, float bc1,
                                             float bc2) const {
    m = __fmaf_rn(a1, g, __fmul_rn(m, b1));
    v = __fmaf_rn(a2, __fmul_rn(g, g), __fmul_rn(v, b2));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, bc2)), eps);
    p = __fmaf_rn(neg_lr, __fdiv_rn(__fmul_rn(m, bc1), den), p);
  }
};

// Adam.step's chain (torch.optim.Adam's multi-tensor CUDA update):
// g + wd * p; m.lerp_(g, 1 - b1); v.mul_(b2).addcmul_(g, g, 1 - b2);
// d = sqrt(v) / bc2_sqrt + eps; p + step_size * (m / d)
struct AdamOp {
  float wd, w1, b2, a2, eps;
  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v, float bc2_sqrt,
                                             float step_size) const {
    if (wd != 0.0f) g = __fmaf_rn(wd, p, g);
    m = __fmaf_rn(w1, __fsub_rn(g, m), m);
    v = __fmaf_rn(a2, __fmul_rn(g, g), __fmul_rn(v, b2));
    const float den = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2_sqrt), eps);
    p = __fmaf_rn(step_size, __fdiv_rn(m, den), p);
  }
};

template <class Op>
__global__ void __launch_bounds__(THREADS)
multi_tensor_step(const __grid_constant__ Segments segs, const Op op,
                  const float* s0p, const float* s1p) {
  const float s0 = *s0p, s1 = *s1p;
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  int k = 0;
  for (int64_t c = int64_t(blockIdx.x) * THREADS + threadIdx.x;
       c < segs.chunks; c += stride) {
    while (c >= segs.end[k]) ++k;
    const Segment& sg = segs.s[k];
    const int64_t e = (c - sg.chunk0) * 4;
    const int64_t left = sg.numel - e;
    if (sg.vec && left >= 4) {
      float4 p = *reinterpret_cast<const float4*>(sg.p + e);
      const float4 g = __ldg(reinterpret_cast<const float4*>(sg.g + e));
      float4 m = *reinterpret_cast<const float4*>(sg.m + e);
      float4 v = *reinterpret_cast<const float4*>(sg.v + e);
      op(p.x, g.x, m.x, v.x, s0, s1);
      op(p.y, g.y, m.y, v.y, s0, s1);
      op(p.z, g.z, m.z, v.z, s0, s1);
      op(p.w, g.w, m.w, v.w, s0, s1);
      *reinterpret_cast<float4*>(sg.p + e) = p;
      *reinterpret_cast<float4*>(sg.m + e) = m;
      *reinterpret_cast<float4*>(sg.v + e) = v;
    } else {
      for (int64_t j = e; j < e + (left < 4 ? left : 4); ++j) {
        float p = sg.p[j], m = sg.m[j], v = sg.v[j];
        op(p, sg.g[j], m, v, s0, s1);
        sg.p[j] = p;
        sg.m[j] = m;
        sg.v[j] = v;
      }
    }
  }
}

int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!cached[dev])
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev];
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <class Op>
int launch(void* const* p, void* const* g, void* const* m, void* const* v,
           const int64_t* numel, int n, const Op& op, const float* s0,
           const float* s1, cudaStream_t stream) {
  if (n < 1 || n > MAX_SEGS) return int(cudaErrorInvalidValue);
  Segments segs{};
  int64_t chunks = 0;
  for (int i = 0; i < n; ++i) {
    Segment& sg = segs.s[i];
    sg.p = static_cast<float*>(p[i]);
    sg.g = static_cast<const float*>(g[i]);
    sg.m = static_cast<float*>(m[i]);
    sg.v = static_cast<float*>(v[i]);
    sg.numel = numel[i];
    sg.chunk0 = chunks;
    sg.vec = aligned(p[i]) && aligned(g[i]) && aligned(m[i]) && aligned(v[i]);
    chunks += (numel[i] + 3) / 4;
    segs.end[i] = chunks;
  }
  segs.n = n;
  segs.chunks = chunks;
  if (chunks == 0) return int(cudaGetLastError());
  const int64_t want = (chunks + THREADS - 1) / THREADS;
  const int64_t cap = int64_t(sm_count()) * BLOCKS_PER_SM;
  const int blocks = int(want < cap ? want : cap);
  multi_tensor_step<Op><<<blocks, THREADS, 0, stream>>>(segs, op, s0, s1);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// bc1 / bc2: device pointers to 1 / (1 - b1^t) and 1 / (1 - b2^t)
int naruto_embed_adam(void* const* p, void* const* g, void* const* m,
                      void* const* v, const int64_t* numel, int n,
                      const float* bc1, const float* bc2, float b1, float a1,
                      float b2, float a2, float neg_lr, float eps,
                      cudaStream_t stream) {
  return launch(p, g, m, v, numel, n, EmbedAdamOp{b1, a1, b2, a2, neg_lr, eps},
                bc1, bc2, stream);
}

// bc2_sqrt / step_size: device pointers to sqrt(1 - b2^t) and
// -lr / (1 - b1^t)
int naruto_adam(void* const* p, void* const* g, void* const* m,
                void* const* v, const int64_t* numel, int n,
                const float* bc2_sqrt, const float* step_size, float wd,
                float w1, float b2, float a2, float eps, cudaStream_t stream) {
  return launch(p, g, m, v, numel, n, AdamOp{wd, w1, b2, a2, eps}, bc2_sqrt,
                step_size, stream);
}

}  // extern "C"
