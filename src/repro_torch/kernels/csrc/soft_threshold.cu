// Element-wise soft thresholding (the l1 prox) over a batch of blocks, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel soft_threshold_pallas (repro/kernels/soft_threshold.py):
//
//     out = sign(x) * max(|x| - tau, 0)
//
// with tau cast to x's dtype first. The Pallas kernel shrinks one 2-D block
// by one scalar; the ADMM S-update runs a stacked leaf (L, n, m) as one batch
// of nb blocks, each with its own tau = beta / rho (JAX gets the same effect
// by vmapping the per-block sweep). So this kernel takes x (nb, per)
// contiguous, f32 or bf16, and tau as a DEVICE vector (nb,) f32: the
// controller's beta never leaves the card, and the launch needs no host sync.
//
// Numerics. tau is rounded to x's dtype, then the arithmetic runs in f32 and
// the result is stored in x's dtype (for bf16 the difference |x| - tau is
// exact in f32 except when the exponents are far apart, so the stored value
// is within one bf16 ulp of the bf16 computation). NaN is written through
// (jnp.sign(NaN) is NaN; copysignf(fmaxf(...)) would give 0), a NaN
// difference stays NaN (jnp.maximum propagates it), tau = 0 returns x, and
// +-inf stays +-inf for a finite tau.
//
// Bound on this card: bytes - 2 * nb * per * sizeof(T) over 3.35 TB/s; the
// kernel does a handful of operations per element. What holds a stream near
// its bound is keeping the memory busy from the first block to the last.
//
// Design. The (nb, per) buffer is one flat range of elements: a scalar head
// up to x's first 16-byte boundary, a body of 16-byte vectors (4 f32 or 8
// bf16) cut into tiles of 256 (4 KB, one vector a thread), and a scalar
// tail, all in one launch; the C entry cuts it from x's and out's addresses
// (the whole range scalar where they are not on one 16-byte phase). Vectors
// stay aligned whatever per is, and nb has no limit. The slice of a tile's
// first element (b, r: slice and offset in it) is resolved once per tile,
// by one 32-bit division; only a tile that a slice boundary crosses resolves
// its vectors' slices one by one, and a vector that a boundary crosses its
// elements'. The grid is one block per tile, each thread's load issued
// before the tile's division, 8 blocks an SM.
//
// tools/bulk_variants.py times this beside the other designs it builds from
// its own sources (PERF.md has the numbers): one tile per block beats every
// grid sized from the SM count and the occupancy on the streams past L2 (the
// embedding leaf, 4i's sweep chunks), since the block scheduler keeps
// feeding the SMs that finish early, and there 1 load a thread beats 2, 4
// and 8 by a little; a TMA ring (common.cuh's mbarriers and bulk copies: 2-4
// shared-memory stages of 8-32 KB, shrunk in place, written back by bulk
// stores) is slower on every shape. Evict-first (.cs) loads and stores
// change little, so they are plain. On the gate stack, whose 45 MB fit in
// L2, every variant is slower than the first design (a grid-stride loop over
// 132 x 8 / nb blocks a slice) and F.softshrink; neither the grid, the loads
// per thread, the hints nor a 32-register cap closes the gap.
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;   // and vectors per tile

__device__ __forceinline__ float shrink(float v, float t) {
  if (v != v) return v;                 // NaN in, NaN out
  const float a = fabsf(v) - t;
  if (a != a) return a;                 // inf - inf, or a NaN tau
  return (a > 0.f && v != 0.f) ? copysignf(a, v) : 0.f;
}

template <typename T>
__device__ __forceinline__ float tau_of(const float* tau, int64_t b) {
  return to_f32(from_f32<T>(tau[b]));   // tau in x's dtype, as the Pallas kernel casts it
}

struct SoftArgs {
  const void* x;
  const float* tau;
  void* out;
  int64_t per;        // elements per slice
  int64_t numel;
  int64_t head;       // scalar elements before the body
  int64_t nvec;       // 16-byte vectors of the body
};

// n / d for n, d >= 0: one 32-bit division where both fit in 32 bits (every
// call up to 2^32 elements), about a fifth of the instructions of a 64-bit
// one, which a block of small tiles would otherwise spend most of its issue
// slots on
__device__ __forceinline__ int64_t div_fast(int64_t n, int64_t d) {
  return (n | d) >> 32 ? n / d : (int64_t)((uint32_t)n / (uint32_t)d);
}

// A tile's first element lies in slice b at offset r.
struct Cursor {
  int64_t b, r;
  __device__ __forceinline__ Cursor(int64_t first_elem, int64_t per)
      : b(div_fast(first_elem, per)), r(first_elem - b * per) {}
};

// shrink the vector at element offset `off` of the current tile
template <typename T>
__device__ __forceinline__ uint4 shrink_vec(uint4 raw, const SoftArgs& a, const Cursor& c,
                                            int64_t off, bool one_slice, float t) {
  constexpr int kN = 16 / sizeof(T);
  T* e = reinterpret_cast<T*>(&raw);
  if (one_slice) {
#pragma unroll
    for (int k = 0; k < kN; ++k) e[k] = from_f32<T>(shrink(to_f32(e[k]), t));
  } else {
    const int64_t r0 = c.r + off;
    const Cursor v(r0, a.per);          // the vector's first element: slice c.b + v.b
    if (v.r + kN <= a.per) {            // this vector lies in one slice
      const float tv = tau_of<T>(a.tau, c.b + v.b);
#pragma unroll
      for (int k = 0; k < kN; ++k) e[k] = from_f32<T>(shrink(to_f32(e[k]), tv));
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k)
        e[k] = from_f32<T>(shrink(to_f32(e[k]), tau_of<T>(a.tau, c.b + div_fast(r0 + k, a.per))));
    }
  }
  return raw;
}

// the scalar head and tail, over the whole grid
template <typename T>
__device__ void scalar_ends(const SoftArgs& a) {
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  const int64_t tail = a.head + a.nvec * (16 / sizeof(T));
  const int64_t n_ends = a.head + (a.numel - tail);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_ends; i += stride) {
    const int64_t e = i < a.head ? i : tail + (i - a.head);
    out[e] = from_f32<T>(shrink(to_f32(x[e]), tau_of<T>(a.tau, div_fast(e, a.per))));
  }
}

// 8 blocks of 256 threads fill an SM's 2048 threads, which a stream needs
// with every load in flight: at most 32 registers a thread (a version of
// this loop at 38, 6 blocks an SM, lost 1-8%: tools/bulk_variants.py)
template <typename T>
__global__ void __launch_bounds__(kThreads, 8) soft_threshold_kernel(SoftArgs a) {
  constexpr int kN = 16 / sizeof(T);
  scalar_ends<T>(a);
  const char* xb = static_cast<const char*>(a.x) + a.head * sizeof(T);
  char* ob = static_cast<char*>(a.out) + a.head * sizeof(T);
  int64_t t = blockIdx.x;   // one tile a block: the loop runs once but past 2^31 - 1 tiles
  if (t * kThreads >= a.nvec) return;
  uint4 v;
  int64_t j = t * kThreads + threadIdx.x;
  if (j < a.nvec) v = *reinterpret_cast<const uint4*>(xb + j * 16);
  for (; t * kThreads < a.nvec; t += gridDim.x) {
    const int64_t v0 = t * kThreads;
    const Cursor c(a.head + v0 * kN, a.per);
    const int64_t n = a.nvec - v0 < kThreads ? a.nvec - v0 : kThreads;
    const bool one_slice = c.r + n * kN <= a.per;
    const float tv = tau_of<T>(a.tau, c.b);
    if (threadIdx.x < n) {
      const uint4 y = shrink_vec<T>(v, a, c, (int64_t)threadIdx.x * kN, one_slice, tv);
      *reinterpret_cast<uint4*>(ob + (v0 + threadIdx.x) * 16) = y;
    }
    if ((t + gridDim.x) * kThreads < a.nvec) {
      j = (t + gridDim.x) * kThreads + threadIdx.x;
      if (j < a.nvec) v = *reinterpret_cast<const uint4*>(xb + j * 16);
    }
  }
}

template <typename T>
cudaError_t launch(const SoftArgs& a, cudaStream_t stream) {
  const int64_t items = a.nvec ? a.nvec : a.numel;   // tiles of vectors, else of scalars
  const int64_t work = (items + kThreads - 1) / kThreads;
  const int grid = (int)(work < 1 ? 1 : work < INT32_MAX ? work : INT32_MAX);
  soft_threshold_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace salaad

// x, out (numel,) contiguous of dtype (0 f32, 1 bf16) in slices of `per`
// elements; tau (numel / per,) f32. Vectors where x and out lie on one
// 16-byte phase: `head` scalars up to x's first 16-byte boundary, then
// `nvec` vectors, the rest scalar; else all scalar.
extern "C" int soft_threshold_launch(const void* x, const float* tau, void* out, long long per,
                                     long long numel, int dtype, void* stream) {
  if (per < 1 || numel < 1 || numel % per || (dtype != salaad::kF32 && dtype != salaad::kBF16))
    return cudaErrorInvalidValue;
  const int size = dtype == salaad::kF32 ? 4 : 2;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(out);
  long long head = numel, nvec = 0;
  if ((xa - oa) % 16 == 0) {
    head = (long long)((16 - xa % 16) % 16) / size;
    if (head > numel) head = numel;
    nvec = (numel - head) / (16 / size);
  }
  const salaad::SoftArgs a{x, tau, out, per, numel, head, nvec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == salaad::kF32 ? salaad::launch<float>(a, s)
                               : salaad::launch<__nv_bfloat16>(a, s);
}
