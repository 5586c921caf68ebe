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
// Design. A grid-stride loop per slice: blockIdx.y names the slice and its
// tau, blockIdx.x strides over the slice's elements with 16-byte vector
// loads and stores (4 f32 or 8 bf16) when the slice starts on a 16-byte
// boundary, and a scalar tail for the last per % VEC elements (a slice whose
// start is not aligned runs scalar throughout). Each element is read once
// and written once.
//
// Bound on this card: bytes - 2 * nb * per * sizeof(T) over 3.35 TB/s; the
// kernel does a handful of operations per element.
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float shrink(float v, float t) {
  if (v != v) return v;                 // NaN in, NaN out
  const float a = fabsf(v) - t;
  if (a != a) return a;                 // inf - inf, or a NaN tau
  return (a > 0.f && v != 0.f) ? copysignf(a, v) : 0.f;
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };

template <typename T>
__global__ void __launch_bounds__(kThreads)
soft_threshold_kernel(const T* __restrict__ x, const float* __restrict__ tau,
                      T* __restrict__ out, int64_t per) {
  constexpr int kN = Vec<T>::kN;
  const int64_t base = (int64_t)blockIdx.y * per;
  const T* xs = x + base;
  T* os = out + base;
  // tau in x's dtype, as the Pallas kernel casts it
  const float t = to_f32(from_f32<T>(tau[blockIdx.y]));
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(xs) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(os) % 16 == 0);
  int64_t done = 0;
  if (aligned) {
    const int64_t nvec = per / kN;
    const uint4* xv = reinterpret_cast<const uint4*>(xs);
    uint4* ov = reinterpret_cast<uint4*>(os);
    for (int64_t i = first; i < nvec; i += stride) {
      uint4 raw = xv[i];
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < kN; ++k) e[k] = from_f32<T>(shrink(to_f32(e[k]), t));
      ov[i] = raw;
    }
    done = nvec * kN;
  }
  for (int64_t i = done + first; i < per; i += stride)
    os[i] = from_f32<T>(shrink(to_f32(xs[i]), t));
}

template <typename T>
cudaError_t launch(const void* x, const float* tau, void* out, int nb, int64_t per,
                   cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  // enough blocks to cover the slice once with vectors, capped so that the
  // whole grid stays a few waves of the 132 SMs
  int64_t want = (per / kN + kThreads - 1) / kThreads;
  const int64_t cap = (132 * 8 + nb - 1) / nb;
  int blocks_x = (int)(want < 1 ? 1 : (want > cap ? cap : want));
  dim3 grid(blocks_x, nb);
  soft_threshold_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), tau, static_cast<T*>(out), per);
  return cudaGetLastError();
}

}  // namespace
}  // namespace salaad

// x, out (nb, per) contiguous of dtype (0 f32, 1 bf16); tau (nb,) f32.
extern "C" int soft_threshold_launch(const void* x, const float* tau, void* out, int nb,
                                     long long per, int dtype, void* stream) {
  if (nb < 1 || nb > 65535 || per < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == salaad::kF32) return salaad::launch<float>(x, tau, out, nb, per, s);
  if (dtype == salaad::kBF16) return salaad::launch<__nv_bfloat16>(x, tau, out, nb, per, s);
  return cudaErrorInvalidValue;
}
