// Batched whole-page copy over a paged KV pool, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel page_copy_pallas (repro/kernels/page_copy.py): for
// every pair i, page dst[i] of every layer becomes a copy of page src[i]
// (pool (L, N, H, bs, D) of any element type: a page is page_bytes
// contiguous bytes, so one kernel serves f32 and bf16 payloads, int8
// payloads and the (..., 1) f32 scale pools). The pool is updated in place,
// as the Pallas call aliases its pool operand to its output.
//
// Design. One thread block per (pair, layer) copies one page with 16-byte
// vector loads and stores when the page size allows, bytes otherwise. The
// Pallas grid applies pairs in order; here all pairs run at once, which is the
// same only under the engine's precondition that every dst is a fresh page
// that is no pair's src. A pair with src == dst (the (0, 0) identity pads the
// engine adds to reach a power-of-two width) is skipped: it is a no-op, and
// skipping it keeps a pad from racing a real copy into page 0. Pairs naming a
// page outside [0, N) are skipped too (the pool is never touched out of
// bounds; the wrapper validates ids it can see on the host).
//
// Bound on this card: bytes - each copied page is read once and written once
// (2 * n * L * page_bytes); there is no arithmetic.
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
page_copy_kernel(char* __restrict__ pool, const int* __restrict__ src,
                 const int* __restrict__ dst, int n_pages, int64_t page_bytes) {
  const int i = blockIdx.x;
  const int layer = blockIdx.y;
  const int s = src[i], t = dst[i];
  if (s == t || s < 0 || t < 0 || s >= n_pages || t >= n_pages) return;
  const int64_t layer_off = (int64_t)layer * n_pages * page_bytes;
  const char* from = pool + layer_off + (int64_t)s * page_bytes;
  char* to = pool + layer_off + (int64_t)t * page_bytes;
  if (page_bytes % 16 == 0) {
    const uint4* f = reinterpret_cast<const uint4*>(from);
    uint4* o = reinterpret_cast<uint4*>(to);
    for (int64_t e = threadIdx.x; e < page_bytes / 16; e += kThreads) o[e] = f[e];
  } else {
    for (int64_t e = threadIdx.x; e < page_bytes; e += kThreads) to[e] = from[e];
  }
}

}  // namespace
}  // namespace salaad

// pool (L, N, ...) with page_bytes bytes per page; src / dst (n,) int32.
extern "C" int page_copy_launch(void* pool, const int* src, const int* dst, int n_pairs,
                                int n_layers, int n_pages, long long page_bytes,
                                void* stream) {
  if (n_pairs < 1 || n_layers < 1 || n_pages < 1 || page_bytes < 1 ||
      reinterpret_cast<uintptr_t>(pool) % 16)
    return cudaErrorInvalidValue;
  dim3 grid(n_pairs, n_layers);
  salaad::page_copy_kernel<<<grid, salaad::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(pool), src, dst, n_pages, page_bytes);
  return cudaGetLastError();
}
