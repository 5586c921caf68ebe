// Batched whole-page copy over a paged KV pool, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel page_copy_pallas (repro/kernels/page_copy.py): for
// every pair i, page dst[i] of every layer becomes a copy of page src[i]
// (pool (L, N, H, bs, D) of any element type: a page is page_bytes
// contiguous bytes, so one kernel serves f32 and bf16 payloads, int8
// payloads and the (..., 1) f32 scale pools). The pool is updated in place,
// as the Pallas call aliases its pool operand to its output.
//
// The Pallas grid applies pairs in order; here all pairs run at once, which is
// the same only under the engine's precondition that every dst is a fresh
// page that is no pair's src. A pair with src == dst (the (0, 0) identity pads
// the engine adds to reach a power-of-two width) is skipped: it is a no-op,
// and skipping it keeps a pad from racing a real copy into page 0. Pairs
// naming a page outside [0, N) are skipped too (the pool is never touched out
// of bounds).
//
// Bound on this card: bytes - each copied page is read once and written once
// (2 * n * L * page_bytes); there is no arithmetic. A call moves little (2 MB
// at the engine's 8 pairs of 8 layers) from a pool that fits in L2, so its
// time is the launch and one round trip of the copies: the design is about
// spreading the copies over every SM with all of them in flight at once.
//
// Design (kernels/page_copy.py::page_copy_plan cuts the call). Each (pair,
// layer) page is cut into chunks; a unit is one chunk of one page, the
// chunk the largest of 32, 16, 8 and 4 KB that gives every SM a unit, and a
// block walks units at a stride of the grid, which the plan sizes from the
// card's SM count and the kernel's occupancy (at the engine's 8 pairs of 8
// layers: 256 units of 8 KB, one per block). Each thread issues all of its
// 16-byte loads of a unit (2 at 8 KB) before its first store. Pages whose
// size or address is no multiple of 16 bytes take a byte path.
//
// tools/bulk_variants.py times this with chunks of 4-32 KB beside the first
// design (one block per page, 4 KB in flight), a TMA bulk ring built from
// its own sources (common.cuh's mbarriers and bulk copies, the counterpart
// of the Pallas DMA: one thread per block issues a bulk copy of each unit
// into a shared-memory stage, up to 1-4 units in flight, and a bulk store
// of each once it has landed) and the launch floor (PERF.md has the
// numbers): the register path beats the bulk copies at every chunk and
// stage count, since a call is one round trip per unit and the bulk copy's
// round trip (an mbarrier wait between the load and the store) is the
// longer.
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;

struct CopyArgs {
  char* pool;
  const int* src;
  const int* dst;
  int n_layers, n_pages;
  int64_t page_bytes;
  int chunk;           // bytes per unit (the last of a page ragged)
  int chunks;          // units per page
  int64_t units;       // n_pairs * n_layers * chunks
  bool vec;            // pages on 16-byte boundaries, 16-byte multiples
};

// unit u: (pair, layer, chunk) of the page copy; false for a skipped pair
struct Unit {
  const char* from;
  char* to;
  int bytes;
};
__device__ __forceinline__ bool unit_of(const CopyArgs& a, int64_t u, Unit& out) {
  const int c = (int)(u % a.chunks);
  const int64_t pl = u / a.chunks;
  const int layer = (int)(pl % a.n_layers);
  const int i = (int)(pl / a.n_layers);
  const int s = a.src[i], t = a.dst[i];
  if (s == t || s < 0 || t < 0 || s >= a.n_pages || t >= a.n_pages) return false;
  const int64_t off = (int64_t)layer * a.n_pages * a.page_bytes + (int64_t)c * a.chunk;
  out.from = a.pool + off + (int64_t)s * a.page_bytes;
  out.to = a.pool + off + (int64_t)t * a.page_bytes;
  const int64_t left = a.page_bytes - (int64_t)c * a.chunk;
  out.bytes = (int)(left < a.chunk ? left : a.chunk);
  return true;
}

__device__ __forceinline__ void copy_bytes(const Unit& w) {
  for (int e = threadIdx.x; e < w.bytes; e += blockDim.x) w.to[e] = w.from[e];
}

template <int kLoads>
__global__ void __launch_bounds__(kThreads) page_copy_kernel(CopyArgs a) {
  for (int64_t u = blockIdx.x; u < a.units; u += gridDim.x) {
    Unit w;
    if (!unit_of(a, u, w)) continue;
    if (!a.vec) {
      copy_bytes(w);
      continue;
    }
    const int n = w.bytes / 16;
    uint4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < n) v[k] = reinterpret_cast<const uint4*>(w.from)[j];
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < n) reinterpret_cast<uint4*>(w.to)[j] = v[k];
    }
  }
}

template <int kLoads>
cudaError_t run(const CopyArgs& a, int grid, cudaStream_t stream, int* resident) {
  if (resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, page_copy_kernel<kLoads>,
                                                         kThreads, 0);
  page_copy_kernel<kLoads><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// units of 4, 8, 16 or 32 KB: 1, 2, 4 or 8 loads a thread
cudaError_t dispatch(const CopyArgs& a, int grid, cudaStream_t stream, int* resident) {
  switch (a.chunk) {
    case 4096: return run<1>(a, grid, stream, resident);
    case 8192: return run<2>(a, grid, stream, resident);
    case 16384: return run<4>(a, grid, stream, resident);
    case 32768: return run<8>(a, grid, stream, resident);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace salaad

// pool (L, N, ...) with page_bytes bytes per page; src / dst (n,) int32. The
// cut (kernels/page_copy.py::page_copy_plan): units of `chunk` bytes (4, 8,
// 16 or 32 KB), walked by `grid` blocks.
extern "C" int page_copy_launch(void* pool, const int* src, const int* dst, int n_pairs,
                                int n_layers, int n_pages, long long page_bytes, int chunk,
                                int grid, void* stream) {
  if (n_pairs < 1 || n_layers < 1 || n_pages < 1 || page_bytes < 1 || chunk < 1 || grid < 1)
    return cudaErrorInvalidValue;
  const int chunks = (int)((page_bytes + chunk - 1) / chunk);
  const bool vec = page_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  const salaad::CopyArgs a{static_cast<char*>(pool), src, dst, n_layers, n_pages, page_bytes,
                           chunk, chunks, (int64_t)n_pairs * n_layers * chunks, vec};
  return salaad::dispatch(a, grid, static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of units of `chunk` bytes that one SM holds at once.
extern "C" int page_copy_resident(int chunk, int* out) {
  if (out == nullptr) return cudaErrorInvalidValue;
  const salaad::CopyArgs a{nullptr, nullptr, nullptr, 1, 1, chunk, chunk, 1, 1, true};
  return salaad::dispatch(a, 1, nullptr, out);
}
