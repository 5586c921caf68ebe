// Other designs of the soft-threshold kernel, timed beside it by
// tools/bulk_variants.py, which compiles this file with
// -I src/repro_torch/kernels/csrc: it includes the kernel's own source, so
// every design shares its shrink, its slice lookup and its scalar ends.
//   - soft_threshold_loads_kernel: kLoads 16-byte loads a thread issued
//     before the first store, tiles walked at a stride of any grid (the
//     kernel's design is 1 load on a block per tile); -DSALAAD_EVICT_FIRST
//     makes the loads and stores evict-first (.cs), -DSALAAD_MIN_BLOCKS=8
//     caps the registers at 32 a thread, and -DSALAAD_ONE_TAU skips the
//     tile's slice lookup and shrinks every element by tau[0] (exact only
//     for nb = 1: it times the lookup);
//   - soft_threshold_ring_kernel: a TMA ring of `stages` shared-memory
//     stages of one tile each per block, filled by bulk copies under an
//     mbarrier, shrunk in place and written back by bulk stores; a stage is
//     refilled only after its store has read it.
#include "soft_threshold.cu"

#ifdef SALAAD_MIN_BLOCKS
#define SALAAD_BOUNDS __launch_bounds__(kThreads, SALAAD_MIN_BLOCKS)
#else
#define SALAAD_BOUNDS __launch_bounds__(kThreads)
#endif

namespace salaad {
namespace {

constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 227 * 1024;

template <typename T, int kLoads>
__global__ void SALAAD_BOUNDS soft_threshold_loads_kernel(SoftArgs a) {
  constexpr int kN = 16 / sizeof(T);
  constexpr int kTile = kThreads * kLoads;   // vectors per tile
  scalar_ends<T>(a);
  const char* xb = static_cast<const char*>(a.x) + a.head * sizeof(T);
  char* ob = static_cast<char*>(a.out) + a.head * sizeof(T);
  int64_t t = blockIdx.x;
  if (t * kTile >= a.nvec) return;
  auto load = [&](int64_t tile, uint4(&r)[kLoads]) {
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int64_t j = tile * kTile + k * kThreads + threadIdx.x;
#ifdef SALAAD_EVICT_FIRST
      if (j < a.nvec) r[k] = __ldcs(reinterpret_cast<const uint4*>(xb + j * 16));
#else
      if (j < a.nvec) r[k] = *reinterpret_cast<const uint4*>(xb + j * 16);
#endif
    }
  };
  uint4 v[kLoads];
  load(t, v);
  for (; t * kTile < a.nvec; t += gridDim.x) {
    const int64_t v0 = t * kTile;
    const int64_t n = a.nvec - v0 < kTile ? a.nvec - v0 : kTile;
#ifdef SALAAD_ONE_TAU
    const Cursor c(0, a.per);
    const bool one_slice = true;
#else
    const Cursor c(a.head + v0 * kN, a.per);
    const bool one_slice = c.r + n * kN <= a.per;
#endif
    const float tv = tau_of<T>(a.tau, c.b);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = k * kThreads + threadIdx.x;
      if (j < n) {
        const uint4 y = shrink_vec<T>(v[k], a, c, (int64_t)j * kN, one_slice, tv);
#ifdef SALAAD_EVICT_FIRST
        __stcs(reinterpret_cast<uint4*>(ob + (v0 + j) * 16), y);
#else
        *reinterpret_cast<uint4*>(ob + (v0 + j) * 16) = y;
#endif
      }
    }
    if ((t + gridDim.x) * kTile < a.nvec) load(t + gridDim.x, v);
  }
}

// Tile i of this block sits in stage i % stages, whose mbarrier completes
// its (i / stages)-th phase when the tile has landed; thread 0 issues every
// bulk copy.
template <typename T>
__global__ void __launch_bounds__(kThreads)
soft_threshold_ring_kernel(SoftArgs a, int tile_vecs, int stages) {
  constexpr int kN = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages];
  scalar_ends<T>(a);
  const char* xb = static_cast<const char*>(a.x) + a.head * sizeof(T);
  char* ob = static_cast<char*>(a.out) + a.head * sizeof(T);
  const int64_t tv = tile_vecs;
  const int64_t tiles = (a.nvec + tv - 1) / tv;
  if (blockIdx.x >= tiles) return;
  const int64_t mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const uint32_t stage_bytes = (uint32_t)tv * 16;
  auto tile_of = [&](int64_t i) { return blockIdx.x + i * gridDim.x; };
  auto bytes_of = [&](int64_t i) {
    const int64_t left = a.nvec - tile_of(i) * tv;
    return (uint32_t)((left < tv ? left : tv) * 16);
  };
  auto load = [&](int64_t i) {
    const int s = (int)(i % stages);
    mbar_arrive_expect_tx(&full[s], bytes_of(i));
    bulk_load(ring + s * stage_bytes, xb + tile_of(i) * tv * 16, bytes_of(i), &full[s]);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    for (int64_t i = 0; i < stages && i < mine; ++i) load(i);
  }
  __syncthreads();
  for (int64_t i = 0; i < mine; ++i) {
    const int s = (int)(i % stages);
    const Cursor c(a.head + tile_of(i) * tv * kN, a.per);
    mbar_wait(&full[s], (uint32_t)((i / stages) & 1));
    const int64_t n = bytes_of(i) / 16;
    const bool one_slice = c.r + n * kN <= a.per;
    const float t = tau_of<T>(a.tau, c.b);
    uint4* st = reinterpret_cast<uint4*>(ring + s * stage_bytes);
    for (int64_t j = threadIdx.x; j < n; j += kThreads)
      st[j] = shrink_vec<T>(st[j], a, c, j * kN, one_slice, t);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(ob + tile_of(i) * tv * 16, st, (uint32_t)n * 16);
      bulk_commit();
      // the previous tile's stage takes the tile `stages` after it once its
      // store has read it (this tile's store may still be reading)
      if (i >= 1 && i - 1 + stages < mine) {
        bulk_wait_read<1>();
        load(i - 1 + stages);
      }
    }
  }
  // the block may end once the stores have read shared memory: their writes
  // are visible to the next kernel on the stream
  if (threadIdx.x == 0) bulk_wait_read<0>();
}

template <typename T>
cudaError_t variant(const SoftArgs& a, int tile_vecs, int stages, int grid, cudaStream_t stream,
                    int* resident) {
  if (stages == 0) {
#define SALAAD_LOADS(L)                                                                      \
  if (tile_vecs == kThreads * L) {                                                           \
    if (resident)                                                                            \
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                  \
          resident, soft_threshold_loads_kernel<T, L>, kThreads, 0);                         \
    soft_threshold_loads_kernel<T, L><<<grid, kThreads, 0, stream>>>(a);                     \
    return cudaGetLastError();                                                               \
  }
    SALAAD_LOADS(1)
    SALAAD_LOADS(2)
    SALAAD_LOADS(4)
    SALAAD_LOADS(8)
#undef SALAAD_LOADS
    return cudaErrorInvalidValue;
  }
  const int64_t smem = (int64_t)stages * tile_vecs * 16;
  if (stages < 2 || stages > kMaxStages || tile_vecs < 1 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      soft_threshold_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, soft_threshold_ring_kernel<T>, kThreads, (int)smem);
  soft_threshold_ring_kernel<T><<<grid, kThreads, smem, stream>>>(a, tile_vecs, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace salaad

// The cut as the kernel's C entry makes it (head, nvec), in tiles of
// `tile_vecs` vectors: stages 0 for the loads kernel (256 x 1, 2, 4 or 8),
// else the ring's stages; `grid` blocks walk the tiles.
extern "C" int variant_soft_launch(const void* x, const float* tau, void* out, long long per,
                                   long long numel, long long head, long long nvec,
                                   int tile_vecs, int stages, int grid, int dtype,
                                   void* stream) {
  if (per < 1 || numel < 1 || numel % per || grid < 1) return cudaErrorInvalidValue;
  const salaad::SoftArgs a{x, tau, out, per, numel, head, nvec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == salaad::kF32) return salaad::variant<float>(a, tile_vecs, stages, grid, s, nullptr);
  if (dtype == salaad::kBF16)
    return salaad::variant<__nv_bfloat16>(a, tile_vecs, stages, grid, s, nullptr);
  return cudaErrorInvalidValue;
}

// Blocks of the design (tile_vecs, stages) that one SM holds at once.
extern "C" int variant_soft_resident(int dtype, int tile_vecs, int stages, int* out) {
  const salaad::SoftArgs a{nullptr, nullptr, nullptr, 1, 1, 0, 0};
  if (dtype == salaad::kF32) return salaad::variant<float>(a, tile_vecs, stages, 1, nullptr, out);
  return salaad::variant<__nv_bfloat16>(a, tile_vecs, stages, 1, nullptr, out);
}
