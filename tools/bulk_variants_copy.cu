// A TMA bulk-copy design of the page-copy kernel, the counterpart of the
// Pallas DMA, timed beside the kernel by tools/bulk_variants.py, which
// compiles this file with -I src/repro_torch/kernels/csrc: it includes the
// kernel's own source and shares its units and skip rules. One thread per
// block issues a bulk copy of each of the block's units into a shared-memory
// stage under an mbarrier, up to `stages` units in flight, and a bulk store
// of each once it has landed; a stage takes its next unit after its store
// has read it. Pages whose size or address is no multiple of 16 bytes take
// the kernel's byte path.
#include "page_copy.cu"

namespace salaad {
namespace {

constexpr int kBulkThreads = 128;   // thread 0 copies; all copy bytes on the byte path
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 227 * 1024;

// Unit i of this block rides stage i % stages, whose mbarrier completes a
// phase each time one of its units lands (skipped units take no phase:
// `phases` holds each stage's next parity).
__global__ void __launch_bounds__(kBulkThreads) page_copy_bulk_kernel(CopyArgs a, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages];
  const int64_t mine = blockIdx.x < a.units
                           ? (a.units - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (!a.vec) {
    for (int64_t i = 0; i < mine; ++i) {
      Unit w;
      if (unit_of(a, blockIdx.x + i * gridDim.x, w)) copy_bytes(w);
    }
    return;
  }
  if (threadIdx.x != 0 || mine == 0) return;
  auto load = [&](int64_t i) {
    Unit w;
    if (!unit_of(a, blockIdx.x + i * gridDim.x, w)) return;
    const int s = (int)(i % stages);
    mbar_arrive_expect_tx(&full[s], w.bytes);
    bulk_load(ring + (int64_t)s * a.chunk, w.from, w.bytes, &full[s]);
  };
  for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
  for (int64_t i = 0; i < stages && i < mine; ++i) load(i);
  uint32_t phases = 0;
  for (int64_t i = 0; i < mine; ++i) {
    Unit w;
    const bool live = unit_of(a, blockIdx.x + i * gridDim.x, w);
    if (live) {
      const int s = (int)(i % stages);
      mbar_wait(&full[s], (phases >> s) & 1);
      phases ^= 1u << s;
      bulk_store(w.to, ring + (int64_t)s * a.chunk, w.bytes);
      bulk_commit();
    }
    if (i + stages < mine) {
      if (live) bulk_wait_read<0>();   // the stage is free once its store has read it
      load(i + stages);
    }
  }
  bulk_wait_read<0>();   // the writes are visible to the next kernel on the stream
}

cudaError_t bulk(const CopyArgs& a, int stages, int grid, cudaStream_t stream, int* resident) {
  if (stages < 1 || stages > kMaxStages || a.chunk < 16 || a.chunk % 16 ||
      a.chunk > kMaxSmem / stages)
    return cudaErrorInvalidValue;
  const int smem = stages * a.chunk;
  const cudaError_t err = cudaFuncSetAttribute(
      page_copy_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (resident)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, page_copy_bulk_kernel,
                                                         kBulkThreads, smem);
  page_copy_bulk_kernel<<<grid, kBulkThreads, smem, stream>>>(a, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace salaad

// As page_copy_launch, on the bulk ring: units of `chunk` bytes (a multiple
// of 16), `stages` of them in flight per block, `grid` blocks.
extern "C" int variant_copy_launch(void* pool, const int* src, const int* dst, int n_pairs,
                                   int n_layers, int n_pages, long long page_bytes, int chunk,
                                   int stages, int grid, void* stream) {
  if (n_pairs < 1 || n_layers < 1 || n_pages < 1 || page_bytes < 1 || chunk < 16 || grid < 1)
    return cudaErrorInvalidValue;
  const int chunks = (int)((page_bytes + chunk - 1) / chunk);
  const bool vec = page_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0;
  const salaad::CopyArgs a{static_cast<char*>(pool), src, dst, n_layers, n_pages, page_bytes,
                           chunk, chunks, (int64_t)n_pairs * n_layers * chunks, vec};
  return salaad::bulk(a, stages, grid, static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of the bulk ring (chunk, stages) that one SM holds at once.
extern "C" int variant_copy_resident(int chunk, int stages, int* out) {
  const salaad::CopyArgs a{nullptr, nullptr, nullptr, 1, 1, chunk, chunk, 1, 1, true};
  return salaad::bulk(a, stages, 1, nullptr, out);
}
