// Low-rank matmul y = (x @ P) @ Vt for Hopper (sm_90a).
//
// Replaces the TPU kernel lowrank_matmul_pallas (repro/kernels/
// lowrank_matmul.py): the empty-S corner of the fused SLR weight and the L
// part of the bsr format. One entry serves one table row (lowrank_matmul)
// and per-slot table rows (slr_matmul_multi's empty-S corner: slot b reads
// row ids[b] * layers + layer on the device, no host sync; a row outside
// [0, n_tab) writes NaN rows and reads no table), so a slot gives bit for bit
// what lowrank_matmul gives on its row.
//
// What bounds it on this card: at decode widths the bytes of P and Vt, read
// once (salaad_llama_60m's gate factors, K = 512, r = 128, M = 1376, f32:
// 0.97 MB, 0.3 us at 3.35 TB/s); at prefill widths the operations (T = 512:
// 247 MFLOP, 1.5 us as 3xTF32 products at 495 / 3 TFLOP/s).
//
// Design: two launches of the stream kernel (stream_matmul.cuh) on the
// stream, the second a programmatic dependent of the first:
//   A. t = x @ P into a (B * T, rp) f32 buffer, column parts of 64 rank
//      columns, K cut into up to 8 segments;
//   B. y = t @ Vt, column parts of 64 output columns, r cut into up to 8
//      segments; it loads its first Vt stages before it waits for A.
// What that does about the first design (one block per (row tile of at most
// 32 rows, 64 output columns), x @ P computed again for every column block,
// f32 FMAs from shared memory with synchronous loads: 112.6 us at the gate
// site, T = 512, on an NVIDIA H100 80GB HBM3 at 700 W): x @ P runs once per
// row tile (1.41 of the 1.66 GFLOP the first design ran at T = 512 were its
// repeats); products on the tensor cores (3xTF32 for f32 operands, t is
// f32); a decode call runs nseg blocks per column part, so the gate site's
// t @ Vt runs 22 x 4 blocks instead of 22. Measured (chip_smoke.py phase
// 3b, 20 calls replayed from a CUDA graph, on an NVIDIA H100 80GB HBM3 at
// 700 W): gate factors at T = 512 18.1 us (torch.linalg.multi_dot: 17.0), at
// T = 8 8.1 us (55.6), q factors at T = 8 8.0 us (59.3); at decode width
// each of the two kernels is a launch, one load round trip and a cluster's
// sum, ~4 us. The segments (kernels/stream.py::
// lowrank_plan) come from (K, r, M) alone, so rows are bit for bit
// independent of T and B. Instances: the three dtype pairs x the two
// products, 64 columns per block.
#include "stream_matmul.cuh"

namespace salaad {
namespace {

// A: t = x @ P (f32 t)
template <typename TX, typename TW, int ROWS>
__global__ void __launch_bounds__(stream::block_threads(64, ROWS), stream::min_blocks(64, ROWS))
    lowrank_xp_kernel(const stream::Args a) {
  stream::stream_body<TX, TW, float, 64, 32, ROWS>(a);
}

// B: y = t @ Vt
template <typename TY, typename TW, int ROWS>
__global__ void __launch_bounds__(stream::block_threads(64, ROWS), stream::min_blocks(64, ROWS))
    lowrank_tv_kernel(const stream::Args a) {
  stream::stream_body<float, TW, TY, 64, 32, ROWS>(a);
}

template <typename TX, typename TW, int ROWS>
cudaError_t launch_pair(const stream::Args& a1, const stream::Args& a2, cudaStream_t s) {
  const cudaError_t err =
      stream::launch<TX, TW, 64, 32, ROWS>(lowrank_xp_kernel<TX, TW, ROWS>, a1, s);
  if (err != cudaSuccess) return err;
  return stream::launch<float, TW, 64, 32, ROWS>(lowrank_tv_kernel<TX, TW, ROWS>, a2, s);
}

template <typename TX, typename TW>
cudaError_t dispatch_rows(const stream::Args& a1, const stream::Args& a2, cudaStream_t s) {
  return a1.xrows == 8 ? launch_pair<TX, TW, 8>(a1, a2, s)
                       : launch_pair<TX, TW, stream::kMaxRows>(a1, a2, s);
}

}  // namespace
}  // namespace salaad

// x (B, T, K), p (N, K, r), vt (N, r, M), y (B, T, M); ids (B,) selects
// table row ids[b] * layers + layer of the N = n_tab rows, or is null (B = 1,
// one table row: the pointers arrive offset to it, n_tab = 1); t (B * T, rp)
// f32 scratch for x @ P, rp = r rounded up to 4. x and y of dtype, the
// factors of wdtype (equal, or bf16 activations over f32 factors). nseg_p and
// nseg_v segment K and r, xrows rows per block, split_p and split_v cut
// each product (kernels/stream.py::lowrank_plan and its launch cut).
extern "C" int lowrank_matmul_launch(const void* x, const void* p, const void* vt,
                                     const int* ids, float* t, void* y, int b_dim, int t_dim,
                                     int k_dim, int m_dim, int r, int rp, int layers,
                                     int layer, int n_tab, int nseg_p, int nseg_v, int xrows,
                                     int split_p, int split_v, int dtype, int wdtype,
                                     void* stream) {
  using namespace salaad;
  if (r < 1 || rp < r || rp % 4 || layers < 1 || layer < 0 || layer >= layers || n_tab < 1 ||
      (ids != nullptr && n_tab % layers) || (ids == nullptr && b_dim != 1))
    return cudaErrorInvalidValue;
  stream::Args a1{};
  a1.x = x, a1.w = p, a1.ids = ids, a1.y = t;
  a1.b_dim = b_dim, a1.t_dim = t_dim, a1.k_dim = k_dim, a1.m_dim = r, a1.ldx = k_dim, a1.ldy = rp;
  a1.layers = layers, a1.layer = layer, a1.n_tab = n_tab;
  a1.bs = 64, a1.jb = (r + 63) / 64, a1.cs = 1;
  a1.nseg = nseg_p, a1.xrows = xrows, a1.split = split_p, a1.lead = 1;
  stream::Args a2 = a1;
  a2.x = t, a2.w = vt, a2.y = y;
  a2.k_dim = r, a2.m_dim = m_dim, a2.ldx = rp, a2.ldy = m_dim;
  a2.jb = (m_dim + 63) / 64;
  a2.nseg = nseg_v, a2.split = split_v, a2.dep = 1, a2.lead = 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && wdtype == kF32) return dispatch_rows<float, float>(a1, a2, s);
  if (dtype == kBF16 && wdtype == kBF16)
    return dispatch_rows<__nv_bfloat16, __nv_bfloat16>(a1, a2, s);
  if (dtype == kBF16 && wdtype == kF32) return dispatch_rows<__nv_bfloat16, float>(a1, a2, s);
  return cudaErrorInvalidValue;
}
