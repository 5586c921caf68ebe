// Block-CSC sparse matmul y = x @ S for Hopper (sm_90a).
//
// Replaces the TPU kernel bsr_matmul_pallas (repro/kernels/bsr_matmul.py).
// S (n, m) is held as block-CSC tables (kernels/bsr_matmul.py): counts (JB,)
// live tiles per output column block, rows (JB, MAXB) their input row-block
// indices, vals (JB, MAXB, bs, bs) the tiles. x is (T, n), y (T, m); n and m
// need not be multiples of bs (the tables cover the zero-padded matrix).
//
// What bounds it on this card: at decode widths the bytes of the live tiles,
// read once (salaad_llama_60m's gate S at T = 8: 688 tiles of 32 x 32 f32,
// 2.8 MB, 0.9 us at 3.35 TB/s); at prefill widths the operations (T = 512:
// 721 MFLOP, 4.4 us as 3xTF32 products at 495 / 3 TFLOP/s).
//
// Design: the stream kernel (stream_matmul.cuh) over each column block's
// live tiles, a column block of bs = 128 cut into two parts of 64 columns.
// What it does about the first design (one block per (row tile of at most 32
// rows, column block), synchronous loads, f32 FMAs from shared memory, 88.7
// us at the gate site, T = 512, and 35.4 us at T = 8 on an NVIDIA H100 80GB
// HBM3 at 700 W):
//   - decode widths: a column block's live tiles are cut into up to 8
//     segments, one block each, summed in segment order through distributed
//     shared memory (the gate site runs 344 blocks instead of 43);
//   - the live tiles and the gathered x columns arrive through a 4-deep ring
//     of 16-byte cp.async stages, three in flight while the tensor cores run
//     on the fourth;
//   - tensor-core products (3xTF32 for f32 tiles, one TF32 product for bf16
//     x bf16, two for bf16 x over f32 tiles), the rows of x on the n side;
//   - prefill widths: 64 rows of x per block, so each live tile is read from
//     L2 once per 64 rows (was once per 32), and one block walks its column
//     block's whole axis where the row tiles alone fill the card.
// Measured (chip_smoke.py phase 3c, 20 calls replayed from a CUDA graph, on
// an NVIDIA H100 80GB HBM3 at 700 W): gate S at T = 512 30.6 us (torch.matmul
// on the dense S: 24.2), at T = 8 6.2 us (6.9), the q site's S (bs = 128) at
// T = 8 5.7 us (6.2). At T = 512 neither bytes nor operations bound it: the
// load path alone and the product path alone (per k8 step, fragment loads
// and TF32 splits from shared memory) each take most of its time
// (tools/stream_variants.py).
// The segments (kernels/stream.py::bsr_plan) come from the table shape, so
// rows are bit for bit independent of T. Instances: the three dtype pairs x
// four (columns, stage rows) shapes: (16, 8) for bs = 8, (16, 16) for 16,
// (32, 32) for 32, (64, 32) for 64 and 128.
#include "stream_matmul.cuh"

namespace salaad {
namespace {

template <typename TX, typename TW, int BNB, int KS, int ROWS>
__global__ void __launch_bounds__(stream::block_threads(BNB, ROWS), stream::min_blocks(BNB, ROWS))
    bsr_matmul_kernel(const stream::Args a) {
  stream::stream_body<TX, TW, TX, BNB, KS, ROWS>(a);
}

template <typename TX, typename TW, int BNB, int KS>
cudaError_t launch_bs(const stream::Args& a, cudaStream_t s) {
  if (a.xrows == 8)
    return stream::launch<TX, TW, BNB, KS, 8>(bsr_matmul_kernel<TX, TW, BNB, KS, 8>, a, s);
  return stream::launch<TX, TW, BNB, KS, stream::kMaxRows>(
      bsr_matmul_kernel<TX, TW, BNB, KS, stream::kMaxRows>, a, s);
}

template <typename TX, typename TW>
cudaError_t dispatch_bs(const stream::Args& a, cudaStream_t s) {
  switch (a.bs) {
    case 8: return launch_bs<TX, TW, 16, 8>(a, s);
    case 16: return launch_bs<TX, TW, 16, 16>(a, s);
    case 32: return launch_bs<TX, TW, 32, 32>(a, s);
    case 64:
    case 128: return launch_bs<TX, TW, 64, 32>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace salaad

// x (T, n), counts (JB,), rows (JB, MAXB), vals (JB, MAXB, bs, bs), y (T, m);
// x and y of dtype, vals of wdtype (equal, or bf16 activations over f32
// tiles); nseg segments per column block, xrows rows per block, split or
// walk (kernels/stream.py::bsr_plan and its launch cut).
extern "C" int bsr_matmul_launch(const void* x, const int* counts, const int* rows,
                                 const void* vals, void* y, int t_dim, int n_dim, int m_dim,
                                 int jb, int maxb, int bs, int nseg, int xrows, int split,
                                 int dtype, int wdtype, void* stream) {
  using namespace salaad;
  if (maxb < 1 || jb != (m_dim + bs - 1) / bs) return cudaErrorInvalidValue;
  stream::Args a{};
  a.x = x, a.w = vals, a.counts = counts, a.rows = rows, a.y = y;
  a.b_dim = 1, a.t_dim = t_dim, a.k_dim = n_dim, a.m_dim = m_dim, a.ldx = n_dim, a.ldy = m_dim;
  a.layers = 1, a.n_tab = 1;
  a.bs = bs, a.jb = jb, a.maxb = maxb, a.cs = bs > 64 ? bs / 64 : 1;
  a.nseg = nseg, a.xrows = xrows, a.split = split;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && wdtype == kF32) return dispatch_bs<float, float>(a, s);
  if (dtype == kBF16 && wdtype == kBF16) return dispatch_bs<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (dtype == kBF16 && wdtype == kF32) return dispatch_bs<__nv_bfloat16, float>(a, s);
  return cudaErrorInvalidValue;
}
