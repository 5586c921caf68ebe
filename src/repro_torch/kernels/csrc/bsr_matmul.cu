// Block-CSC sparse matmul y = x @ S for Hopper (sm_90a).
//
// Replaces the TPU kernel bsr_matmul_pallas (repro/kernels/bsr_matmul.py).
// S (n, m) is held as block-CSC tables (kernels/bsr_matmul.py): counts (JB,)
// live tiles per output column block, rows (JB, MAXB) their input row-block
// indices, vals (JB, MAXB, bs, bs) the tiles. x is (T, n), y (T, m); n and m
// need not be multiples of bs (the tables cover the zero-padded matrix).
//
// Design. One thread block per (row tile of x, output column block j). The
// Pallas grid walks (row tile, j, slot) and carries the (bt, bs) accumulator
// across the slot axis in VMEM scratch; here the block loops over its
// counts[j] live slots itself (padded slots are never read), gathering the
// x columns rows[j, s] * bs .. + bs that each tile multiplies - the block's
// own index load in place of the TPU's scalar prefetch - and writes its
// (bt, bs) tile of y once. Every block-CSC size that deployment produces
// (8..128) is its own template instance; ragged T, n and m are masked in the
// loads and the store.
//
// Bound on this card: bytes at decode widths (each live tile is read once per
// row tile), operations at prefill widths. Products run on the CUDA cores in
// f32 from shared memory; no tensor cores (wgmma) and no TMA yet. x and y
// have one type (TX), the tiles one dtype too (TW): equal, or bf16
// activations over f32 tiles (a bf16 model deployed from an f32 SLR state).
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBT = 32;   // rows of x per block

template <typename TX, typename TW, int BN>
__global__ void __launch_bounds__(kThreads)
bsr_matmul_kernel(const TX* __restrict__ x, const int* __restrict__ counts,
                  const int* __restrict__ rows, const TW* __restrict__ vals,
                  TX* __restrict__ y, int t_dim, int n_dim, int m_dim, int maxb, int bt) {
  constexpr int KC = BN < 32 ? BN : 32;          // reduction chunk
  constexpr int NACC = (kMaxBT * BN + kThreads - 1) / kThreads;
  constexpr int ACC_RSTRIDE = kThreads / BN;     // rows between a thread's outputs

  __shared__ float xs[kMaxBT][KC];
  __shared__ float ws[KC][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * bt;
  const int j = blockIdx.y;
  const int col0 = j * BN;
  const int n_rows = min(bt, t_dim - row0);
  const int acc_c = tid % BN;
  const int acc_r = tid / BN;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int cnt = min(counts[j], maxb);
  for (int s = 0; s < cnt; ++s) {
    const int rb = rows[(int64_t)j * maxb + s];
    const TW* tile = vals + ((int64_t)j * maxb + s) * BN * BN;
    for (int k0 = 0; k0 < BN; k0 += KC) {
      const int kbase = rb * BN + k0;
      for (int e = tid; e < kMaxBT * KC; e += kThreads) {
        const int rr = e / KC, kk = e % KC;
        xs[rr][kk] = (rr < n_rows && kbase + kk >= 0 && kbase + kk < n_dim)
                         ? to_f32(x[(int64_t)(row0 + rr) * n_dim + kbase + kk]) : 0.f;
      }
      for (int e = tid; e < KC * BN; e += kThreads) {
        const int kk = e / BN, cc = e % BN;
        ws[kk][cc] = to_f32(tile[(k0 + kk) * BN + cc]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float w = ws[kk][acc_c];
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const int rr = acc_r + i * ACC_RSTRIDE;
          if (rr < kMaxBT) acc[i] += xs[rr][kk] * w;
        }
      }
      __syncthreads();
    }
  }

  if (col0 + acc_c < m_dim) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int rr = acc_r + i * ACC_RSTRIDE;
      if (rr < n_rows) y[(int64_t)(row0 + rr) * m_dim + col0 + acc_c] = from_f32<TX>(acc[i]);
    }
  }
}

template <typename TX, typename TW, int BN>
cudaError_t launch(const void* x, const int* counts, const int* rows, const void* vals,
                   void* y, int t_dim, int n_dim, int m_dim, int jb, int maxb, int bt,
                   cudaStream_t stream) {
  dim3 grid((t_dim + bt - 1) / bt, jb);
  bsr_matmul_kernel<TX, TW, BN><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), counts, rows, static_cast<const TW*>(vals),
      static_cast<TX*>(y), t_dim, n_dim, m_dim, maxb, bt);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t dispatch_bs(int bs, const void* x, const int* counts, const int* rows,
                        const void* vals, void* y, int t_dim, int n_dim, int m_dim, int jb,
                        int maxb, int bt, cudaStream_t stream) {
  switch (bs) {
    case 8: return launch<TX, TW, 8>(x, counts, rows, vals, y, t_dim, n_dim, m_dim, jb, maxb, bt, stream);
    case 16: return launch<TX, TW, 16>(x, counts, rows, vals, y, t_dim, n_dim, m_dim, jb, maxb, bt, stream);
    case 32: return launch<TX, TW, 32>(x, counts, rows, vals, y, t_dim, n_dim, m_dim, jb, maxb, bt, stream);
    case 64: return launch<TX, TW, 64>(x, counts, rows, vals, y, t_dim, n_dim, m_dim, jb, maxb, bt, stream);
    case 128: return launch<TX, TW, 128>(x, counts, rows, vals, y, t_dim, n_dim, m_dim, jb, maxb, bt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace salaad

// x (T, n), counts (JB,), rows (JB, MAXB), vals (JB, MAXB, bs, bs), y (T, m);
// x and y of dtype, vals of wdtype.
extern "C" int bsr_matmul_launch(const void* x, const int* counts, const int* rows,
                                 const void* vals, void* y, int t_dim, int n_dim, int m_dim,
                                 int jb, int maxb, int bs, int bt, int dtype, int wdtype,
                                 void* stream) {
  using namespace salaad;
  if (bt < 1 || bt > kMaxBT || t_dim < 1 || jb < 1 || maxb < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && wdtype == kF32)
    return dispatch_bs<float, float>(bs, x, counts, rows, vals, y, t_dim, n_dim, m_dim, jb,
                                     maxb, bt, s);
  if (dtype == kBF16 && wdtype == kBF16)
    return dispatch_bs<__nv_bfloat16, __nv_bfloat16>(bs, x, counts, rows, vals, y, t_dim,
                                                     n_dim, m_dim, jb, maxb, bt, s);
  if (dtype == kBF16 && wdtype == kF32)
    return dispatch_bs<__nv_bfloat16, float>(bs, x, counts, rows, vals, y, t_dim, n_dim,
                                             m_dim, jb, maxb, bt, s);
  return cudaErrorInvalidValue;
}
