// Fused SLR matmul for Hopper (sm_90a):  y = x @ P[l] @ Vt[l] + x @ S[l]
//
// Replaces the TPU kernels slr_matmul_stacked_pallas
// (repro/kernels/slr_matmul.py) and lowrank_matmul_pallas
// (repro/kernels/lowrank_matmul.py). S[l] is layer l of a block-CSC stack
// (counts (L, JB), rows (L, JB, MAXB), vals (L, JB, MAXB, bs, bs)), the layout
// built by kernels/bsr_matmul.py.
//
// Design. One thread block per (row tile of x, output column block j of width
// BN). The block
//   1. computes t = x_tile @ P[l] one rank chunk of kRC columns at a time into
//      shared memory (f32), and seeds the accumulator with t @ Vt[l][:, j];
//   2. (fused kernel only) walks the counts[l, j] live tiles of column block j
//      and adds x[:, rows[l, j, s]] @ vals[l, j, s];
//   3. writes its (bt, BN) tile of y once.
// The (bt, r) intermediate never leaves the SM and y is written once, as in
// the Pallas kernels. Every column block recomputes x_tile @ P[l]: a known
// redundancy of JB times the low-rank first product, paid for a grid with
// enough blocks to fill the card at decode widths. Products run on the CUDA
// cores in f32 from shared memory; no tensor cores (wgmma) and no TMA yet.
//
// Bound on this card: at decode widths (T of a few rows) the kernel must read
// the layer's P, Vt and live S tiles once, so it is bound by bytes; at
// prefill-chunk widths by operations. The f32 CUDA-core products keep it far
// from either bound; wgmma tiles are the next step.
//
// For the fused kernel BN equals the BSR block size bs (8..128); ragged T, K
// and M are masked in the loads and the store. The wrappers in
// kernels/slr_matmul.py and kernels/lowrank_matmul.py check every argument.
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBT = 32;   // rows of x per block
constexpr int kRC = 128;     // rank chunk held in shared memory

template <typename T, int BN, bool kSparse>
__global__ void __launch_bounds__(kThreads)
slr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ p,
                  const T* __restrict__ vt, const int* __restrict__ counts,
                  const int* __restrict__ rows, const T* __restrict__ vals,
                  T* __restrict__ y, int t_dim, int k_dim, int m_dim, int r,
                  int maxb, int bt) {
  constexpr int KC = BN < 32 ? BN : 32;          // reduction chunk
  constexpr int NACC = (kMaxBT * BN + kThreads - 1) / kThreads;
  constexpr int NT = kMaxBT * kRC / kThreads;
  constexpr int ACC_RSTRIDE = kThreads / BN;     // rows between a thread's outputs
  constexpr int T_RSTRIDE = kThreads / kRC;

  __shared__ float xs[kMaxBT][KC];
  __shared__ float ws[KC][kRC > BN ? kRC : BN];
  __shared__ float ts[kMaxBT][kRC];

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

  // ---- low-rank phase: acc = (x_tile @ P) @ Vt[:, j-block], rank-chunked --
  const int t_c = tid % kRC;
  const int t_r = tid / kRC;
  for (int rc0 = 0; rc0 < r; rc0 += kRC) {
    const int rcw = min(kRC, r - rc0);
    float tacc[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) tacc[i] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += KC) {
      for (int e = tid; e < kMaxBT * KC; e += kThreads) {
        const int rr = e / KC, kk = e % KC;
        xs[rr][kk] = (rr < n_rows && k0 + kk < k_dim)
                         ? to_f32(x[(int64_t)(row0 + rr) * k_dim + k0 + kk]) : 0.f;
      }
      for (int e = tid; e < KC * kRC; e += kThreads) {
        const int kk = e / kRC, cc = e % kRC;
        ws[kk][cc] = (k0 + kk < k_dim && cc < rcw)
                         ? to_f32(p[(int64_t)(k0 + kk) * r + rc0 + cc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float w = ws[kk][t_c];
#pragma unroll
        for (int i = 0; i < NT; ++i) tacc[i] += xs[t_r + i * T_RSTRIDE][kk] * w;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) ts[t_r + i * T_RSTRIDE][t_c] = tacc[i];
    __syncthreads();
    for (int q0 = 0; q0 < rcw; q0 += KC) {
      for (int e = tid; e < KC * BN; e += kThreads) {
        const int kk = e / BN, cc = e % BN;
        ws[kk][cc] = (q0 + kk < rcw && col0 + cc < m_dim)
                         ? to_f32(vt[(int64_t)(rc0 + q0 + kk) * m_dim + col0 + cc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float w = ws[kk][acc_c];
#pragma unroll
        for (int i = 0; i < NACC; ++i) {
          const int rr = acc_r + i * ACC_RSTRIDE;
          if (rr < kMaxBT) acc[i] += ts[rr][q0 + kk] * w;
        }
      }
      __syncthreads();
    }
  }

  // ---- sparse epilogue: live tiles of column block j ----------------------
  if constexpr (kSparse) {
    const int cnt = min(counts[j], maxb);
    for (int s = 0; s < cnt; ++s) {
      const int rb = rows[(int64_t)j * maxb + s];
      const T* tile = vals + ((int64_t)j * maxb + s) * BN * BN;
      for (int k0 = 0; k0 < BN; k0 += KC) {
        const int kbase = rb * BN + k0;
        for (int e = tid; e < kMaxBT * KC; e += kThreads) {
          const int rr = e / KC, kk = e % KC;
          xs[rr][kk] = (rr < n_rows && kbase + kk >= 0 && kbase + kk < k_dim)
                           ? to_f32(x[(int64_t)(row0 + rr) * k_dim + kbase + kk]) : 0.f;
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
  }

  // ---- one write of the (bt, BN) tile --------------------------------------
  if (col0 + acc_c < m_dim) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int rr = acc_r + i * ACC_RSTRIDE;
      if (rr < n_rows)
        y[(int64_t)(row0 + rr) * m_dim + col0 + acc_c] = from_f32<T>(acc[i]);
    }
  }
}

template <typename T, int BN, bool kSparse>
cudaError_t launch(const void* x, const void* p, const void* vt, const int* counts,
                   const int* rows, const void* vals, void* y, int t_dim, int k_dim,
                   int m_dim, int r, int maxb, int bt, cudaStream_t stream) {
  dim3 grid((t_dim + bt - 1) / bt, (m_dim + BN - 1) / BN);
  slr_matmul_kernel<T, BN, kSparse><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(p), static_cast<const T*>(vt),
      counts, rows, static_cast<const T*>(vals), static_cast<T*>(y), t_dim, k_dim,
      m_dim, r, maxb, bt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bs(int bs, const void* x, const void* p, const void* vt,
                        const int* counts, const int* rows, const void* vals, void* y,
                        int t_dim, int k_dim, int m_dim, int r, int maxb, int bt,
                        cudaStream_t stream) {
  switch (bs) {
    case 8: return launch<T, 8, true>(x, p, vt, counts, rows, vals, y, t_dim, k_dim, m_dim, r, maxb, bt, stream);
    case 16: return launch<T, 16, true>(x, p, vt, counts, rows, vals, y, t_dim, k_dim, m_dim, r, maxb, bt, stream);
    case 32: return launch<T, 32, true>(x, p, vt, counts, rows, vals, y, t_dim, k_dim, m_dim, r, maxb, bt, stream);
    case 64: return launch<T, 64, true>(x, p, vt, counts, rows, vals, y, t_dim, k_dim, m_dim, r, maxb, bt, stream);
    case 128: return launch<T, 128, true>(x, p, vt, counts, rows, vals, y, t_dim, k_dim, m_dim, r, maxb, bt, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_tile(int bt) { return bt < 1 || bt > kMaxBT; }

}  // namespace
}  // namespace salaad

using namespace salaad;

// Layer ``layer`` of the stacked tables: p (L, K, r), vt (L, r, M),
// counts (L, JB), rows (L, JB, MAXB), vals (L, JB, MAXB, bs, bs); x (T, K),
// y (T, M). Returns the launch's cudaGetLastError().
extern "C" int slr_matmul_stacked_launch(const void* x, const void* p, const void* vt,
                                         const int* counts, const int* rows,
                                         const void* vals, void* y, int t_dim, int k_dim,
                                         int m_dim, int r, int layer, int jb, int maxb,
                                         int bs, int bt, int dtype, void* stream) {
  if (bad_tile(bt) || t_dim < 1) return cudaErrorInvalidValue;
  const int64_t esize = dtype == kF32 ? 4 : 2;
  const char* pl = static_cast<const char*>(p) + (int64_t)layer * k_dim * r * esize;
  const char* vl = static_cast<const char*>(vt) + (int64_t)layer * r * m_dim * esize;
  const int* cl = counts + (int64_t)layer * jb;
  const int* rl = rows + (int64_t)layer * jb * maxb;
  const char* sl = static_cast<const char*>(vals) + (int64_t)layer * jb * maxb * bs * bs * esize;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_bs<float>(bs, x, pl, vl, cl, rl, sl, y, t_dim, k_dim, m_dim, r, maxb, bt, s);
  if (dtype == kBF16)
    return dispatch_bs<__nv_bfloat16>(bs, x, pl, vl, cl, rl, sl, y, t_dim, k_dim, m_dim, r, maxb, bt, s);
  return cudaErrorInvalidValue;
}

// y = x @ p @ vt with x (T, K), p (K, r), vt (r, M), y (T, M).
extern "C" int lowrank_matmul_launch(const void* x, const void* p, const void* vt, void* y,
                                     int t_dim, int k_dim, int m_dim, int r, int bt,
                                     int dtype, void* stream) {
  if (bad_tile(bt) || t_dim < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float, 64, false>(x, p, vt, nullptr, nullptr, nullptr, y, t_dim, k_dim,
                                    m_dim, r, 0, bt, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, 64, false>(x, p, vt, nullptr, nullptr, nullptr, y, t_dim,
                                            k_dim, m_dim, r, 0, bt, s);
  return cudaErrorInvalidValue;
}
