// Fused SLR matmul for Hopper (sm_90a):  y = x @ P[l] @ Vt[l] + x @ S[l]
//
// Replaces the TPU kernels slr_matmul_stacked_pallas and
// slr_matmul_multi_pallas (repro/kernels/slr_matmul.py) and
// lowrank_matmul_pallas (repro/kernels/lowrank_matmul.py). S[l] is row l of a
// block-CSC stack (counts (N, JB), rows (N, JB, MAXB), vals (N, JB, MAXB, bs,
// bs)), the layout built by kernels/bsr_matmul.py; the stack's leading axis
// is a layer axis (L) or, for pooled adapter tables, an (adapter, layer) axis
// of A * L rows.
//
// Design. x is (B, T, K): B slots of T rows each (B = 1 for the stacked and
// low-rank entries). One thread block per (slot b, row tile of that slot,
// output column block j of width BN); a row tile never spans two slots. Two
// thin kernels, one per entry kind, inline the one body (slr_tile), so the
// single-row entries compile as before the per-slot entry existed. The
// block
//   0. (multi entry only) reads its table row ids[b] * layers + layer from
//      device memory - the TPU kernel's scalar-prefetched adapter id - so any
//      slot -> adapter assignment runs without a host sync;
//   1. computes t = x_tile @ P[row] one rank chunk of kRC columns at a time
//      into shared memory (f32), and seeds the accumulator with
//      t @ Vt[row][:, j];
//   2. (fused instances only) walks the counts[row, j] live tiles of column
//      block j and adds x[:, rows[row, j, s]] @ vals[row, j, s];
//   3. writes its (bt, BN) tile of y once.
// The (bt, r) intermediate never leaves the SM and y is written once, as in
// the Pallas kernels. Every column block recomputes x_tile @ P: a known
// redundancy of JB times the low-rank first product, paid for a grid with
// enough blocks to fill the card at decode widths. Products run on the CUDA
// cores in f32 from shared memory; no tensor cores (wgmma) and no TMA yet.
// Each output row's arithmetic depends only on that row of x and the table
// row it reads (never on T, the tile or the slot), so the multi entry gives
// bit for bit what the stacked entry gives on the same rows: a one-adapter
// pool serves exactly the single-tenant tier's numbers.
//
// Bound on this card: at decode widths (a few rows per slot) the kernel must
// read the selected rows' P, Vt and live S tiles once, so it is bound by
// bytes; at prefill-chunk widths by operations. The f32 CUDA-core products
// keep it far from either bound; wgmma tiles are the next step. With B slots
// at decode width the multi entry re-reads a row's P once per slot that
// selects it (L2 serves the repeats).
//
// For the fused instances BN equals the BSR block size bs (8..128); ragged
// T, K and M are masked in the loads and the store. A table row outside
// [0, n_tab) writes NaN rows instead of reading past the pool. The wrappers
// in kernels/slr_matmul.py and kernels/lowrank_matmul.py check every
// argument.
#include <stdint.h>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBT = 32;   // rows of x per block
constexpr int kRC = 128;     // rank chunk held in shared memory
constexpr int kLowRankBN = 64;

// The body every entry runs: rows row0 .. row0 + n_rows - 1 of x against one
// table row (the pointers arrive offset to it), output column block
// blockIdx.y. Both __global__ entries inline it, so a row's arithmetic is the
// same under either.
template <typename T, int BN, bool kSparse>
__device__ __forceinline__ void slr_tile(const T* __restrict__ x, const T* __restrict__ p,
                                         const T* __restrict__ vt,
                                         const int* __restrict__ counts,
                                         const int* __restrict__ rows,
                                         const T* __restrict__ vals, T* __restrict__ y,
                                         int k_dim, int m_dim, int r, int maxb, int row0,
                                         int n_rows) {
  constexpr int KC = BN < 32 ? BN : 32;          // reduction chunk
  constexpr int NACC = (kMaxBT * BN + kThreads - 1) / kThreads;
  constexpr int NT = kMaxBT * kRC / kThreads;
  constexpr int ACC_RSTRIDE = kThreads / BN;     // rows between a thread's outputs
  constexpr int T_RSTRIDE = kThreads / kRC;

  __shared__ float xs[kMaxBT][KC];
  __shared__ float ws[KC][kRC > BN ? kRC : BN];
  __shared__ float ts[kMaxBT][kRC];

  const int tid = threadIdx.x;
  const int j = blockIdx.y;
  const int col0 = j * BN;

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

// One table row for the whole grid: blockIdx.x is the row tile (the stacked
// and low-rank entries; the host offsets the tables to the row).
template <typename T, int BN, bool kSparse>
__global__ void __launch_bounds__(kThreads)
slr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ p,
                  const T* __restrict__ vt, const int* __restrict__ counts,
                  const int* __restrict__ rows, const T* __restrict__ vals,
                  T* __restrict__ y, int t_dim, int k_dim, int m_dim, int r,
                  int maxb, int bt) {
  const int row0 = blockIdx.x * bt;
  slr_tile<T, BN, kSparse>(x, p, vt, counts, rows, vals, y, k_dim, m_dim, r, maxb, row0,
                           min(bt, t_dim - row0));
}

// Per-slot table rows: blockIdx.x = slot * tiles + row tile of the slot; the
// block reads its row ids[slot] * layers + layer on the device.
template <typename T, int BN, bool kSparse>
__global__ void __launch_bounds__(kThreads)
slr_matmul_multi_kernel(const T* __restrict__ x, const T* __restrict__ p,
                        const T* __restrict__ vt, const int* __restrict__ counts,
                        const int* __restrict__ rows, const T* __restrict__ vals,
                        const int* __restrict__ ids, T* __restrict__ y, int t_dim,
                        int k_dim, int m_dim, int r, int maxb, int bt, int tiles,
                        int layers, int layer, int n_tab, int jb) {
  const int slot = blockIdx.x / tiles;
  const int row0 = (blockIdx.x % tiles) * bt;
  const int n_rows = min(bt, t_dim - row0);
  x += (int64_t)slot * t_dim * k_dim;
  y += (int64_t)slot * t_dim * m_dim;
  const int64_t tab = (int64_t)ids[slot] * layers + layer;
  if (tab < 0 || tab >= n_tab) {   // uniform over the block: no barrier is skipped
    const int c = blockIdx.y * BN + threadIdx.x % BN;
    if (c < m_dim) {
      for (int rr = threadIdx.x / BN; rr < n_rows; rr += kThreads / BN)
        y[(int64_t)(row0 + rr) * m_dim + c] = from_f32<T>(__int_as_float(0x7fc00000));
    }
    return;
  }
  slr_tile<T, BN, kSparse>(
      x, p + tab * k_dim * r, vt + tab * r * m_dim,
      kSparse ? counts + tab * jb : counts, kSparse ? rows + tab * jb * maxb : rows,
      kSparse ? vals + tab * jb * maxb * BN * BN : vals, y, k_dim, m_dim, r, maxb, row0,
      n_rows);
}

struct SlrArgs {
  const void* x;       // (B, T, K)
  const void* p;       // (N, K, r), or one row's (K, r) without ids
  const void* vt;      // (N, r, M)
  const int* counts;   // (N, JB)
  const int* rows;     // (N, JB, MAXB)
  const void* vals;    // (N, JB, MAXB, bs, bs)
  const int* ids;      // (B,) slot -> table selector, or null (one row)
  void* y;             // (B, T, M)
  int b_dim, t_dim, k_dim, m_dim, r, maxb, bt, layers, layer, n_tab, jb;
};

template <typename T, int BN, bool kSparse>
cudaError_t launch(const SlrArgs& a, cudaStream_t stream) {
  const int tiles = (a.t_dim + a.bt - 1) / a.bt;
  dim3 grid(a.b_dim * tiles, (a.m_dim + BN - 1) / BN);
  const T* x = static_cast<const T*>(a.x);
  const T* p = static_cast<const T*>(a.p);
  const T* vt = static_cast<const T*>(a.vt);
  const T* vals = static_cast<const T*>(a.vals);
  T* y = static_cast<T*>(a.y);
  if (a.ids == nullptr)
    slr_matmul_kernel<T, BN, kSparse><<<grid, kThreads, 0, stream>>>(
        x, p, vt, a.counts, a.rows, vals, y, a.t_dim, a.k_dim, a.m_dim, a.r, a.maxb, a.bt);
  else
    slr_matmul_multi_kernel<T, BN, kSparse><<<grid, kThreads, 0, stream>>>(
        x, p, vt, a.counts, a.rows, vals, a.ids, y, a.t_dim, a.k_dim, a.m_dim, a.r, a.maxb,
        a.bt, tiles, a.layers, a.layer, a.n_tab, a.jb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bs(int bs, const SlrArgs& a, cudaStream_t stream) {
  switch (bs) {
    case 8: return launch<T, 8, true>(a, stream);
    case 16: return launch<T, 16, true>(a, stream);
    case 32: return launch<T, 32, true>(a, stream);
    case 64: return launch<T, 64, true>(a, stream);
    case 128: return launch<T, 128, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bs == 0: the low-rank instance (no sparse tables)
cudaError_t dispatch(int dtype, int bs, const SlrArgs& a, cudaStream_t stream) {
  if (a.bt < 1 || a.bt > kMaxBT || a.t_dim < 1 || a.b_dim < 1) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return bs ? dispatch_bs<float>(bs, a, stream) : launch<float, kLowRankBN, false>(a, stream);
  if (dtype == kBF16)
    return bs ? dispatch_bs<__nv_bfloat16>(bs, a, stream)
              : launch<__nv_bfloat16, kLowRankBN, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace salaad

using namespace salaad;

// Layer ``layer`` of the stacked tables: p (L, K, r), vt (L, r, M),
// counts (L, JB), rows (L, JB, MAXB), vals (L, JB, MAXB, bs, bs); x (T, K),
// y (T, M). The host offsets the tables to the layer. Returns the launch's
// cudaGetLastError().
extern "C" int slr_matmul_stacked_launch(const void* x, const void* p, const void* vt,
                                         const int* counts, const int* rows,
                                         const void* vals, void* y, int t_dim, int k_dim,
                                         int m_dim, int r, int layer, int jb, int maxb,
                                         int bs, int bt, int dtype, void* stream) {
  const int64_t esize = dtype == kF32 ? 4 : 2;
  SlrArgs a{};
  a.x = x;
  a.p = static_cast<const char*>(p) + (int64_t)layer * k_dim * r * esize;
  a.vt = static_cast<const char*>(vt) + (int64_t)layer * r * m_dim * esize;
  a.counts = counts + (int64_t)layer * jb;
  a.rows = rows + (int64_t)layer * jb * maxb;
  a.vals = static_cast<const char*>(vals) + (int64_t)layer * jb * maxb * bs * bs * esize;
  a.y = y;
  a.b_dim = 1, a.t_dim = t_dim, a.k_dim = k_dim, a.m_dim = m_dim, a.r = r;
  a.maxb = maxb, a.bt = bt;
  return dispatch(dtype, bs, a, static_cast<cudaStream_t>(stream));
}

// Per-slot tables: slot b of x (B, T, K) runs table row
// ids[b] * layers + layer of p (N, K, r), vt (N, r, M) and, when counts is
// not null, of the block-CSC stack counts (N, JB), rows (N, JB, MAXB),
// vals (N, JB, MAXB, bs, bs); y (B, T, M). counts == null runs the low-rank
// instance (bs ignored). ids is read on the device.
extern "C" int slr_matmul_multi_launch(const void* x, const void* p, const void* vt,
                                       const int* counts, const int* rows,
                                       const void* vals, const int* ids, void* y, int b_dim,
                                       int t_dim, int k_dim, int m_dim, int r, int layers,
                                       int layer, int n_tab, int jb, int maxb, int bs,
                                       int bt, int dtype, void* stream) {
  if (ids == nullptr || n_tab < 1) return cudaErrorInvalidValue;
  SlrArgs a{};
  a.x = x, a.p = p, a.vt = vt, a.counts = counts, a.rows = rows, a.vals = vals;
  a.ids = ids, a.y = y;
  a.b_dim = b_dim, a.t_dim = t_dim, a.k_dim = k_dim, a.m_dim = m_dim, a.r = r;
  a.maxb = maxb, a.bt = bt, a.layers = layers, a.layer = layer, a.n_tab = n_tab, a.jb = jb;
  return dispatch(dtype, counts == nullptr ? 0 : bs, a, static_cast<cudaStream_t>(stream));
}

// y = x @ p @ vt with x (T, K), p (K, r), vt (r, M), y (T, M).
extern "C" int lowrank_matmul_launch(const void* x, const void* p, const void* vt, void* y,
                                     int t_dim, int k_dim, int m_dim, int r, int bt,
                                     int dtype, void* stream) {
  SlrArgs a{};
  a.x = x, a.p = p, a.vt = vt, a.y = y;
  a.b_dim = 1, a.t_dim = t_dim, a.k_dim = k_dim, a.m_dim = m_dim, a.r = r, a.bt = bt;
  return dispatch(dtype, 0, a, static_cast<cudaStream_t>(stream));
}
