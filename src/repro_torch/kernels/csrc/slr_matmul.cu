// Fused SLR matmul for Hopper (sm_90a):  y = x @ P[l] @ Vt[l] + x @ S[l]
//
// Replaces the TPU kernels slr_matmul_stacked_pallas, slr_matmul_multi_pallas
// and slr_matmul_pallas (repro/kernels/slr_matmul.py) and
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
//
// x and y have one type (TX) and the tables another (TW): the stacked and
// per-slot entries take one dtype for both, the unstacked and low-rank
// entries also bf16 activations over f32 tables (a bf16 model deployed from
// an f32 SLR state, as the hybrid's shared block is), each read into f32.
//
// The unstacked entry (slr_matmul_launch; one (K, M) weight, the shared
// attention block of the hybrid family) computes x @ P ONCE per call, as the
// Pallas kernel computes it once per row tile, in three kernels on the
// stream:
//   A. lowrank_partial_kernel: grid (row tiles, rank chunks of kRC, splits of
//      K of kKSplit rows); each block writes its (BT, kRC) partial product
//      of x[:, split] @ P[split, chunk] to an f32 scratch (S_k, T, r);
//   B. slr_emit_kernel: grid (row tiles, column blocks of bs, work splits);
//      a column block's work is its rank chunks (t, the sum of that chunk's
//      partials in split order, times Vt[chunk, j]) then its live tiles, and
//      each work split writes the f32 partial of its items to a second
//      scratch (S_w, T, M);
//   C. sum_splits_kernel: y = the sum of the S_w partials in order, rounded
//      once to x's dtype.
// Zamba2's shared block has K up to 10240, M up to 10240 and r up to 640: the
// per-column-block recompute of the fused body would read P once per column
// block (80 times for gate/up); here P is read once and only the partials, a
// few MB, are read again (from L2). The wrapper sizes S_w so that the grid of
// B holds about two blocks per SM (M = 2560 gives only 20 column blocks at
// bs = 128). BT is 8 rows for T <= 8 (decode) and 32 otherwise, so a
// one-token call does not compute 32 padded rows. Every sum runs in a fixed
// order, so a call is deterministic.
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
template <typename TX, typename TW, int BN, bool kSparse>
__device__ __forceinline__ void slr_tile(const TX* __restrict__ x, const TW* __restrict__ p,
                                         const TW* __restrict__ vt,
                                         const int* __restrict__ counts,
                                         const int* __restrict__ rows,
                                         const TW* __restrict__ vals, TX* __restrict__ y,
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
      const TW* tile = vals + ((int64_t)j * maxb + s) * BN * BN;
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
        y[(int64_t)(row0 + rr) * m_dim + col0 + acc_c] = from_f32<TX>(acc[i]);
    }
  }
}

// One table row for the whole grid: blockIdx.x is the row tile (the stacked
// and low-rank entries; the host offsets the tables to the row).
template <typename TX, typename TW, int BN, bool kSparse>
__global__ void __launch_bounds__(kThreads)
slr_matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ p,
                  const TW* __restrict__ vt, const int* __restrict__ counts,
                  const int* __restrict__ rows, const TW* __restrict__ vals,
                  TX* __restrict__ y, int t_dim, int k_dim, int m_dim, int r,
                  int maxb, int bt) {
  const int row0 = blockIdx.x * bt;
  slr_tile<TX, TW, BN, kSparse>(x, p, vt, counts, rows, vals, y, k_dim, m_dim, r, maxb, row0,
                                min(bt, t_dim - row0));
}

// Per-slot table rows: blockIdx.x = slot * tiles + row tile of the slot; the
// block reads its row ids[slot] * layers + layer on the device.
template <typename TX, typename TW, int BN, bool kSparse>
__global__ void __launch_bounds__(kThreads)
slr_matmul_multi_kernel(const TX* __restrict__ x, const TW* __restrict__ p,
                        const TW* __restrict__ vt, const int* __restrict__ counts,
                        const int* __restrict__ rows, const TW* __restrict__ vals,
                        const int* __restrict__ ids, TX* __restrict__ y, int t_dim,
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
        y[(int64_t)(row0 + rr) * m_dim + c] = from_f32<TX>(__int_as_float(0x7fc00000));
    }
    return;
  }
  slr_tile<TX, TW, BN, kSparse>(
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

template <typename TX, typename TW, int BN, bool kSparse>
cudaError_t launch(const SlrArgs& a, cudaStream_t stream) {
  const int tiles = (a.t_dim + a.bt - 1) / a.bt;
  dim3 grid(a.b_dim * tiles, (a.m_dim + BN - 1) / BN);
  const TX* x = static_cast<const TX*>(a.x);
  const TW* p = static_cast<const TW*>(a.p);
  const TW* vt = static_cast<const TW*>(a.vt);
  const TW* vals = static_cast<const TW*>(a.vals);
  TX* y = static_cast<TX*>(a.y);
  if (a.ids == nullptr)
    slr_matmul_kernel<TX, TW, BN, kSparse><<<grid, kThreads, 0, stream>>>(
        x, p, vt, a.counts, a.rows, vals, y, a.t_dim, a.k_dim, a.m_dim, a.r, a.maxb, a.bt);
  else
    slr_matmul_multi_kernel<TX, TW, BN, kSparse><<<grid, kThreads, 0, stream>>>(
        x, p, vt, a.counts, a.rows, vals, a.ids, y, a.t_dim, a.k_dim, a.m_dim, a.r, a.maxb,
        a.bt, tiles, a.layers, a.layer, a.n_tab, a.jb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bs(int bs, const SlrArgs& a, cudaStream_t stream) {
  switch (bs) {
    case 8: return launch<T, T, 8, true>(a, stream);
    case 16: return launch<T, T, 16, true>(a, stream);
    case 32: return launch<T, T, 32, true>(a, stream);
    case 64: return launch<T, T, 64, true>(a, stream);
    case 128: return launch<T, T, 128, true>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// One dtype for x and the tables; bs == 0: the low-rank instance (no sparse
// tables)
cudaError_t dispatch(int dtype, int bs, const SlrArgs& a, cudaStream_t stream) {
  if (a.bt < 1 || a.bt > kMaxBT || a.t_dim < 1 || a.b_dim < 1) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return bs ? dispatch_bs<float>(bs, a, stream)
              : launch<float, float, kLowRankBN, false>(a, stream);
  if (dtype == kBF16)
    return bs ? dispatch_bs<__nv_bfloat16>(bs, a, stream)
              : launch<__nv_bfloat16, __nv_bfloat16, kLowRankBN, false>(a, stream);
  return cudaErrorInvalidValue;
}

// The low-rank instance with its own table dtype: x/y dtype, tables wdtype
// (equal, or bf16 activations over f32 tables).
cudaError_t dispatch_lowrank(int dtype, int wdtype, const SlrArgs& a, cudaStream_t stream) {
  if (a.bt < 1 || a.bt > kMaxBT || a.t_dim < 1 || a.b_dim < 1) return cudaErrorInvalidValue;
  if (dtype == wdtype) return dispatch(dtype, 0, a, stream);
  if (dtype == kBF16 && wdtype == kF32)
    return launch<__nv_bfloat16, float, kLowRankBN, false>(a, stream);
  return cudaErrorInvalidValue;
}

// ---- the unstacked entry: x @ P once per call, then the column blocks ------

constexpr int kKSplit = 256;   // rows of P per partial-product block

// A. part[split, row, c] = x[row, split rows] @ P[split rows, c] for one
// (row tile, rank chunk, split) per block.
template <typename TX, typename TW, int BT>
__global__ void __launch_bounds__(kThreads)
lowrank_partial_kernel(const TX* __restrict__ x, const TW* __restrict__ p,
                       float* __restrict__ part, int t_dim, int k_dim, int r) {
  constexpr int KC = 32;
  constexpr int T_RSTRIDE = kThreads / kRC;
  constexpr int NT = BT / T_RSTRIDE;
  __shared__ float xs[BT][KC];
  __shared__ float ws[KC][kRC];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BT;
  const int rc0 = blockIdx.y * kRC;
  const int split = blockIdx.z;
  const int k_lo = split * kKSplit;
  const int k_hi = min(k_dim, k_lo + kKSplit);
  const int n_rows = min(BT, t_dim - row0);
  const int rcw = min(kRC, r - rc0);
  const int t_c = tid % kRC;
  const int t_r = tid / kRC;

  float tacc[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) tacc[i] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += KC) {
    for (int e = tid; e < BT * KC; e += kThreads) {
      const int rr = e / KC, kk = e % KC;
      xs[rr][kk] = (rr < n_rows && k0 + kk < k_hi)
                       ? to_f32(x[(int64_t)(row0 + rr) * k_dim + k0 + kk]) : 0.f;
    }
    for (int e = tid; e < KC * kRC; e += kThreads) {
      const int kk = e / kRC, cc = e % kRC;
      ws[kk][cc] = (k0 + kk < k_hi && cc < rcw) ? to_f32(p[(int64_t)(k0 + kk) * r + rc0 + cc])
                                                : 0.f;
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
  if (t_c < rcw) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int rr = t_r + i * T_RSTRIDE;
      if (rr < n_rows) part[((int64_t)split * t_dim + row0 + rr) * r + rc0 + t_c] = tacc[i];
    }
  }
}

// B. One (row tile, column block j, work split z) per block. Column block
// j's work is its ceil(r / kRC) rank chunks (t = the sum of the partials of
// that chunk, then t @ Vt[chunk, j]) followed by its counts[j] live tiles;
// split z of n_ssplit takes a contiguous range of those items and writes its
// f32 partial of the (BT, bs) tile to ypart[z]. Splitting the items keeps
// the card busy when the grid has few column blocks (M = 2560 gives 20 at
// bs = 128, with 80 tiles each for `down`).
template <typename TX, typename TW, int BN, int BT>
__global__ void __launch_bounds__(kThreads)
slr_emit_kernel(const TX* __restrict__ x, const float* __restrict__ part,
                const TW* __restrict__ vt, const int* __restrict__ counts,
                const int* __restrict__ rows, const TW* __restrict__ vals,
                float* __restrict__ ypart, int t_dim, int k_dim, int m_dim, int r,
                int n_ksplit, int maxb, int n_ssplit) {
  constexpr int KC = BN < 32 ? BN : 32;
  constexpr int NACC = (BT * BN + kThreads - 1) / kThreads;
  constexpr int ACC_RSTRIDE = kThreads / BN;

  __shared__ float xs[BT][KC];
  __shared__ float ws[KC][BN];
  __shared__ float ts[BT][kRC];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BT;
  const int j = blockIdx.y;
  const int z = blockIdx.z;
  const int col0 = j * BN;
  const int n_rows = min(BT, t_dim - row0);
  const int acc_c = tid % BN;
  const int acc_r = tid / BN;
  const int n_rc = (r + kRC - 1) / kRC;
  const int cnt = min(counts[j], maxb);
  const int items = n_rc + cnt;
  const int per = (items + n_ssplit - 1) / n_ssplit;
  const int i_lo = min(items, z * per);
  const int i_hi = min(items, i_lo + per);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // rank chunks of this split: t (the sum of the chunk's partials) @ Vt
  for (int rc = i_lo; rc < min(i_hi, n_rc); ++rc) {
    const int rc0 = rc * kRC;
    const int rcw = min(kRC, r - rc0);
    for (int e = tid; e < BT * kRC; e += kThreads) {
      const int rr = e / kRC, cc = e % kRC;
      float sum = 0.f;
      if (rr < n_rows && cc < rcw) {
        const float* src = part + (int64_t)(row0 + rr) * r + rc0 + cc;
        for (int sp = 0; sp < n_ksplit; ++sp) sum += src[(int64_t)sp * t_dim * r];
      }
      ts[rr][cc] = sum;
    }
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
          if (rr < BT) acc[i] += ts[rr][q0 + kk] * w;
        }
      }
      __syncthreads();
    }
  }

  // live tiles of this split
  for (int it = max(i_lo, n_rc); it < i_hi; ++it) {
    const int s = it - n_rc;
    const int rb = rows[(int64_t)j * maxb + s];
    const TW* tile = vals + ((int64_t)j * maxb + s) * BN * BN;
    for (int k0 = 0; k0 < BN; k0 += KC) {
      const int kbase = rb * BN + k0;
      for (int e = tid; e < BT * KC; e += kThreads) {
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
          if (rr < BT) acc[i] += xs[rr][kk] * w;
        }
      }
      __syncthreads();
    }
  }

  if (col0 + acc_c < m_dim) {
    float* out = ypart + (int64_t)z * t_dim * m_dim;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int rr = acc_r + i * ACC_RSTRIDE;
      if (rr < n_rows) out[(int64_t)(row0 + rr) * m_dim + col0 + acc_c] = acc[i];
    }
  }
}

// C. y = the sum of the splits' partials, in split order, rounded once.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ ypart, TX* __restrict__ y, int64_t n,
                  int n_ssplit) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float sum = 0.f;
  for (int z = 0; z < n_ssplit; ++z) sum += ypart[(int64_t)z * n + i];
  y[i] = from_f32<TX>(sum);
}

struct UnstackedArgs {
  const void* x; const void* p; const void* vt;
  const int* counts; const int* rows; const void* vals;
  float* part; float* ypart; void* y;
  int t_dim, k_dim, m_dim, r, jb, maxb, n_ksplit, n_ssplit;
};

template <typename TX, typename TW, int BN, int BT>
cudaError_t launch_emit(const UnstackedArgs& a, cudaStream_t stream) {
  dim3 grid((a.t_dim + BT - 1) / BT, a.jb, a.n_ssplit);
  slr_emit_kernel<TX, TW, BN, BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(a.x), a.part, static_cast<const TW*>(a.vt), a.counts, a.rows,
      static_cast<const TW*>(a.vals), a.ypart, a.t_dim, a.k_dim, a.m_dim, a.r, a.n_ksplit,
      a.maxb, a.n_ssplit);
  return cudaGetLastError();
}

template <typename TX, typename TW, int BT>
cudaError_t launch_unstacked(int bs, const UnstackedArgs& a, cudaStream_t stream) {
  dim3 grid_a((a.t_dim + BT - 1) / BT, (a.r + kRC - 1) / kRC, a.n_ksplit);
  lowrank_partial_kernel<TX, TW, BT><<<grid_a, kThreads, 0, stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.p), a.part, a.t_dim, a.k_dim, a.r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (bs) {
    case 8: err = launch_emit<TX, TW, 8, BT>(a, stream); break;
    case 16: err = launch_emit<TX, TW, 16, BT>(a, stream); break;
    case 32: err = launch_emit<TX, TW, 32, BT>(a, stream); break;
    case 64: err = launch_emit<TX, TW, 64, BT>(a, stream); break;
    case 128: err = launch_emit<TX, TW, 128, BT>(a, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)a.t_dim * a.m_dim;
  sum_splits_kernel<TX><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      a.ypart, static_cast<TX*>(a.y), n, a.n_ssplit);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t dispatch_unstacked_bt(int bs, int bt, const UnstackedArgs& a,
                                  cudaStream_t stream) {
  if (bt == 8) return launch_unstacked<TX, TW, 8>(bs, a, stream);
  if (bt == 32) return launch_unstacked<TX, TW, 32>(bs, a, stream);
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

// y = x @ p @ vt with x (T, K), p (K, r), vt (r, M), y (T, M); x and y of
// dtype, the factors of wdtype.
extern "C" int lowrank_matmul_launch(const void* x, const void* p, const void* vt, void* y,
                                     int t_dim, int k_dim, int m_dim, int r, int bt,
                                     int dtype, int wdtype, void* stream) {
  SlrArgs a{};
  a.x = x, a.p = p, a.vt = vt, a.y = y;
  a.b_dim = 1, a.t_dim = t_dim, a.k_dim = k_dim, a.m_dim = m_dim, a.r = r, a.bt = bt;
  return dispatch_lowrank(dtype, wdtype, a, static_cast<cudaStream_t>(stream));
}

// One unstacked weight: y = x @ p @ vt + x @ S with x (T, K), p (K, r),
// vt (r, M), S block-CSC counts (JB,), rows (JB, MAXB), vals (JB, MAXB, bs,
// bs); f32 scratch part (n_ksplit, T, r) with n_ksplit = ceil(K / ksplit) and
// ypart (n_ssplit, T, M); bt (8 or 32) rows per block; x and y of dtype, the
// tables of wdtype.
extern "C" int slr_matmul_launch(const void* x, const void* p, const void* vt,
                                 const int* counts, const int* rows, const void* vals,
                                 float* part, float* ypart, void* y, int t_dim, int k_dim,
                                 int m_dim, int r, int jb, int maxb, int bs, int bt,
                                 int n_ksplit, int ksplit, int n_ssplit, int dtype, int wdtype,
                                 void* stream) {
  if (t_dim < 1 || k_dim < 1 || r < 1 || jb < 1 || maxb < 1 || bs < 8 || n_ssplit < 1 ||
      ksplit != kKSplit || n_ksplit != (k_dim + kKSplit - 1) / kKSplit ||
      jb != (m_dim + bs - 1) / bs)
    return cudaErrorInvalidValue;
  UnstackedArgs a{x, p, vt, counts, rows, vals, part, ypart, y, t_dim, k_dim, m_dim, r, jb,
                  maxb, n_ksplit, n_ssplit};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && wdtype == kF32) return dispatch_unstacked_bt<float, float>(bs, bt, a, s);
  if (dtype == kBF16 && wdtype == kBF16)
    return dispatch_unstacked_bt<__nv_bfloat16, __nv_bfloat16>(bs, bt, a, s);
  if (dtype == kBF16 && wdtype == kF32)
    return dispatch_unstacked_bt<__nv_bfloat16, float>(bs, bt, a, s);
  return cudaErrorInvalidValue;
}
