// Fused SLR matmul for Hopper (sm_90a):  y = x @ P[l] @ Vt[l] + x @ S[l]
//
// Replaces four TPU kernels of repro/kernels/: slr_matmul_stacked_pallas and
// slr_matmul_multi_pallas (slr_matmul.py; the stacked and per-slot entries,
// both the fused body slr_fused_kernel below), slr_matmul_pallas
// (slr_matmul.py; the unstacked entry) and lowrank_matmul_pallas
// (lowrank_matmul.py; the low-rank body, also the per-slot entry's empty-S
// corner). S[l] is row l of a block-CSC stack (counts (N, JB), rows (N, JB,
// MAXB), vals (N, JB, MAXB, bs, bs)), the layout built by
// kernels/bsr_matmul.py; the leading axis is a layer axis (L) or, for pooled
// adapter tables, an (adapter, layer) axis of A * L rows.
//
// The fused body. Column block j (width BN = bs) of y reduces over one axis:
// the r rank rows (operand t = x @ P, weights Vt[:, j]), then the counts[j]
// live tiles of bs rows (operand x[:, rows[j, s] * bs ...], weights
// vals[j, s]). A thread-block cluster of C = 8 blocks serves one row tile
// (BT rows of x: 8 at decode, 32 otherwise) and `loops` groups of G column
// blocks, S = C / G blocks per column block. Each block runs one stream of
// stages through a kStages-deep cp.async ring (16-byte copies):
//   1. the stages of x_tile @ P over its split c of K (K / C rows), into its
//      partial tp_c;
//   2. one cluster barrier; t = tp_0 + ... + tp_{C-1}, read in rank order
//      from every block's shared memory (distributed shared memory);
//   3. per column group, the stages of segment s of column block j's axis
//      (the stages n * s / S .. n * (s+1) / S of its n stages of kStep
//      rows): Vt rows against t, then live tiles against the gathered rows
//      of x. These tiles load while step 1 still computes;
//   4. S = 1: y written from registers; else each group's partial tile waits
//      in shared memory, and once per batch of ypn groups one barrier lets
//      block (g, s) sum slice s of the S partials of each tile in segment
//      order and write it. y is written once, rounded once to x's dtype.
// One launch per call, no atomics, no scratch in device memory.
//
// Products: mma.sync m16n8k8 TF32 on the tensor cores, error-compensated
// (3xTF32: each operand v = hi + lo, both TF32; hi hi + hi lo + lo hi summed
// in f32, the lo lo term dropped), so f32 tables keep f32 accuracy (about
// 1e-6 relative here; the gates are 1e-4) and bf16 tables are read into f32
// the same way. The rows of x sit on the n side of the product, so a decode
// tile is exactly 8 rows: a decode call computes no padded row beyond 8.
//
// What bounds it on this card: at decode widths the bytes of the selected
// rows' P, Vt and live tiles, read once (the f32 gate site: 3.8 MB, 1.1 us at
// 3.35 TB/s); at chunk and prefill widths the operations (gate, T = 512:
// 0.97 GFLOP of f32 products, each three TF32 products here: 5.9 us at 495
// TFLOP/s of dense TF32, 165 TFLOP/s of 3xTF32 products). Measured (PERF.md)
// the body is bound by neither: each stage pays a barrier and a memory round
// trip, and the cluster barriers and distributed-shared-memory sums add
// microseconds per call. What the design does about the first design's five
// faults:
//   - x @ P per column block: computed once per cluster, split C ways over K
//     (a block reads 1/C of P), and at prefill widths once per row tile, one
//     cluster walking all column groups (loops);
//   - 32 rows computed at decode: BT is 8 at decode, 32 otherwise;
//   - too few blocks at small JB: S blocks split each column block's axis;
//     S is the most segments whose decode call still fits in one wave of the
//     card's resident clusters (the q site, JB = 4: 32 blocks per table row
//     instead of 4), and loops keeps every cluster of a call resident;
//   - inner loops: tensor-core products from conflict-free shared-memory
//     fragments, 16-byte cp.async stages double-buffered against them,
//     dynamic shared memory above 48 KB, two blocks per SM where it fits;
//   - per-slot re-reads: the per-slot grid runs over (pool row, row tile): a
//     block gathers the rows of every slot that selects its pool row (ids
//     read on the device, no host sync), so each selected row's tables are
//     read once per call, not once per slot; a pool row nobody selects exits.
//
// Rows stay independent of T and B. Every output element is, per split of K
// and per segment of its column block, three chains of products in a fixed
// order (k ascending), summed in a fixed order, then the C (for t) or S (for
// y) partials summed in rank order. The splits and segments depend only on
// the table shape (K, r, M, bs), the card and the table row's counts (the
// launch plan kernels/slr_matmul.py::fused_plan), never on T, B, the row
// tile, the slot, ids or the thread that holds the element; padded rows are
// zero and never written. So a row of x gives bit for bit the same row of y
// in a call of any T, the per-slot entry gives bit for bit what the stacked
// entry gives on the same table row (a one-adapter pool serves the
// single-tenant tier's numbers), and batched, grouped and one-request runs
// serve one stream.
//
// Ragged T, K and M are masked (zero-filled in the stages, never written);
// misaligned rows are staged element by element. A per-slot table row
// outside [0, n_tab) writes NaN rows instead of reading past the pool.
//
// The low-rank body (lowrank_tile: lowrank_matmul and the per-slot entry's
// empty-S corner, which must stay equal bit for bit) is the first design:
// one block per (slot, row tile of 32 or fewer rows, column block of 64),
// x @ P recomputed per column block, f32 products from shared memory.
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
// Zamba2's shared block has K up to 10240, M up to 10240 and r up to 640: P
// is read once and only the partials, a few MB, are read again (from L2). The
// wrapper sizes S_w so that the grid of B holds about two blocks per SM (M =
// 2560 gives only 20 column blocks at bs = 128). BT is 8 rows for T <= 8
// (decode) and 32 otherwise. Every sum runs in a fixed order, so a call is
// deterministic.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace salaad {
namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxBT = 32;   // rows of x per block of the low-rank body
constexpr int kRC = 128;     // rank chunk held in shared memory
constexpr int kLowRankBN = 64;

// The low-rank body: rows row0 .. row0 + n_rows - 1 of x against one table
// row (the pointers arrive offset to it), output column block blockIdx.y.
template <typename TX, typename TW, int BN>
__device__ __forceinline__ void lowrank_tile(const TX* __restrict__ x, const TW* __restrict__ p,
                                             const TW* __restrict__ vt, TX* __restrict__ y,
                                             int k_dim, int m_dim, int r, int row0,
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

  // acc = (x_tile @ P) @ Vt[:, j-block], rank-chunked
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

  // one write of the (bt, BN) tile
  if (col0 + acc_c < m_dim) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int rr = acc_r + i * ACC_RSTRIDE;
      if (rr < n_rows)
        y[(int64_t)(row0 + rr) * m_dim + col0 + acc_c] = from_f32<TX>(acc[i]);
    }
  }
}

// One table row for the whole grid: blockIdx.x is the row tile (the host
// offsets the factors to the row).
template <typename TX, typename TW, int BN>
__global__ void __launch_bounds__(kThreads)
lowrank_kernel(const TX* __restrict__ x, const TW* __restrict__ p, const TW* __restrict__ vt,
               TX* __restrict__ y, int t_dim, int k_dim, int m_dim, int r, int bt) {
  const int row0 = blockIdx.x * bt;
  lowrank_tile<TX, TW, BN>(x, p, vt, y, k_dim, m_dim, r, row0, min(bt, t_dim - row0));
}

// Per-slot factor rows: blockIdx.x = slot * tiles + row tile of the slot; the
// block reads its row ids[slot] * layers + layer on the device.
template <typename TX, typename TW, int BN>
__global__ void __launch_bounds__(kThreads)
lowrank_multi_kernel(const TX* __restrict__ x, const TW* __restrict__ p,
                     const TW* __restrict__ vt, const int* __restrict__ ids, TX* __restrict__ y,
                     int t_dim, int k_dim, int m_dim, int r, int bt, int tiles, int layers,
                     int layer, int n_tab) {
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
  lowrank_tile<TX, TW, BN>(x, p + tab * k_dim * r, vt + tab * r * m_dim, y, k_dim, m_dim, r,
                           row0, n_rows);
}

struct LowRankArgs {
  const void* x;       // (B, T, K)
  const void* p;       // (N, K, r), or one row's (K, r) without ids
  const void* vt;      // (N, r, M)
  const int* ids;      // (B,) slot -> table selector, or null (one row)
  void* y;             // (B, T, M)
  int b_dim, t_dim, k_dim, m_dim, r, bt, layers, layer, n_tab;
};

template <typename TX, typename TW>
cudaError_t launch_lowrank(const LowRankArgs& a, cudaStream_t stream) {
  if (a.bt < 1 || a.bt > kMaxBT || a.t_dim < 1 || a.b_dim < 1) return cudaErrorInvalidValue;
  const int tiles = (a.t_dim + a.bt - 1) / a.bt;
  dim3 grid(a.b_dim * tiles, (a.m_dim + kLowRankBN - 1) / kLowRankBN);
  const TX* x = static_cast<const TX*>(a.x);
  const TW* p = static_cast<const TW*>(a.p);
  const TW* vt = static_cast<const TW*>(a.vt);
  TX* y = static_cast<TX*>(a.y);
  if (a.ids == nullptr)
    lowrank_kernel<TX, TW, kLowRankBN><<<grid, kThreads, 0, stream>>>(
        x, p, vt, y, a.t_dim, a.k_dim, a.m_dim, a.r, a.bt);
  else
    lowrank_multi_kernel<TX, TW, kLowRankBN><<<grid, kThreads, 0, stream>>>(
        x, p, vt, a.ids, y, a.t_dim, a.k_dim, a.m_dim, a.r, a.bt, tiles, a.layers, a.layer,
        a.n_tab);
  return cudaGetLastError();
}

// ---- the fused body: the stacked and per-slot entries ----------------------

constexpr int kFThreads = 256;     // 8 warps
constexpr int kStages = 3;         // cp.async ring depth
constexpr int kStep = 32;          // reduction rows per stage (bs rows for bs < 32)
// rank columns per pass of x @ P: a pass splits columns, never a sum, so a
// decode tile takes all of r = 128 in one pass and a wider tile two
__host__ __device__ constexpr int pass_cols(int bt) { return bt == 8 ? 128 : 64; }
constexpr int kCluster = 8;        // blocks per cluster = splits of K for x @ P
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use (227 KB)

struct FusedArgs {
  const void* x;       // (B, T, K)
  const void* p;       // (N, K, r)
  const void* vt;      // (N, r, M)
  const int* counts;   // (N, JB)
  const int* rows;     // (N, JB, MAXB)
  const void* vals;    // (N, JB, MAXB, bs, bs)
  const int* ids;      // (B,) slot -> pool row, or null: table row tab0 for all rows
  void* y;             // (B, T, M)
  int b_dim, t_dim, k_dim, m_dim, r, maxb, jb;
  int layers, layer, n_tab, tab0;
  int nseg, kseg, loops, ypn;   // the launch plan (kernels/slr_matmul.py::fused_plan)
  int groups;                   // column groups: ceil(jb / (kCluster / nseg))
};

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
// staged W columns of a column block (an mma tile is 16 columns wide) and the
// row strides of the W stages (+8 elements: conflict-free fragment loads)
__host__ __device__ constexpr int w_cols(int bn) { return bn < 16 ? 16 : bn; }
__host__ __device__ constexpr int ldw1(int bt) { return pass_cols(bt) + 8; }
__host__ __device__ constexpr int ldw2(int bn) { return w_cols(bn) + 8; }
__host__ __device__ constexpr int ldw_max(int bn, int bt) {
  return ldw2(bn) > ldw1(bt) ? ldw2(bn) : ldw1(bt);
}

// Byte offsets of the dynamic shared memory: tp and tf (BT, rp) f32, the
// block's partial t and the summed t; yp (yp_tiles, BT, BN + 4) f32, the
// partial y tiles of two batches of ypn column groups (none when S = 1); the
// ring of kStages (x tile (BT, kStep + pad), W tile (kStep,
// ldw_max)) in the tables' dtype; rowidx (BT,) int; the column tables of
// the block's column groups (loops counts, then loops x MAXB rows).
// kernels/slr_matmul.py::fused_smem_bytes mirrors the total.
struct FusedSmem {
  int rp, tp, tf, yp, ring, rowidx, cols, total;
};

__host__ __device__ inline int yp_tiles(int nseg, int loops, int ypn) {
  return nseg > 1 ? (loops < 2 * ypn ? loops : 2 * ypn) : 0;
}

template <typename T>
__host__ __device__ inline FusedSmem fused_smem(int bt, int bn, int r, int n_yp, int n_cols) {
  FusedSmem s;
  s.rp = round_up(r, kStep) + 4;
  s.tp = 0;
  s.tf = s.tp + 4 * bt * s.rp;
  s.yp = s.tf + 4 * bt * s.rp;
  s.ring = s.yp + 4 * n_yp * bt * (bn + 4);
  s.rowidx = s.ring + kStages * (bt * (kStep + 16 / (int)sizeof(T)) + kStep * ldw_max(bn, bt)) *
                          (int)sizeof(T);
  s.cols = s.rowidx + 4 * bt;
  s.total = s.cols + 4 * n_cols;
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst (nr, nc), row stride ldd, from src rows of stride lds: element (i, c)
// is read where i < vr and c < vc, zero elsewhere. nc is a multiple of 16
// bytes of T. 16-byte cp.async where the rows are 16-byte aligned, else
// element by element; safe is an address the zero-byte copies may name.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ldd, const T* src, int64_t lds, int nr,
                                           int nc, int vr, int vc, const T* safe) {
  constexpr int V = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && (lds * (int64_t)sizeof(T)) % 16 == 0) {
    const int cpr = nc / V;
    for (int e = threadIdx.x; e < nr * cpr; e += kFThreads) {
      const int i = e / cpr, c = (e % cpr) * V;
      const int n = i < vr ? min(max(vc - c, 0), V) : 0;
      cp_async16(dst + i * ldd + c, n ? src + i * lds + c : safe, n * (int)sizeof(T));
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += kFThreads) {
      const int i = e / nc, c = e % nc;
      dst[i * ldd + c] = (i < vr && c < vc) ? src[i * lds + c] : from_f32<T>(0.f);
    }
  }
}

// dst (BT, nc) of the gathered rows x[rowidx[i], k0 .. k0 + nc), zero where
// rowidx[i] < 0 or the column lies outside [max(k0, 0), min(k0 + vc, K)).
template <typename T, int BT>
__device__ __forceinline__ void stage_rows(T* dst, int ldd, const T* x, const int* rowidx,
                                           int k_dim, int k0, int nc, int vc) {
  constexpr int V = 16 / sizeof(T);
  const int hi = min(vc, k_dim - k0);
  if (k0 >= 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      ((int64_t)k_dim * sizeof(T)) % 16 == 0 && (k0 * (int)sizeof(T)) % 16 == 0) {
    const int cpr = nc / V;
    for (int e = threadIdx.x; e < BT * cpr; e += kFThreads) {
      const int i = e / cpr, c = (e % cpr) * V;
      const int row = rowidx[i];
      const int n = row >= 0 ? min(max(hi - c, 0), V) : 0;
      cp_async16(dst + i * ldd + c, n ? x + (int64_t)row * k_dim + k0 + c : x,
                 n * (int)sizeof(T));
    }
  } else {
    for (int e = threadIdx.x; e < BT * nc; e += kFThreads) {
      const int i = e / nc, c = e % nc;
      const int row = rowidx[i];
      dst[i * ldd + c] = (row >= 0 && c < hi && k0 + c >= 0)
                             ? x[(int64_t)row * k_dim + k0 + c] : from_f32<T>(0.f);
    }
  }
}

// v = hi + lo, both TF32 (the lo part carries the bits TF32 drops)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));
}

// d += a b on the tensor cores: one m16n8k8 TF32 product, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's tiles of a stage: acc[j] (16 columns c0 .. c0 + 15 of W x 8 rows
// of row tile wr + j * WR) += (X[rows, 0:8 KSTEPS] @ W[0:8 KSTEPS, cols])^T.
// The rows of x sit on the n side of the m16n8k8 product (a decode tile is
// exactly 8 rows), the output columns on the m side. Error-compensated
// 3xTF32: with v = hi + lo for every operand, each k8 step adds lo(w) hi(x)
// to acc[j][0], hi(w) lo(x) to acc[j][1] and hi(w) hi(x) to acc[j][2] (three
// independent chains); the lo(w) lo(x) term, below f32's last bit, is
// dropped, and combine() sums the three. Every element's sequence of
// products depends only on its row of X and its column of W, never on the
// thread or the rows beside it.
template <int NR, int WR, int NRT, int KSTEPS, typename TW, typename TX>
__device__ __forceinline__ void mma_tiles(const TW* W, int ldw, int c0, const TX* X, int ldx,
                                          int wr, float (&acc)[NR][3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < KSTEPS; ++k8) {
    const TW* w = W + (k8 * 8 + q) * ldw + c0 + g;
    uint32_t ah[4], al[4];
    split_tf32(to_f32(w[0]), ah[0], al[0]);
    split_tf32(to_f32(w[8]), ah[1], al[1]);
    split_tf32(to_f32(w[4 * ldw]), ah[2], al[2]);
    split_tf32(to_f32(w[4 * ldw + 8]), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int rt = wr + j * WR;
      if (rt < NRT) {
        const TX* xb = X + (rt * 8 + g) * ldx + k8 * 8 + q;
        uint32_t bh[2], bl[2];
        split_tf32(to_f32(xb[0]), bh[0], bl[0]);
        split_tf32(to_f32(xb[4]), bh[1], bl[1]);
        mma_tf32(acc[j][0], al, bh);
        mma_tf32(acc[j][1], ah, bl);
        mma_tf32(acc[j][2], ah, bh);
      }
    }
  }
}

template <int NR>
__device__ __forceinline__ void zero(float (&acc)[NR][3][4]) {
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int t = 0; t < 3; ++t) acc[j][t][0] = acc[j][t][1] = acc[j][t][2] = acc[j][t][3] = 0.f;
}

// element h of fragment acc[j]: the small terms first, then hi(w) hi(x)
__device__ __forceinline__ float combine(const float (&acc)[3][4], int h) {
  return (acc[0][h] + acc[1][h]) + acc[2][h];
}

template <typename T, int BN, int BT>
__global__ void __launch_bounds__(kFThreads, BN >= 64 && BT >= 32 ? 1 : 2)
    slr_fused_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int AST = kStep + 16 / (int)sizeof(T);    // row stride of the x stage
  constexpr int KS = BN < kStep ? BN : kStep;          // column-axis rows per stage
  constexpr int BSUB = BN / KS;                        // stages per live tile
  constexpr int YPS = BN + 4;
  constexpr int NRT = BT / 8;                          // row tiles of 8
  // warps of x @ P: 4 column tiles (of a pass) x 2 row-tile classes
  constexpr int kPass = pass_cols(BT), WC1 = kPass / 16;
  constexpr int WR1 = 8 / WC1, NR1 = (NRT + WR1 - 1) / WR1;
  // warps of the column work: NCT column tiles x WR2 row-tile classes
  constexpr int NCT = w_cols(BN) / 16;
  constexpr int WR2 = 8 / NCT, NR2 = (NRT + WR2 - 1) / WR2;
  constexpr int LDW1 = ldw1(BT), LDW2 = ldw2(BN);

  const FusedSmem L = fused_smem<T>(BT, BN, a.r, yp_tiles(a.nseg, a.loops, a.ypn),
                                    a.loops * (a.maxb + 1));
  float* tp = reinterpret_cast<float*>(smem + L.tp);
  float* tf = reinterpret_cast<float*>(smem + L.tf);
  float* yp = reinterpret_cast<float*>(smem + L.yp);
  T* ring = reinterpret_cast<T*>(smem + L.ring);
  int* rowidx = reinterpret_cast<int*>(smem + L.rowidx);
  constexpr int kSlot = BT * AST + kStep * ldw_max(BN, BT);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.nseg, G = kCluster / S;
  const int crank = static_cast<int>(cluster.block_rank());
  const int g = crank / S, s = crank % S;
  const int cc = blockIdx.x / kCluster;
  const int tid = threadIdx.x, warp = tid / 32;
  const int lane = tid & 31, lg = lane >> 2, lq = lane & 3;
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);

  // ---- the block's rows (rowidx: row of x and y, or -1) and table row ----
  int64_t tab = a.tab0;
  bool outside = false;
  int n_real;
  if (a.ids == nullptr) {
    const int row0 = blockIdx.y * BT;
    n_real = min(BT, a.t_dim - row0);
    if (tid < BT) rowidx[tid] = tid < n_real ? row0 + tid : -1;
  } else {
    // key blockIdx.z: a pool row, or n_pool: the slots whose row is outside
    // the pool. The block's rows are row tile blockIdx.y of the rows of the
    // slots with that key, in slot order.
    const int n_pool = a.n_tab / a.layers;
    const int key = blockIdx.z;
    outside = key == n_pool;
    tab = (int64_t)key * a.layers + a.layer;
    auto picks = [&](int id) { return outside ? (id < 0 || id >= n_pool) : id == key; };
    int nsel = 0;
    for (int b = 0; b < a.b_dim; ++b) nsel += picks(a.ids[b]);
    const int row0 = blockIdx.y * BT;
    n_real = min(BT, nsel * a.t_dim - row0);
    if (tid < BT) {
      int idx = -1;
      if (tid < n_real) {
        const int q = (row0 + tid) / a.t_dim, t = (row0 + tid) % a.t_dim;
        for (int b = 0, seen = 0; b < a.b_dim; ++b) {
          if (!picks(a.ids[b])) continue;
          if (seen++ == q) {
            idx = b * a.t_dim + t;
            break;
          }
        }
      }
      rowidx[tid] = idx;
    }
  }
  if (n_real <= 0) return;   // one key and row tile per cluster: all its blocks leave
  __syncthreads();

  if (outside) {   // NaN rows, no table read (every block of the cluster is here)
    if (s == 0) {
      for (int it = 0; it < a.loops; ++it) {
        const int j = (cc * a.loops + it) * G + g;
        if (j >= a.jb) continue;
        for (int e = tid; e < BT * BN; e += kFThreads) {
          const int i = e / BN, col = j * BN + e % BN;
          if (rowidx[i] >= 0 && col < a.m_dim)
            y[(int64_t)rowidx[i] * a.m_dim + col] = from_f32<T>(__int_as_float(0x7fc00000));
        }
      }
    }
    return;
  }

  const T* p = static_cast<const T*>(a.p) + tab * a.k_dim * a.r;
  const T* vt = static_cast<const T*>(a.vt) + tab * a.r * a.m_dim;
  const T* vals = static_cast<const T*>(a.vals) + tab * a.jb * a.maxb * BN * BN;
  auto col_of = [&](int it) { return (cc * a.loops + it) * G + g; };
  // the live-tile counts and rows of the block's column blocks, read once:
  // the stage issues below never wait on a table read
  int* colcnt = reinterpret_cast<int*>(smem + L.cols);
  int* colrows = colcnt + a.loops;
  {
    const int* counts = a.counts + tab * a.jb;
    const int* rows = a.rows + tab * a.jb * a.maxb;
    for (int e = tid; e < a.loops; e += kFThreads) {
      const int j = col_of(e);
      colcnt[e] = j < a.jb ? max(0, min(counts[j], a.maxb)) : 0;
    }
    for (int e = tid; e < a.loops * a.maxb; e += kFThreads) {
      const int j = col_of(e / a.maxb);
      colrows[e] = j < a.jb ? rows[(int64_t)j * a.maxb + e % a.maxb] : 0;
    }
  }

  // ---- the block's stream of stages: np passes of x @ P over its split of K
  // (n1 stages each), then per column group `it` the stages [lo, hi) of
  // segment s of column block j(it): its rank stages (t @ Vt), then its live
  // tiles' stages. One cp.async ring runs through all of them, so the column
  // work's tiles load while x @ P computes.
  const int k_lo = min(a.k_dim, crank * a.kseg), k_hi = min(a.k_dim, k_lo + a.kseg);
  const int n1 = (k_hi - k_lo + kStep - 1) / kStep;
  const int np = (L.rp - 4 + kPass - 1) / kPass;
  const int nr = (a.r + KS - 1) / KS;   // rank stages of every column block
  const int n_segs = np + a.loops;
  auto seg_stages = [&](int seg, int& lo) {
    lo = 0;
    if (seg < np) return n1;
    if (col_of(seg - np) >= a.jb) return 0;
    const int n = nr + colcnt[seg - np] * BSUB;
    lo = n * s / S;
    return n * (s + 1) / S - lo;
  };
  auto issue = [&](int seg, int st, int slot) {
    T* as = ring + slot * kSlot;
    T* ws = as + BT * AST;
    if (seg < np) {
      const int k0 = k_lo + st * kStep, c0 = seg * kPass;
      stage_rows<T, BT>(as, AST, x, rowidx, a.k_dim, k0, kStep, k_hi - k0);
      stage_tile<T>(ws, LDW1, p + (int64_t)k0 * a.r + c0, a.r, kStep, kPass, k_hi - k0,
                    a.r - c0, p);
      return;
    }
    const int j = col_of(seg - np), col0 = j * BN;
    if (st < nr) {
      stage_tile<T>(ws, LDW2, vt + (int64_t)st * KS * a.m_dim + col0, a.m_dim, KS, w_cols(BN),
                    a.r - st * KS, min(BN, a.m_dim - col0), vt);
    } else {
      const int tile = (st - nr) / BSUB, u = (st - nr) % BSUB;
      const int64_t slot_j = (int64_t)j * a.maxb + tile;
      stage_tile<T>(ws, LDW2, vals + (slot_j * BN + u * KS) * BN, BN, KS, w_cols(BN), KS, BN,
                    vals);
      stage_rows<T, BT>(as, AST, x, rowidx, a.k_dim,
                        colrows[(seg - np) * a.maxb + tile] * BN + u * KS, KS, KS);
    }
  };
  __syncthreads();   // the column tables are in
  // issue cursor: segment, stage within it, its first stage and its count
  int i_seg = 0, i_idx = 0, i_lo = 0, i_n = seg_stages(0, i_lo);
  auto issue_next = [&](int slot) {
    while (i_seg < n_segs && i_idx >= i_n) {
      ++i_seg;
      i_idx = 0;
      if (i_seg < n_segs) i_n = seg_stages(i_seg, i_lo);
    }
    if (i_seg < n_segs) issue(i_seg, i_lo + i_idx++, slot);
    cp_async_commit();
  };

  // warp roles: x @ P column tile wc1 (of the pass) and row tiles wr1 + WR1 j;
  // column work column tile wc2 and row tiles wr2 + WR2 j
  const int wc1 = warp % WC1, wr1 = warp / WC1;
  const int wc2 = warp % NCT, wr2 = warp / NCT;
  float acc1[NR1][3][4], acc2[NR2][3][4];
  zero(acc1);
  zero(acc2);

#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) issue_next(i);
  int c_slot = 0, i_slot = kStages - 1;
  for (int seg = 0; seg < n_segs; ++seg) {
    int lo;
    const int n = seg_stages(seg, lo);
    for (int idx = 0; idx < n; ++idx) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // stage idx landed; the slot issued next was consumed
      issue_next(i_slot);
      i_slot = (i_slot + 1) % kStages;
      const T* as = ring + c_slot * kSlot;
      const T* ws = as + BT * AST;
      c_slot = (c_slot + 1) % kStages;
      if (seg < np)
        mma_tiles<NR1, WR1, NRT, kStep / 8>(ws, LDW1, wc1 * 16, as, AST, wr1, acc1);
      else if (lo + idx < nr)
        mma_tiles<NR2, WR2, NRT, KS / 8>(ws, LDW2, wc2 * 16, tf + (lo + idx) * KS, L.rp, wr2,
                                         acc2);
      else
        mma_tiles<NR2, WR2, NRT, KS / 8>(ws, LDW2, wc2 * 16, as, AST, wr2, acc2);
    }

    if (seg < np) {
      // end of a pass: this block's partial t for the pass's columns
#pragma unroll
      for (int j = 0; j < NR1; ++j) {
        const int row = (wr1 + WR1 * j) * 8 + 2 * lq, col = seg * kPass + wc1 * 16 + lg;
        if (row < BT) {
          if (col < L.rp - 4) {
            tp[row * L.rp + col] = combine(acc1[j], 0);
            tp[(row + 1) * L.rp + col] = combine(acc1[j], 1);
          }
          if (col + 8 < L.rp - 4) {
            tp[row * L.rp + col + 8] = combine(acc1[j], 2);
            tp[(row + 1) * L.rp + col + 8] = combine(acc1[j], 3);
          }
        }
      }
      zero(acc1);
      if (seg == np - 1) {
        // t = tp_0 + tp_1 + ... + tp_{C-1}, summed in rank order from every
        // block's shared memory into this block's tf
        cluster.sync();
        const float4* src[kCluster];
#pragma unroll
        for (int c = 0; c < kCluster; ++c)
          src[c] = reinterpret_cast<const float4*>(cluster.map_shared_rank(tp, c));
        for (int e = tid; e < BT * L.rp / 4; e += kFThreads) {
          float4 v = src[0][e];
#pragma unroll
          for (int c = 1; c < kCluster; ++c) {
            const float4 w = src[c][e];
            v.x += w.x;
            v.y += w.y;
            v.z += w.z;
            v.w += w.w;
          }
          reinterpret_cast<float4*>(tf)[e] = v;
        }
        __syncthreads();
      }
      continue;
    }

    // end of a column group: segment s of column block j is in acc2; with
    // S == 1 it is y, else it waits in yp for the cluster's sum, taken once
    // per batch of ypn column groups
    const int it = seg - np;
    const int col0 = col_of(it) * BN;
    const int slot_t = ((it / max(a.ypn, 1)) & 1) * a.ypn + it % max(a.ypn, 1);
    if (S > 1 || col_of(it) < a.jb) {
#pragma unroll
      for (int jj = 0; jj < NR2; ++jj) {
        const int row = (wr2 + WR2 * jj) * 8 + 2 * lq;
        if (row >= BT) continue;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int rr = row + (h & 1), col = wc2 * 16 + lg + (h >> 1) * 8;
          if (col >= BN) continue;
          if (S > 1) {
            yp[(slot_t * BT + rr) * YPS + col] = combine(acc2[jj], h);
          } else {
            const int gi = rowidx[rr];
            if (gi >= 0 && col0 + col < a.m_dim)
              y[(int64_t)gi * a.m_dim + col0 + col] = from_f32<T>(combine(acc2[jj], h));
          }
        }
      }
    }
    zero(acc2);
    if (S > 1 && (it % a.ypn == a.ypn - 1 || it == a.loops - 1)) {
      // y = the S partial tiles of each column block of the batch summed in
      // segment order, block (g, s) taking slice s of every tile
      cluster.sync();
      const float* src[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q)
        src[q] = cluster.map_shared_rank(yp, g * S + (q < S ? q : 0));
      const int first = it - it % a.ypn;
      const int e_lo = s * BT * BN / S, n_e = (s + 1) * BT * BN / S - e_lo;
      for (int f = tid; f < (it - first + 1) * n_e; f += kFThreads) {
        const int ib = first + f / n_e, e = e_lo + f % n_e;
        const int i = e / BN, c = e % BN, col = col_of(ib) * BN + c;
        const int gi = rowidx[i];
        if (gi < 0 || col_of(ib) >= a.jb || col >= a.m_dim) continue;
        const int at = ((((ib / a.ypn) & 1) * a.ypn + ib % a.ypn) * BT + i) * YPS + c;
        float v = src[0][at];
#pragma unroll
        for (int q = 1; q < kCluster; ++q)
          if (q < S) v += src[q][at];
        y[(int64_t)gi * a.m_dim + col] = from_f32<T>(v);
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();   // no block leaves while a peer reads its tp or yp
}

// The launch of one instance: cfg gets the cluster grid, 256 threads and
// smem bytes; the instance's shared-memory limit is lifted on the current
// device (an attribute of each device's context, so set on every call).
template <typename T, int BN, int BT>
cudaError_t fused_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int smem) {
  const cudaError_t err = cudaFuncSetAttribute(slr_fused_kernel<T, BN, BT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kMaxSmem);
  if (err != cudaSuccess) return err;
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int BN, int BT>
cudaError_t launch_fused(const FusedArgs& a, int tiles, int keys, cudaStream_t stream) {
  const FusedSmem L = fused_smem<T>(BT, BN, a.r, yp_tiles(a.nseg, a.loops, a.ypn),
                                    a.loops * (a.maxb + 1));
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cudaError_t err = fused_config<T, BN, BT>(cfg, attr, L.total);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3((a.groups + a.loops - 1) / a.loops * kCluster, tiles, keys);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, slr_fused_kernel<T, BN, BT>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Clusters of the instance that the card holds at once with smem bytes per
// block (cudaOccupancyMaxActiveClusters).
template <typename T, int BN, int BT>
cudaError_t resident_fused(int smem, int* out) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  const cudaError_t err = fused_config<T, BN, BT>(cfg, attr, smem);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(kCluster);
  return cudaOccupancyMaxActiveClusters(out, slr_fused_kernel<T, BN, BT>, &cfg);
}

// Launch (out == null) or query the resident clusters of one instance.
template <typename T, int BN>
cudaError_t dispatch_fused_bt(int bt, const FusedArgs& a, int tiles, int keys, int smem,
                              int* out, cudaStream_t stream) {
  switch (bt) {
    case 8:
      return out ? resident_fused<T, BN, 8>(smem, out)
                 : launch_fused<T, BN, 8>(a, tiles, keys, stream);
    case 32:
      return out ? resident_fused<T, BN, 32>(smem, out)
                 : launch_fused<T, BN, 32>(a, tiles, keys, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_fused_bs(int bs, int bt, const FusedArgs& a, int tiles, int keys,
                              int smem, int* out, cudaStream_t stream) {
  switch (bs) {
    case 8: return dispatch_fused_bt<T, 8>(bt, a, tiles, keys, smem, out, stream);
    case 16: return dispatch_fused_bt<T, 16>(bt, a, tiles, keys, smem, out, stream);
    case 32: return dispatch_fused_bt<T, 32>(bt, a, tiles, keys, smem, out, stream);
    case 64: return dispatch_fused_bt<T, 64>(bt, a, tiles, keys, smem, out, stream);
    case 128: return dispatch_fused_bt<T, 128>(bt, a, tiles, keys, smem, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Checks the plan and launches: rows = T (stacked) or B * T (per slot, the
// most one pool row can gather); keys = 1, or the pool rows + 1.
cudaError_t dispatch_fused(int dtype, int bs, int bt, FusedArgs a, cudaStream_t stream) {
  if (a.t_dim < 1 || a.b_dim < 1 || a.k_dim < 1 || a.r < 1 || a.maxb < 1 || a.nseg < 1 ||
      kCluster % a.nseg || a.kseg < 16 || a.kseg % 16 ||
      (int64_t)a.kseg * kCluster < a.k_dim || a.loops < 1 || (a.nseg > 1 && a.ypn < 1) ||
      bs < 1 || a.jb != (a.m_dim + bs - 1) / bs)
    return cudaErrorInvalidValue;
  const int g = kCluster / a.nseg;
  a.groups = (a.jb + g - 1) / g;
  const int64_t rows = a.ids ? (int64_t)a.b_dim * a.t_dim : a.t_dim;
  const int64_t tiles = (rows + bt - 1) / bt;
  const int keys = a.ids ? a.n_tab / a.layers + 1 : 1;
  if (tiles > 65535 || keys > 65535) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return dispatch_fused_bs<float>(bs, bt, a, (int)tiles, keys, 0, nullptr, stream);
  if (dtype == kBF16)
    return dispatch_fused_bs<__nv_bfloat16>(bs, bt, a, (int)tiles, keys, 0, nullptr, stream);
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

// Stacked: table row ``layer`` of p (L, K, r), vt (L, r, M), counts (L, JB),
// rows (L, JB, MAXB), vals (L, JB, MAXB, bs, bs) for x (T, K), y (T, M);
// bt, nseg, kseg, loops and ypn are the launch plan
// (kernels/slr_matmul.py::fused_plan). Returns the launch's error.
extern "C" int slr_matmul_stacked_launch(const void* x, const void* p, const void* vt,
                                         const int* counts, const int* rows, const void* vals,
                                         void* y, int t_dim, int k_dim, int m_dim, int r,
                                         int layer, int n_tab, int jb, int maxb, int bs, int bt,
                                         int nseg, int kseg, int loops, int ypn, int dtype,
                                         void* stream) {
  if (layer < 0 || layer >= n_tab) return cudaErrorInvalidValue;
  FusedArgs f{};
  f.x = x, f.p = p, f.vt = vt, f.counts = counts, f.rows = rows, f.vals = vals, f.y = y;
  f.b_dim = 1, f.t_dim = t_dim, f.k_dim = k_dim, f.m_dim = m_dim, f.r = r;
  f.layers = 1, f.tab0 = layer, f.n_tab = n_tab, f.jb = jb, f.maxb = maxb;
  f.nseg = nseg, f.kseg = kseg, f.loops = loops, f.ypn = ypn;
  return dispatch_fused(dtype, bs, bt, f, static_cast<cudaStream_t>(stream));
}

// Per slot: slot b of x (B, T, K) runs table row ids[b] * layers + layer of
// p (N, K, r), vt (N, r, M) and, when counts is not null, of the block-CSC
// stack counts (N, JB), rows (N, JB, MAXB), vals (N, JB, MAXB, bs, bs);
// y (B, T, M); ids is read on the device. counts == null runs the low-rank
// body (bt <= 32 rows per slot; bs and the plan ignored).
extern "C" int slr_matmul_multi_launch(const void* x, const void* p, const void* vt,
                                       const int* counts, const int* rows, const void* vals,
                                       const int* ids, void* y, int b_dim, int t_dim, int k_dim,
                                       int m_dim, int r, int layers, int layer, int n_tab,
                                       int jb, int maxb, int bs, int bt, int nseg, int kseg,
                                       int loops, int ypn, int dtype, void* stream) {
  if (ids == nullptr || n_tab < 1 || layers < 1 || layer < 0 || layer >= layers ||
      n_tab % layers)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (counts == nullptr) {
    const LowRankArgs l{x, p, vt, ids, y, b_dim, t_dim, k_dim, m_dim, r, bt, layers, layer,
                        n_tab};
    if (dtype == kF32) return launch_lowrank<float, float>(l, s);
    if (dtype == kBF16) return launch_lowrank<__nv_bfloat16, __nv_bfloat16>(l, s);
    return cudaErrorInvalidValue;
  }
  FusedArgs f{};
  f.x = x, f.p = p, f.vt = vt, f.counts = counts, f.rows = rows, f.vals = vals, f.ids = ids;
  f.y = y;
  f.b_dim = b_dim, f.t_dim = t_dim, f.k_dim = k_dim, f.m_dim = m_dim, f.r = r;
  f.layers = layers, f.layer = layer, f.n_tab = n_tab, f.jb = jb, f.maxb = maxb;
  f.nseg = nseg, f.kseg = kseg, f.loops = loops, f.ypn = ypn;
  return dispatch_fused(dtype, bs, bt, f, s);
}

// The clusters of the fused body's instance (dtype, bs, bt) that the card
// holds at once with smem bytes of dynamic shared memory per block.
extern "C" int slr_fused_resident(int dtype, int bs, int bt, int smem, int* out) {
  const FusedArgs a{};
  if (smem < 0 || smem > kMaxSmem || out == nullptr) return cudaErrorInvalidValue;
  if (dtype == kF32) return dispatch_fused_bs<float>(bs, bt, a, 0, 0, smem, out, nullptr);
  if (dtype == kBF16)
    return dispatch_fused_bs<__nv_bfloat16>(bs, bt, a, 0, 0, smem, out, nullptr);
  return cudaErrorInvalidValue;
}

// y = x @ p @ vt with x (T, K), p (K, r), vt (r, M), y (T, M); x and y of
// dtype, the factors of wdtype (equal, or bf16 activations over f32 tables).
extern "C" int lowrank_matmul_launch(const void* x, const void* p, const void* vt, void* y,
                                     int t_dim, int k_dim, int m_dim, int r, int bt,
                                     int dtype, int wdtype, void* stream) {
  const LowRankArgs a{x, p, vt, nullptr, y, 1, t_dim, k_dim, m_dim, r, bt, 1, 0, 1};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && wdtype == kF32) return launch_lowrank<float, float>(a, s);
  if (dtype == kBF16 && wdtype == kBF16)
    return launch_lowrank<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (dtype == kBF16 && wdtype == kF32) return launch_lowrank<__nv_bfloat16, float>(a, s);
  return cudaErrorInvalidValue;
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
