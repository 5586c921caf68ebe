// Fused SLR matmul for Hopper (sm_90a):  y = x @ P[l] @ Vt[l] + x @ S[l]
//
// Replaces three TPU kernels of repro/kernels/slr_matmul.py:
// slr_matmul_stacked_pallas and slr_matmul_multi_pallas (the stacked and
// per-slot entries, both the fused body slr_fused_kernel below) and
// slr_matmul_pallas (the unstacked entry). The per-slot entry's empty-S
// corner is the low-rank kernel's per-slot form (lowrank_matmul.cu).
// S[l] is row l of a block-CSC stack (counts (N, JB), rows (N, JB,
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
// x and y have one type (TX) and the tables another (TW): the stacked and
// per-slot entries take one dtype for both, the unstacked entry also bf16
// activations over f32 tables (a bf16 model deployed from
// an f32 SLR state, as the hybrid's shared block is), each read into f32.
//
// The unstacked entry (slr_matmul_launch; one (K, M) weight, the shared
// attention block of the hybrid family) at decode width is bound by the
// bytes of its tables, read once: at Zamba2's gate site (K = 2560, M =
// 10240, r = 640, a full S at bs = 128, f32 tables) 138 MB, 41 us at 3.35
// TB/s, of which the live tiles are 105 MB and do not depend on x @ P. Two
// kernels on the stream, the second a programmatic dependent of the first:
//   A. unstacked_xp_kernel: t = x @ P (T, rp) in f32, clusters of 8 blocks
//      splitting K (16 columns of P per block, eight 16-byte loads in flight
//      per thread) and summing the splits in rank order on chip; it
//      triggers its dependent at once;
//   B. unstacked_stream_kernel: one block per (column part, segment, row
//      tile), a 128-wide column block cut into two 64-wide parts, the
//      segments of a part one cluster, eight blocks per column block; each
//      block streams its live tiles first (no dependence on A), then waits
//      for A (griddepcontrol.wait) and streams its Vt rows against t; a
//      4-deep ring of 16-byte cp.async copies keeps three 16 KB stages of
//      f32 tiles in flight per block while f32 FMAs run on the fourth; the
//      segments' partial tiles are summed in segment order through
//      distributed shared memory and y is written once.
// No output scratch in device memory: only t (T x rp floats). The split of
// a column block comes from bs alone (kernels/slr_matmul.py::unstacked_plan:
// measured on the card, eight blocks per column block beat the other counts
// at every Zamba2 site), never from x or T; every sum runs in a fixed order,
// so a call is deterministic, bit for bit from run to run. BT is 1 row for
// T = 1, 8 rows for T <= 8 (decode) and 32 otherwise; products are f32 FMAs
// on the CUDA cores (at T <= 8 a 4-byte table value feeds 16 flops, a fifth
// of the f32 rate at the HBM rate). Measured, the streaming kernel is bound
// by its cp.async load path (removing its FMAs left its time unchanged), at
// 60-70% of the HBM rate.
#include <stdint.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace salaad {
namespace {

namespace cg = cooperative_groups;

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

// ---- the unstacked entry: x @ P, then the column blocks streamed ----------

constexpr int kUStages = 4;     // cp.async ring depth of the streaming kernel
constexpr int kXPCluster = 8;   // blocks per cluster of the x @ P kernel = splits of K
constexpr int kXPRows = 8;      // rows of x per block of the x @ P kernel (1 at T = 1)
constexpr int kXPCols = 16;     // columns of P per block of the x @ P kernel

// rows of a thread's accumulators in a streaming block of bt rows of x
__host__ __device__ constexpr int rows_per_thread(int bt) { return bt < 8 ? bt : 8; }

// programmatic dependent launch: the x @ P kernel lets the streaming kernel
// start at once; the streaming kernel waits for it only before it reads t
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// four consecutive values as f32: one 16-byte load of f32, one 8-byte of bf16
__device__ __forceinline__ void load4(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x, w[1] = a.y, w[2] = b.x, w[3] = b.y;
}

struct UnstackedArgs {
  const void* x;       // (T, K)
  const void* p;       // (K, r)
  const void* vt;      // (r, M)
  const int* counts;   // (JB,)
  const int* rows;     // (JB, MAXB)
  const void* vals;    // (JB, MAXB, bs, bs)
  float* t;            // (T, rp) f32: x @ P, columns r .. rp - 1 zero
  void* y;             // (T, M)
  int t_dim, k_dim, m_dim, r, rp, jb, maxb;
  int nseg, kseg;      // the launch plan (kernels/slr_matmul.py::unstacked_plan)
  int pvec;            // P's rows take 16-byte (f32) or 8-byte (bf16) loads
};

// Byte offsets of the streaming kernel's dynamic shared memory: the ring of
// kUStages stages (a (KS, BN) table tile, then a (BT, KS) operand tile of x
// or t, up to f32) or, after the last stage, the k-group partials (kFThreads
// x rows_per_thread(BT) x 4 f32); tp (BT, BN) f32, the block's partial tile
// that the cluster sums; rowidx (BT,) int; the column block's live-tile rows
// (MAXB,) int. kernels/slr_matmul.py::unstacked_smem_bytes mirrors the total.
struct UnstackedSmem {
  int slot, tp, rowidx, cols, total;
};

// reduction rows per stage of a streaming block over cs column parts of a
// column block of bn columns: a whole column block takes kStep rows, a part
// of one 2 kStep (a stage of 16 KB of f32 either way at bs = 128)
__host__ __device__ constexpr int stream_rows(int bn, int cs) {
  return bn < cs * kStep ? bn : cs * kStep;
}

__host__ __device__ inline UnstackedSmem unstacked_smem(int bt, int bn, int cs, int wsize,
                                                        int maxb) {
  UnstackedSmem s;
  const int ks = stream_rows(bn, cs), bnb = bn / cs;
  s.slot = ks * bnb * wsize + bt * ks * 4;
  const int ring = kUStages * s.slot, red = 16 * kFThreads * rows_per_thread(bt);
  s.tp = ring > red ? ring : red;
  s.rowidx = s.tp + 4 * bt * bnb;
  s.cols = s.rowidx + 4 * bt;
  s.total = s.cols + 4 * maxb;
  return s;
}

// A. t[row, c] = x[row, :] @ P[:, c] in f32. One block per (split of K = its
// cluster rank, chunk of kXPCols columns, group of R rows): the block's x
// rows sit transposed in shared memory, its threads stream P's rows (thread
// (quad, kl): columns c0 + 4 quad .. + 3 of rows k_lo + kl + kLanes i, one
// vector load per row, eight rows in flight) into register partials, summed
// over the warp's rows by shuffles, over the 8 warps in order, then over
// the cluster's kXPCluster splits in rank order through distributed shared
// memory. It triggers its dependents first.
template <typename TX, typename TW, int R>
__global__ void __launch_bounds__(kFThreads)
unstacked_xp_kernel(const UnstackedArgs a) {
  griddep_launch_dependents();
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);          // (kseg, R)
  float* wp = xs + a.kseg * R;                          // (8 warps, R, kXPCols)
  float* part = wp + 8 * R * kXPCols;                   // (R, kXPCols)
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = static_cast<int>(cluster.block_rank());
  const TX* x = static_cast<const TX*>(a.x);
  const TW* p = static_cast<const TW*>(a.p);
  const int c0 = blockIdx.y * kXPCols;
  const int row0 = blockIdx.z * R;
  const int n_rows = min(R, a.t_dim - row0);
  const int k_lo = min(a.k_dim, crank * a.kseg), k_hi = min(a.k_dim, k_lo + a.kseg);
  const int nk = k_hi - k_lo;
  constexpr int kQuads = kXPCols / 4, kLanes = kFThreads / kQuads;   // per row, rows per pass
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int quad = tid % kQuads, kl = tid / kQuads;

  for (int e = tid; e < nk * R; e += kFThreads) {
    const int i = e / nk, kk = e % nk;
    xs[kk * R + i] = i < n_rows ? to_f32(x[(int64_t)(row0 + i) * a.k_dim + k_lo + kk]) : 0.f;
  }
  __syncthreads();

  float acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int col = c0 + 4 * quad;
  const bool vec = a.pvec && col + 4 <= a.r;
#pragma unroll 8
  for (int k = k_lo + kl; k < k_hi; k += kLanes) {
    const TW* src = p + (int64_t)k * a.r + col;
    float w[4];
    if (vec) {
      load4(src, w);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = col + c < a.r ? to_f32(src[c]) : 0.f;
    }
    float xv[R];
    if constexpr (R == 8) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + (k - k_lo) * R);
      const float4 xb = *reinterpret_cast<const float4*>(xs + (k - k_lo) * R + 4);
      xv[0] = xa.x, xv[1] = xa.y, xv[2] = xa.z, xv[3] = xa.w;
      xv[4] = xb.x, xv[5] = xb.y, xv[6] = xb.z, xv[7] = xb.w;
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) xv[i] = xs[(k - k_lo) * R + i];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv[i], w[c], acc[i][c]);
  }
  // the warp's rows of K (lanes kQuads apart), then the 8 warps in order
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[i][c];
#pragma unroll
      for (int off = kQuads; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[i][c] = v;
    }
  if (lane < kQuads) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) wp[(warp * R + i) * kXPCols + 4 * lane + c] = acc[i][c];
  }
  __syncthreads();
  if (tid < R * kXPCols) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) v += wp[w * R * kXPCols + tid];
    part[tid] = v;
  }
  // rank c sums slice c of the chunk over the cluster's splits, in rank order
  cluster.sync();
  constexpr int kPer = R * kXPCols / kXPCluster;
  if (tid < kPer) {
    const int e = crank * kPer + tid;
    const int i = e / kXPCols, c = e % kXPCols;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kXPCluster; ++q) v += cluster.map_shared_rank(part, q)[e];
    if (i < n_rows) a.t[(int64_t)(row0 + i) * a.rp + c0 + c] = v;
  }
  cluster.sync();   // no block leaves while a peer reads its part
}

// acc (RT rows x 4 columns of the thread) += os[rows, k] * ws[k, columns]
// over the stage's rows k = kg, kg + KG, ... in order (f32 products)
template <int BN, int KS, int KG, int RT, typename TO, typename TW>
__device__ __forceinline__ void stream_stage(const TW* ws, const TO* os, int cq, int rg, int kg,
                                             float (&acc)[RT][4]) {
#pragma unroll
  for (int kk = 0; kk < (KS + KG - 1) / KG; ++kk) {
    const int k = kg + kk * KG;
    if (KS % KG == 0 || k < KS) {
      float w[4];
      load4(ws + k * BN + 4 * cq, w);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float xv = to_f32(os[(rg * RT + i) * KS + k]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xv, w[c], acc[i][c]);
      }
    }
  }
}

// B. One block per (column part of BNB = BN / CS columns of column block j,
// segment s, row tile); the nseg segments of a part form one cluster. Column
// block j's reduction axis is its counts[j] live tiles (BSUB stages of KS
// rows each: the gathered columns of x against the tile's rows) followed by
// its ceil(r / KS) rank stages (t against Vt's rows); segment s takes the
// tile stages [n_t s / S, n_t (s+1) / S) and then the rank stages [n_r s /
// S, n_r (s+1) / S), so every block streams live tiles first and reads t
// last, after griddepcontrol.wait. The stages run through a kUStages-deep
// ring of 16-byte cp.async copies (three in flight while one computes, one
// barrier per stage); thread (cq, rg, kg) accumulates RT rows x 4 columns
// over every KG-th row of a stage in f32 FMAs (RT = 1 for a one-row call,
// else 8). Then the k groups are summed in order, and the cluster's S
// partial tiles in segment order: block s sums slice s of the tile and
// writes it, rounded once to x's dtype.
template <typename TX, typename TW, int BN, int BT, int CS>
__global__ void __launch_bounds__(kFThreads, 2)
unstacked_stream_kernel(const UnstackedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BNB = BN / CS;                  // the block's columns
  constexpr int KS = stream_rows(BN, CS);       // reduction rows per stage
  constexpr int BSUB = BN / KS;                 // stages per live tile
  constexpr int RT = rows_per_thread(BT);
  constexpr int CQ = BNB / 4, RG = BT / RT, KG = kFThreads / (CQ * RG);
  constexpr int W_BYTES = KS * BNB * (int)sizeof(TW);
  static_assert(KG >= 1 && KG * CQ * RG == kFThreads, "k groups");
  const UnstackedSmem L = unstacked_smem(BT, BN, CS, (int)sizeof(TW), a.maxb);
  float* tp = reinterpret_cast<float*>(smem + L.tp);
  int* rowidx = reinterpret_cast<int*>(smem + L.rowidx);
  int* colrows = reinterpret_cast<int*>(smem + L.cols);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = a.nseg;
  const int s = static_cast<int>(cluster.block_rank());
  const int unit = blockIdx.x / S, j = unit / CS;
  const int col0 = j * BN + (unit % CS) * BNB;
  const int row0 = blockIdx.y * BT, n_rows = min(BT, a.t_dim - row0);
  const int tid = threadIdx.x;
  const TX* x = static_cast<const TX*>(a.x);
  const TW* vt = static_cast<const TW*>(a.vt);
  const TW* vals = static_cast<const TW*>(a.vals);

  if (tid < BT) rowidx[tid] = tid < n_rows ? row0 + tid : -1;
  const int cnt = max(0, min(a.counts[j], a.maxb));
  for (int e = tid; e < cnt; e += kFThreads) colrows[e] = a.rows[(int64_t)j * a.maxb + e];
  const int n_t = cnt * BSUB, n_r = (a.r + KS - 1) / KS;
  const int t_lo = n_t * s / S, t_n = n_t * (s + 1) / S - t_lo;
  const int r_lo = n_r * s / S, r_n = n_r * (s + 1) / S - r_lo;
  const int n_st = t_n + r_n;
  __syncthreads();   // rowidx and the live-tile rows are in

  bool waited = false;
  auto issue = [&](int i) {
    if (i < n_st) {
      unsigned char* slot = smem + (i % kUStages) * L.slot;
      TW* ws = reinterpret_cast<TW*>(slot);
      if (i < t_n) {
        const int st = t_lo + i, tile = st / BSUB, u = st % BSUB;
        stage_tile<TW>(ws, BNB, vals + (((int64_t)j * a.maxb + tile) * BN + u * KS) * BN +
                                    (col0 - j * BN), BN, KS, BNB, KS, BNB, vals);
        stage_rows<TX, BT>(reinterpret_cast<TX*>(slot + W_BYTES), KS, x, rowidx, a.k_dim,
                           colrows[tile] * BN + u * KS, KS, KS);
      } else {
        const int st = r_lo + i - t_n;
        stage_tile<TW>(ws, BNB, vt + (int64_t)st * KS * a.m_dim + col0, a.m_dim, KS, BNB,
                       a.r - st * KS, min(BNB, a.m_dim - col0), vt);
        if (!waited) {   // t is the x @ P kernel's output
          griddep_wait();
          waited = true;
        }
        stage_rows<float, BT>(reinterpret_cast<float*>(slot + W_BYTES), KS, a.t, rowidx, a.rp,
                              st * KS, KS, KS);
      }
    }
    cp_async_commit();
  };

  const int cq = tid % CQ, rg = (tid / CQ) % RG, kg = tid / (CQ * RG);
  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 1
  for (int i = 0; i < kUStages - 1; ++i) issue(i);
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kUStages - 2>();
    __syncthreads();   // stage i landed; the slot issued next was consumed
    issue(i + kUStages - 1);
    const unsigned char* slot = smem + (i % kUStages) * L.slot;
    const TW* ws = reinterpret_cast<const TW*>(slot);
    if (i < t_n)
      stream_stage<BNB, KS, KG>(ws, reinterpret_cast<const TX*>(slot + W_BYTES), cq, rg, kg, acc);
    else
      stream_stage<BNB, KS, KG>(ws, reinterpret_cast<const float*>(slot + W_BYTES), cq, rg, kg,
                                acc);
  }
  if (!waited) griddep_wait();   // the call ends after the x @ P kernel, always
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the k-group partials

  TX* y = static_cast<TX*>(a.y);
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < RT; ++i)
    *reinterpret_cast<float4*>(red + (kg * BT + rg * RT + i) * BNB + 4 * cq) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int e = tid; e < BT * BNB; e += kFThreads) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < KG; ++g) v += red[g * BT * BNB + e];
    const int i = e / BNB, c = e % BNB;
    if (S > 1)
      tp[e] = v;
    else if (i < n_rows && col0 + c < a.m_dim)
      y[(int64_t)(row0 + i) * a.m_dim + col0 + c] = from_f32<TX>(v);
  }
  if (S > 1) {
    cluster.sync();
    const float* src[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) src[q] = cluster.map_shared_rank(tp, q < S ? q : 0);
    const int e_hi = (s + 1) * BT * BNB / S;
    for (int e = s * BT * BNB / S + tid; e < e_hi; e += kFThreads) {
      const int i = e / BNB, c = e % BNB;
      if (i >= n_rows || col0 + c >= a.m_dim) continue;
      float v = src[0][e];
#pragma unroll
      for (int q = 1; q < kCluster; ++q)
        if (q < S) v += src[q][e];
      y[(int64_t)(row0 + i) * a.m_dim + col0 + c] = from_f32<TX>(v);
    }
    cluster.sync();   // no block leaves while a peer reads its tp
  }
}

template <typename TX, typename TW, int BN, int BT, int CS>
cudaError_t launch_unstacked(const UnstackedArgs& a, cudaStream_t stream) {
  constexpr int R = BT == 1 ? 1 : kXPRows;
  auto xp_kernel = unstacked_xp_kernel<TX, TW, R>;
  auto stream_kernel = unstacked_stream_kernel<TX, TW, BN, BT, CS>;
  const int xp_smem = 4 * (a.kseg * R + 8 * R * kXPCols + R * kXPCols);
  const UnstackedSmem L = unstacked_smem(BT, BN, CS, (int)sizeof(TW), a.maxb);
  if (xp_smem > kMaxSmem || L.total > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(xp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, xp_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;

  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kXPCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kXPCluster, a.rp / kXPCols, (a.t_dim + R - 1) / R);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = xp_smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, xp_kernel, a);
  if (err != cudaSuccess) return err;

  attrs[0].val.clusterDim.x = a.nseg;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3(a.jb * CS * a.nseg, (a.t_dim + BT - 1) / BT);
  cfg.dynamicSmemBytes = L.total;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, stream_kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TX, typename TW, int BT>
cudaError_t dispatch_unstacked_bs(int bs, const UnstackedArgs& a, cudaStream_t stream) {
  switch (bs) {
    case 8: return launch_unstacked<TX, TW, 8, BT, 1>(a, stream);
    case 16: return launch_unstacked<TX, TW, 16, BT, 1>(a, stream);
    case 32: return launch_unstacked<TX, TW, 32, BT, 1>(a, stream);
    case 64: return launch_unstacked<TX, TW, 64, BT, 1>(a, stream);
    case 128: return launch_unstacked<TX, TW, 128, BT, 2>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TW>
cudaError_t dispatch_unstacked_bt(int bs, int bt, const UnstackedArgs& a,
                                  cudaStream_t stream) {
  if (bt == 1) return dispatch_unstacked_bs<TX, TW, 1>(bs, a, stream);
  if (bt == 8) return dispatch_unstacked_bs<TX, TW, 8>(bs, a, stream);
  if (bt == 32) return dispatch_unstacked_bs<TX, TW, 32>(bs, a, stream);
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
// p (N, K, r), vt (N, r, M) and the block-CSC stack counts (N, JB), rows
// (N, JB, MAXB), vals (N, JB, MAXB, bs, bs); y (B, T, M); ids is read on the
// device.
extern "C" int slr_matmul_multi_launch(const void* x, const void* p, const void* vt,
                                       const int* counts, const int* rows, const void* vals,
                                       const int* ids, void* y, int b_dim, int t_dim, int k_dim,
                                       int m_dim, int r, int layers, int layer, int n_tab,
                                       int jb, int maxb, int bs, int bt, int nseg, int kseg,
                                       int loops, int ypn, int dtype, void* stream) {
  if (ids == nullptr || counts == nullptr || n_tab < 1 || layers < 1 || layer < 0 ||
      layer >= layers || n_tab % layers)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
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

// One unstacked weight: y = x @ p @ vt + x @ S with x (T, K), p (K, r),
// vt (r, M), S block-CSC counts (JB,), rows (JB, MAXB), vals (JB, MAXB, bs,
// bs); t (T, rp) f32 scratch for x @ p with rp = r rounded up to 32; bt (8 or
// 32) rows per streaming block, nseg segments per column block, kseg rows of
// K per x @ P block (kernels/slr_matmul.py::unstacked_plan); x and y of
// dtype, the tables of wdtype. Two launches, the second a programmatic
// dependent of the first.
extern "C" int slr_matmul_launch(const void* x, const void* p, const void* vt,
                                 const int* counts, const int* rows, const void* vals,
                                 float* t, void* y, int t_dim, int k_dim, int m_dim, int r,
                                 int rp, int jb, int maxb, int bs, int bt, int nseg, int kseg,
                                 int dtype, int wdtype, void* stream) {
  if (t_dim < 1 || k_dim < 1 || r < 1 || jb < 1 || maxb < 1 || bs < 8 ||
      jb != (m_dim + bs - 1) / bs || rp != (r + 31) / 32 * 32 ||
      nseg < 1 || nseg > kCluster || kseg < 1 || (int64_t)kseg * kXPCluster < k_dim ||
      t_dim > 65535 * kXPRows || (t_dim + bt - 1) / bt > 65535)
    return cudaErrorInvalidValue;
  const int wsize = wdtype == kF32 ? 4 : 2;
  const int pvec = r % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * wsize) == 0;
  const UnstackedArgs a{x, p, vt, counts, rows, vals, t, y, t_dim, k_dim, m_dim, r, rp, jb,
                        maxb, nseg, kseg, pvec};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && wdtype == kF32) return dispatch_unstacked_bt<float, float>(bs, bt, a, s);
  if (dtype == kBF16 && wdtype == kBF16)
    return dispatch_unstacked_bt<__nv_bfloat16, __nv_bfloat16>(bs, bt, a, s);
  if (dtype == kBF16 && wdtype == kF32)
    return dispatch_unstacked_bt<__nv_bfloat16, float>(bs, bt, a, s);
  return cudaErrorInvalidValue;
}
