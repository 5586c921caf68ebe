// The stream kernel: y = X @ W over one column block's reduction axis, on the
// tensor cores, shared by the block-CSC kernel (bsr_matmul.cu) and the
// low-rank kernel (lowrank_matmul.cu).
//
// Column block j of y (bs columns; the low-rank products take bs = BNB) is
// cut into cs parts of BNB columns. Its reduction axis is a list of n stages
// of KS rows each:
//   - block-CSC S: the counts[j] live tiles in slot order, bs / KS stages per
//     tile; stage (tile, u) pairs rows u KS .. u KS + KS of vals[j, tile] with
//     the columns rows[j, tile] bs + u KS .. of x (gathered);
//   - a dense table W (K, M) (P for t = x @ P, Vt for y = t @ Vt): stage st
//     pairs rows st KS .. of W with the same columns of the operand.
// The stages are cut into nseg segments, segment s = stages [n s / nseg,
// n (s+1) / nseg). Every output element is one chain of tensor-core products
// per segment, k ascending, and the nseg partials summed in segment order:
// y = ((p_0 + p_1) + p_2) + ... The launch plan (kernels/stream.py) takes nseg,
// BNB and KS from the table's shape alone, never from T or B, so a row of y
// is bit for bit the same in a call of any T and B. Two cuts of the same sums:
//   - split: one block per (part, segment, row tile); the nseg blocks of a
//     part form a cluster, write their partial tiles to shared memory, and
//     block s sums slice s of the tile over the cluster's partials in segment
//     order through distributed shared memory and writes it (decode widths:
//     nseg times the blocks, a fraction of the stages each);
//   - walk: one block per (part, row tile) runs all n stages with two sets of
//     accumulators, the segment's chain and the running sum, folded at each
//     segment's end in the same order (prefill widths: no cluster, no
//     barrier across blocks).
// The wrapper picks the cut from the call's row tiles; the sums, and so the
// bits, are the same either way.
//
// A block holds 64 rows of x (8 at decode widths: xrows). The stages run
// through a kStages-deep ring of 16-byte cp.async copies (W tile and x tile
// together), one barrier per stage. Products are mma.sync m16n8k8 TF32 with
// the output columns on the m side and the rows of x on the n side (a decode
// tile is exactly 8 rows). An f32 operand is split v = hi + lo, both TF32,
// and a product takes hi hi + the cross terms of the split operands (3xTF32
// for f32 x f32, two products where one side is f32, f32 accuracy either
// way); a bf16 operand is exact in TF32, so bf16 x bf16 is one product:
// exact, f32 accumulation, as m16n8k16 bf16 would give. Ragged rows,
// reduction rows and columns are zero-filled in the stages and never
// written; misaligned rows are staged element by element.
#pragma once

#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace salaad {
namespace stream {

namespace cg = cooperative_groups;

constexpr int kStages = 4;         // cp.async ring depth
constexpr int kMaxRows = 64;       // rows of x per block above decode width
constexpr int kMaxSeg = 8;         // segments per column block = blocks per cluster
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use (227 KB)

struct Args {
  const void* x;       // operand (B * T, ldx): x, or t = x @ P
  const void* w;       // dense: (N, k_dim, m_dim) tables; block-CSC: vals (JB, MAXB, bs, bs)
  const int* counts;   // block-CSC (JB,), or null: a dense table
  const int* rows;     // block-CSC (JB, MAXB)
  const int* ids;      // (B,) slot -> table selector, or null: table row 0 for every row
  void* y;             // (B * T, ldy)
  int b_dim, t_dim;    // slots, rows per slot
  int k_dim, m_dim;    // reduction length (dense K or r; block-CSC n) and columns
  int ldx, ldy;        // row strides of the operand and of y
  int layers, layer, n_tab;   // slot b reads table row ids[b] * layers + layer of n_tab
  int bs, jb, maxb;    // column blocks of bs columns (dense: bs = BNB), JB, MAXB
  int cs;              // parts of BNB columns per column block: bs / BNB, at least 1
  int nseg;            // segments per column block (the plan's partition)
  int xrows;           // rows of x per block: 8 (decode widths) or 64
  int split;           // 1: a cluster of nseg blocks per part; 0: one block walks
  int dep;             // the operand is the previous kernel's output: wait for it
  int lead;            // let the next kernel start at once (it waits for this one)
};

// Byte offsets of the dynamic shared memory: kStages slots (a W tile of KS
// rows x (BNB + 8), then an x tile of xrows x (KS + 16 B)); the partial tile
// (xrows x (BNB + 4) f32, split with nseg > 1); the column block's live-tile
// rows (MAXB ints, block-CSC). kernels/stream.py::stream_smem_bytes mirrors it.
struct Smem {
  int w_bytes, slot, tp, cols, total;
};

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }

__host__ __device__ inline Smem smem_layout(int bnb, int ks, int xrows, int xsize, int wsize,
                                            bool reduce, int ncols) {
  Smem s;
  s.w_bytes = round16(ks * (bnb + 8) * wsize);
  s.slot = s.w_bytes + round16(xrows * (ks + 16 / xsize) * xsize);
  s.tp = kStages * s.slot;
  s.cols = s.tp + (reduce ? 4 * xrows * (bnb + 4) : 0);
  s.total = s.cols + 4 * ncols;
  return s;
}

// Threads of a block: at decode width (8 rows) one warp per 16-column tile;
// at 64 rows 8 warps over 64 columns, else 4 warps of 4 row tiles each,
// three blocks an SM (tools/stream_variants.py times 8 warps against them)
__host__ __device__ constexpr int block_threads(int bnb, int rows) {
  return rows == 8 ? 32 * (bnb / 16) : bnb == 64 ? 256 : 128;
}

// dst (nr, nc), row stride ldd, from src rows of stride lds, by NT threads:
// element (i, c) is read where i < vr and c < vc, zero elsewhere; nc is a
// multiple of 16 bytes of T. 16-byte cp.async where src's rows are 16-byte
// aligned, else element by element (a plain store, seen after the ring's
// barrier).
template <int NT, typename T>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* src, int64_t lds, int nr, int nc,
                                      int vr, int vc) {
  constexpr int V = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && (lds * (int64_t)sizeof(T)) % 16 == 0) {
    const int cpr = nc / V;
    for (int e = threadIdx.x; e < nr * cpr; e += NT) {
      const int i = e / cpr, c = (e % cpr) * V;
      const int n = i < vr ? min(max(vc - c, 0), V) : 0;
      cp_async16(dst + i * ldd + c, n ? src + i * lds + c : src, n * (int)sizeof(T));
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += NT) {
      const int i = e / nc, c = e % nc;
      dst[i * ldd + c] = (i < vr && c < vc) ? src[i * lds + c] : from_f32<T>(0.f);
    }
  }
}

// The TF32 parts of an operand: an f32 value is split (hi + lo), a bf16
// value is exact in TF32 (lo unused)
__device__ __forceinline__ void tf32_parts(float v, uint32_t& hi, uint32_t& lo) {
  split_tf32_fast(v, hi, lo);
}
__device__ __forceinline__ void tf32_parts(__nv_bfloat16 v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(v));
  lo = 0u;
}

// One stage of a warp's tiles: acc[i] (16 columns c0 .. c0 + 15 of W x the 8
// rows of row tile wr + i RW) += (X[rows, 0:KS] @ W[0:KS, cols])^T, k8 steps
// in order, per step the cross terms of the split operands, then hi hi. No
// branch: every row tile is staged (zero past the last row of x), so the
// compiler interleaves the tiles' loads and products.
template <int NR, int RW, int KS, int LDW, int LDX, typename TW, typename TX>
__device__ __forceinline__ void stage_mma(const TW* W, const TX* X, int c0, int wr,
                                          float (&acc)[NR][4]) {
  constexpr bool kSplitW = std::is_same<TW, float>::value;
  constexpr bool kSplitX = std::is_same<TX, float>::value;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < KS / 8; ++k8) {
    const TW* w = W + (k8 * 8 + q) * LDW + c0 + g;
    uint32_t ah[4], al[4];
    tf32_parts(w[0], ah[0], al[0]);
    tf32_parts(w[8], ah[1], al[1]);
    tf32_parts(w[4 * LDW], ah[2], al[2]);
    tf32_parts(w[4 * LDW + 8], ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const TX* xb = X + ((wr + i * RW) * 8 + g) * LDX + k8 * 8 + q;
      uint32_t bh[2], bl[2];
      tf32_parts(xb[0], bh[0], bl[0]);
      tf32_parts(xb[4], bh[1], bl[1]);
      if constexpr (kSplitW) mma_tf32(acc[i], al, bh);
      if constexpr (kSplitX) mma_tf32(acc[i], ah, bl);
      mma_tf32(acc[i], ah, bh);
    }
  }
}

template <int NR>
__device__ __forceinline__ void zero(float (&acc)[NR][4]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// programmatic dependent launch: the first kernel of a pair lets the second
// start at once; the second waits for the first before it reads its output
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Blocks an SM keeps (the kernels' __launch_bounds__): two at 64 rows and 64
// columns, three at 64 rows and fewer columns
__host__ __device__ constexpr int min_blocks(int bnb, int rows) {
  return rows == 8 ? 1 : bnb == 64 ? 2 : 3;
}

// The body of a kernel (bsr_matmul.cu and lowrank_matmul.cu name their own
// __global__ entries, so a profile tells them apart). TX: the operand's
// type, TW: the table's, TY: y's. BNB columns per block (16, 32 or 64), KS
// reduction rows per stage (8, 16 or 32), ROWS rows of x per block (8 or 64).
template <typename TX, typename TW, typename TY, int BNB, int KS, int ROWS>
__device__ __forceinline__ void stream_body(const Args& a) {
  constexpr int NT = block_threads(BNB, ROWS);
  constexpr int NCT = BNB / 16;            // column tiles of 16
  constexpr int RW = NT / 32 / NCT;        // row-tile classes: warps per column tile
  constexpr int NR = ROWS / 8 / RW;        // row tiles per warp
  constexpr int LDW = BNB + 8;             // row strides of the stages (conflict-free fragments)
  constexpr int LDX = KS + 16 / (int)sizeof(TX);
  constexpr int LDT = BNB + 4;
  if (a.lead) griddep_launch_dependents();
  extern __shared__ __align__(16) unsigned char smem[];
  const bool bsr = a.counts != nullptr;
  const bool reduce = a.split && a.nseg > 1;
  const Smem L = smem_layout(BNB, KS, a.xrows, sizeof(TX), sizeof(TW), reduce, bsr ? a.maxb : 0);
  float* tp = reinterpret_cast<float*>(smem + L.tp);
  int* colrows = reinterpret_cast<int*>(smem + L.cols);

  const int S = a.nseg;
  const int s = a.split ? (int)(blockIdx.x % S) : 0;   // the cluster rank under split
  const int unit = a.split ? blockIdx.x / S : blockIdx.x;
  const int j = unit / a.cs, part = unit % a.cs;
  const int col0 = j * a.bs + part * BNB;
  const int bw = min(min(BNB, a.bs - part * BNB), a.m_dim - col0);   // columns written
  const int tiles = (a.t_dim + a.xrows - 1) / a.xrows;
  const int slot = blockIdx.y / tiles;
  const int r0 = (blockIdx.y % tiles) * a.xrows;
  const int n_rows = min(a.xrows, a.t_dim - r0);
  const int64_t row0 = (int64_t)slot * a.t_dim + r0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const TX* x = static_cast<const TX*>(a.x) + row0 * a.ldx;
  TY* y = static_cast<TY*>(a.y) + row0 * a.ldy;

  // the table row (per slot: read on the device); a row outside the pool
  // writes NaN rows and reads no table (uniform over the cluster)
  int64_t tab = 0;
  if (a.ids != nullptr) {
    tab = (int64_t)a.ids[slot] * a.layers + a.layer;
    if (tab < 0 || tab >= a.n_tab) {
      if (s == 0) {
        for (int e = tid; e < n_rows * bw; e += NT)
          y[(int64_t)(e / bw) * a.ldy + col0 + e % bw] = from_f32<TY>(__int_as_float(0x7fc00000));
      }
      if (a.dep) griddep_wait();   // the call ends after the kernel it follows
      return;
    }
  }
  const TW* w = static_cast<const TW*>(a.w);
  const int bsub = a.bs / KS;                // stages per live tile
  int n;                                     // stages of column block j
  if (bsr) {
    const int live = max(0, min(a.counts[j], a.maxb));
    for (int e = tid; e < live; e += NT) colrows[e] = a.rows[(int64_t)j * a.maxb + e];
    n = live * bsub;
    w += (int64_t)j * a.maxb * a.bs * a.bs + part * BNB;
  } else {
    n = (a.k_dim + KS - 1) / KS;
    w += tab * a.k_dim * a.m_dim + col0;
  }
  const int first = a.split ? n * s / S : 0;
  const int cnt = a.split ? n * (s + 1) / S - first : n;   // the block's stages
  __syncthreads();   // the live-tile rows are in

  auto slot_of = [&](int i) { return smem + (i % kStages) * L.slot; };
  auto issue_w = [&](int i) {
    TW* ws = reinterpret_cast<TW*>(slot_of(i));
    const int st = first + i;
    if (bsr) {
      const int tile = st / bsub, u = st % bsub;
      stage<NT>(ws, LDW, w + ((int64_t)tile * a.bs + u * KS) * a.bs, a.bs, KS, BNB, KS, bw);
    } else {
      stage<NT>(ws, LDW, w + (int64_t)st * KS * a.m_dim, a.m_dim, KS, BNB, a.k_dim - st * KS,
                bw);
    }
  };
  auto issue_x = [&](int i) {
    TX* xs = reinterpret_cast<TX*>(slot_of(i) + L.w_bytes);
    const int st = first + i;
    const int k0 = bsr ? colrows[st / bsub] * a.bs + (st % bsub) * KS : st * KS;
    stage<NT>(xs, LDX, x + k0, a.ldx, ROWS, KS, n_rows, a.k_dim - k0);
  };

  // warp roles: column tile ct, row tiles wr + RW i
  const int ct = warp % NCT, wr = warp / NCT;
  float acc[NR][4], sum[NR][4];
  zero(acc);

  // the ring's first stages; under dep the W tiles load before the wait
  if (a.dep) {
#pragma unroll 1
    for (int i = 0; i < kStages - 1 && i < cnt; ++i) issue_w(i);
    griddep_wait();
  }
#pragma unroll 1
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < cnt) {
      if (!a.dep) issue_w(i);
      issue_x(i);
    }
    cp_async_commit();
  }

  // walk: fold the chain into the running sum at each segment's end (empty
  // segments included, as the cluster sums them)
  int sg = 0, seg_end = n / S;
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int h = 0; h < 4; ++h) sum[i][h] = sg == 0 ? acc[i][h] : sum[i][h] + acc[i][h];
    zero(acc);
    ++sg;
    seg_end = (int)((int64_t)n * (sg + 1) / S);
  };
  if (!a.split)
    while (sg < S && seg_end == 0) fold();

  for (int i = 0; i < cnt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage i landed; the slot issued next was consumed
    const int nx = i + kStages - 1;
    if (nx < cnt) {
      issue_w(nx);
      issue_x(nx);
    }
    cp_async_commit();
    const unsigned char* sl = slot_of(i);
    stage_mma<NR, RW, KS, LDW, LDX>(reinterpret_cast<const TW*>(sl),
                                    reinterpret_cast<const TX*>(sl + L.w_bytes), ct * 16, wr,
                                    acc);
    if (!a.split)
      while (sg < S && seg_end == i + 1) fold();
  }
  cp_async_wait<0>();

  // y from the fragments: element h of a tile is row 2q + (h & 1), column g +
  // 8 (h >> 1) of it
  const int g = lane >> 2, q = lane & 3;
  auto write = [&](const float (&v)[NR][4]) {
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int rt = wr + i * RW;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int rr = rt * 8 + 2 * q + (h & 1), c = ct * 16 + g + (h >> 1) * 8;
        if (rr < n_rows && c < bw) y[(int64_t)rr * a.ldy + col0 + c] = from_f32<TY>(v[i][h]);
      }
    }
  };
  if (!a.split) {
    write(sum);
    return;
  }
  if (S == 1) {
    write(acc);
    return;
  }
  // split: the S partial tiles summed in segment order, block s taking slice
  // s of the tile's elements
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int rt = wr + i * RW;
#pragma unroll
    for (int h = 0; h < 4; ++h)
      tp[(rt * 8 + 2 * q + (h & 1)) * LDT + ct * 16 + g + (h >> 1) * 8] = acc[i][h];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* src[kMaxSeg];
#pragma unroll
  for (int c = 0; c < kMaxSeg; ++c) src[c] = cluster.map_shared_rank(tp, c < S ? c : 0);
  const int n_e = n_rows * BNB;
  for (int e = n_e * s / S + tid; e < n_e * (s + 1) / S; e += NT) {
    const int rr = e / BNB, c = e % BNB;
    if (c >= bw) continue;
    float v = src[0][rr * LDT + c];
#pragma unroll
    for (int c2 = 1; c2 < kMaxSeg; ++c2)
      if (c2 < S) v += src[c2][rr * LDT + c];
    y[(int64_t)rr * a.ldy + col0 + c] = from_f32<TY>(v);
  }
  cluster.sync();   // no block leaves while a peer reads its partial tile
}

// Launch kernel, an instance over (TX, TW, BNB, KS, ROWS): a cluster of nseg
// blocks per part under split, the programmatic-serialization attribute
// under dep. The instance's shared-memory limit is lifted on the current
// device (an attribute of each device's context, so set on every call).
template <typename TX, typename TW, int BNB, int KS, int ROWS>
cudaError_t launch(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  if (a.t_dim < 1 || a.b_dim < 1 || a.k_dim < 1 || a.m_dim < 1 || a.nseg < 1 ||
      a.nseg > kMaxSeg || (a.xrows != 8 && a.xrows != kMaxRows) || a.cs < 1 || a.bs < 1 ||
      a.bs % KS || (a.counts != nullptr && a.bs > a.cs * BNB) || a.jb < 1 || a.xrows != ROWS)
    return cudaErrorInvalidValue;
  const bool reduce = a.split && a.nseg > 1;
  const Smem L = smem_layout(BNB, KS, a.xrows, sizeof(TX), sizeof(TW), reduce,
                             a.counts != nullptr ? a.maxb : 0);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const int64_t rows = (int64_t)a.b_dim * ((a.t_dim + a.xrows - 1) / a.xrows);
  const int64_t cols = (int64_t)a.jb * a.cs * (a.split ? a.nseg : 1);
  if (rows > 65535 || cols > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  int na = 0;
  if (reduce) {
    attrs[na].id = cudaLaunchAttributeClusterDimension;
    attrs[na].val.clusterDim.x = a.nseg;
    attrs[na].val.clusterDim.y = 1;
    attrs[na].val.clusterDim.z = 1;
    ++na;
  }
  if (a.dep) {
    attrs[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cols, (unsigned)rows);
  cfg.blockDim = dim3(block_threads(BNB, ROWS));
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = na;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace stream
}  // namespace salaad
