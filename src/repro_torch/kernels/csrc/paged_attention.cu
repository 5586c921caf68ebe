// Paged attention for Hopper (sm_90a): single-query decode and k-query.
//
// Replaces the TPU kernels paged_attention_pallas and
// paged_attention_kquery_pallas (repro/kernels/paged_attention.py).
// q (B, Hq, kq, D) - the decode kernel is kq == 1 - attends a page pool
// k/v (N, Hkv, bs, D) through a block table (B, nb) int32; entries >= N are
// clamped to N - 1 and hidden by the mask. Query i of slot b sits at position
// lengths[b] + i and sees keys at positions <= lengths[b] + i (and < nb * bs).
//
// What bounds it on this card: bytes. Each visible K and V row is read once
// per (slot, KV head, row tile) and meets one query row per GQA group member
// (decode: 4 D flops per 2 D elements read); at the chunked-prefill width
// (kq = 64, the engine's shapes) the K/V bytes still outweigh the 3xTF32
// products. At these sizes the kernel is far from either: its time is the
// latency of a few dependent steps per block (block-table read, 16-byte
// copies, products, sums across warps and blocks), so the design keeps every
// block's chain short and the card full:
//   - the warp tile of flash attention (attention_tile.cuh): S = Q K^T and
//     O += P V on the tensor cores (3xTF32 m16n8k8 for f32, m16n8k16 for
//     bf16, f32 accumulation), scores and the online softmax in registers;
//   - rows are (query, GQA group member) pairs, query-major, 16 per block
//     (one m16 tile: a decode query's whole group at group <= 16), so one
//     tile shares one KV head; the block's 4 warps split each chunk's keys
//     (16-row tiles beat 32- and 64-row ones, tools/paged_variants.py);
//   - decode cuts the key axis into up to 8 segments of at least two chunks,
//     from the table shape, D and dtype alone (paged_plan in
//     kernels/paged_attention.py): one block per (segment, row tile x KV
//     head, slot), a tile's segments one thread-block cluster - 256 blocks
//     for a decode tick of 8 slots x 8 heads at 512 positions, where one
//     block per (slot, head) gave 64 on 132 SMs. k-query walks the key axis
//     whole: its 16-row tiles already fill the card, and a split cost more
//     than it saved;
//   - a block walks its segment in chunks of 64 keys (32 for f32 at D > 128)
//     up to the last position its tile's last row sees (the Pallas page
//     skip), double-buffered in shared memory through 16-byte cp.async rows
//     (a (page, head) row of D elements is contiguous in the pool); each
//     key's pool offset comes from one block-table read, issued a chunk
//     before its copies; a warp skips a chunk none of its rows sees, and
//     only chunks that cross a row's last position are masked;
//   - the partials (running max m, denominator l, unnormalised output o) are
//     summed in a fixed order: the warps in the block's shared memory, then
//     the cluster's segments in rank order in distributed shared memory,
//     each rank finishing a slice of the tile's outputs; a part that saw no
//     key of a row adds nothing to it.
// Nothing here depends on B, on the other slots' lengths or on the call, so
// a slot's output is bit for bit the same alone or in any batch, and across
// calls; the grid comes from nb on the host (no host sync, capturable in a
// CUDA graph). Masked scores contribute exactly zero; the output is q.dtype
// with the denominator floored at 1e-30.
//
// Three instances: f32 q over f32 pools, bf16 over bf16, and f32 q over bf16
// pools (a bf16 page pool under an f32 model, the speculative engine's draft
// pools). The last stages its K and V chunks in bf16 as the bf16 instance
// does (so its chunk and segment plan are the bf16 pool's: paged_plan gets
// the pool's itemsize) and widens each element to f32 exactly as its
// fragments load (qk_wide, pv_wide in attention_tile.cuh): the f32 route on
// the widened values, which is the Pallas kernels' astype(f32) per tile. q
// is never rounded to bf16.
#include <stdint.h>

#include <climits>
#include <cmath>

#include <type_traits>

#include <cooperative_groups.h>

#include "attention_tile.cuh"

namespace salaad {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// warps along rows, 16 rows each: one, so a block holds 16 rows and its 4
// warps split each chunk's keys (tools/paged_variants.py times 2 and 4)
constexpr int kRowWarps = 1;
constexpr int kKeyWarps = kWarps / kRowWarps;
constexpr int kRows = 16 * kRowWarps;
constexpr int kMaxSeg = 8;    // segments per row tile = blocks per cluster (the portable limit)

// keys per chunk: 64, or 32 for f32 pools at D > 128, where two slots of 64
// f32 K and V rows would not fit beside the Q tile (paged_plan's chunk)
template <typename T>
__host__ __device__ constexpr int chunk_keys(int dp) {
  return sizeof(T) == 4 && dp > 128 ? 32 : 64;
}

struct PagedArgs {
  const void* q;
  const void* kp;
  const void* vp;
  const int* table;
  const int* lengths;
  void* out;
  int hq, hkv, kq, d, n_pages, bs, nb, seg_keys, nseg, vec;
  float sl2;   // the softmax scale times log2 e
};

// One instance's shared memory: two chunks of key offsets, the Q tile
// (kRows, LDQ) of T, then two slots of (K, V) chunks (BC, LD) of the pool's
// TK - or one, for a segment of one chunk, the launch allocating no more;
// after the walk the same bytes hold the warps' partials (o, m, l) and the
// block's (m, l).
template <typename T, typename TK, int DP>
struct Tile {
  static constexpr int BC = chunk_keys<TK>(DP);  // keys per chunk
  static constexpr int BCW = BC / kKeyWarps;     // keys of a chunk per warp
  static constexpr int LDQ = row_stride<T>(DP);
  static constexpr int LD = row_stride<TK>(DP);
  static constexpr int koff_bytes = 2 * BC * (int)sizeof(int64_t);
  static constexpr int q_bytes = (int)sizeof(T) * LDQ * kRows;
  static constexpr int slot_bytes = (int)sizeof(TK) * LD * 2 * BC;
  static constexpr int part_bytes =
      4 * (kKeyWarps * kRows * DP + 2 * kKeyWarps * kRows + 2 * kRows);
  // the bytes of a launch whose walk uses `slots` slots
  static constexpr int smem(int slots) {
    return koff_bytes + q_bytes + slots * slot_bytes > part_bytes
               ? koff_bytes + q_bytes + slots * slot_bytes
               : part_bytes;
  }
  static_assert(BCW % (sizeof(T) == 4 ? 8 : 16) == 0, "a warp's keys fill whole k steps");
  static_assert(smem(2) <= 232448, "two slots fit a block's shared memory");
};

// grid (nseg, row tiles x Hkv, B), clusters of (nseg, 1, 1) when nseg > 1;
// q and out of T, the pools of TK
template <typename T, typename TK, int DP>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(const PagedArgs a) {
  using L = Tile<T, TK, DP>;
  constexpr int BC = L::BC, BCW = L::BCW, LDQ = L::LDQ, LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* koff = reinterpret_cast<int64_t*>(smem);                 // (2, BC)
  T* qs = reinterpret_cast<T*>(smem + L::koff_bytes);               // (kRows, LDQ)
  TK* kvs = reinterpret_cast<TK*>(smem + L::koff_bytes + L::q_bytes);  // slot c & 1: K, then V

  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());   // the block's segment
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int wk = warp / kRowWarps, wrow = warp % kRowWarps * 16;   // keys, first row
  const int h = blockIdx.y % a.hkv, tile = blockIdx.y / a.hkv, b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int r0 = tile * kRows, n_rows = min(kRows, a.kq * group - r0);
  const int length = a.lengths[b], n_keys = a.nb * a.bs;
  // the last key position tile row i sees
  auto last_key = [&](int i) { return min(length + (r0 + i) / group, n_keys - 1); };
  const int seg0 = s * a.seg_keys;
  const int seg_end = min(seg0 + a.seg_keys, last_key(n_rows - 1) + 1);
  const int n_chunks = seg_end > seg0 ? (seg_end - seg0 + BC - 1) / BC : 0;
  const T* q = static_cast<const T*>(a.q);
  const TK* kp = static_cast<const TK*>(a.kp);
  const TK* vp = static_cast<const TK*>(a.vp);
  const int* tab = a.table + (int64_t)b * a.nb;
  // element offset of tile row i (query r / group, head h group + r % group)
  auto row_off = [&](int i) -> int64_t {
    const int r = r0 + i;
    return (((int64_t)b * a.hq + h * group + r % group) * a.kq + r / group) * a.d;
  };
  // the pool offset of key tid of chunk c (-1 past the table): one
  // block-table read, which the 32 keys of a warp share one or two of, a
  // chunk before the copies
  auto key_off = [&](int c) -> int64_t {
    const int pos = seg0 + c * BC + tid;
    if (pos >= n_keys) return -1;
    const int page = max(min(__ldg(tab + pos / a.bs), a.n_pages - 1), 0);
    return (((int64_t)page * a.hkv + h) * a.bs + pos % a.bs) * a.d;
  };
  // chunk c's K and V rows into slot c & 1: 16-byte copies of the segment's
  // keys, zeros past its end
  auto stage_chunk = [&](int c) {
    TK* ks = kvs + (c & 1) * 2 * BC * LD;
    TK* vs = ks + BC * LD;
    const int64_t* ko = koff + (c & 1) * BC;
    const int n_live = seg_end - seg0 - c * BC;
    if (a.vec) {
      constexpr int V = 16 / (int)sizeof(TK), CPR = DP / V;
      for (int e = tid; e < BC * CPR; e += kThreads) {
        const int i = e / CPR, col = (e % CPR) * V;
        const int64_t off = ko[i];
        const bool live = i < n_live && col < a.d;
        cp_async16(ks + i * LD + col, live ? kp + off + col : kp, live ? 16 : 0);
        cp_async16(vs + i * LD + col, live ? vp + off + col : vp, live ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BC * DP; e += kThreads) {
        const int i = e / DP, col = e % DP;
        const int64_t off = ko[i];
        const bool live = i < n_live && col < a.d;
        ks[i * LD + col] = live ? kp[off + col] : from_f32<TK>(0.f);
        vs[i * LD + col] = live ? vp[off + col] : from_f32<TK>(0.f);
      }
    }
  };

  const int last_a = last_key(wrow + g), last_b = last_key(wrow + g + 8);
  const int last_0 = last_key(wrow);                          // the fewest keys a row sees
  const int last_n = last_key(min(wrow + 15, n_rows - 1));    // the most
  const bool warp_live = wrow < n_rows;
  float o[DP / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};   // running max (log2 domain), rows g and g + 8
  float l[2] = {0.f, 0.f};               // the thread's part of the denominators
  // the Q tile, the length and chunk 0's table rows load at once
  if (a.vec) {
    constexpr int V = 16 / (int)sizeof(T), CPR = DP / V;
    for (int e = tid; e < kRows * CPR; e += kThreads) {
      const int i = e / CPR, col = (e % CPR) * V;
      const bool live = i < n_rows && col < a.d;
      cp_async16(qs + i * LDQ + col, live ? q + row_off(i) + col : q, live ? 16 : 0);
    }
  } else {
    for (int e = tid; e < kRows * DP; e += kThreads) {
      const int i = e / DP, col = e % DP;
      qs[i * LDQ + col] = i < n_rows && col < a.d ? q[row_off(i) + col] : from_f32<T>(0.f);
    }
  }
  if (tid < BC) koff[tid] = key_off(0);
  __syncthreads();
  if (n_chunks > 0) stage_chunk(0);
  cp_async_commit();                 // the Q tile and chunk 0
  if (tid < BC) koff[BC + tid] = key_off(1);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed, chunk c + 1's offsets are in; chunk c - 1's slot is free
    if (c + 1 < n_chunks) stage_chunk(c + 1);
    cp_async_commit();
    if (c + 2 < n_chunks && tid < BC) koff[(c & 1) * BC + tid] = key_off(c + 2);
    const int c0 = seg0 + c * BC + wk * BCW;   // the warp's first key of the chunk
    if (!warp_live || c0 > last_n) continue;   // no row of the warp sees these keys
    const TK* ks = kvs + (c & 1) * 2 * BC * LD + wk * BCW * LD;
    float sc[BCW / 8][4] = {};
    if constexpr (std::is_same_v<T, TK>)
      qk<DP, BCW, LD>(qs + wrow * LDQ, ks, sc);
    else
      qk_wide<DP, BCW, LDQ, LD>(qs + wrow * LDQ, ks, sc);
    const bool edge = c0 + BCW - 1 > last_0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BCW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + j * 8 + 2 * qd + (e & 1);
        float val = sc[j][e] * a.sl2;
        if (edge && key > (e < 2 ? last_a : last_b)) val = -INFINITY;
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    online_softmax<DP, BCW>(sc, mx, m, l, o);
    if constexpr (std::is_same_v<T, TK>)
      pv<DP, BCW, LD>(sc, ks + BC * LD, o);
    else
      pv_wide<DP, BCW, LD>(sc, ks + BC * LD, o);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  cp_async_wait<0>();   // a block with no chunk still has its Q tile in flight
  __syncthreads();      // every warp is done with the staged tiles
  float* po = reinterpret_cast<float*>(smem);   // (kKeyWarps, kRows, DP): each warp's o
  float* pm = po + kKeyWarps * kRows * DP;      // (kKeyWarps, kRows): its m
  float* pl = pm + kKeyWarps * kRows;           // (kKeyWarps, kRows): its l
  float* bm = pl + kKeyWarps * kRows;           // (kRows): the block's m
  float* bl = bm + kRows;                       // (kRows): the block's l
  {
    float* ow = po + (wk * kRows + wrow) * DP;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (wrow + g + (e & 2) * 4 < n_rows)   // a decode tile holds `group` live rows
          ow[(g + (e & 2) * 4) * DP + nt * 8 + 2 * qd + (e & 1)] = o[nt][e];
    if (qd == 0) {
      pm[wk * kRows + wrow + g] = m[0];
      pm[wk * kRows + wrow + g + 8] = m[1];
      pl[wk * kRows + wrow + g] = l[0];
      pl[wk * kRows + wrow + g + 8] = l[1];
    }
  }
  __syncthreads();
  // the block's part: its warps' parts, in order (one that saw no key of a
  // row adds nothing to it)
  for (int e = tid; e < n_rows * DP; e += kThreads) {
    const int i = e / DP, col = e % DP;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w) mb = fmaxf(mb, pm[w * kRows + i]);
    float ob = 0.f, lb = 0.f;
#pragma unroll
    for (int w = 0; w < kKeyWarps; ++w) {
      const float mw = pm[w * kRows + i];
      if (mw == -INFINITY) continue;
      const float f = exp2f(mw - mb);
      ob += po[(w * kRows + i) * DP + col] * f;
      lb += pl[w * kRows + i] * f;
    }
    po[i * DP + col] = ob;   // warp 0's slot: this thread alone reads and writes it
    if (col == 0) {
      bm[i] = mb;
      bl[i] = lb;
    }
  }
  if (a.nseg > 1)
    cluster.sync();   // every segment's part is in its block's shared memory
  else
    __syncthreads();

  // the tile's outputs, rank s's slice, over the segments in rank order
  const float* rm[kMaxSeg];
  const float* rl[kMaxSeg];
  const float* ro[kMaxSeg];
#pragma unroll
  for (int r = 0; r < kMaxSeg; ++r) {
    const int rk = r < a.nseg ? r : 0;
    rm[r] = a.nseg > 1 ? cluster.map_shared_rank(bm, rk) : bm;
    rl[r] = a.nseg > 1 ? cluster.map_shared_rank(bl, rk) : bl;
    ro[r] = a.nseg > 1 ? cluster.map_shared_rank(po, rk) : po;
  }
  T* out = static_cast<T*>(a.out);
  const int n_out = n_rows * a.d;
  for (int e = s * n_out / a.nseg + tid; e < (s + 1) * n_out / a.nseg; e += kThreads) {
    const int i = e / a.d, col = e % a.d;
    float mt = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSeg; ++r)
      if (r < a.nseg) mt = fmaxf(mt, rm[r][i]);
    float ot = 0.f, lt = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSeg; ++r) {
      if (r >= a.nseg) break;
      const float mr = rm[r][i];
      if (mr == -INFINITY) continue;
      const float f = exp2f(mr - mt);
      ot += ro[r][i * DP + col] * f;
      lt += rl[r][i] * f;
    }
    out[row_off(i) + col] = from_f32<T>(ot * (1.f / fmaxf(lt, 1e-30f)));
  }
  if (a.nseg > 1) cluster.sync();   // no block leaves while a peer reads its part
}

template <typename T, typename TK, int DP>
cudaError_t launch_dp(const PagedArgs& a, int b, cudaStream_t stream) {
  using L = Tile<T, TK, DP>;
  if (a.seg_keys % L::BC) return cudaErrorInvalidValue;
  const int64_t tiles = ((int64_t)a.kq * (a.hq / a.hkv) + kRows - 1) / kRows;
  if (tiles * a.hkv > 65535 || b > 65535) return cudaErrorInvalidValue;
  auto kernel = paged_attention_kernel<T, TK, DP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::smem(2));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.nseg;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nseg, static_cast<unsigned>(tiles * a.hkv), b);
  cfg.blockDim = dim3(kThreads);
  // a segment of one chunk never reaches the second slot
  cfg.dynamicSmemBytes = L::smem(a.seg_keys > L::BC ? 2 : 1);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = a.nseg > 1;   // one segment: each block is a cluster of its own
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename TK>
cudaError_t launch(PagedArgs a, int b, cudaStream_t stream) {
  a.vec = (a.d * (int)sizeof(T)) % 16 == 0 && (a.d * (int)sizeof(TK)) % 16 == 0 &&
          (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.kp) |
           reinterpret_cast<uintptr_t>(a.vp)) % 16 == 0;
  if (a.d <= 64) return launch_dp<T, TK, 64>(a, b, stream);
  if (a.d <= 80) return launch_dp<T, TK, 80>(a, b, stream);
  if (a.d <= 128) return launch_dp<T, TK, 128>(a, b, stream);
  return launch_dp<T, TK, 256>(a, b, stream);
}

// the dtype code of f32 q and out over bf16 pools (kernels/paged_attention.py)
constexpr int kF32OverBF16 = 2;

int run(const void* q, const void* kp, const void* vp, const int* table, const int* lengths,
        void* out, int b, int hq, int hkv, int kq, int d, int n_pages, int bs, int nb,
        int seg_keys, int dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || kq < 1 || d < 1 || d > 256 || n_pages < 1 || nb < 1 ||
      bs < 1 || seg_keys < 1 || (int64_t)nb * bs > INT_MAX / 2 ||
      (int64_t)kq * (hq / hkv) > INT_MAX / 2)
    return cudaErrorInvalidValue;
  const int64_t nseg = ((int64_t)nb * bs + seg_keys - 1) / seg_keys;
  if (nseg > kMaxSeg) return cudaErrorInvalidValue;
  const PagedArgs a{q, kp, vp, table, lengths, out, hq, hkv, kq, d, n_pages, bs, nb, seg_keys,
                    static_cast<int>(nseg), 0,
                    static_cast<float>(1.0 / std::sqrt(static_cast<double>(d))) * kLog2e};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float, float>(a, b, s);
  if (dtype == kBF16) return launch<__nv_bfloat16, __nv_bfloat16>(a, b, s);
  if (dtype == kF32OverBF16) return launch<float, __nv_bfloat16>(a, b, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace salaad

// Decode: q / out (B, Hq, D), one query per slot at position lengths[b].
// seg_keys comes from paged_plan (kernels/paged_attention.py).
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const int* table, const int* lengths, void* out, int b,
                                      int hq, int hkv, int d, int n_pages, int bs, int nb,
                                      int seg_keys, int dtype, void* stream) {
  return salaad::run(q, kp, vp, table, lengths, out, b, hq, hkv, 1, d, n_pages, bs, nb,
                     seg_keys, dtype, stream);
}

// k-query: q / out (B, Hq, kq, D), queries at lengths[b] .. lengths[b] + kq - 1.
extern "C" int paged_attention_kquery_launch(const void* q, const void* kp, const void* vp,
                                             const int* table, const int* lengths, void* out,
                                             int b, int hq, int hkv, int kq, int d,
                                             int n_pages, int bs, int nb, int seg_keys,
                                             int dtype, void* stream) {
  return salaad::run(q, kp, vp, table, lengths, out, b, hq, hkv, kq, d, n_pages, bs, nb,
                     seg_keys, dtype, stream);
}
