// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas (repro/kernels/
// flash_attention.py). q (B, Hq, T, D) attends k / v (B, Hkv, S, D); q head h
// reads KV head h / (Hq / Hkv) (GQA). Under ``causal`` query row i sees keys
// j <= i (positions counted from 0 in both q and k, the Pallas kernel's
// alignment). Scores and the softmax run in f32; the output is q.dtype with
// the denominator floored at 1e-30, and masked scores contribute exactly 0.
//
// What bounds it on this card: operations at the prefill widths the engine
// runs (T = S = 16..512, D = 64 or 80): every (query, visible key) pair costs
// 4 D flops against 2 D bytes read per key per tile. The design is
// FlashAttention-2 on the tensor cores with mma.sync (the warp tile -
// products and online softmax - is attention_tile.cuh, shared with paged
// attention):
//   - one block of 4 warps per (batch x q head, tile of 64 query rows), each
//     warp owning 16 rows; the block walks the KV sequence in chunks of 64
//     keys (32 at D > 128), so nothing crosses blocks (the Pallas grid
//     carries its running max, denominator and accumulator across its
//     sequential KV axis in VMEM scratch instead);
//   - S = Q K^T and O += P V on the tensor cores: f32 inputs as
//     error-compensated 3xTF32 m16n8k8 products (each operand hi + lo, the
//     lo lo term dropped: about 1e-6 relative, where plain TF32 would miss
//     the 1e-4 gate), split by masking (split_tf32_fast: the rounding
//     conversions of split_tf32 made this kernel 1.5x slower), bf16 inputs
//     as m16n8k16 bf16 products, f32 accumulation in both;
//   - the scores stay in registers: the scale (times log2 e) is applied to
//     them in f32, the online softmax (running max, denominator,
//     correction) runs on each quad of lanes that holds a row, with
//     shuffles, and P is reused from the accumulator fragments as the A
//     operand of P V (for TF32 the 8 keys of a k step are taken in the
//     order the accumulator holds them, 2q and 2q + 1 for columns q and
//     q + 4, and V's rows are read in the same order: no shuffles);
//   - K and V chunks stream through two shared-memory slots with 16-byte
//     cp.async copies, one barrier per chunk: chunk c + 1 loads while chunk
//     c computes; row strides padded so fragment loads are conflict-free;
//   - causal: the walk stops at the last chunk the tile's last row can see,
//     heavy tiles are scheduled first, a warp skips a chunk its rows cannot
//     see, and only chunks that cross the diagonal or the end of S are
//     masked;
//   - the head dim is a template over the buckets 64, 80, 128 and 256, other
//     D zero-padded in shared memory; ragged T and S are masked.
#include <stdint.h>

#include <cmath>

#include "attention_tile.cuh"

namespace salaad {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows per block

// keys per chunk of head-dim bucket dp
__host__ __device__ constexpr int chunk_keys(int dp) { return dp > 128 ? 32 : 64; }
// Q tile, then two slots of (K chunk, V chunk)
template <typename T>
__host__ __device__ constexpr int flash_smem(int dp) {
  return (int)sizeof(T) * row_stride<T>(dp) * (kRows + 4 * chunk_keys(dp));
}

// dst (n, dp), row stride LD, from src rows of d elements: rows >= valid and
// columns >= d are zero. vec: 16-byte cp.async (d fills whole 16-byte
// chunks and the rows are aligned), else element by element.
template <typename T, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int valid, int d, int dp,
                                      bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int cpr = dp / V;
    for (int e = threadIdx.x; e < n * cpr; e += kThreads) {
      const int i = e / cpr, c = (e % cpr) * V;
      const bool live = i < valid && c < d;
      cp_async16(dst + i * LD + c, live ? src + (int64_t)i * d + c : src, live ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n * dp; e += kThreads) {
      const int i = e / dp, c = e % dp;
      dst[i * LD + c] = i < valid && c < d ? src[(int64_t)i * d + c] : from_f32<T>(0.f);
    }
  }
}

// grid (B * Hq, query tiles); the tiles run in reverse under causal, so the
// ones that see the most keys are scheduled first
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
                       int t_dim, int s_dim, int d, int causal, float sl2, int vec) {
  constexpr int BC = chunk_keys(DP), LD = row_stride<T>(DP);
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);   // (kRows, LD)
  T* kvs = qs + kRows * LD;             // slot b: K (BC, LD) at kvs + 2 b BC LD, then V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int r0 = tile * kRows;
  const T* qb = q + ((int64_t)bh * t_dim + r0) * d;
  const T* kb = k + (int64_t)kvh * s_dim * d;
  const T* vb = v + (int64_t)kvh * s_dim * d;
  // keys [0, n_keys) are the ones some row of the tile may see
  const int n_keys = causal ? min(s_dim, r0 + kRows) : s_dim;
  const int n_chunks = (n_keys + BC - 1) / BC;

  stage<T, LD>(qs, qb, kRows, min(kRows, t_dim - r0), d, DP, vec);
  auto stage_chunk = [&](int c) {
    T* ks = kvs + (c & 1) * 2 * BC * LD;
    const int valid = min(BC, s_dim - c * BC);
    stage<T, LD>(ks, kb + (int64_t)c * BC * d, BC, valid, d, DP, vec);
    stage<T, LD>(ks + BC * LD, vb + (int64_t)c * BC * d, BC, valid, d, DP, vec);
    cp_async_commit();
  };
  stage_chunk(0);   // with the Q tile

  const int wr0 = r0 + warp * 16;   // the warp's first query row
  const int row_a = wr0 + g, row_b = row_a + 8;
  float o[DP / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};   // running max (log2 domain), rows g and g + 8
  float l[2] = {0.f, 0.f};               // the thread's part of the denominators
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();   // chunk c landed; every warp is done with chunk c - 1's slot
    if (c + 1 < n_chunks) stage_chunk(c + 1);
    const int c0 = c * BC;
    if (wr0 >= t_dim || (causal && c0 > wr0 + 15)) continue;   // no row of the warp sees it
    const T* ks = kvs + (c & 1) * 2 * BC * LD;
    float s[BC / 8][4] = {};
    qk<DP, BC, LD>(qs + warp * 16 * LD, ks, s);

    // scale into the log2 domain; mask past S and above the diagonal
    const bool edge = c0 + BC > s_dim || (causal && c0 + BC - 1 > wr0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + j * 8 + 2 * qd + (e & 1);
        float val = s[j][e] * sl2;
        if (edge && (key >= s_dim || (causal && key > (e < 2 ? row_a : row_b))))
          val = -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    online_softmax<DP, BC>(s, mx, m, l, o);
    pv<DP, BC, LD>(s, ks + BC * LD, o);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    l[rr] = 1.f / fmaxf(l[rr], 1e-30f);
  }
  T* ob = out + (int64_t)bh * t_dim * d;
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_a : row_b, col = nt * 8 + 2 * qd + (e & 1);
      if (row < t_dim && col < d) ob[(int64_t)row * d + col] = from_f32<T>(o[nt][e] * l[e >> 1]);
    }
}

template <typename T, int DP>
cudaError_t launch_dp(const void* q, const void* k, const void* v, void* out, int b, int hq,
                      int hkv, int t_dim, int s_dim, int d, int causal, float scale,
                      cudaStream_t stream) {
  constexpr int smem = flash_smem<T>(DP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool vec = (d * (int)sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  dim3 grid(b * hq, (t_dim + kRows - 1) / kRows);
  flash_attention_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, t_dim, s_dim, d, causal, scale * kLog2e, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int t_dim, int s_dim, int d, int causal, float scale,
                   cudaStream_t stream) {
  if (d <= 64)
    return launch_dp<T, 64>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal, scale, stream);
  if (d <= 80)
    return launch_dp<T, 80>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal, scale, stream);
  if (d <= 128)
    return launch_dp<T, 128>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal, scale, stream);
  return launch_dp<T, 256>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal, scale, stream);
}

}  // namespace
}  // namespace salaad

// q / out (B, Hq, T, D), k / v (B, Hkv, S, D), all contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int hq, int hkv, int t_dim, int s_dim, int d,
                                      int causal, float scale, int dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || t_dim < 1 || s_dim < 1 || d < 1 || d > 256 ||
      (t_dim + salaad::kRows - 1) / salaad::kRows > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == salaad::kF32)
    return salaad::launch<float>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal, scale, s);
  if (dtype == salaad::kBF16)
    return salaad::launch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal,
                                         scale, s);
  return cudaErrorInvalidValue;
}
