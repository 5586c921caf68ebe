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
// FlashAttention-2 on the tensor cores with mma.sync:
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

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

// keys per chunk of head-dim bucket dp
__host__ __device__ constexpr int chunk_keys(int dp) { return dp > 128 ? 32 : 64; }
// row stride of the staged tiles, in elements: 4 words mod 32 (f32) or 4
// words mod 8 (bf16, 2 elements a word), so the fragment loads of a warp hit
// distinct banks; a multiple of 16 bytes for cp.async
template <typename T>
__host__ __device__ constexpr int row_stride(int dp) { return sizeof(T) == 4 ? dp + 4 : dp + 8; }
// Q tile, then two slots of (K chunk, V chunk)
template <typename T>
__host__ __device__ constexpr int flash_smem(int dp) {
  return (int)sizeof(T) * row_stride<T>(dp) * (kRows + 4 * chunk_keys(dp));
}

// d += a b on the tensor cores: one m16n8k16 bf16 product, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 in one register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// s (16 rows of the warp x BC keys) = Q_w K^T, 3xTF32
template <int DP, int BC, int LD>
__device__ __forceinline__ void qk(const float* qw, const float* ks, float (&s)[BC / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k8 = 0; k8 < DP / 8; ++k8) {
    const float* qa = qw + g * LD + k8 * 8 + q;
    uint32_t ah[4], al[4];
    split_tf32_fast(qa[0], ah[0], al[0]);
    split_tf32_fast(qa[8 * LD], ah[1], al[1]);
    split_tf32_fast(qa[4], ah[2], al[2]);
    split_tf32_fast(qa[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      const float* kb = ks + (j * 8 + g) * LD + k8 * 8 + q;
      uint32_t bh[2], bl[2];
      split_tf32_fast(kb[0], bh[0], bl[0]);
      split_tf32_fast(kb[4], bh[1], bl[1]);
      mma_tf32(s[j], al, bh);
      mma_tf32(s[j], ah, bl);
      mma_tf32(s[j], ah, bh);
    }
  }
}

// s = Q_w K^T, bf16
template <int DP, int BC, int LD>
__device__ __forceinline__ void qk(const __nv_bfloat16* qw, const __nv_bfloat16* ks,
                                   float (&s)[BC / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int k16 = 0; k16 < DP / 16; ++k16) {
    const __nv_bfloat16* qa = qw + g * LD + k16 * 16 + 2 * q;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * LD), ld32(qa + 8), ld32(qa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      const __nv_bfloat16* kb = ks + (j * 8 + g) * LD + k16 * 16 + 2 * q;
      const uint32_t b[2] = {ld32(kb), ld32(kb + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

// o (16 rows x DP) += P V, 3xTF32. P's accumulator fragment p[kk] holds
// keys 2q and 2q + 1 of the 8: they are A's columns q and q + 4, and V's
// rows are read in that order.
template <int DP, int BC, int LD>
__device__ __forceinline__ void pv(const float (&p)[BC / 8][4], const float* vs,
                                   float (&o)[DP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BC / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32_fast(p[kk][0], ah[0], al[0]);
    split_tf32_fast(p[kk][2], ah[1], al[1]);
    split_tf32_fast(p[kk][1], ah[2], al[2]);
    split_tf32_fast(p[kk][3], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const float* vb = vs + (kk * 8 + 2 * q) * LD + nt * 8 + g;
      uint32_t bh[2], bl[2];
      split_tf32_fast(vb[0], bh[0], bl[0]);
      split_tf32_fast(vb[LD], bh[1], bl[1]);
      mma_tf32(o[nt], al, bh);
      mma_tf32(o[nt], ah, bl);
      mma_tf32(o[nt], ah, bh);
    }
  }
}

// o += P V, bf16: P rounded to bf16 from the accumulator fragments of two
// 8-key tiles (the m16n8k16 A layout)
template <int DP, int BC, int LD>
__device__ __forceinline__ void pv(const float (&p)[BC / 8][4], const __nv_bfloat16* vs,
                                   float (&o)[DP / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BC / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const __nv_bfloat16* vb = vs + (kk * 16 + 2 * q) * LD + nt * 8 + g;
      const uint32_t b[2] = {pack_bf16(vb[0], vb[LD]), pack_bf16(vb[8 * LD], vb[9 * LD])};
      mma_bf16(o[nt], a, b);
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
    // online softmax: the row's max over its quad, the correction of the
    // running sums, then P = exp2(s - max) (exactly 0 where masked)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[rr] - m_use);
      m[rr] = m_new;
      l[rr] *= corr;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt) {
        o[nt][2 * rr] *= corr;
        o[nt][2 * rr + 1] *= corr;
      }
      mx[rr] = m_use;
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
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
