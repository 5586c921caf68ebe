// The FlashAttention-2 warp tile on mma.sync, shared by flash attention
// (flash_attention.cu) and paged attention (paged_attention.cu).
//
// A warp owns 16 query rows. Against a chunk of BC keys staged in shared
// memory (rows of stride LD elements, head dim zero-padded to DP) it forms
// the scores S = Q K^T in registers (qk), updates its running softmax
// (online_softmax: row max over the quad of lanes that holds a row, the
// correction of the running sums, P = exp2(S - max)) and accumulates
// O += P V (pv), P reused from the accumulator fragments as the A operand.
// f32 operands run as error-compensated 3xTF32 m16n8k8 products (each
// operand hi + lo, split by masking: split_tf32_fast; the lo lo term
// dropped: about 1e-6 relative), bf16 operands as m16n8k16 products, with
// f32 accumulation in both; f32 queries over bf16 keys and values
// (qk_wide, pv_wide) take the f32 route on K and V widened exactly. Rows of a quad: lane = 4 g + q holds rows g and
// g + 8, columns 2 q and 2 q + 1 of every 8-column tile.
#pragma once

#include <stdint.h>

#include <cmath>

#include "common.cuh"

namespace salaad {

constexpr float kLog2e = 1.4426950408889634f;

// row stride of the staged tiles, in elements: 4 words mod 32 (f32) or 4
// words mod 8 (bf16, 2 elements a word), so the fragment loads of a warp hit
// distinct banks; a multiple of 16 bytes for cp.async
template <typename T>
__host__ __device__ constexpr int row_stride(int dp) { return sizeof(T) == 4 ? dp + 4 : dp + 8; }

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

// s (16 rows of the warp x BC keys) = Q_w K^T, 3xTF32. A narrow tile (under
// 4 key tiles: paged attention's warps) sums the two correction terms in a
// chain of their own, so no accumulator waits on a chain of 3 DP / 8 products.
template <int DP, int BC, int LD>
__device__ __forceinline__ void qk(const float* qw, const float* ks, float (&s)[BC / 8][4]) {
  constexpr bool split = BC / 8 < 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float c[split ? BC / 8 : 1][4] = {};
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
      if constexpr (split) {
        mma_tf32(c[j], al, bh);
        mma_tf32(c[j], ah, bl);
      } else {
        mma_tf32(s[j], al, bh);
        mma_tf32(s[j], ah, bl);
      }
      mma_tf32(s[j], ah, bh);
    }
  }
  if constexpr (split) {
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];
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

// A bf16 K or V element widened to f32, as a TF32 operand: exact, since
// bf16's 8 significant bits fit TF32's 11, so its 3xTF32 correction term is
// zero and an f32 operand against it takes two products, (hi + lo) b
__device__ __forceinline__ uint32_t widen_tf32(__nv_bfloat16 v) {
  return __float_as_uint(__bfloat162float(v));
}

// s = Q_w K^T with f32 Q over bf16 K (f32 queries over bf16 pages): Q split
// as in the f32 route, each K element widened; Q's rows have stride LDQ
// (f32 staging), K's LDK (bf16 staging)
template <int DP, int BC, int LDQ, int LDK>
__device__ __forceinline__ void qk_wide(const float* qw, const __nv_bfloat16* ks,
                                        float (&s)[BC / 8][4]) {
  constexpr bool split = BC / 8 < 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float c[split ? BC / 8 : 1][4] = {};
#pragma unroll
  for (int k8 = 0; k8 < DP / 8; ++k8) {
    const float* qa = qw + g * LDQ + k8 * 8 + q;
    uint32_t ah[4], al[4];
    split_tf32_fast(qa[0], ah[0], al[0]);
    split_tf32_fast(qa[8 * LDQ], ah[1], al[1]);
    split_tf32_fast(qa[4], ah[2], al[2]);
    split_tf32_fast(qa[8 * LDQ + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      const __nv_bfloat16* kb = ks + (j * 8 + g) * LDK + k8 * 8 + q;
      const uint32_t b[2] = {widen_tf32(kb[0]), widen_tf32(kb[4])};
      if constexpr (split)
        mma_tf32(c[j], al, b);
      else
        mma_tf32(s[j], al, b);
      mma_tf32(s[j], ah, b);
    }
  }
  if constexpr (split) {
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += c[j][e];
  }
}

// o += P V with f32 P over bf16 V: P split as in the f32 route, each V
// element widened (rows of stride LD, bf16 staging)
template <int DP, int BC, int LD>
__device__ __forceinline__ void pv_wide(const float (&p)[BC / 8][4], const __nv_bfloat16* vs,
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
      const __nv_bfloat16* vb = vs + (kk * 8 + 2 * q) * LD + nt * 8 + g;
      const uint32_t b[2] = {widen_tf32(vb[0]), widen_tf32(vb[LD])};
      mma_tf32(o[nt], al, b);
      mma_tf32(o[nt], ah, b);
    }
  }
}

// The online softmax over one chunk: s holds the warp's scores, scaled into
// the log2 domain and masked (-inf), and mx each thread's max of its two
// rows' scores. Takes each row's max over its quad, rescales the running
// denominators l and output rows o by the correction, and turns s into
// P = exp2(s - max): exactly 0 where masked, and a row that has seen no key
// keeps m = -inf, l = 0, o = 0.
template <int DP, int BC>
__device__ __forceinline__ void online_softmax(float (&s)[BC / 8][4], float (&mx)[2],
                                               float (&m)[2], float (&l)[2],
                                               float (&o)[DP / 8][4]) {
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

}  // namespace salaad
