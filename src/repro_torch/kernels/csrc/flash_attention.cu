// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas (repro/kernels/
// flash_attention.py). q (B, Hq, T, D) attends k / v (B, Hkv, S, D); q head h
// reads KV head h / (Hq / Hkv) (GQA). Under ``causal`` query row i sees keys
// j <= i (positions counted from 0 in both q and k, the Pallas kernel's
// alignment). Scores and the softmax run in f32 with the scale applied to q;
// the output is q.dtype with the denominator floored at 1e-30.
//
// Design. One thread block per (batch * q head, tile of kRows query rows).
// The Pallas grid carries (max, denominator, accumulator) across its
// sequential KV axis in VMEM scratch; here the block walks the KV sequence
// itself in chunks of kKeys keys with the same online softmax held in shared
// memory, so nothing crosses blocks. Under ``causal`` the walk stops at the
// last key the tile's last row can see (the tiles wholly above the diagonal
// that Pallas skips with pl.when). Masked scores contribute exactly zero.
// The tile is 64 rows for head dims up to 128 and 32 beyond, which keeps the
// f32 tiles (q, K chunk, V chunk, scores, output rows) under the 227 KB of
// dynamic shared memory a block may use.
//
// Bound on this card: operations at the prefill widths the engine runs
// (T = S = 16..512, D = 64): every (query, visible key) pair costs 4 D
// flops against 2 D bytes read per key per tile. Products run on the CUDA
// cores in f32 from shared memory; tensor-core (wgmma) score and PV tiles and
// TMA loads are the next steps.
#include <stdint.h>

#include <cmath>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int tile, int d) {
  // q rows, K chunk (padded stride), V chunk, scores, output rows, m, l, corr
  return sizeof(float) * ((size_t)tile * d + (size_t)tile * (d + 1) + (size_t)tile * d +
                          (size_t)tile * tile + (size_t)tile * d + 3 * (size_t)tile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
                       int t_dim, int s_dim, int d, int tile, int causal, float scale) {
  extern __shared__ float smem[];
  const int rows = tile, keys = tile, dk = d + 1;
  float* qs = smem;                 // [rows][d]
  float* ks = qs + rows * d;        // [keys][d + 1]
  float* vs = ks + keys * dk;       // [keys][d]
  float* ss = vs + keys * d;        // [rows][keys]
  float* os = ss + rows * keys;     // [rows][d]
  float* ms = os + rows * d;        // [rows]
  float* ls = ms + rows;
  float* cs = ls + rows;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;                        // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const int kvh = b * hkv + h / (hq / hkv);
  const int r0 = blockIdx.x * rows;
  const int n_rows = min(rows, t_dim - r0);
  const T* qb = q + ((int64_t)bh * t_dim + r0) * d;
  const T* kb = k + (int64_t)kvh * s_dim * d;
  const T* vb = v + (int64_t)kvh * s_dim * d;

  for (int e = tid; e < rows * d; e += kThreads) {
    const int rr = e / d;
    qs[e] = rr < n_rows ? to_f32(qb[e]) * scale : 0.f;
    os[e] = 0.f;
  }
  if (tid < rows) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  // last key any row of this tile may see
  const int kmax = causal ? min(s_dim - 1, r0 + n_rows - 1) : s_dim - 1;
  __syncthreads();

  for (int c0 = 0; c0 <= kmax; c0 += keys) {
    for (int e = tid; e < keys * d; e += kThreads) {
      const int kk = e / d, c = e % d, pos = c0 + kk;
      const bool live = pos <= kmax;
      ks[kk * dk + c] = live ? to_f32(kb[(int64_t)pos * d + c]) : 0.f;
      vs[e] = live ? to_f32(vb[(int64_t)pos * d + c]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < rows * keys; e += kThreads) {
      const int rr = e / keys, kk = e % keys, pos = c0 + kk;
      float sc = kNegInf;
      if (rr < n_rows && pos <= kmax && (!causal || pos <= r0 + rr)) {
        sc = 0.f;
        const float* qr = qs + rr * d;
        const float* kr = ks + kk * dk;
        for (int c = 0; c < d; ++c) sc += qr[c] * kr[c];
      }
      ss[e] = sc;
    }
    __syncthreads();
    if (tid < n_rows) {
      float* row = ss + tid * keys;
      const float m_prev = ms[tid];
      float mx = m_prev;
      for (int kk = 0; kk < keys; ++kk) mx = fmaxf(mx, row[kk]);
      float sum = 0.f;
      for (int kk = 0; kk < keys; ++kk) {
        const float pk = row[kk] <= 0.5f * kNegInf ? 0.f : expf(row[kk] - mx);
        row[kk] = pk;
        sum += pk;
      }
      const float corr = expf(m_prev - mx);
      ls[tid] = corr * ls[tid] + sum;
      ms[tid] = mx;
      cs[tid] = corr;
    }
    __syncthreads();
    for (int e = tid; e < rows * d; e += kThreads) {
      const int rr = e / d, c = e % d;
      if (rr < n_rows) {
        const float* pr = ss + rr * keys;
        float a = os[e] * cs[rr];
        for (int kk = 0; kk < keys; ++kk) a += pr[kk] * vs[kk * d + c];
        os[e] = a;
      }
    }
    __syncthreads();
  }

  T* ob = out + ((int64_t)bh * t_dim + r0) * d;
  for (int e = tid; e < rows * d; e += kThreads) {
    const int rr = e / d;
    if (rr < n_rows) ob[e] = from_f32<T>(os[e] / fmaxf(ls[rr], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int t_dim, int s_dim, int d, int causal, float scale,
                   cudaStream_t stream) {
  const int tile = d <= 128 ? 64 : 32;
  const size_t smem = smem_bytes(tile, d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((t_dim + tile - 1) / tile, b * hq);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, t_dim, s_dim, d, tile, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace salaad

// q / out (B, Hq, T, D), k / v (B, Hkv, S, D), all contiguous.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int b, int hq, int hkv, int t_dim, int s_dim, int d,
                                      int causal, float scale, int dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || t_dim < 1 || s_dim < 1 || d < 1 || d > 256)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == salaad::kF32)
    return salaad::launch<float>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal, scale, s);
  if (dtype == salaad::kBF16)
    return salaad::launch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, t_dim, s_dim, d, causal,
                                         scale, s);
  return cudaErrorInvalidValue;
}
