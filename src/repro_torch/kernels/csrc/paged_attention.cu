// Paged attention for Hopper (sm_90a): single-query decode and k-query.
//
// Replaces the TPU kernels paged_attention_pallas and
// paged_attention_kquery_pallas (repro/kernels/paged_attention.py).
// q (B, Hq, kq, D) - the decode kernel is kq == 1 - attends a page pool
// k/v (N, Hkv, bs, D) through a block table (B, nb) int32; entries >= N are
// clamped to N - 1 and hidden by the mask. Query i of slot b sits at position
// lengths[b] + i and sees keys at positions <= lengths[b] + i (and < nb * bs).
//
// Design. One thread block per (row tile, KV head, slot). A row is one
// (query, GQA group member) pair, rows ordered query-major, kRows per tile, so
// a decode block covers the whole GQA group of one KV head and a k-query
// block one tile of the chunk. The block walks the slot's keys in chunks of
// kKeys positions from 0 up to the last position any of its rows can see
// (the tile-level page skip of the Pallas kernel), each key found through its
// own block-table entry, and keeps an f32 online softmax (running max, sum
// and output rows) in shared memory. Masked scores contribute exactly zero.
//
// Bound on this card: bytes - every visible K and V row is read once per
// (slot, KV head, row tile), scores and weights stay in shared memory.
// Products run on the CUDA cores in f32; the softmax bookkeeping is one
// thread per row. A tensor-core (wgmma) score tile and cp.async/TMA page
// loads are the next steps.
#include <stdint.h>

#include <cmath>

#include "common.cuh"

namespace salaad {
namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;    // query rows per block
constexpr int kKeys = 32;    // key positions per chunk
constexpr float kNegInf = -1e30f;

size_t smem_bytes(int d) {
  // q rows, K chunk (padded stride), V chunk, scores, output rows, m, l, corr
  return sizeof(float) * ((size_t)kRows * d + (size_t)kKeys * (d + 1) +
                          (size_t)kKeys * d + kRows * kKeys + (size_t)kRows * d + 3 * kRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out, int hq,
                       int hkv, int kq, int d, int n_pages, int bs, int nb, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kRows][d]
  float* ks = qs + kRows * d;                // [kKeys][d + 1]
  float* vs = ks + kKeys * (d + 1);          // [kKeys][d]
  float* ss = vs + kKeys * d;                // [kRows][kKeys]
  float* os = ss + kRows * kKeys;            // [kRows][d]
  float* ms = os + kRows * d;                // [kRows]
  float* ls = ms + kRows;
  float* cs = ls + kRows;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int r0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, kq * group - r0);
  const int length = lengths[b];
  const int dk = d + 1;

  // q / out offset of tile row rr (query qi, group member g -> head h*group+g)
  auto q_off = [&](int rr) -> int64_t {
    const int r = r0 + rr, qi = r / group, g = r % group;
    return (((int64_t)b * hq + h * group + g) * kq + qi) * d;
  };

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int rr = e / d, c = e % d;
    qs[e] = rr < n_rows ? to_f32(q[q_off(rr) + c]) * scale : 0.f;
    os[e] = 0.f;
  }
  if (tid < kRows) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }
  // last key position any row of this tile may see
  const int qi_last = (r0 + n_rows - 1) / group;
  const int kmax = min(length + qi_last, nb * bs - 1);
  __syncthreads();

  for (int c0 = 0; c0 <= kmax; c0 += kKeys) {
    for (int e = tid; e < kKeys * d; e += kThreads) {
      const int kk = e / d, c = e % d, pos = c0 + kk;
      float kv = 0.f, vv = 0.f;
      if (pos <= kmax) {
        const int page = max(min(table[(int64_t)b * nb + pos / bs], n_pages - 1), 0);
        const int64_t idx = (((int64_t)page * hkv + h) * bs + pos % bs) * d + c;
        kv = to_f32(kp[idx]);
        vv = to_f32(vp[idx]);
      }
      ks[kk * dk + c] = kv;
      vs[e] = vv;
    }
    __syncthreads();
    for (int e = tid; e < kRows * kKeys; e += kThreads) {
      const int rr = e / kKeys, kk = e % kKeys, pos = c0 + kk;
      const int qi = (r0 + rr) / group;
      float sc = kNegInf;
      if (rr < n_rows && pos <= kmax && pos <= length + qi) {
        sc = 0.f;
        for (int c = 0; c < d; ++c) sc += qs[rr * d + c] * ks[kk * dk + c];
      }
      ss[e] = sc;
    }
    __syncthreads();
    if (tid < n_rows) {
      float* row = ss + tid * kKeys;
      const float m_prev = ms[tid];
      float mx = m_prev;
      for (int kk = 0; kk < kKeys; ++kk) mx = fmaxf(mx, row[kk]);
      float sum = 0.f;
      for (int kk = 0; kk < kKeys; ++kk) {
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
    for (int e = tid; e < kRows * d; e += kThreads) {
      const int rr = e / d, c = e % d;
      if (rr < n_rows) {
        float a = os[e] * cs[rr];
        for (int kk = 0; kk < kKeys; ++kk) a += ss[rr * kKeys + kk] * vs[kk * d + c];
        os[e] = a;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int rr = e / d, c = e % d;
    if (rr < n_rows) out[q_off(rr) + c] = from_f32<T>(os[e] / fmaxf(ls[rr], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* table,
                   const int* lengths, void* out, int b, int hq, int hkv, int kq, int d,
                   int n_pages, int bs, int nb, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int row_tiles = (kq * (hq / hkv) + kRows - 1) / kRows;
  dim3 grid(row_tiles, hkv, b);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), table,
      lengths, static_cast<T*>(out), hq, hkv, kq, d, n_pages, bs, nb,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(d))));
  return cudaGetLastError();
}

int run(const void* q, const void* kp, const void* vp, const int* table, const int* lengths,
        void* out, int b, int hq, int hkv, int kq, int d, int n_pages, int bs, int nb,
        int dtype, void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv || kq < 1 || d < 1 || d > 256 || n_pages < 1 || nb < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, kp, vp, table, lengths, out, b, hq, hkv, kq, d, n_pages, bs, nb, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, kp, vp, table, lengths, out, b, hq, hkv, kq, d, n_pages,
                                 bs, nb, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace salaad

// Decode: q / out (B, Hq, D), one query per slot at position lengths[b].
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const int* table, const int* lengths, void* out, int b,
                                      int hq, int hkv, int d, int n_pages, int bs, int nb,
                                      int dtype, void* stream) {
  return salaad::run(q, kp, vp, table, lengths, out, b, hq, hkv, 1, d, n_pages, bs, nb,
                     dtype, stream);
}

// k-query: q / out (B, Hq, kq, D), queries at lengths[b] .. lengths[b] + kq - 1.
extern "C" int paged_attention_kquery_launch(const void* q, const void* kp, const void* vp,
                                             const int* table, const int* lengths, void* out,
                                             int b, int hq, int hkv, int kq, int d,
                                             int n_pages, int bs, int nb, int dtype,
                                             void* stream) {
  return salaad::run(q, kp, vp, table, lengths, out, b, hq, hkv, kq, d, n_pages, bs, nb,
                     dtype, stream);
}
