// Shared device code of the two fused paged-attention kernels
// (paged_attention.cu: decode rows; paged_prefill_attention.cu: ragged
// prefill and speculative-verify rows).
//
// One thread block owns BR query rows of one (batch row, kv head): the G
// grouped query heads of one token for decode, BQ tokens x G heads for
// prefill (row r = t*G + g, the TPU kernel's layout). It walks the row's
// block table over the live page range [j_lo, j_hi), TP pages per tile:
//   1. the K and V planes of the tile's pages -> shared memory (each page's
//      K plane and V plane are one contiguous 2*ps*D run in the fused pool;
//      16-byte vector loads),
//   2. scores s = q.k * scale, then the softcap, then the mask (the
//      reference's order), masked entries = -1e30 (finite, like the
//      reference: an all-masked tile gives exp(0) = 1, never NaN),
//   3. the fp32 online-softmax carry (m, l) of each row, p rounded to V's
//      dtype before the P.V product,
//   4. acc[row, d] = acc * corr + p.v, the fp32 accumulator in registers.
// Finally out = acc / max(l, 1e-30), or the partial state (acc, m, l).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 256;     // threads per block, both kernels
constexpr int kMaxAcc = 32;       // fp32 accumulators per thread
constexpr float kNegInf = -1e30f;

// Floor division for b > 0: the page bounds use it so that a negative
// shard-local position still rounds toward -inf (C's '/' truncates).
__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (q * b != a && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// fp32 dot product of two D-element rows in shared memory (16-byte aligned).
__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int D) {
  float sum = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
    sum = fmaf(x.z, y.z, sum);
    sum = fmaf(x.w, y.w, sum);
  }
  return sum;
}

__device__ __forceinline__ float dot_row(const __nv_bfloat16* a,
                                         const __nv_bfloat16* b, int D) {
  float sum = 0.f;
  for (int d = 0; d < D; d += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + d);
    const uint4 y = *reinterpret_cast<const uint4*>(b + d);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fx = __bfloat1622float2(x2[i]);
      const float2 fy = __bfloat1622float2(y2[i]);
      sum = fmaf(fx.x, fy.x, sum);
      sum = fmaf(fx.y, fy.y, sum);
    }
  }
  return sum;
}

// Shared-memory layout of one block (the carving at the top of attend_rows).
// Rows are padded by 16 bytes so that neighbouring keys start in different
// banks when the score loop reads one key per thread.
__host__ __device__ __forceinline__ int padded_dim(int D, int elt) {
  return D + 16 / elt;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int rows, int keys,
                                                      int D, int elt) {
  const int DP = padded_dim(D, elt);
  return (size_t)(rows + 2 * keys) * DP * elt      // q, K, V tiles
         + (size_t)rows * keys * sizeof(float)     // scores / probabilities
         + (size_t)2 * rows * sizeof(float);       // corr, l
}

// One block's work. Row r of the block is token t = r / G, head g = r % G:
// its query sits at q[t * tok_stride + g * D], its output at the same
// offset of out (m/l at t * ml_stride + g), its query position is
// q_pos0 + t. kv_head points at this kv head's pages [P, 2, ps, D].
template <typename T>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, long tok_stride, void* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, long ml_stride,
    const T* __restrict__ kv_head, const int* __restrict__ bt_row,
    int ps, int D, int G, int BR, int q_pos0, int length, int window,
    float scale, float softcap, int j_lo, int j_hi, int tile_pages,
    bool partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VN = 16 / sizeof(T);         // elements per 16-byte vector
  const int tid = threadIdx.x;
  const int KT = tile_pages * ps;
  const int DP = padded_dim(D, sizeof(T));
  const int dv = D / VN;
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + (size_t)BR * DP;
  T* v_s = k_s + (size_t)KT * DP;
  float* s_s = reinterpret_cast<float*>(v_s + (size_t)KT * DP);
  float* c_s = s_s + (size_t)BR * KT;
  float* l_s = c_s + BR;

  for (int i = tid; i < BR * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    const T* src = q + (r / G) * tok_stride + (r % G) * D + c * VN;
    *reinterpret_cast<uint4*>(q_s + r * DP + c * VN) =
        *reinterpret_cast<const uint4*>(src);
  }

  // P.V ownership: column col of rows rg, rg + nrg, ... (D <= kThreads).
  const int nrg = kThreads / D;
  const int col = tid % D;
  const int rg = tid / D;
  const int nacc = rg < nrg ? (BR - rg + nrg - 1) / nrg : 0;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  float m_r = kNegInf, l_r = 0.f;            // softmax carry of row tid

  for (int j0 = j_lo; j0 < j_hi; j0 += tile_pages) {
    const int np = min(tile_pages, j_hi - j0);
    const int nk = np * ps;
    __syncthreads();   // q_s is loaded; the previous tile is consumed
    const int per_page = 2 * ps * dv;
    for (int i = tid; i < np * per_page; i += kThreads) {
      const int pi = i / per_page, rem = i % per_page;
      const int row = rem / dv, c = rem % dv;   // K rows, then V rows
      const T* src = kv_head + (size_t)bt_row[j0 + pi] * 2 * ps * D +
                     (size_t)row * D + c * VN;
      T* dst = (row < ps ? k_s + (size_t)(pi * ps + row) * DP
                         : v_s + (size_t)(pi * ps + row - ps) * DP) +
               c * VN;
      *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
    }
    __syncthreads();

    for (int i = tid; i < BR * nk; i += kThreads) {
      const int r = i / nk, k = i % nk;
      float s = dot_row(q_s + (size_t)r * DP, k_s + (size_t)k * DP, D) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kp = j0 * ps + k;
      const int qp = q_pos0 + r / G;
      bool ok = kp <= qp && kp < length;
      if (window > 0) ok = ok && (qp - kp < window);
      s_s[(size_t)r * KT + k] = ok ? s : kNegInf;
    }
    __syncthreads();

    if (tid < BR) {
      float* srow = s_s + (size_t)tid * KT;
      float mx = m_r;
      for (int k = 0; k < nk; ++k) mx = fmaxf(mx, srow[k]);
      float sum = 0.f;
      for (int k = 0; k < nk; ++k) {
        const float p = expf(srow[k] - mx);
        sum += p;
        srow[k] = to_float(from_float<T>(p));
      }
      const float corr = expf(m_r - mx);
      l_r = l_r * corr + sum;
      m_r = mx;
      c_s[tid] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      if (i >= nacc) break;
      acc[i] *= c_s[rg + i * nrg];
    }
    for (int k = 0; k < nk; ++k) {
      const float v = nacc > 0 ? to_float(v_s[(size_t)k * DP + col]) : 0.f;
#pragma unroll
      for (int i = 0; i < kMaxAcc; ++i) {
        if (i >= nacc) break;
        acc[i] = fmaf(s_s[(size_t)(rg + i * nrg) * KT + k], v, acc[i]);
      }
    }
  }

  if (tid < BR) {
    l_s[tid] = l_r;
    if (partial) {
      const long o = (tid / G) * ml_stride + tid % G;
      m_out[o] = m_r;
      l_out[o] = l_r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    if (i >= nacc) break;
    const int r = rg + i * nrg;
    const long o = (r / G) * tok_stride + (r % G) * D + col;
    if (partial) {
      reinterpret_cast<float*>(out)[o] = acc[i];
    } else {
      reinterpret_cast<T*>(out)[o] =
          from_float<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

// Launch geometry, chosen by the launchers (the only owners of the layout
// above). Query rows one block holds: one softmax thread per row, and the
// [rows, D] accumulator spread over the threads at <= kMaxAcc each.
constexpr size_t kSmemLimit = 200 * 1024;

inline int max_rows(int D) {
  const int r = kMaxAcc * (kThreads / D);
  return r < kThreads ? r : kThreads;
}

// Pages per tile: about 64 keys, fewer if shared memory runs out; 0 if
// `rows` do not fit a block or one page does not fit shared memory.
inline int tile_pages(int rows, int ps, int D, int elt) {
  if (rows < 1 || rows > max_rows(D)) return 0;
  int tp = 64 / ps > 1 ? 64 / ps : 1;
  while (tp > 1 && smem_bytes(rows, tp * ps, D, elt) > kSmemLimit) tp /= 2;
  return smem_bytes(rows, tp * ps, D, elt) <= kSmemLimit ? tp : 0;
}

// Raise the dynamic shared-memory limit of a kernel when a launch needs
// more than the default 48 KB.
template <typename Kernel>
inline cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged
