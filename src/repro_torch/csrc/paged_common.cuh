// Shared device code of the scalar attention kernels
// (paged_prefill_attention.cu: ragged prefill and speculative-verify rows,
// each over the fused page pool or over split K and V pools;
// chunked_prefill_attention.cu: a query chunk over contiguous K/V rows; in
// bf16 both take attend_wgmma.cuh instead).
// The decode kernels (paged_attention.cu) have their own split-K block and
// use only floordiv, the dtype conversions and reserve_smem from here.
//
// One thread block owns BR query rows of one (batch row, kv head): BQ
// tokens x G heads (row r = t*G + g, the TPU kernel's layout). It walks
// the live key range [key_lo, key_hi), tile_keys keys per tile:
//   1. the tile's K and V rows -> shared memory through the block's KV
//      source (PagedKV: whole pages through the block table, each page's K
//      plane and V plane one contiguous 2*ps*D run in the fused pool;
//      SplitPagedKV: the same pages in two pools; StridedKV: rows at a
//      fixed stride), 16-byte vector loads,
//   2. scores s = q.k * scale, then the softcap, then the mask (the
//      reference's order), masked entries = -1e30 (finite, like the
//      reference: an all-masked tile gives exp(0) = 1, never NaN),
//   3. the fp32 online-softmax carry (m, l) of each row, p rounded to V's
//      dtype before the P.V product,
//   4. acc[row, d] = acc * corr + p.v, the fp32 accumulator in registers.
// Finally out = acc / max(l, 1e-30), or the partial state (acc, m, l). A
// block whose key range is empty writes zeros. Q and K rows are D wide, V
// rows and the output Dv (Dv <= D; MLA's values are narrower than its
// keys); the page pools hold both at one width, Dv = D.
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
                                                      int D, int Dv,
                                                      int elt) {
  return (size_t)(rows + keys) * padded_dim(D, elt) * elt   // q, K tiles
         + (size_t)keys * padded_dim(Dv, elt) * elt         // V tile
         + (size_t)rows * keys * sizeof(float)     // scores / probabilities
         + (size_t)2 * rows * sizeof(float);       // corr, l
}

__host__ __device__ __forceinline__ size_t smem_bytes(int rows, int keys,
                                                      int D, int elt) {
  return smem_bytes(rows, keys, D, D, elt);
}

// KV sources of attend_rows: copy keys [k0, k0 + nk) of one kv head into
// the K tile (rows of D elements padded to DP) and the V tile (Dv padded
// to DVP) in shared memory. The page pools hold K and V at one width: they
// take Dv = D and DVP = DP, and ignore those two.

// The fused page pool; k0 and nk are multiples of ps.
template <typename T>
struct PagedKV {
  const T* kv_head;     // this kv head's pages [P, 2, ps, D]
  const int* bt_row;    // the row's block table
  int ps;

  __device__ __forceinline__ void load(T* k_s, T* v_s, int k0, int nk, int D,
                                       int DP, int, int) const {
    constexpr int VN = 16 / sizeof(T);
    const int dv = D / VN;
    const int per_page = 2 * ps * dv;
    const int p0 = k0 / ps;
    for (int i = threadIdx.x; i < (nk / ps) * per_page; i += kThreads) {
      const int pi = i / per_page, rem = i % per_page;
      const int row = rem / dv, c = rem % dv;   // K rows, then V rows
      const T* src = kv_head + (size_t)bt_row[p0 + pi] * 2 * ps * D +
                     (size_t)row * D + c * VN;
      T* dst = (row < ps ? k_s + (size_t)(pi * ps + row) * DP
                         : v_s + (size_t)(pi * ps + row - ps) * DP) +
               c * VN;
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
};

// Split K and V pools, each [P, ps, D] for this kv head; k0 and nk are
// multiples of ps. A page's K rows and its V rows are each one contiguous
// ps*D run.
template <typename T>
struct SplitPagedKV {
  const T* k_head;      // this kv head's K pages [P, ps, D]
  const T* v_head;      // and its V pages
  const int* bt_row;    // the row's block table
  int ps;

  __device__ __forceinline__ void load(T* k_s, T* v_s, int k0, int nk, int D,
                                       int DP, int, int) const {
    constexpr int VN = 16 / sizeof(T);
    const int dv = D / VN;
    const int per_page = 2 * ps * dv;
    const int p0 = k0 / ps;
    for (int i = threadIdx.x; i < (nk / ps) * per_page; i += kThreads) {
      const int pi = i / per_page, rem = i % per_page;
      const int row = rem / dv, c = rem % dv;   // K rows, then V rows
      const bool is_v = row >= ps;
      const int key = is_v ? row - ps : row;
      const size_t page = (size_t)bt_row[p0 + pi] * ps * D;
      const T* src = (is_v ? v_head : k_head) + page + (size_t)key * D +
                     c * VN;
      T* dst = (is_v ? v_s : k_s) + (size_t)(pi * ps + key) * DP + c * VN;
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
};

// K and V rows at fixed strides (elements between consecutive keys; the
// last axis is contiguous), e.g. a slot cache row [S, Hkv, D] read in place;
// V rows may be narrower than K rows (Dv < D).
template <typename T>
struct StridedKV {
  const T* k;           // key 0 of this (batch row, kv head)
  const T* v;
  long k_stride, v_stride;

  __device__ __forceinline__ void load(T* k_s, T* v_s, int k0, int nk, int D,
                                       int DP, int Dv, int DVP) const {
    constexpr int VN = 16 / sizeof(T);
    const int ck = D / VN, cv = Dv / VN;        // vectors a K / V row
    for (int i = threadIdx.x; i < nk * (ck + cv); i += kThreads) {
      const bool is_v = i >= nk * ck;           // K rows, then V rows
      const int j = is_v ? i - nk * ck : i;
      const int key = is_v ? j / cv : j / ck;
      const int c = is_v ? j % cv : j % ck;
      const T* src = (is_v ? v + (long)(k0 + key) * v_stride
                           : k + (long)(k0 + key) * k_stride) + c * VN;
      T* dst = (is_v ? v_s + (size_t)key * DVP : k_s + (size_t)key * DP) +
               c * VN;
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
};

// One block's work. Row r of the block is token t = r / G, head g = r % G:
// its query sits at q[t * q_tok + g * q_head], its output (Dv wide) at
// out[t * o_tok + g * o_head] (m/l at t * ml_stride + g), its query
// position is q_pos0 + t. Key kp is visible to query position qp when
// kp < length, kp <= qp if causal, and qp - kp < window if window > 0.
template <typename T, typename KV>
__device__ __forceinline__ void attend_rows(
    const T* __restrict__ q, long q_tok, long q_head, void* __restrict__ out,
    long o_tok, long o_head, float* __restrict__ m_out,
    float* __restrict__ l_out, long ml_stride, const KV& kv, int D, int Dv,
    int G, int BR, int q_pos0, int length, bool causal, int window,
    float scale, float softcap, int key_lo, int key_hi, int tile_keys,
    bool partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int VN = 16 / sizeof(T);         // elements per 16-byte vector
  const int tid = threadIdx.x;
  const int KT = tile_keys;
  const int DP = padded_dim(D, sizeof(T));
  const int DVP = padded_dim(Dv, sizeof(T));
  const int dv = D / VN;
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + (size_t)BR * DP;
  T* v_s = k_s + (size_t)KT * DP;
  float* s_s = reinterpret_cast<float*>(v_s + (size_t)KT * DVP);
  float* c_s = s_s + (size_t)BR * KT;
  float* l_s = c_s + BR;

  for (int i = tid; i < BR * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    const T* src = q + (r / G) * q_tok + (r % G) * q_head + c * VN;
    *reinterpret_cast<uint4*>(q_s + r * DP + c * VN) =
        *reinterpret_cast<const uint4*>(src);
  }

  // P.V ownership: column col of rows rg, rg + nrg, ... (Dv <= kThreads).
  const int nrg = kThreads / Dv;
  const int col = tid % Dv;
  const int rg = tid / Dv;
  const int nacc = rg < nrg ? (BR - rg + nrg - 1) / nrg : 0;
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  float m_r = kNegInf, l_r = 0.f;            // softmax carry of row tid

  for (int k0 = key_lo; k0 < key_hi; k0 += KT) {
    const int nk = min(KT, key_hi - k0);
    __syncthreads();   // q_s is loaded; the previous tile is consumed
    kv.load(k_s, v_s, k0, nk, D, DP, Dv, DVP);
    __syncthreads();

    for (int i = tid; i < BR * nk; i += kThreads) {
      const int r = i / nk, k = i % nk;
      float s = dot_row(q_s + (size_t)r * DP, k_s + (size_t)k * DP, D) * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kp = k0 + k;
      const int qp = q_pos0 + r / G;
      bool ok = kp < length && (!causal || kp <= qp);
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
      const float v = nacc > 0 ? to_float(v_s[(size_t)k * DVP + col]) : 0.f;
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
    const long o = (r / G) * o_tok + (r % G) * o_head + col;
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
// [rows, Dv] accumulator spread over the threads at <= kMaxAcc each.
constexpr size_t kSmemLimit = 200 * 1024;

inline int max_rows(int Dv) {
  const int r = kMaxAcc * (kThreads / Dv);
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

// Keys per tile over contiguous K/V (V rows Dv wide): 64, fewer if shared
// memory runs out; 0 if `rows` do not fit a block.
inline int tile_keys(int rows, int D, int Dv, int elt) {
  if (rows < 1 || rows > max_rows(Dv)) return 0;
  int kt = 64;
  while (kt > 1 && smem_bytes(rows, kt, D, Dv, elt) > kSmemLimit) kt /= 2;
  return smem_bytes(rows, kt, D, Dv, elt) <= kSmemLimit ? kt : 0;
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
