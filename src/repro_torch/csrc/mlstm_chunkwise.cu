// mLSTM chunkwise recurrence with a carried state, for Hopper (sm_90a).
// Serves every mLSTM call of the slot engine (models/ssm.py mlstm_mix):
// prompt chunks of any length S >= 1 and decode steps (S = 1).
//
// Replaces the TPU kernel mlstm_chunkwise
// (src/repro/kernels/mlstm_chunkwise/kernel.py, _kernel), and reads and
// writes the state it keeps in VMEM scratch. Per (batch row b, head h),
// chunk by chunk of kChunk tokens, with b_t the inclusive cumulative sum of
// log_f inside the chunk and (C, n, m) the state carried in:
//   m_t   = max(b_t + m, max_{s<=t} (b_t - b_s + log_i_s))
//   s_ts  = (q_t . k_s) * exp(b_t - b_s + log_i_s - m_t)       (s <= t)
//   g_t   = exp(b_t + m - m_t)
//   nrm_t = g_t * (q_t . n) + sum_s s_ts
//   h_t   = (g_t * q_t C + sum_s s_ts v_s)
//           / max(max(|nrm_t|, exp(-min(m_t, 30))), 1e-30)
// then the carry: m' = m_{last}, w_s = exp(b_last - b_s + log_i_s - m'),
// C' = exp(b_last + m - m') C + sum_s w_s k_s v_s^T, n' likewise with k_s.
// Masked pairs count zero (the reference's -1e30 logits); s stays fp32 in
// s.v, as in the reference mlstm_mix, which this matches.
//
// Bound on the H100: bytes for decode (each step reads and writes the
// whole fp32 C, 4*D*D*4 bytes a (row, head)); operations for long chunks
// (about 4*S*D*(c + D) flops a (row, head) for chunk c). The state C is
// D x D fp32, 576 KB at D = 384, far above the 227 KB of shared memory a
// block can hold, so the work is tiled over C's value columns: a block
// owns (b, h, DV value columns), keeps its D x DV slice of C in shared
// memory for the whole walk over the chunks, and writes it back in place
// at the end (the columns are its own). The score tile q k^T, the row
// stabilizers and n.q need all of D and the whole chunk, so every value
// tile recomputes them, streaming q and k through shared memory kDK
// columns at a time: D/DV times the score work of one block per head.
// n and m are shared by all value tiles of a head, so each tile keeps a
// private copy, and the new n and m go to output buffers that no block
// reads (tile 0 writes them). This first kernel does its products with
// scalar fp32 FMA from shared memory, far below the tensor-core peak.
#include <algorithm>

#include "paged_common.cuh"

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kChunk = 64;      // tokens per chunk
constexpr int kDK = 32;         // head-dim columns of q and k per stream tile
constexpr int kPad = kDK + 1;   // row stride of the q/k tiles (no conflicts)
constexpr int kMaxDV = 32;      // widest value tile
constexpr int kAccPerThread = kChunk * kMaxDV / kThreads;

struct Strides {   // elements per step of (batch row, token, head)
  long b, s, h;
};

__host__ __device__ inline size_t smem_floats(int D, int DV) {
  return (size_t)D * DV        // C slice
         + D                   // private n
         + kChunk * kChunk     // decayed scores
         + 2 * kChunk * kPad   // q and k stream tiles
         + kChunk * DV         // v tile
         + 5 * kChunk;         // b, log_i, m_t, g_t, nrm_t (w_s reuses g)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_chunkwise_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ log_i,
                       const float* __restrict__ log_f, Strides qs,
                       Strides ks, Strides vs, Strides is, Strides fs,
                       float* __restrict__ C, const float* __restrict__ n_in,
                       const float* __restrict__ m_in,
                       const int* __restrict__ rows, long cb, long nb,
                       long mb, T* __restrict__ h_out,
                       float* __restrict__ n_out, float* __restrict__ m_out,
                       int S, int H, int D, int DV) {
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int j0 = blockIdx.y * DV;
  const int tid = threadIdx.x;
  const long sb = rows ? rows[b] : b;        // state row

  extern __shared__ __align__(16) float smem[];
  float* c_s = smem;                         // [D][DV]
  float* n_s = c_s + (size_t)D * DV;         // [D]
  float* sc = n_s + D;                       // [kChunk][kChunk]
  float* q_s = sc + kChunk * kChunk;         // [kChunk][kPad]
  float* k_s = q_s + kChunk * kPad;          // [kChunk][kPad]
  float* v_s = k_s + kChunk * kPad;          // [kChunk][DV]
  float* b_s = v_s + kChunk * DV;            // [kChunk] cumulative log_f
  float* li_s = b_s + kChunk;                // [kChunk] log_i
  float* m_s = li_s + kChunk;                // [kChunk] row stabilizer
  float* g_s = m_s + kChunk;                 // [kChunk] inter scale, then w
  float* nr_s = g_s + kChunk;                // [kChunk] n.q, then nrm
  __shared__ float m_run;

  float* c_g = C + sb * cb + (long)hh * D * D + j0;
  for (int i = tid; i < D * DV; i += kThreads)
    c_s[i] = c_g[(long)(i / DV) * D + i % DV];
  for (int i = tid; i < D; i += kThreads) n_s[i] = n_in[sb * nb + (long)hh * D + i];
  if (tid == 0) m_run = m_in[sb * mb + hh];

  const T* q_bh = q + b * qs.b + hh * qs.h;
  const T* k_bh = k + b * ks.b + hh * ks.h;
  const T* v_bh = v + b * vs.b + hh * vs.h + j0;
  T* h_bh = h_out + ((long)b * S * H + hh) * D + j0;   // h is [B, S, H, D]
  // score micro-tile of this thread: rows ty + 16 i, columns tx + 16 j
  const int ty = tid / 16, tx = tid % 16;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int L = min(kChunk, S - t0);
    __syncthreads();                         // previous chunk done
    if (tid < L) {
      li_s[tid] = log_i[b * is.b + (long)(t0 + tid) * is.s + hh * is.h];
      b_s[tid] = log_f[b * fs.b + (long)(t0 + tid) * fs.s + hh * fs.h];
    }
    __syncthreads();
    if (tid == 0)
      for (int t = 1; t < L; ++t) b_s[t] += b_s[t - 1];
    __syncthreads();
    const float m0 = m_run;
    if (tid < L) {
      const float bt = b_s[tid];
      const float inter = bt + m0;
      float mx = -3.402823466e38f;
      for (int s = 0; s <= tid; ++s) mx = fmaxf(mx, bt - b_s[s] + li_s[s]);
      mx = fmaxf(inter, mx);
      m_s[tid] = mx;
      g_s[tid] = expf(inter - mx);
    }

    // ---- stream q and k over the head dim: scores, q.C slice, q.n
    float sreg[4][4] = {};
    float acc[kAccPerThread] = {};
    float qn = 0.f;
    const bool any_pair = ty < L && tx < L;
    for (int d0 = 0; d0 < D; d0 += kDK) {
      __syncthreads();                       // tiles free to overwrite
      for (int i = tid; i < kChunk * kDK; i += kThreads) {
        const int t = i / kDK, dd = i % kDK;
        float qv = 0.f, kv = 0.f;
        if (t < L) {
          qv = paged::to_float(q_bh[(long)(t0 + t) * qs.s + d0 + dd]);
          kv = paged::to_float(k_bh[(long)(t0 + t) * ks.s + d0 + dd]);
        }
        q_s[t * kPad + dd] = qv;
        k_s[t * kPad + dd] = kv;
      }
      __syncthreads();
      if (any_pair) {
#pragma unroll 4
        for (int dd = 0; dd < kDK; ++dd) {
          float a[4], c[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = q_s[(ty + 16 * i) * kPad + dd];
            c[i] = k_s[(tx + 16 * i) * kPad + dd];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sreg[i][j] = fmaf(a[i], c[j], sreg[i][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < kAccPerThread; ++r) {
        const int o = tid + r * kThreads;
        if (o < L * DV) {
          const int t = o / DV, j = o % DV;
          const float* qrow = q_s + t * kPad;
          const float* ccol = c_s + (size_t)d0 * DV + j;
          float sum = acc[r];
          for (int dd = 0; dd < kDK; ++dd)
            sum = fmaf(qrow[dd], ccol[dd * DV], sum);
          acc[r] = sum;
        }
      }
      if (tid < L) {
        const float* qrow = q_s + tid * kPad;
        for (int dd = 0; dd < kDK; ++dd) qn = fmaf(qrow[dd], n_s[d0 + dd], qn);
      }
    }

    // ---- decayed scores (zero where masked), the v tile, nrm
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        float val = 0.f;
        if (t < L && s <= t)
          val = sreg[i][j] * expf(b_s[t] - b_s[s] + li_s[s] - m_s[t]);
        sc[t * kChunk + s] = val;
      }
    }
    for (int i = tid; i < kChunk * DV; i += kThreads) {
      const int s = i / DV, j = i % DV;
      v_s[i] = s < L ? paged::to_float(v_bh[(long)(t0 + s) * vs.s + j]) : 0.f;
    }
    if (tid < L) nr_s[tid] = qn;
    __syncthreads();
    if (tid < L) {
      float sum = 0.f;
      for (int s = 0; s <= tid; ++s) sum += sc[tid * kChunk + s];
      nr_s[tid] = g_s[tid] * nr_s[tid] + sum;
    }
    __syncthreads();

    // ---- h for this value tile
#pragma unroll
    for (int r = 0; r < kAccPerThread; ++r) {
      const int o = tid + r * kThreads;
      if (o < L * DV) {
        const int t = o / DV, j = o % DV;
        float pv = 0.f;
        for (int s = 0; s <= t; ++s)
          pv = fmaf(sc[t * kChunk + s], v_s[s * DV + j], pv);
        const float a = g_s[t] * acc[r] + pv;
        const float den = fmaxf(fmaxf(fabsf(nr_s[t]),
                                      expf(-fminf(m_s[t], 30.f))), 1e-30f);
        h_bh[(long)(t0 + t) * H * D + j] = paged::from_float<T>(a / den);
      }
    }
    __syncthreads();                         // g_s, m_s read; reuse g_s

    // ---- carry the state to the next chunk
    const float m_new = m_s[L - 1];
    const float b_last = b_s[L - 1];
    const float decay = expf(b_last + m0 - m_new);
    float* w_s = g_s;
    if (tid < L) w_s[tid] = expf(b_last - b_s[tid] + li_s[tid] - m_new);
    for (int d0 = 0; d0 < D; d0 += kDK) {
      __syncthreads();                       // w ready, k tile free
      for (int i = tid; i < kChunk * kDK; i += kThreads) {
        const int t = i / kDK, dd = i % kDK;
        k_s[t * kPad + dd] =
            t < L ? paged::to_float(k_bh[(long)(t0 + t) * ks.s + d0 + dd])
                  : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < kDK * DV; i += kThreads) {
        const int dd = i / DV, j = i % DV;
        float sum = 0.f;
        for (int s = 0; s < L; ++s)
          sum = fmaf(k_s[s * kPad + dd] * w_s[s], v_s[s * DV + j], sum);
        float* cell = c_s + (size_t)(d0 + dd) * DV + j;
        *cell = decay * *cell + sum;
      }
      if (tid < kDK) {
        float sum = 0.f;
        for (int s = 0; s < L; ++s) sum += k_s[s * kPad + tid] * w_s[s];
        n_s[d0 + tid] = decay * n_s[d0 + tid] + sum;
      }
    }
    __syncthreads();
    if (tid == 0) m_run = m_new;
  }
  __syncthreads();

  for (int i = tid; i < D * DV; i += kThreads)
    c_g[(long)(i / DV) * D + i % DV] = c_s[i];
  if (blockIdx.y == 0) {
    for (int i = tid; i < D; i += kThreads) n_out[((long)b * H + hh) * D + i] = n_s[i];
    if (tid == 0) m_out[(long)b * H + hh] = m_run;
  }
}

// Value-tile width: kMaxDV, halved (down to 8) while the grid of the
// narrower tiles still fits on the SMs, so that a short batch (a prompt
// chunk of one row: B*H = 4 at xlstm-125m) spreads over more SMs.
int value_tile(int BH, int D, int sms) {
  int DV = kMaxDV;
  while (DV > 8 && D % (DV / 2) == 0 && (long)BH * (D / (DV / 2)) <= sms)
    DV /= 2;
  return DV;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_i,
           const float* log_f, Strides qs, Strides ks, Strides vs,
           Strides is, Strides fs, float* C, const float* n_in,
           const float* m_in, const int* rows, long cb, long nb, long mb,
           void* h, float* n_out, float* m_out, int B, int S, int H, int D,
           cudaStream_t stream) {
  if (D % kDK != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || S == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int DV = value_tile(B * H, D, sms);
  const size_t smem = smem_floats(D, DV) * sizeof(float);
  err = paged::reserve_smem(mlstm_chunkwise_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunkwise_kernel<T><<<dim3(B * H, D / DV), kThreads, smem, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), log_i, log_f, qs, ks, vs, is, fs, C,
      n_in, m_in, rows, cb, nb, mb, reinterpret_cast<T*>(h), n_out, m_out,
      S, H, D, DV);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, (batch row, token, head) for q, k, v [B, S, H,
// D] (head-dim stride 1) and for log_i, log_f [B, S, H]. The state C
// [Bs, H, D, D], n [Bs, H, D], m [Bs, H] is fp32 with contiguous rows;
// cb, nb, mb are its batch strides. rows [B] (int32, distinct) maps batch
// row b to state row rows[b], or is null for rows[b] = b. C is updated in
// place; h [B, S, H, D] (contiguous), n_out [B, H, D] and m_out [B, H] are
// allocated by the caller. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue when D is not a multiple of 32.
// Allocates nothing and does not synchronise: the launch goes on `stream`.
int mlstm_chunkwise_launch(
    const void* q, const void* k, const void* v, const float* log_i,
    const float* log_f, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long isb, long long iss,
    long long ish, long long fsb, long long fss, long long fsh, float* C,
    const float* n_in, const float* m_in, const int* rows, long long cb,
    long long nb, long long mb, void* h, float* n_out, float* m_out, int B,
    int S, int H, int D, int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      is{isb, iss, ish}, fs{fsb, fss, fsh};
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, log_i, log_f, qs, ks, vs, is, fs,
                                 C, n_in, m_in, rows, cb, nb, mb, h, n_out,
                                 m_out, B, S, H, D, st);
  return launch<float>(q, k, v, log_i, log_f, qs, ks, vs, is, fs, C, n_in,
                       m_in, rows, cb, nb, mb, h, n_out, m_out, B, S, H, D,
                       st);
}

const char* mlstm_chunkwise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
