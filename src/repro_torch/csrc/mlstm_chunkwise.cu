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
// s.v, as in the reference mlstm_mix, which this matches. The exponents
// are formed in the reference's order of operations.
//
// Three paths, chosen by the launcher:
//
// 1. Decode, S = 1 (both dtypes; most of the serving launches). The work
//    is a GEMV q.C and a rank-1 update of C: bound by bytes, C read once
//    and written once (2 x D*D*4 bytes a (row, head)). A block owns (b, h,
//    kDecCols columns of C): every thread forms q.k, q.n and the gates
//    (D-length dots, once a block), streams its rows of the block's
//    columns with 16-byte loads, adds q_i C_ij into its partial q.C and
//    writes decay*C_ij + (k_i w) v_j back in the same pass; the partials
//    of the row groups are summed in shared memory. One launch.
//
// 2. Chunks in bf16, S > 1: the chunkwise-parallel form, three launches.
//    a. Gate pass, a block a (chunk, b, h), all in parallel: the in-chunk
//       cumulative sums b_t, each token's row max over the chunk (max_s
//       of b_t - b_s + log_i_s) and the chunk's raw scores Q K^T on the
//       tensor cores (64 x 64 over D in slices of 64), once a chunk and
//       head, into fp32 scratch.
//    b. State pass, a block a (b, h, 64 rows x 64 columns of C), 4 warps:
//       the scalar m chain across chunks (one thread, from each chunk's b
//       and row max at its last token), then the chunks in order with the
//       C tile in mma accumulators: write the chunk's starting C to
//       scratch as two bf16 planes (hi, lo: see below) and its n (the
//       column-0 tiles; n is C's extra column with v = 1, an n-block of
//       ones), then C <- decay*C + (k w)^T V on the tensor cores. Only
//       this product is on the serial chain: the next chunk's k*w (w from
//       the chain) is formed while it runs, and K and V stream in through
//       a three-stage cp.async ring, one __syncthreads a chunk. C, n_out
//       and m_out are written at the end.
//    c. Output pass, a block a (chunk, b, h, 64 columns of h), all in
//       parallel: the m chain up to the chunk, m_t and g_t, the raw scores
//       decayed and masked in registers and kept as hi/lo bf16 planes with
//       their row sums; then Q C_c over D in slices of 64 (C_c's hi and lo
//       planes through a two-stage cp.async ring; q.n on the side), and
//       h = (g * Q C_c + S V) / den in bf16.
//    Scratch, allocated by the wrapper: the chunk-start states, nc x 2 x
//    D*D bf16 and nc x D fp32 a (row, head) (75.5 MB at B1 S2048 D 384),
//    and the gate pass's per-token values and raw scores (3 x 64 + 2 +
//    4096 floats a chunk).
//
// 3. Chunks in fp32, S > 1 (the smoke configs and the parity cases, on no
//    serving path at full width): a scalar loop.
//    A block owns (b, h, DV value columns), keeps its D x DV slice of C
//    in shared memory for the walk over the chunks, and recomputes the
//    score tile in every value tile, with scalar fp32 FMA. Its limit
//    (2e-5 + 2e-5|ref| on h) rules out bf16 operands.
//
// Precision of the bf16 chunk path. q, k and v are exact in bf16, so Q K^T
// and the products with V take bf16 operands as they are (exact products,
// fp32 sums). The operands that are fp32 take an error-compensated split,
// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), and two mma.sync into
// one fp32 accumulator (relative error about 2^-16 of each product): k*w
// in the state update, C_c in q.C_c and the decayed scores s in s.v. Plain
// bf16 (2^-8) or TF32 (2^-11) in the C update would miss the state's limit
// (1e-5 + 1e-4|ref|). q.n is an fp32 FMA dot product.
#include <algorithm>

#include "attend_mma.cuh"
#include "paged_common.cuh"

// Diagnostic cuts (tools/mlstm_variants.py builds the source with
// -DMLSTM_CUT=1 or 2): 1 issues none of the streamed loads of the decode,
// state and output passes, 2 none of their products; the results are then
// wrong and only the times mean anything.
#ifndef MLSTM_CUT
#define MLSTM_CUT 0
#endif

namespace {

using bf16 = __nv_bfloat16;
constexpr bool kLoads = MLSTM_CUT != 1;
constexpr bool kCompute = MLSTM_CUT != 2;

constexpr int kChunk = 64;      // tokens per chunk, every path

struct Strides {   // elements per step of (batch row, token, head)
  long b, s, h;
};

// ---------------------------------------------------------------------------
// 1. decode
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 256;
constexpr int kDecCols = 32;                    // C columns a block
constexpr int kDecGroups = kDecCols / 4;        // float4 column groups
constexpr int kDecRowGroups = kDecThreads / kDecGroups;
constexpr int kMaxD = 1024;

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int warp = threadIdx.x / 32;
  __syncthreads();                              // red free to overwrite
  if (threadIdx.x % 32 == 0) red[warp] = x;
  __syncthreads();
  float sum = 0.f;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) sum += red[w];
  return sum;
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
mlstm_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ log_i,
                    const float* __restrict__ log_f, Strides qs, Strides ks,
                    Strides vs, Strides is, Strides fs, float* __restrict__ C,
                    const float* __restrict__ n_in,
                    const float* __restrict__ m_in,
                    const int* __restrict__ rows, long cb, long nb, long mb,
                    T* __restrict__ h_out, float* __restrict__ n_out,
                    float* __restrict__ m_out, int H, int D) {
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const int j0 = blockIdx.y * kDecCols;
  const int tid = threadIdx.x;
  const long sb = rows ? rows[b] : b;           // state row
  __shared__ float q_s[kMaxD], k_s[kMaxD];
  __shared__ float red[kDecThreads / 32];
  __shared__ __align__(16) float part[kDecRowGroups][kDecCols];

  const T* q_bh = q + b * qs.b + hh * qs.h;
  const T* k_bh = k + b * ks.b + hh * ks.h;
  const float* n_bh = n_in + sb * nb + (long)hh * D;
  float qk = 0.f, qn = 0.f;
  for (int i = tid; i < D; i += kDecThreads) {
    const float qv = paged::to_float(q_bh[i]);
    const float kv = paged::to_float(k_bh[i]);
    q_s[i] = qv;
    k_s[i] = kv;
    qk = fmaf(qv, kv, qk);
    qn = fmaf(qv, n_bh[i], qn);
  }
  qk = block_sum(qk, red);
  qn = block_sum(qn, red);

  // the gates of one token (b_0 = log_f, so b_t - b_s + log_i_s = log_i)
  const float li = log_i[b * is.b + hh * is.h];
  const float lf = log_f[b * fs.b + hh * fs.h];
  const float inter = lf + m_in[sb * mb + hh];
  const float m_new = fmaxf(inter, li);
  const float g = expf(inter - m_new);          // also the carry's decay
  const float s = qk * expf(li - m_new);
  const float w = expf(li - m_new);
  const float nrm = g * qn + s;
  const float den =
      fmaxf(fmaxf(fabsf(nrm), expf(-fminf(m_new, 30.f))), 1e-30f);

  // stream the block's columns of C: partial q.C, then C in place
  const int cg = tid % kDecGroups, rg = tid / kDecGroups;
  const int j = j0 + 4 * cg;
  const T* v_bh = v + b * vs.b + hh * vs.h;
  const float v0 = paged::to_float(v_bh[j]), v1 = paged::to_float(v_bh[j + 1]);
  const float v2 = paged::to_float(v_bh[j + 2]);
  const float v3 = paged::to_float(v_bh[j + 3]);
  float* c_bh = C + sb * cb + (long)hh * D * D + j;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = rg; i < D; i += kDecRowGroups) {
    float4* cell = reinterpret_cast<float4*>(c_bh + (long)i * D);
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kLoads) c = *cell;
    if (kCompute) {
      const float qi = q_s[i];
      const float kw = __fmul_rn(k_s[i], w);    // the reference's k * w
      acc.x = fmaf(qi, c.x, acc.x);
      acc.y = fmaf(qi, c.y, acc.y);
      acc.z = fmaf(qi, c.z, acc.z);
      acc.w = fmaf(qi, c.w, acc.w);
      c.x = __fadd_rn(__fmul_rn(g, c.x), __fmul_rn(kw, v0));
      c.y = __fadd_rn(__fmul_rn(g, c.y), __fmul_rn(kw, v1));
      c.z = __fadd_rn(__fmul_rn(g, c.z), __fmul_rn(kw, v2));
      c.w = __fadd_rn(__fmul_rn(g, c.w), __fmul_rn(kw, v3));
    }
    *cell = c;
  }
  *reinterpret_cast<float4*>(&part[rg][4 * cg]) = acc;
  __syncthreads();
  if (tid < kDecCols) {
    float qc = 0.f;
    for (int r = 0; r < kDecRowGroups; ++r) qc += part[r][tid];
    const float a = g * qc + s * paged::to_float(v_bh[j0 + tid]);
    h_out[((long)b * H + hh) * D + j0 + tid] = paged::from_float<T>(a / den);
  }
  if (blockIdx.y == 0) {
    for (int i = tid; i < D; i += kDecThreads)
      n_out[((long)b * H + hh) * D + i] =
          __fadd_rn(__fmul_rn(g, n_bh[i]), __fmul_rn(k_s[i], w));
    if (tid == 0) m_out[(long)b * H + hh] = m_new;
  }
}

// ---------------------------------------------------------------------------
// 2. the bf16 chunk passes
// ---------------------------------------------------------------------------
// bf16 tiles of 64 rows in shared memory, rows padded by 16 bytes so that
// ldmatrix is conflict-free (the pitch of attend_mma.cuh)
constexpr int kTile = 64;
constexpr int kPitch = kTile + 8;
constexpr int kTileElems = kTile * kPitch;

// Scratch of the gate pass, per (b, h), in floats: kTokenFields arrays of
// Sp = nc * kChunk per-token values (zero past S), each chunk's b and row
// max at its last token (padded to 4 floats), and each chunk's raw scores
// Q K^T [kChunk][kChunk]. Every (b, h) starts 16-byte aligned.
enum TokenField { kB = 0, kLi = 1, kX = 2, kTokenFields = 3 };

__host__ __device__ inline long gate_floats(int nc) {
  return (long)kTokenFields * nc * kChunk + ((2 * nc + 3) & ~3) +
         (long)nc * kChunk * kChunk;
}

struct GateView {            // one (b, h) of the gate scratch
  float* tok;                // [kTokenFields][Sp]
  float* last;               // [nc][2]: b, row max at the chunk's last token
  float* scores;             // [nc][kChunk][kChunk]
  int Sp;

  __device__ GateView(float* gates, int bh, int nc) {
    Sp = nc * kChunk;
    tok = gates + (long)bh * gate_floats(nc);
    last = tok + (long)kTokenFields * Sp;
    scores = last + ((2 * nc + 3) & ~3);
  }
};

// The scalar m chain of one (b, h) from its chunks' (b_last, row max) in
// shared memory: m_s[c] is the m carried into chunk c, m_s[nc] the final
// one (m' = max(b_last + m, row max)). One thread, nc steps.
__device__ __forceinline__ void m_chain(const float* last_s, float m, int nc,
                                        float* m_s) {
  for (int c = 0; c < nc; ++c) {
    m_s[c] = m;
    m = fmaxf(last_s[2 * c] + m, last_s[2 * c + 1]);
  }
  m_s[nc] = m;
}

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of a bf16 matrix (row i at
// src + i * stride) -> tile; rows >= r_hi and columns >= c_hi zero-filled.
// 16-byte copies: stride, c0 and the source 8-element aligned.
template <int kThreadsT>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long stride, int r0, int r_hi,
                                          int c0, int c_hi) {
#pragma unroll
  for (int i = threadIdx.x; i < kTile * (kTile / 8); i += kThreadsT) {
    const int r = i / (kTile / 8), c = (i % (kTile / 8)) * 8;
    const bool live = r0 + r < r_hi && c0 + c < c_hi;
    const bf16* p = live ? src + (long)(r0 + r) * stride + c0 + c : src;
    if (kLoads) mma::cp_async16(tile + r * kPitch + c, p, live ? 16 : 0);
  }
}

// n floats (a multiple of 4, 16-byte aligned) -> shared memory
template <int kThreadsT>
__device__ __forceinline__ void load_floats(float* dst, const float* src,
                                            int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreadsT)
    if (kLoads) mma::cp_async16(dst + i, src + i, 16);
}

// x = hi + lo, both bf16, packed in pairs (the first in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = mma::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// 8 warps over a 64-row tile: warp w owns rows 16 * (w % 4) and columns
// 32 * (w / 4) of a 64 x 64 product, four n-blocks of 8.
constexpr int kWideThreads = 256;

// acc[4][4] += A B for one 64-deep step: A [64][64] row-major (rows = the
// tile's tokens), B either row-major [n][k] (K of Q K^T, ldmatrix) or
// [k][n] (C's rows or V, ldmatrix.trans); B2, when given, a second B
// plane into the same accumulators (the lo half of a split).
template <bool kTrans>
__device__ __forceinline__ void mma_step(float (&acc)[4][4], const bf16* a,
                                         const bf16* b, const bf16* b2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp % 4, ch = warp / 4;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, a + (16 * rb + (lane & 15)) * kPitch + kk * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int nb = 0; nb < 4; nb += 2) {
      const int off =
          kTrans ? (kk * 16 + (lane & 15)) * kPitch + 32 * ch + nb * 8 +
                       (lane >> 4) * 8
                 : (32 * ch + nb * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                           kPitch +
                       kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t bf[4];
      if (kTrans)
        mma::ldmatrix_x4_trans(bf, b + off);
      else
        mma::ldmatrix_x4(bf, b + off);
      mma::mma_bf16(acc[nb], af, bf[0], bf[1]);
      mma::mma_bf16(acc[nb + 1], af, bf[2], bf[3]);
      if (b2) {
        uint32_t bl[4];
        mma::ldmatrix_x4_trans(bl, b2 + off);
        mma::mma_bf16(acc[nb], af, bl[0], bl[1]);
        mma::mma_bf16(acc[nb + 1], af, bl[2], bl[3]);
      }
    }
  }
}

struct GateSmem {
  bf16 ring[2][2][kTileElems];     // Q and K slices, two stages
  float b[kChunk], li[kChunk];
};

// 2a. grid (nc, B*H), all chunks in parallel: the chunk's in-chunk sums
// b_t (one lane's serial sum, as the reference's order), each token's row
// max over the chunk, and the raw scores Q K^T on the tensor cores over D
// in slices of 64.
__global__ void __launch_bounds__(kWideThreads)
mlstm_gate_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const float* __restrict__ log_i,
                  const float* __restrict__ log_f, Strides qs, Strides ks,
                  Strides is, Strides fs, float* __restrict__ gates, int S,
                  int H, int D, int nc) {
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int t0 = c * kChunk, L = min(kChunk, S - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4, rb = warp % 4, ch = warp / 4;
  extern __shared__ __align__(16) unsigned char gate_raw[];
  GateSmem& sm = *reinterpret_cast<GateSmem*>(gate_raw);
  const GateView gv(gates, bh, nc);
  const bf16* q_bc = q + b * qs.b + t0 * qs.s + hh * qs.h;
  const bf16* k_bc = k + b * ks.b + t0 * ks.s + hh * ks.h;
  const int ns = (D + kTile - 1) / kTile;
  auto load = [&](int step, int st) {
    load_tile<kWideThreads>(sm.ring[st][0], q_bc, qs.s, 0, L, step * kTile, D);
    load_tile<kWideThreads>(sm.ring[st][1], k_bc, ks.s, 0, L, step * kTile, D);
  };
  load(0, 0);
  mma::cp_async_commit();

  if (warp == 0) {
    for (int u = lane; u < kChunk; u += 32) {
      const bool live = u < L;
      sm.li[u] = live ? log_i[b * is.b + (long)(t0 + u) * is.s + hh * is.h]
                      : 0.f;
      sm.b[u] = live ? log_f[b * fs.b + (long)(t0 + u) * fs.s + hh * fs.h]
                     : 0.f;
    }
    __syncwarp();
    if (lane == 0)
      for (int u = 1; u < L; ++u) sm.b[u] += sm.b[u - 1];
    __syncwarp();
    for (int u = lane; u < kChunk; u += 32) {
      const float bt = sm.b[u];
      float x = 0.f;
      if (u < L) {
        x = -3.402823466e38f;
        for (int s = 0; s <= u; ++s) x = fmaxf(x, bt - sm.b[s] + sm.li[s]);
      }
      gv.tok[kB * gv.Sp + t0 + u] = bt;
      gv.tok[kLi * gv.Sp + t0 + u] = sm.li[u];
      gv.tok[kX * gv.Sp + t0 + u] = x;
      if (u == L - 1) {
        gv.last[2 * c] = bt;
        gv.last[2 * c + 1] = x;
      }
    }
  }

  float acc[4][4] = {};
  for (int step = 0; step < ns; ++step) {
    const int st = step & 1;
    if (step + 1 < ns) load(step + 1, st ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();                            // the step's slices landed
    if (kCompute)
      mma_step<false>(acc, sm.ring[st][0], sm.ring[st][1], nullptr);
    __syncthreads();                            // stage st free to refill
  }
  mma::cp_async_wait<0>();
  float* sc = gv.scores + (long)c * kChunk * kChunk;
  const int r0 = 16 * rb + gq;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int s0 = 32 * ch + nb * 8 + 2 * tq;
    *reinterpret_cast<float2*>(sc + r0 * kChunk + s0) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(sc + (r0 + 8) * kChunk + s0) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
}

constexpr int kStateThreads = 256;   // 8 warps: 16 rows x 32 columns each
constexpr int kStateStages = 3;      // chunks of K and V in flight
constexpr uint32_t kOnes = 0x3F803F80u;     // two bf16 1.0

// Shared memory of the state pass: a ring of K and V tiles with their
// tokens' b and log_i, the hi/lo planes of k * w and w for two chunks, the
// chunk-start C tile's hi/lo planes on their way to scratch, and
// (an nc-sized tail) the chunks' (b_last, row max), the m chain and the
// chunks' decays.
struct StateSmem {
  bf16 k_s[kStateStages][kTileElems], v_s[kStateStages][kTileElems];
  bf16 khi[2][kTileElems], klo[2][kTileElems];
  bf16 chi[kTileElems], clo[kTileElems];   // the chunk-start tile, staged
  float bt[kStateStages][kChunk], lt[kStateStages][kChunk];
  float w[2][kChunk];
};

__host__ __device__ inline size_t state_smem(int nc) {
  return sizeof(StateSmem) + (2 * (size_t)nc + 4 + 2 * nc + 1) * sizeof(float);
}

// 2b. grid (B*H, row tiles, column tiles). Two __syncthreads a chunk: at the
// top of chunk c the planes of c (formed during c - 1) and the K/V of c + 1
// are ready; chunk c forms w of c + 1 (64 exps), splits its starting state
// into shared memory and issues its product, then (second barrier) writes
// the staged state to scratch in 16-byte rows (a thread's accumulator
// fragments are 4-byte pieces of 8 rows: written as they are, they took
// 0.07 ms of the 0.23 at B1 S2048 on an H100) and forms the planes of c + 1 while the
// product runs.
__global__ void __launch_bounds__(kStateThreads)
mlstm_state_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   Strides ks, Strides vs, float* __restrict__ C,
                   const float* __restrict__ n_in,
                   const float* __restrict__ m_in,
                   const int* __restrict__ rows, long cb, long n_stride,
                   long mb, const float* __restrict__ gates,
                   bf16* __restrict__ c_scr, float* __restrict__ n_scr,
                   float* __restrict__ n_out, float* __restrict__ m_out,
                   int S, int H, int D, int nc) {
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.z * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4, rb = warp % 4, ch = warp / 4;
  const bool with_n = blockIdx.z == 0 && ch == 0;   // n: one warp a row block
  const long sb = rows ? rows[b] : b;
  const GateView gv(const_cast<float*>(gates), bh, nc);
  const int r_lo = i0 + rb * 16 + gq;             // this thread's rows
  const int c_lo = j0 + ch * 32 + 2 * tq;         // and first column
  const bool active = i0 + rb * 16 < D;
  extern __shared__ __align__(16) unsigned char state_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(state_raw);
  float* last_s = reinterpret_cast<float*>(state_raw + sizeof(StateSmem));
  float* m_s = last_s + ((2 * nc + 3) & ~3);      // [nc + 1]
  float* dec_s = m_s + nc + 1;                    // [nc]

  const bf16* k_bh = k + b * ks.b + hh * ks.h;
  const bf16* v_bh = v + b * vs.b + hh * vs.h;
  auto load = [&](int c) {
    const int st = c % kStateStages, t0 = c * kChunk, L = min(kChunk, S - t0);
    load_tile<kStateThreads>(sm.k_s[st], k_bh + t0 * ks.s, ks.s, 0, L, i0, D);
    load_tile<kStateThreads>(sm.v_s[st], v_bh + t0 * vs.s, vs.s, 0, L, j0, D);
    load_floats<kStateThreads>(sm.bt[st], gv.tok + kB * gv.Sp + t0, kChunk);
    load_floats<kStateThreads>(sm.lt[st], gv.tok + kLi * gv.Sp + t0, kChunk);
  };
  // w_s = exp(b_last - b_s + log_i_s - m') of chunk c's tokens (0 past S)
  auto weights = [&](int c) {
    const int st = c % kStateStages, L = min(kChunk, S - c * kChunk);
    if (tid < kChunk)
      sm.w[c & 1][tid] =
          tid < L ? expf(last_s[2 * c] - sm.bt[st][tid] + sm.lt[st][tid] -
                         m_s[c + 1])
                  : 0.f;
  };
  // k * w of chunk c -> hi and lo planes (the reference's fp32 product,
  // then split)
  auto planes = [&](int c) {
    const int st = c % kStateStages;
    const float* w = sm.w[c & 1];
    bf16* hi_p = sm.khi[c & 1];
    bf16* lo_p = sm.klo[c & 1];
#pragma unroll 4
    for (int it = 0; it < kTile * kTile / 2 / kStateThreads; ++it) {
      const int i = tid + it * kStateThreads;
      const int s = i / (kTile / 2), col = (i % (kTile / 2)) * 2;
      const __nv_bfloat162 kk = *reinterpret_cast<const __nv_bfloat162*>(
          &sm.k_s[st][s * kPitch + col]);
      uint32_t hi, lo;
      split2(__low2float(kk) * w[s], __high2float(kk) * w[s], hi, lo);
      *reinterpret_cast<uint32_t*>(&hi_p[s * kPitch + col]) = hi;
      *reinterpret_cast<uint32_t*>(&lo_p[s * kPitch + col]) = lo;
    }
  };

  load(0);
  mma::cp_async_commit();
  if (nc > 1) load(1);
  mma::cp_async_commit();
  for (int i = tid; i < 2 * nc; i += kStateThreads) last_s[i] = gv.last[i];
  __syncthreads();
  if (tid == 0) {
    m_chain(last_s, m_in[sb * mb + hh], nc, m_s);
    for (int c = 0; c < nc; ++c)   // exp(b_last + m - m')
      dec_s[c] = expf(last_s[2 * c] + m_s[c] - m_s[c + 1]);
  }

  // the C tile in accumulators: rows r_lo, r_lo + 8; columns c_lo + 8*nb
  // (+1); n likewise in an n-block of ones
  float acc[4][4], nacc[4];
  float* c_bh = C + sb * cb + (long)hh * D * D;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = c_lo + nb * 8;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float2 cv = make_float2(0.f, 0.f);
      if (active && col < D)
        cv = *reinterpret_cast<const float2*>(c_bh + (long)(r_lo + 8 * x) * D +
                                              col);
      acc[nb][2 * x] = cv.x;
      acc[nb][2 * x + 1] = cv.y;
    }
  }
  {
    const float* n_bh = n_in + sb * n_stride + (long)hh * D;
    const float n0 = active ? n_bh[r_lo] : 0.f;
    const float n1 = active ? n_bh[r_lo + 8] : 0.f;
    nacc[0] = nacc[1] = n0;
    nacc[2] = nacc[3] = n1;
  }
  mma::cp_async_wait<1>();
  __syncthreads();                                // chunk 0 and the chain
  weights(0);
  __syncthreads();
  planes(0);

  for (int c = 0; c < nc; ++c) {
    mma::cp_async_wait<0>();
    __syncthreads();   // planes of c and K/V of c + 1 ready; c - 1 done
    if (c + 2 < nc) load(c + 2);
    mma::cp_async_commit();
    if (c + 1 < nc) weights(c + 1);
    if (active) {
      // the chunk's starting state -> shared memory as hi/lo planes
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          uint32_t hi, lo;
          split2(acc[nb][2 * x], acc[nb][2 * x + 1], hi, lo);
          const int o = (rb * 16 + gq + 8 * x) * kPitch + ch * 32 + nb * 8 +
                        2 * tq;
          *reinterpret_cast<uint32_t*>(&sm.chi[o]) = hi;
          *reinterpret_cast<uint32_t*>(&sm.clo[o]) = lo;
        }
      }
      if (with_n && tq == 0) {
        float* nc_out = n_scr + ((long)bh * nc + c) * D;
        nc_out[r_lo] = nacc[0];
        nc_out[r_lo + 8] = nacc[2];
      }
      const float decay = dec_s[c];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[nb][x] *= decay;
#pragma unroll
      for (int x = 0; x < 4; ++x) nacc[x] *= decay;
      // C += (k w)^T V: A = (k w)^T from the [s][i] planes (ldmatrix.trans),
      // B = V [s][j] (ldmatrix.trans), hi and lo into one accumulator
      if (kCompute) {
        const bf16* hi_p = sm.khi[c & 1];
        const bf16* lo_p = sm.klo[c & 1];
        const bf16* v_t = sm.v_s[c % kStateStages];
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          uint32_t ahi[4], alo[4];
          const int arow = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int acol = rb * 16 + ((lane >> 3) & 1) * 8;
          mma::ldmatrix_x4_trans(ahi, hi_p + arow * kPitch + acol);
          mma::ldmatrix_x4_trans(alo, lo_p + arow * kPitch + acol);
#pragma unroll
          for (int nb = 0; nb < 4; nb += 2) {
            uint32_t bv[4];
            mma::ldmatrix_x4_trans(bv, v_t + (kk * 16 + (lane & 15)) * kPitch +
                                           ch * 32 + nb * 8 + (lane >> 4) * 8);
            mma::mma_bf16(acc[nb], ahi, bv[0], bv[1]);
            mma::mma_bf16(acc[nb], alo, bv[0], bv[1]);
            mma::mma_bf16(acc[nb + 1], ahi, bv[2], bv[3]);
            mma::mma_bf16(acc[nb + 1], alo, bv[2], bv[3]);
          }
          if (with_n) {
            mma::mma_bf16(nacc, ahi, kOnes, kOnes);
            mma::mma_bf16(nacc, alo, kOnes, kOnes);
          }
        }
      }
    }
    __syncthreads();                      // w of c + 1, staged state ready
    {
      // the staged tile -> scratch, rows of 64 bf16 in 16-byte pieces
      bf16* chi = c_scr + ((long)bh * nc + c) * 2 * D * D;
#pragma unroll
      for (int it = 0; it < 2 * kTile * kTile / 8 / kStateThreads; ++it) {
        const int i = tid + it * kStateThreads;
        const int plane = i / (kTile * kTile / 8);
        const int r = (i / (kTile / 8)) % kTile, c8 = (i % (kTile / 8)) * 8;
        if (i0 + r < D && j0 + c8 < D && kLoads)
          *reinterpret_cast<uint4*>(chi + (long)plane * D * D +
                                    (long)(i0 + r) * D + j0 + c8) =
              *reinterpret_cast<const uint4*>(
                  (plane ? sm.clo : sm.chi) + r * kPitch + c8);
      }
    }
    if (c + 1 < nc) planes(c + 1);
  }
  mma::cp_async_wait<0>();
  if (blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) m_out[bh] = m_s[nc];
  if (!active) return;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = c_lo + nb * 8;
    if (col >= D) continue;
#pragma unroll
    for (int x = 0; x < 2; ++x)
      *reinterpret_cast<float2*>(c_bh + (long)(r_lo + 8 * x) * D + col) =
          make_float2(acc[nb][2 * x], acc[nb][2 * x + 1]);
  }
  if (with_n && tq == 0) {
    float* n_o = n_out + (long)bh * D;
    n_o[r_lo] = nacc[0];
    n_o[r_lo + 8] = nacc[2];
  }
}

// Shared memory of the output pass: a three-stage ring of Q and C_c's hi
// and lo slices (two blocks an SM fit), the V tile, the score planes, the chunk's per-token gates and
// row terms, and the chunks' (b_last, row max) (nc-sized tail).
constexpr int kOutStages = 3;

struct OutSmem {
  bf16 ring[kOutStages][3][kTileElems];
  float n_s[kOutStages][kTile];    // the slice's n_c
  bf16 vt[kTileElems];
  bf16 shi[kTileElems], slo[kTileElems];
  float b[kChunk], li[kChunk], x[kChunk], m[kChunk], g[kChunk];
  float rsum[2][kChunk];           // row sums of s, per column half
  float qn[kChunk], den[kChunk];
  float m0;
};

__host__ __device__ inline size_t out_smem(int nc) {
  return sizeof(OutSmem) + ((2 * (size_t)nc + 3) & ~(size_t)3) * sizeof(float);
}

// 2c. grid (nc, B*H, column tiles of h), all in parallel. The chunk's raw
// scores come from the gate pass, decayed with the m chain up to the chunk;
// then Q C_c over D in slices of 64 for the block's 64 columns, q.n on the
// side, and s V.
__global__ void __launch_bounds__(kWideThreads)
mlstm_output_kernel(const bf16* __restrict__ q, const bf16* __restrict__ v,
                    Strides qs, Strides vs, const float* __restrict__ m_in,
                    const int* __restrict__ rows, long mb,
                    const float* __restrict__ gates,
                    const bf16* __restrict__ c_scr,
                    const float* __restrict__ n_scr, bf16* __restrict__ h_out,
                    int S, int H, int D, int nc) {
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int j0 = blockIdx.z * kTile;
  const int t0 = c * kChunk, L = min(kChunk, S - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4, rb = warp % 4, ch = warp / 4;
  const long sb = rows ? rows[b] : b;
  extern __shared__ __align__(16) unsigned char out_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(out_raw);
  float* last_s = reinterpret_cast<float*>(out_raw + sizeof(OutSmem));
  const GateView gv(const_cast<float*>(gates), bh, nc);

  const bf16* q_bc = q + b * qs.b + t0 * qs.s + hh * qs.h;
  const bf16* v_bc = v + b * vs.b + t0 * vs.s + hh * vs.h;
  const bf16* chi = c_scr + ((long)bh * nc + c) * 2 * D * D;
  const bf16* clo = chi + (long)D * D;
  const float* n_c = n_scr + ((long)bh * nc + c) * D;
  const int ns = (D + kTile - 1) / kTile;
  auto load = [&](int step, int st) {
    const int i0 = step * kTile;
    load_tile<kWideThreads>(sm.ring[st][0], q_bc, qs.s, 0, L, i0, D);
    load_tile<kWideThreads>(sm.ring[st][1], chi, D, i0, D, j0, D);
    load_tile<kWideThreads>(sm.ring[st][2], clo, D, i0, D, j0, D);
    load_floats<kWideThreads>(sm.n_s[st], n_c + i0, min(kTile, D - i0));
  };
  load(0, 0);
  load_tile<kWideThreads>(sm.vt, v_bc, vs.s, 0, L, j0, D);
  load_floats<kWideThreads>(sm.b, gv.tok + kB * gv.Sp + t0, kChunk);
  load_floats<kWideThreads>(sm.li, gv.tok + kLi * gv.Sp + t0, kChunk);
  load_floats<kWideThreads>(sm.x, gv.tok + kX * gv.Sp + t0, kChunk);
  mma::cp_async_commit();
  if (ns > 1) load(1, 1);
  mma::cp_async_commit();
  for (int i = tid; i < 2 * c; i += kWideThreads) last_s[i] = gv.last[i];
  // the raw scores of this thread's fragments: rows r0, r0 + 8
  const int r0 = 16 * rb + gq;
  float s_f[4][4];
  {
    const float* sc = gv.scores + (long)c * kChunk * kChunk;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int s0 = 32 * ch + nb * 8 + 2 * tq;
      const float2 x0 = *reinterpret_cast<const float2*>(sc + r0 * kChunk + s0);
      const float2 x1 =
          *reinterpret_cast<const float2*>(sc + (r0 + 8) * kChunk + s0);
      s_f[nb][0] = x0.x;
      s_f[nb][1] = x0.y;
      s_f[nb][2] = x1.x;
      s_f[nb][3] = x1.y;
    }
  }
  __syncthreads();
  if (tid == 0) {                  // the m chain up to this chunk
    float m = m_in[sb * mb + hh];
    for (int cc = 0; cc < c; ++cc)
      m = fmaxf(last_s[2 * cc] + m, last_s[2 * cc + 1]);
    sm.m0 = m;
  }
  mma::cp_async_wait<1>();
  __syncthreads();
  if (tid < kChunk) {              // m_t and g_t
    const float inter = sm.b[tid] + sm.m0;
    const float m_t = fmaxf(inter, sm.x[tid]);
    sm.m[tid] = m_t;
    sm.g[tid] = tid < L ? expf(inter - m_t) : 0.f;
  }
  __syncthreads();
  // decay and mask the scores in registers, keep them as hi/lo planes,
  // and the row sums
  {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int s0 = 32 * ch + nb * 8 + 2 * tq;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int t = r0 + 8 * x;
        float val[2];
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int s = s0 + y;
          val[y] = 0.f;
          if (t < L && s <= t)
            val[y] = s_f[nb][2 * x + y] *
                     expf(sm.b[t] - sm.b[s] + sm.li[s] - sm.m[t]);
          rs[x] += val[y];
        }
        uint32_t hi, lo;
        split2(val[0], val[1], hi, lo);
        *reinterpret_cast<uint32_t*>(&sm.shi[t * kPitch + s0]) = hi;
        *reinterpret_cast<uint32_t*>(&sm.slo[t * kPitch + s0]) = lo;
      }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 1);
      rs[x] += __shfl_xor_sync(0xffffffffu, rs[x], 2);
    }
    if (tq == 0) {
      sm.rsum[ch][r0] = rs[0];
      sm.rsum[ch][r0 + 8] = rs[1];
    }
  }

  // acc = Q C_c over D in slices (hi and lo planes); q.n on the side
  float acc[4][4] = {};
  float qn = 0.f;                                 // row tid / 4, quarter
  const int t = tid / 4, part = tid % 4;
  for (int step = 0; step < ns; ++step) {
    const int st = step % kOutStages;
    mma::cp_async_wait<1>();
    __syncthreads();   // the step's tiles landed; step - 1's stage is free
    if (step + 2 < ns) load(step + 2, (step + 2) % kOutStages);
    mma::cp_async_commit();
    const bf16* a_s = sm.ring[st][0];
    if (kCompute)
      mma_step<true>(acc, a_s, sm.ring[st][1], sm.ring[st][2]);
    const int d0 = step * kTile;
#pragma unroll 4
    for (int d = part * 16; d < part * 16 + 16; ++d)
      if (d0 + d < D)
        qn = fmaf(__bfloat162float(a_s[t * kPitch + d]), sm.n_s[st][d], qn);
  }
  mma::cp_async_wait<0>();
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  qn += __shfl_xor_sync(0xffffffffu, qn, 2);
  if (part == 0) sm.qn[t] = qn;
  __syncthreads();
  if (tid < kChunk) {
    const float nrm =
        sm.g[tid] * sm.qn[tid] + (sm.rsum[0][tid] + sm.rsum[1][tid]);
    sm.den[tid] =
        fmaxf(fmaxf(fabsf(nrm), expf(-fminf(sm.m[tid], 30.f))), 1e-30f);
  }
  __syncthreads();
  // g * (q C_c) + s V (s as hi and lo planes), over the denominator
  const float g0 = sm.g[r0], g1 = sm.g[r0 + 8];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    acc[nb][0] *= g0;
    acc[nb][1] *= g0;
    acc[nb][2] *= g1;
    acc[nb][3] *= g1;
  }
  if (kCompute) {
    mma_step<true>(acc, sm.shi, sm.vt, nullptr);
    mma_step<true>(acc, sm.slo, sm.vt, nullptr);
  }
  const float d0 = sm.den[r0], d1 = sm.den[r0 + 8];
  bf16* h_bc = h_out + (((long)b * S + t0) * H + hh) * D;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = j0 + 32 * ch + nb * 8 + 2 * tq;
    if (col >= D) continue;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(h_bc + (long)r0 * H * D + col) =
          mma::pack_bf16(acc[nb][0] / d0, acc[nb][1] / d0);
    if (r0 + 8 < L)
      *reinterpret_cast<uint32_t*>(h_bc + (long)(r0 + 8) * H * D + col) =
          mma::pack_bf16(acc[nb][2] / d1, acc[nb][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// 3. the fp32 chunk loop
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;   // threads per block
constexpr int kDK = 32;         // head-dim columns of q and k per stream tile
constexpr int kPad = kDK + 1;   // row stride of the q/k tiles (no conflicts)
constexpr int kMaxDV = 32;      // widest value tile
constexpr int kAccPerThread = kChunk * kMaxDV / kThreads;

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

struct Args {
  const void *q, *k, *v;
  const float *log_i, *log_f;
  Strides qs, ks, vs, is, fs;
  float* C;
  const float *n_in, *m_in;
  const int* rows;
  long cb, nb, mb;
  void* h;
  float *n_out, *m_out;
  float* gates;
  void* c_scr;
  float* n_scr;
  int B, S, H, D;
};

template <typename T>
int launch_decode(const Args& a, cudaStream_t stream) {
  mlstm_decode_kernel<T><<<dim3(a.B * a.H, a.D / kDecCols), kDecThreads, 0,
                           stream>>>(
      reinterpret_cast<const T*>(a.q), reinterpret_cast<const T*>(a.k),
      reinterpret_cast<const T*>(a.v), a.log_i, a.log_f, a.qs, a.ks, a.vs,
      a.is, a.fs, a.C, a.n_in, a.m_in, a.rows, a.cb, a.nb, a.mb,
      reinterpret_cast<T*>(a.h), a.n_out, a.m_out, a.H, a.D);
  return (int)cudaGetLastError();
}

int launch_passes(const Args& a, cudaStream_t stream) {
  if (!a.gates || !a.c_scr || !a.n_scr) return (int)cudaErrorInvalidValue;
  const int nc = (a.S + kChunk - 1) / kChunk;
  const int BH = a.B * a.H, tiles = (a.D + kTile - 1) / kTile;
  cudaError_t err = paged::reserve_smem(mlstm_gate_kernel, sizeof(GateSmem));
  if (err == cudaSuccess)
    err = paged::reserve_smem(mlstm_state_kernel, state_smem(nc));
  if (err == cudaSuccess)
    err = paged::reserve_smem(mlstm_output_kernel, out_smem(nc));
  if (err != cudaSuccess) return (int)err;
  const bf16* q = reinterpret_cast<const bf16*>(a.q);
  const bf16* k = reinterpret_cast<const bf16*>(a.k);
  const bf16* v = reinterpret_cast<const bf16*>(a.v);
  bf16* c_scr = reinterpret_cast<bf16*>(a.c_scr);
  mlstm_gate_kernel<<<dim3(nc, BH), kWideThreads, sizeof(GateSmem),
                      stream>>>(q, k, a.log_i, a.log_f, a.qs, a.ks, a.is,
                                a.fs, a.gates, a.S, a.H, a.D, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_state_kernel<<<dim3(BH, tiles, tiles), kStateThreads, state_smem(nc),
                       stream>>>(
      k, v, a.ks, a.vs, a.C, a.n_in, a.m_in, a.rows, a.cb, a.nb, a.mb,
      a.gates, c_scr, a.n_scr, a.n_out, a.m_out, a.S, a.H, a.D, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_output_kernel<<<dim3(nc, BH, tiles), kWideThreads, out_smem(nc),
                        stream>>>(
      q, v, a.qs, a.vs, a.m_in, a.rows, a.mb, a.gates, c_scr, a.n_scr,
      reinterpret_cast<bf16*>(a.h), a.S, a.H, a.D, nc);
  return (int)cudaGetLastError();
}

int launch_loop(const Args& a, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int DV = value_tile(a.B * a.H, a.D, sms);
  const size_t smem = smem_floats(a.D, DV) * sizeof(float);
  err = paged::reserve_smem(mlstm_chunkwise_kernel<float>, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunkwise_kernel<float><<<dim3(a.B * a.H, a.D / DV), kThreads, smem,
                                  stream>>>(
      reinterpret_cast<const float*>(a.q),
      reinterpret_cast<const float*>(a.k),
      reinterpret_cast<const float*>(a.v), a.log_i, a.log_f, a.qs, a.ks, a.vs,
      a.is, a.fs, a.C, a.n_in, a.m_in, a.rows, a.cb, a.nb, a.mb,
      reinterpret_cast<float*>(a.h), a.n_out, a.m_out, a.S, a.H, a.D, DV);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, (batch row, token, head) for q, k, v [B, S, H,
// D] (head-dim stride 1) and for log_i, log_f [B, S, H]. The state C
// [Bs, H, D, D], n [Bs, H, D], m [Bs, H] is fp32 with contiguous rows;
// cb, nb, mb are its batch strides (C 16-byte aligned). rows [B] (int32,
// distinct) maps batch row b to state row rows[b], or is null for rows[b]
// = b. C is updated in place; h [B, S, H, D] (contiguous), n_out [B, H, D]
// and m_out [B, H] are allocated by the caller. For bf16 with S > 1 the
// caller also allocates the passes' scratch (mlstm_chunkwise_scratch gives
// the sizes; q, k, v 16-byte aligned with strides of multiples of 8),
// otherwise gates, c_scr and n_scr may be null. Returns cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue when D is
// not a multiple of 32 up to 1024 or the scratch is missing. Allocates
// nothing and does not synchronise: the launches go on `stream`.
int mlstm_chunkwise_launch(
    const void* q, const void* k, const void* v, const float* log_i,
    const float* log_f, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long isb, long long iss,
    long long ish, long long fsb, long long fss, long long fsh, float* C,
    const float* n_in, const float* m_in, const int* rows, long long cb,
    long long nb, long long mb, void* h, float* n_out, float* m_out,
    float* gates, void* c_scr, float* n_scr, int B, int S, int H, int D,
    int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D % 32 != 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || S == 0) return 0;
  const Args a{q, k, v, log_i, log_f, {qsb, qss, qsh}, {ksb, kss, ksh},
               {vsb, vss, vsh}, {isb, iss, ish}, {fsb, fss, fsh}, C, n_in,
               m_in, rows, cb, nb, mb, h, n_out, m_out, gates, c_scr, n_scr,
               B, S, H, D};
  if (S == 1)
    return is_bf16 ? launch_decode<bf16>(a, st) : launch_decode<float>(a, st);
  return is_bf16 ? launch_passes(a, st) : launch_loop(a, st);
}

// The kernels a launch of (S, dtype) runs, and for the bf16 passes the
// scratch they need per (batch row, head): floats of gates, bf16 elements
// of chunk-start C planes, floats of chunk-start n (info[0..3]).
int mlstm_chunkwise_plan(int S, int D, int is_bf16, long long* info) {
  const int nc = (S + kChunk - 1) / kChunk;
  const bool passes = is_bf16 && S > 1;
  info[0] = S == 1 ? 1 : passes ? 3 : 1;
  info[1] = passes ? gate_floats(nc) : 0;
  info[2] = passes ? (long long)nc * 2 * D * D : 0;
  info[3] = passes ? (long long)nc * D : 0;
  return 0;
}

const char* mlstm_chunkwise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
