// mLSTM chunkwise recurrence with a carried state, for Hopper (sm_90a).
// Serves every mLSTM call of the slot engine (models/ssm.py mlstm_mix):
// prompt chunks of any length S >= 1 and decode steps (S = 1), and the
// training forward from a fresh state (kernels/mlstm_chunkwise/ops.py).
//
// Replaces the TPU kernel mlstm_chunkwise
// (src/repro/kernels/mlstm_chunkwise/kernel.py, _kernel), and reads and
// writes the state it keeps in VMEM scratch. Per (batch row b, head h),
// chunk by chunk, with b_t the inclusive cumulative sum of log_f inside
// the chunk and (C, n, m) the state carried in:
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
// are formed in the reference's order of operations. The exact m_t is the
// running maximum over all past tokens, so the result does not depend on
// the chunk length but for rounding.
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
// 2. Chunks in bf16, S > 1: the chunkwise-parallel form, three launches,
//    in chunks of LC = 128 tokens (kChunk, the TPU kernel's own) or, up to
//    kShortS tokens, of 64 (chunk_for). The work is about 4*L*D*(L + D)
//    flops a chunk of L tokens and (row, head); by the bytes of q, k, v
//    and h alone the card would take 0.0089 ms at B1 S2048 for
//    xlstm-125m's 4 heads of 384. What the design pays beyond that: the
//    state pass walks the chunks in order (nc steps on one SM a tile of
//    C), each step's product is a split (two wgmma) read from shared
//    memory, and the chunk-start states go out to device memory and come
//    back (nc x 2 x D*D bf16 a (row, head)). So the state pass keeps only
//    the products and C += P on its chain and does everything else beside
//    them in warps of its own; the other two passes run every chunk in
//    parallel. Every product is a wgmma.mma_async fed by TMA
//    (cp.async.bulk.tensor, 128-byte swizzle, mbarrier rings with a full
//    and an empty barrier a stage), q, k and v read in place through 4-D
//    tensor maps of their strides (rows past S and columns past D filled
//    with zeros by the copy):
//    a. Gate pass, grid (chunk, b*h): the chunk's gates (the in-chunk sums
//       b_t, one thread's serial sum in the reference's order; each
//       token's row max over the chunk; its carry exponent b_last - b_t +
//       log_i_t; the chunk's (b_last, row max) for the m chain) while the
//       first slices load, then the raw scores Q K^T (one m64nLCk16 a
//       warpgroup of 64 tokens and k-step) into fp32 scratch.
//    b. State pass, grid (b*h, 64 rows of C, kStateN columns),
//       warp-specialized: a producer lane loads each chunk's k and V, 8
//       transform warps form its k*w planes (w = exp(a_t - m'), hi in
//       place of the k box, lo beside it) and n's update from their column
//       sums, two consumer warpgroups keep the 64 x 128 tile of C in
//       registers and issue each chunk's product P = (k w)^T V into a
//       second set (A M-major, B N-major), staging the chunk's starting C
//       as hi/lo planes while the other warpgroup's products run, and a
//       storer lane writes the staged planes to scratch by TMA (shared ->
//       global). On the chain: the products, their wait and C += P.
//    c. Output pass, grid (chunk, b*h, kOutN columns of h): the m chain up
//       to the chunk, m_t and g_t, the gate pass's raw scores decayed and
//       masked in registers and split into the hi/lo A fragments of s.V;
//       then Q C_c over D in slices of 64 (C_c's hi and lo planes loaded by
//       TMA from scratch, two wgmma into one accumulator; q.n on the side,
//       fp32), g * Q C_c + s V with s from registers, and h = that / den.
//    Scratch, allocated by the wrapper: the chunk-start states, nc x 2 x
//    D*D bf16 and nc x D fp32 a (row, head) (37.7 MB at B1 S2048 D 384),
//    and the gate pass's per-token values and raw scores (4 x LC + 2 +
//    LC^2 floats a chunk).
//
// 3. Chunks in fp32, S > 1 (the smoke configs and the parity cases, on no
//    serving path at full width): a scalar loop over chunks of kLoopChunk
//    = 64 tokens (128 would not fit its shared memory at D 1024).
//    A block owns (b, h, DV value columns), keeps its D x DV slice of C
//    in shared memory for the walk over the chunks, and recomputes the
//    score tile in every value tile, with scalar fp32 FMA. Its limit
//    (2e-5 + 2e-5|ref| on h) rules out bf16 operands.
//
// Precision of the bf16 chunk path. q, k and v are exact in bf16, so Q K^T
// and the products with V take bf16 operands as they are (exact products,
// fp32 sums). The operands that are fp32 take an error-compensated split,
// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), and two wgmma into
// one fp32 accumulator (relative error about 2^-16 of each product): k*w
// in the state update, C_c in q.C_c and the decayed scores s in s.v. Plain
// bf16 (2^-8) or TF32 (2^-11) in the C update would miss the state's limit
// (1e-5 + 1e-4|ref|). q.n and n's update are fp32 sums.
#include <algorithm>

#include "attend_wgmma.cuh"
#include "paged_common.cuh"

// Diagnostic cuts (tools/mlstm_variants.py builds the source with
// -DMLSTM_CUT=1 or 2): 1 issues none of the streamed loads of the decode
// kernel nor any TMA copy of the passes (their barriers still complete),
// 2 none of the decode kernel's products and no wgmma of the passes; the
// results are then wrong and only the times mean anything. MLSTM_CHUNK
// (64 or 128) forces the passes' chunk length for every S; 0 chooses it
// by S (chunk_for).
#ifndef MLSTM_CUT
#define MLSTM_CUT 0
#endif
#ifndef MLSTM_CHUNK
#define MLSTM_CHUNK 0
#endif

namespace {

using bf16 = __nv_bfloat16;
constexpr bool kLoads = MLSTM_CUT != 1;
constexpr bool kCompute = MLSTM_CUT != 2;

constexpr int kChunk = 128;     // tokens per chunk of the bf16 passes
static_assert(MLSTM_CHUNK == 0 || MLSTM_CHUNK == 64 || MLSTM_CHUNK == 128,
              "MLSTM_CHUNK is 0, 64 or 128");

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
// The passes are instantiated at two chunk lengths LC: 128 tokens (kChunk,
// the TPU kernel's: half the steps of the state chain and half the
// chunk-start states of 64) and 64 (kShortChunk), which a launch of S <=
// kShortS tokens takes: up to there, the 64-token chunks' twice as many
// gate and output blocks (and no padding of a short prompt chunk to 128
// rows) outweigh the longer state chain (tools/mlstm_variants.py's A/B,
// "chunk 64" against "chunk 128"). -DMLSTM_CHUNK=64 or 128 forces one
// length for every S.
constexpr int kShortChunk = 64;
constexpr int kShortS = 512;

__host__ __device__ constexpr int chunk_for(int S) {
  return MLSTM_CHUNK ? MLSTM_CHUNK : S <= kShortS ? kShortChunk : kChunk;
}

template <int LC>
struct Tok {                           // the geometry a chunk length sets
  static_assert(LC == 64 || LC == 128, "chunks of 64 or 128 tokens");
  static constexpr int WG = LC / 64;   // warpgroups over a chunk's tokens
  static constexpr int THREADS = 128 * WG + 32;   // + the producer warp
  static constexpr int BOX = LC * 128;            // a [LC tokens, 64 col] box
};
constexpr int kAtomBytes = 64 * 128;   // a [64 rows, 64 col] box
constexpr int kStateN = 128;           // C columns a state block
constexpr int kStateWG = kStateN / 64; // its warpgroups, 64 columns each
constexpr int kStateThreads = 128 * kStateWG + 256 + 32;   // + 8 + 1 warps
constexpr int kOutN = 128;             // h columns an output block
constexpr float kNoWeight = -3.402823466e38f;   // exp(kNoWeight - m') = 0
constexpr unsigned kFull = 0xffffffffu;

// Scratch of the gate pass, per (b, h), in floats: kTokenFields arrays of
// Sp = nc * LC per-token values (b_t, log_i, the row max x_t and the carry
// exponent a_t = b_last - b_t + log_i_t, kNoWeight past S), each chunk's b
// and row max at its last token (padded to 4 floats), and each chunk's raw
// scores Q K^T [LC][LC]. Every (b, h) starts 16-byte aligned.
enum TokenField { kB = 0, kLi = 1, kX = 2, kA = 3, kTokenFields = 4 };

__host__ __device__ inline long gate_floats(int nc, int LC) {
  return (long)kTokenFields * nc * LC + ((2 * nc + 3) & ~3) +
         (long)nc * LC * LC;
}

template <int LC>
struct GateView {            // one (b, h) of the gate scratch
  float* tok;                // [kTokenFields][Sp]
  float* last;               // [nc][2]: b, row max at the chunk's last token
  float* scores;             // [nc][LC][LC]
  int Sp;

  __device__ GateView(float* gates, int bh, int nc) {
    Sp = nc * LC;
    tok = gates + (long)bh * gate_floats(nc, LC);
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

// x = hi + lo, both bf16, packed in pairs (the first in the low half)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = wg::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// ---- TMA and bulk copies (one thread issues each)
// Box [64 columns, LC tokens] of q, k or v at column col, tokens [t0, t0 +
// LC) of (batch row b, head h), through a 4-D map (boxes of LC tokens)
// whose axes sit at `slots` (wg::strided_map).
__device__ __forceinline__ void load_tokens(uint32_t dst, const CUtensorMap* m,
                                            int slots, uint32_t bar, int col,
                                            int t0, int h, int b) {
  using wg::StridedTiles;
  wg::tma_load_4d(dst, m, bar, col, StridedTiles::coord(slots, 1, t0, h, b),
                  StridedTiles::coord(slots, 2, t0, h, b),
                  StridedTiles::coord(slots, 3, t0, h, b));
}

// d (+)= A.B for one warpgroup, m64nNk16, bf16 operands, fp32 accumulators
// (N / 2 a thread, the m16n8 layout repeated over N / 8 column blocks):
// ss() both operands from shared memory (kTransA: A M-major, kTransB: B
// N-major; scale_d 0 overwrites d), rs() A from registers (the m16n8k16 A
// fragments) and B N-major. Nothing is issued with -DMLSTM_CUT=2.
template <int N>
struct Mma;

template <>
struct Mma<64> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    if (!kCompute) return;
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    if (!kCompute) return;
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  template <int kTransA, int kTransB>
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    if (!kCompute) return;
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
  }
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    if (!kCompute) return;
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---- 2a. the gate pass
// Shared memory (1024-aligned base): [stages x (Q box, K box)][full[S],
// empty[S]][b, log_i: LC floats each].
template <int LC>
struct GateGeo {
  static constexpr int STAGE = 2 * Tok<LC>::BOX;
  static constexpr int kStages = 3;
  static constexpr int BAR = kStages * STAGE;
  static constexpr int F_OFF = BAR + 16 * kStages;
  static constexpr size_t kSmem = wg::kAlign + F_OFF + 2 * LC * 4;
};

// Grid (nc, B*H), all chunks in parallel. First the chunk's gates, while
// the first slices load: b_t (one thread's serial sum, the reference's
// order), each token's row max and its carry exponent; then warpgroup g of
// the consumers takes the chunk's tokens [64g, 64g + 64) as the M rows of S
// = Q K^T (N = the chunk's LC keys), over D in k-steps of 16 from the ring
// of 64-column slices. The warp after them is the producer.
template <int LC>
__global__ void __launch_bounds__(Tok<LC>::THREADS, 1)
mlstm_gate_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map, int q_slots,
                  int k_slots, const float* __restrict__ log_i,
                  const float* __restrict__ log_f, Strides is, Strides fs,
                  float* __restrict__ gates, int S, int H, int D, int nc) {
  using G = GateGeo<LC>;
  constexpr int SG = G::kStages, kWG = Tok<LC>::WG, kBox = Tok<LC>::BOX;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int t0 = c * LC, L = min(LC, S - t0), ns = (D + 63) / 64;
  const int t = threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = wg::aligned_smem(smem_raw);
  const uint32_t ring = wg::smem_addr(base);
  const uint32_t full = ring + G::BAR, empty = full + 8 * SG;
  float* b_s = reinterpret_cast<float*>(base + G::F_OFF);
  float* li_s = b_s + LC;
  if (t == 0) {
    for (int s = 0; s < SG; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < LC) {
    const bool live = t < L;
    li_s[t] = live ? log_i[b * is.b + (long)(t0 + t) * is.s + hh * is.h]
                   : 0.f;
    b_s[t] = live ? log_f[b * fs.b + (long)(t0 + t) * fs.s + hh * fs.h]
                  : 0.f;
  }
  __syncthreads();

  if (t >= 128 * kWG) {                     // the producer warp
    if (t == 128 * kWG) {
      for (int j = 0; j < ns; ++j) {
        const int s = j % SG;
        const uint32_t st = ring + s * G::STAGE;
        wg::mbar_wait(empty + 8 * s, ((j / SG) & 1) ^ 1);
        if (kLoads) {
          wg::mbar_expect_tx(full + 8 * s, G::STAGE);
          load_tokens(st, &q_map, q_slots, full + 8 * s, 64 * j, t0, hh, b);
          load_tokens(st + kBox, &k_map, k_slots, full + 8 * s, 64 * j, t0,
                      hh, b);
        } else {
          wg::mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  const GateView<LC> gv(gates, bh, nc);
  if (t == 0) {
    float run = b_s[0];
    for (int u = 1; u < L; ++u) {
      run += b_s[u];
      b_s[u] = run;
    }
  }
  wg::named_sync(1, 128 * kWG);
  if (t < LC) {
    const float bt = b_s[t], b_last = b_s[L - 1];
    float x = 0.f, a = kNoWeight;
    if (t < L) {
      x = -3.402823466e38f;
      for (int s = 0; s <= t; ++s) x = fmaxf(x, bt - b_s[s] + li_s[s]);
      a = b_last - bt + li_s[t];
    }
    gv.tok[kB * gv.Sp + t0 + t] = bt;
    gv.tok[kLi * gv.Sp + t0 + t] = li_s[t];
    gv.tok[kX * gv.Sp + t0 + t] = x;
    gv.tok[kA * gv.Sp + t0 + t] = a;
    if (t == L - 1) {
      gv.last[2 * c] = bt;
      gv.last[2 * c + 1] = x;
    }
  }

  const int wgi = t / 128, w = (t % 128) / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  float acc[LC / 2];
#pragma unroll
  for (int x = 0; x < LC / 2; ++x) acc[x] = 0.f;
  for (int j = 0; j < ns; ++j) {
    const int s = j % SG;
    const uint32_t st = ring + s * G::STAGE;
    wg::mbar_wait(full + 8 * s, (j / SG) & 1);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Mma<LC>::template ss<0, 0>(
          acc, wg::sw128_desc(st + wgi * 64 * 128 + kk * 32),
          wg::sw128_desc(st + kBox + kk * 32), j > 0 || kk > 0);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    if (lane == 0) wg::mbar_arrive(empty + 8 * s);
  }

  // the raw scores -> scratch (rows and columns past S are zero: their
  // boxes were zero-filled)
  float* sc = gv.scores + (long)c * LC * LC;
  const int r0 = 64 * wgi + 16 * w + gq;
#pragma unroll
  for (int nb = 0; nb < LC / 8; ++nb) {
    const int col = 8 * nb + 2 * tq;
    *reinterpret_cast<float2*>(sc + r0 * LC + col) =
        make_float2(acc[4 * nb], acc[4 * nb + 1]);
    *reinterpret_cast<float2*>(sc + (r0 + 8) * LC + col) =
        make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
  }
}

// ---- 2b. the state pass
// Shared memory (1024-aligned base, `stages` ring stages): [stages x (the
// k box, then the hi plane of k*w in its place; the lo plane of k*w; V:
// kStateN / 64 boxes)][the staged chunk-start tile: hi, lo planes,
// kStateN / 64 boxes of [64 rows, 64 columns] each, box g warpgroup g's]
// [full[S], ready[S], empty[S], staged[2], freed[2]][the nc-sized tail:
// the chunks' (b_last, row max), the m chain, the decays].
template <int LC>
struct StateGeo {
  static constexpr int BOX = Tok<LC>::BOX;
  static constexpr int V_BYTES = kStateN / 64 * BOX;
  static constexpr int STAGE = 2 * BOX + V_BYTES;
  static constexpr int TILE_PLANE = kStateN / 64 * kAtomBytes;
  static constexpr int FIXED = 2 * TILE_PLANE;
};

template <int LC>
__host__ __device__ inline size_t state_smem(int stages, int nc) {
  using G = StateGeo<LC>;
  return wg::kAlign + (size_t)stages * G::STAGE + G::FIXED + 24 * stages +
         32 + (((2 * nc + 3) & ~3) + 2 * nc + 1) * sizeof(float);
}

// Grid (B*H, row tiles of 64, column tiles of kStateN); warp-specialized:
//  - the last warp: its lane 0 loads chunk c's k box (64 rows of C) and V
//    (the block's columns) into stage c % S once chunk c - S's product is
//    done (empty); its lane 1 stores each warpgroup's staged chunk-start
//    planes to scratch by TMA (staged), and frees them once read (freed);
//  - the transform warps (8, one a 16-byte piece: rows 8p .. 8p + 7)
//    compute the m chain, then for each chunk, as soon as its loads land
//    (full), form the hi/lo planes of k*w, w = exp(a_t - m'), a_t read
//    from the gate scratch a chunk ahead (hi in place of the k box, lo
//    beside it; the 128-byte swizzle of the box: piece p of token s at p ^
//    (s % 8)), and for the column-0 tiles n's update from the planes'
//    column sums (fp32; n_c written to scratch), then signal the stage
//    (ready);
//  - consumer warpgroup g owns rows [i0, i0 + 64) x columns [j0 + 64g, j0 +
//    64g + 64) of C in registers (cr: rows i0 + 16w + gq (+8), columns j0 +
//    64g + 8nb + 2tq (+1)) and walks the chunks in order: chunk c's product
//    P = (k w)^T V (pr, scale_d 0 first; A = the planes [tokens][64 rows]
//    M-major, B = V N-major) is issued, C_c staged as hi/lo planes (by
//    warpgroup 1 before its product, by warpgroup 0 after it, so that one
//    stages while the other's products run) and C scaled by the decay;
//    then the wait and C += P, the reference's decay*C + (k w)^T V.
// On the chain stay the products, their wait and C += P.
template <int LC>
__global__ void __launch_bounds__(kStateThreads, 1)
mlstm_state_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap c_map, int k_slots,
                   int v_slots, float* __restrict__ C,
                   const float* __restrict__ n_in,
                   const float* __restrict__ m_in,
                   const int* __restrict__ rows, long cb, long n_stride,
                   long mb, const float* __restrict__ gates,
                   float* __restrict__ n_scr, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int H, int D, int nc,
                   int stages) {
  using G = StateGeo<LC>;
  constexpr int kBox = G::BOX, kMma = 128 * kStateWG;
  constexpr int kTransform = 256;                  // 8 warps, one a piece
  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int i0 = blockIdx.y * 64, j0 = blockIdx.z * kStateN;
  const int t = threadIdx.x, lane = t % 32;
  const long sb = rows ? rows[b] : b;
  const GateView<LC> gv(const_cast<float*>(gates), bh, nc);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = wg::aligned_smem(smem_raw);
  const uint32_t ring = wg::smem_addr(base);
  const int R = stages * G::STAGE;
  unsigned char* stg_g = base + R;
  const uint32_t full = ring + R + G::FIXED;
  const uint32_t ready = full + 8 * stages, empty = ready + 8 * stages;
  const uint32_t staged = empty + 8 * stages, freed = staged + 16;
  float* last_s = reinterpret_cast<float*>(base + R + G::FIXED +
                                           24 * stages + 32);
  float* m_s = last_s + ((2 * nc + 3) & ~3);      // [nc + 1]
  float* dec_s = m_s + nc + 1;                    // [nc]
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(ready + 8 * s, kTransform / 32);
      wg::mbar_init(empty + 8 * s, 4 * kStateWG);
    }
    for (int g = 0; g < kStateWG; ++g) {
      wg::mbar_init(staged + 8 * g, 4);
      wg::mbar_init(freed + 8 * g, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = t; i < 2 * nc; i += kStateThreads) last_s[i] = gv.last[i];
  __syncthreads();

  if (t >= kMma + kTransform) {                   // the last warp
    if (t == kMma + kTransform) {                 // lane 0: the loads
      for (int c = 0; c < nc; ++c) {
        const int s = c % stages;
        const uint32_t st = ring + s * G::STAGE;
        wg::mbar_wait(empty + 8 * s, ((c / stages) & 1) ^ 1);
        if (kLoads) {
          const int tc = c * LC;
          wg::mbar_expect_tx(full + 8 * s, kBox + G::V_BYTES);
          load_tokens(st, &k_map, k_slots, full + 8 * s, i0, tc, hh, b);
#pragma unroll
          for (int a = 0; a < kStateN / 64; ++a)
            load_tokens(st + 2 * kBox + a * kBox, &v_map, v_slots,
                        full + 8 * s, j0 + 64 * a, tc, hh, b);
        } else {
          wg::mbar_arrive(full + 8 * s);
        }
      }
    } else if (t == kMma + kTransform + 1) {      // lane 1: the stores
      const uint32_t stg = wg::smem_addr(stg_g);
      for (int c = 0; c < nc; ++c) {
        for (int g = kStateWG - 1; g >= 0; --g) {  // the order they stage in
          wg::mbar_wait(staged + 8 * g, c & 1);
          if (kLoads && j0 + 64 * g < D) {
#pragma unroll
            for (int pl = 0; pl < 2; ++pl)
              wg::tma_store_3d(&c_map,
                               stg + pl * G::TILE_PLANE + g * kAtomBytes,
                               j0 + 64 * g, i0, (bh * nc + c) * 2 + pl);
            wg::bulk_commit();
            wg::bulk_wait_read();
          }
          wg::mbar_arrive(freed + 8 * g);
        }
      }
      wg::bulk_wait();
    }
    return;
  }

  if (t >= kMma) {                                // the transform warps
    const int tt = t - kMma, p = tt / 32;
    const bool with_n = blockIdx.z == 0;          // n: the column-0 tiles
    if (tt == 0) {
      m_chain(last_s, m_in[sb * mb + hh], nc, m_s);
      for (int c = 0; c < nc; ++c)   // exp(b_last + m - m')
        dec_s[c] = expf(last_s[2 * c] + m_s[c] - m_s[c + 1]);
      if (blockIdx.y == 0 && blockIdx.z == 0) m_out[bh] = m_s[nc];
    }
    // lane 0: n of rows i0 + 8p .. i0 + 8p + 7
    float nv[8];
    const float* n_bh = n_in + sb * n_stride + (long)hh * D + i0 + 8 * p;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      nv[e] = with_n && lane == 0 && i0 + 8 * p + e < D ? n_bh[e] : 0.f;
    constexpr int U = LC / 32;                    // tokens a lane
    float a_next[U];
    const float* a_g = gv.tok + kA * gv.Sp;
#pragma unroll
    for (int u = 0; u < U; ++u) a_next[u] = a_g[lane + 32 * u];
    wg::named_sync(2, kTransform);                // the m chain
    for (int c = 0; c < nc; ++c) {
      const int s = c % stages;
      unsigned char* st = base + s * G::STAGE;
      float a_cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a_cur[u] = a_next[u];
        if (c + 1 < nc) a_next[u] = a_g[(c + 1) * LC + lane + 32 * u];
      }
      const float mn = m_s[c + 1];
      float cs[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) cs[e] = 0.f;
      wg::mbar_wait(full + 8 * s, (c / stages) & 1);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tok = lane + 32 * u;
        const float wt = expf(a_cur[u] - mn);   // the reference's exp(.. - m')
        const int off = tok * 128 + ((p ^ (tok & 7)) << 4);
        const uint4 kv = *reinterpret_cast<const uint4*>(st + off);
        const uint32_t* k2 = reinterpret_cast<const uint32_t*>(&kv);
        uint4 hv, lv;
        uint32_t* h2 = reinterpret_cast<uint32_t*>(&hv);
        uint32_t* l2 = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 kk =
              *reinterpret_cast<const __nv_bfloat162*>(&k2[e]);
          const float x0 = __fmul_rn(__low2float(kk), wt);
          const float x1 = __fmul_rn(__high2float(kk), wt);
          cs[2 * e] += x0;
          cs[2 * e + 1] += x1;
          split2(x0, x1, h2[e], l2[e]);
        }
        *reinterpret_cast<uint4*>(st + off) = hv;
        *reinterpret_cast<uint4*>(st + kBox + off) = lv;
      }
      if (with_n) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int o = 1; o < 32; o *= 2)
            cs[e] += __shfl_xor_sync(kFull, cs[e], o);
        if (lane == 0) {
          const float dec = dec_s[c];
          float* nc_out = n_scr + ((long)bh * nc + c) * D + i0 + 8 * p;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (i0 + 8 * p + e < D) nc_out[e] = nv[e];
            nv[e] = __fadd_rn(__fmul_rn(dec, nv[e]), cs[e]);
          }
        }
      }
      wg::proxy_fence();
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(ready + 8 * s);
    }
    if (with_n && lane == 0) {
      float* n_o = n_out + (long)bh * D + i0 + 8 * p;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (i0 + 8 * p + e < D) n_o[e] = nv[e];
    }
    return;
  }

  const int g = t / 128, w = (t % 128) / 32;
  const int gq = lane / 4, tq = lane % 4;
  float cr[32], pr[32];
  float* c_bh = C + sb * cb + (long)hh * D * D;
  const int r_lo = i0 + 16 * w + gq, c_lo = j0 + 64 * g + 2 * tq;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float2 cv = make_float2(0.f, 0.f);
      if (r_lo + 8 * x < D && c_lo + 8 * nb < D)
        cv = *reinterpret_cast<const float2*>(
            c_bh + (long)(r_lo + 8 * x) * D + c_lo + 8 * nb);
      cr[4 * nb + 2 * x] = cv.x;
      cr[4 * nb + 2 * x + 1] = cv.y;
      pr[4 * nb + 2 * x] = pr[4 * nb + 2 * x + 1] = 0.f;
    }
  }
  // C_c -> this warpgroup's box of the staging planes, once chunk c - 1's
  // store has read it: row r = 16w + gq + 8x, the 16-byte piece nb ^ (r %
  // 8); then the storer is told
  auto stage_out = [&](int c) {
    wg::mbar_wait(freed + 8 * g, (c & 1) ^ 1);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = 16 * w + gq + 8 * x;
        const int off = g * kAtomBytes + r * 128 + ((nb ^ gq) << 4) + tq * 4;
        uint32_t hi, lo;
        split2(cr[4 * nb + 2 * x], cr[4 * nb + 2 * x + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(stg_g + off) = hi;
        *reinterpret_cast<uint32_t*>(stg_g + G::TILE_PLANE + off) = lo;
      }
    }
    wg::proxy_fence();
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(staged + 8 * g);
  };
  for (int c = 0; c < nc; ++c) {
    const int s = c % stages;
    const uint32_t st = ring + s * G::STAGE;
    wg::mbar_wait(ready + 8 * s, (c / stages) & 1);
    if (g == 1) stage_out(c);
    // P = (k w)^T V, hi and lo into one accumulator
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < LC / 16; ++kk) {
      const uint64_t vd =
          wg::sw128_desc(st + 2 * kBox + g * kBox + kk * 16 * 128, kBox);
      Mma<64>::ss<1, 1>(pr, wg::sw128_desc(st + kk * 16 * 128, kBox), vd,
                        kk > 0);
      Mma<64>::ss<1, 1>(pr, wg::sw128_desc(st + kBox + kk * 16 * 128, kBox),
                        vd, 1);
    }
    wg::wgmma_commit();
    if (g == 0) stage_out(c);
    const float dec = dec_s[c];
#pragma unroll
    for (int x = 0; x < 32; ++x) cr[x] = __fmul_rn(cr[x], dec);
    wg::wgmma_wait<0>();
    wg::fence_regs(pr);
    if (lane == 0) wg::mbar_arrive(empty + 8 * s);   // chunk c's stage is free
#pragma unroll
    for (int x = 0; x < 32; ++x) cr[x] = __fadd_rn(cr[x], pr[x]);
  }
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
      if (r_lo + 8 * x < D && c_lo + 8 * nb < D)
        *reinterpret_cast<float2*>(c_bh + (long)(r_lo + 8 * x) * D + c_lo +
                                   8 * nb) =
            make_float2(cr[4 * nb + 2 * x], cr[4 * nb + 2 * x + 1]);
  }
}

// ---- 2c. the output pass
// Shared memory (1024-aligned base, `stages` ring stages): [stages x (a
// [LC, 64] slice of Q; C_c's hi and lo planes over the slice's 64 rows and
// the block's kOutN columns, kOutN / 64 boxes each)][the V tile: kOutN /
// 64 boxes][full[S], empty[S], the V tile's barrier][b, log_i, x, m, g,
// q.n of the chunk's tokens; m0; n_c (D rounded up to 64); the nc-sized
// tail: the chunks' (b_last, row max)].
template <int LC>
struct OutGeo {
  static constexpr int Q_BYTES = Tok<LC>::BOX;
  static constexpr int C_PLANE = kOutN / 64 * kAtomBytes;
  static constexpr int STAGE = Q_BYTES + 2 * C_PLANE;
  static constexpr int V_BYTES = kOutN / 64 * Tok<LC>::BOX;
};

template <int LC>
__host__ __device__ inline size_t out_smem(int stages, int nc, int D) {
  using G = OutGeo<LC>;
  return wg::kAlign + (size_t)stages * G::STAGE + G::V_BYTES +
         16 * stages + 16 +
         (6 * LC + 4 + (D + 63) / 64 * 64 + ((2 * nc + 3) & ~3)) *
             sizeof(float);
}

// Grid (nc, B*H, column tiles of kOutN), all in parallel. Consumer
// warpgroup g owns the chunk's tokens [64g, 64g + 64) as the M rows of
// h[:, j0:j0 + kOutN] (acc: rows 64g + 16w + gq (+8), columns j0 + 8nb +
// 2tq (+1)); the warp after them is the producer (the V tile once, then Q
// and C_c slice by slice). The products of slice j run while q.n of slice
// j is summed and slice j - 1's stage goes back.
template <int LC>
__global__ void __launch_bounds__(Tok<LC>::THREADS, 1)
mlstm_output_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap c_map, int q_slots,
                    int v_slots, const float* __restrict__ m_in,
                    const int* __restrict__ rows, long mb,
                    const float* __restrict__ gates,
                    const float* __restrict__ n_scr, bf16* __restrict__ h_out,
                    int S, int H, int D, int nc, int stages) {
  using G = OutGeo<LC>;
  constexpr int kWG = Tok<LC>::WG, kBox = Tok<LC>::BOX;
  constexpr int kThreads = Tok<LC>::THREADS;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int j0 = blockIdx.z * kOutN;
  const int t0 = c * LC, L = min(LC, S - t0), ns = (D + 63) / 64;
  const int t = threadIdx.x;
  const long sb = rows ? rows[b] : b;
  const GateView<LC> gv(const_cast<float*>(gates), bh, nc);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = wg::aligned_smem(smem_raw);
  const uint32_t ring = wg::smem_addr(base);
  const int R = stages * G::STAGE;
  const uint32_t v_s = ring + R;
  const uint32_t full = v_s + G::V_BYTES, empty = full + 8 * stages;
  const uint32_t vbar = empty + 8 * stages;
  float* b_s = reinterpret_cast<float*>(base + R + G::V_BYTES + 16 * stages +
                                        16);
  float* li_s = b_s + LC;
  float* x_s = li_s + LC;
  float* m_s = x_s + LC;
  float* g_s = m_s + LC;
  float* qn_s = g_s + LC;
  float* m0_s = qn_s + LC;
  float* n_s = m0_s + 4;
  float* last_s = n_s + ns * 64;
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4 * kWG);
    }
    wg::mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < LC) {
    b_s[t] = gv.tok[kB * gv.Sp + t0 + t];
    li_s[t] = gv.tok[kLi * gv.Sp + t0 + t];
    x_s[t] = gv.tok[kX * gv.Sp + t0 + t];
  }
  const float* n_c = n_scr + ((long)bh * nc + c) * D;
  for (int i = t; i < ns * 64; i += kThreads) n_s[i] = i < D ? n_c[i] : 0.f;
  for (int i = t; i < 2 * c; i += kThreads) last_s[i] = gv.last[i];
  __syncthreads();

  if (t >= 128 * kWG) {                     // the producer warp
    if (t == 128 * kWG) {
      if (kLoads) {
        wg::mbar_expect_tx(vbar, G::V_BYTES);
#pragma unroll
        for (int a = 0; a < kOutN / 64; ++a)
          load_tokens(v_s + a * kBox, &v_map, v_slots, vbar, j0 + 64 * a, t0,
                      hh, b);
      } else {
        wg::mbar_arrive(vbar);
      }
      for (int j = 0; j < ns; ++j) {
        const int s = j % stages;
        const uint32_t st = ring + s * G::STAGE;
        wg::mbar_wait(empty + 8 * s, ((j / stages) & 1) ^ 1);
        if (kLoads) {
          wg::mbar_expect_tx(full + 8 * s, G::STAGE);
          load_tokens(st, &q_map, q_slots, full + 8 * s, 64 * j, t0, hh, b);
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
#pragma unroll
            for (int a = 0; a < kOutN / 64; ++a)
              wg::tma_load_3d(
                  st + G::Q_BYTES + pl * G::C_PLANE + a * kAtomBytes, &c_map,
                  full + 8 * s, j0 + 64 * a, 64 * j, (bh * nc + c) * 2 + pl);
        } else {
          wg::mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  const int wgi = t / 128, w = (t % 128) / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int r0 = 64 * wgi + 16 * w + gq;   // this thread's rows r0, r0 + 8
  // the raw scores of this thread's fragments
  float sf[LC / 2];
  {
    const float* sc = gv.scores + (long)c * LC * LC;
#pragma unroll
    for (int nb = 0; nb < LC / 8; ++nb) {
      const int s0 = 8 * nb + 2 * tq;
      const float2 x0 = *reinterpret_cast<const float2*>(sc + r0 * LC + s0);
      const float2 x1 =
          *reinterpret_cast<const float2*>(sc + (r0 + 8) * LC + s0);
      sf[4 * nb] = x0.x;
      sf[4 * nb + 1] = x0.y;
      sf[4 * nb + 2] = x1.x;
      sf[4 * nb + 3] = x1.y;
    }
  }
  if (t == 0) {                   // the m chain up to this chunk
    float m = m_in[sb * mb + hh];
    for (int cc = 0; cc < c; ++cc)
      m = fmaxf(last_s[2 * cc] + m, last_s[2 * cc + 1]);
    *m0_s = m;
  }
  wg::named_sync(1, 128 * kWG);
  if (t < LC) {                   // m_t and g_t
    const float inter = b_s[t] + *m0_s;
    const float m_t = fmaxf(inter, x_s[t]);
    m_s[t] = m_t;
    g_s[t] = t < L ? expf(inter - m_t) : 0.f;
  }
  wg::named_sync(1, 128 * kWG);
  // the scores decayed and masked, split into the hi/lo A fragments of
  // s.V (k-step kk: n-blocks 2kk and 2kk + 1), and the row sums
  uint32_t shi[LC / 16][4], slo[LC / 16][4];
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < LC / 8; ++nb) {
    const int s0 = 8 * nb + 2 * tq;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int tt = r0 + 8 * x;
      float val[2];
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int s = s0 + y;
        val[y] = 0.f;
        if (tt < L && s <= tt)
          val[y] = sf[4 * nb + 2 * x + y] *
                   expf(b_s[tt] - b_s[s] + li_s[s] - m_s[tt]);
        rs[x] += val[y];
      }
      split2(val[0], val[1], shi[nb / 2][(nb & 1) * 2 + x],
             slo[nb / 2][(nb & 1) * 2 + x]);
    }
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    rs[x] += __shfl_xor_sync(kFull, rs[x], 1);
    rs[x] += __shfl_xor_sync(kFull, rs[x], 2);
  }

  // acc = Q C_c over D in slices of 64 (C_c's hi and lo planes N-major),
  // and q.n on the side: thread t takes half of its row's 64 columns
  float acc[kOutN / 2];
#pragma unroll
  for (int x = 0; x < kOutN / 2; ++x) acc[x] = 0.f;
  float qn = 0.f;
  const int rq = 64 * wgi + (t % 128) / 2, half = t % 2;
  for (int j = 0; j < ns; ++j) {
    const int s = j % stages;
    const uint32_t st = ring + s * G::STAGE;
    wg::mbar_wait(full + 8 * s, (j / stages) & 1);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t qd = wg::sw128_desc(st + wgi * 64 * 128 + kk * 32);
      Mma<kOutN>::ss<0, 1>(
          acc, qd, wg::sw128_desc(st + G::Q_BYTES + kk * 16 * 128, kAtomBytes),
          j > 0 || kk > 0);
      Mma<kOutN>::ss<0, 1>(
          acc, qd,
          wg::sw128_desc(st + G::Q_BYTES + G::C_PLANE + kk * 16 * 128,
                         kAtomBytes),
          1);
    }
    wg::wgmma_commit();
    const unsigned char* qg = base + s * G::STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = half * 4 + i;
      const uint4 qv = *reinterpret_cast<const uint4*>(
          qg + rq * 128 + ((p ^ (rq & 7)) << 4));
      const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
      const float* nn = n_s + 64 * j + 8 * p;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qn = fmaf(__low2float(q2[e]), nn[2 * e], qn);
        qn = fmaf(__high2float(q2[e]), nn[2 * e + 1], qn);
      }
    }
    wg::wgmma_wait<1>();            // slice j - 1's products are done
    if (j > 0 && lane == 0)
      wg::mbar_arrive(empty + 8 * ((j - 1) % stages));
  }
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
  if (lane == 0) wg::mbar_arrive(empty + 8 * ((ns - 1) % stages));
  qn += __shfl_xor_sync(kFull, qn, 1);
  if (half == 0) qn_s[rq] = qn;
  wg::named_sync(2 + wgi, 128);
  float inv[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int tt = r0 + 8 * x;
    const float nrm = __fadd_rn(__fmul_rn(g_s[tt], qn_s[tt]), rs[x]);
    inv[x] = 1.f / fmaxf(fmaxf(fabsf(nrm), expf(-fminf(m_s[tt], 30.f))),
                         1e-30f);
  }
  // g * (Q C_c) + s V (s from registers, hi and lo; V N-major)
  const float g0 = g_s[r0], g1 = g_s[r0 + 8];
#pragma unroll
  for (int nb = 0; nb < kOutN / 8; ++nb) {
    acc[4 * nb] = __fmul_rn(acc[4 * nb], g0);
    acc[4 * nb + 1] = __fmul_rn(acc[4 * nb + 1], g0);
    acc[4 * nb + 2] = __fmul_rn(acc[4 * nb + 2], g1);
    acc[4 * nb + 3] = __fmul_rn(acc[4 * nb + 3], g1);
  }
  wg::mbar_wait(vbar, 0);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < LC / 16; ++kk) {
    const uint64_t vd = wg::sw128_desc(v_s + kk * 16 * 128, kBox);
    Mma<kOutN>::rs(acc, shi[kk], vd);
    Mma<kOutN>::rs(acc, slo[kk], vd);
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);
  bf16* h_bc = h_out + (((long)b * S + t0) * H + hh) * D;
#pragma unroll
  for (int nb = 0; nb < kOutN / 8; ++nb) {
    const int col = j0 + 8 * nb + 2 * tq;
    if (col >= D) continue;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(h_bc + (long)r0 * H * D + col) =
          wg::pack_bf16(acc[4 * nb] * inv[0], acc[4 * nb + 1] * inv[0]);
    if (r0 + 8 < L)
      *reinterpret_cast<uint32_t*>(h_bc + (long)(r0 + 8) * H * D + col) =
          wg::pack_bf16(acc[4 * nb + 2] * inv[1], acc[4 * nb + 3] * inv[1]);
  }
}

// ---------------------------------------------------------------------------
// 3. the fp32 chunk loop
// ---------------------------------------------------------------------------
constexpr int kLoopChunk = 64;  // tokens per chunk of the loop
constexpr int kThreads = 256;   // threads per block
constexpr int kDK = 32;         // head-dim columns of q and k per stream tile
constexpr int kPad = kDK + 1;   // row stride of the q/k tiles (no conflicts)
constexpr int kMaxDV = 32;      // widest value tile
constexpr int kAccPerThread = kLoopChunk * kMaxDV / kThreads;

__host__ __device__ inline size_t smem_floats(int D, int DV) {
  return (size_t)D * DV              // C slice
         + D                         // private n
         + kLoopChunk * kLoopChunk   // decayed scores
         + 2 * kLoopChunk * kPad     // q and k stream tiles
         + kLoopChunk * DV           // v tile
         + 5 * kLoopChunk;           // b, log_i, m_t, g_t, nrm_t (w_s: g)
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
  float* sc = n_s + D;                       // [kLoopChunk][kLoopChunk]
  float* q_s = sc + kLoopChunk * kLoopChunk; // [kLoopChunk][kPad]
  float* k_s = q_s + kLoopChunk * kPad;      // [kLoopChunk][kPad]
  float* v_s = k_s + kLoopChunk * kPad;      // [kLoopChunk][DV]
  float* b_s = v_s + kLoopChunk * DV;        // [kLoopChunk] cumulative log_f
  float* li_s = b_s + kLoopChunk;            // [kLoopChunk] log_i
  float* m_s = li_s + kLoopChunk;            // [kLoopChunk] row stabilizer
  float* g_s = m_s + kLoopChunk;             // [kLoopChunk] inter scale, then w
  float* nr_s = g_s + kLoopChunk;            // [kLoopChunk] n.q, then nrm
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

  for (int t0 = 0; t0 < S; t0 += kLoopChunk) {
    const int L = min(kLoopChunk, S - t0);
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
      for (int i = tid; i < kLoopChunk * kDK; i += kThreads) {
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
        sc[t * kLoopChunk + s] = val;
      }
    }
    for (int i = tid; i < kLoopChunk * DV; i += kThreads) {
      const int s = i / DV, j = i % DV;
      v_s[i] = s < L ? paged::to_float(v_bh[(long)(t0 + s) * vs.s + j]) : 0.f;
    }
    if (tid < L) nr_s[tid] = qn;
    __syncthreads();
    if (tid < L) {
      float sum = 0.f;
      for (int s = 0; s <= tid; ++s) sum += sc[tid * kLoopChunk + s];
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
          pv = fmaf(sc[t * kLoopChunk + s], v_s[s * DV + j], pv);
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
      for (int i = tid; i < kLoopChunk * kDK; i += kThreads) {
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

// Ring stages of the state and output passes: as many as fit in a block's
// shared memory beside their fixed parts and the nc-sized tails, at most 4
// (0 or 1 when S is too long for two).
template <int LC>
int state_stages(int nc) {
  const size_t fixed = state_smem<LC>(0, nc);
  if (fixed >= (size_t)wg::kSmemLimit) return 0;
  return std::min<int>(4, (int)((wg::kSmemLimit - fixed) /
                                (StateGeo<LC>::STAGE + 24)));
}

template <int LC>
int out_stages(int nc, int D) {
  const size_t fixed = out_smem<LC>(0, nc, D);
  if (fixed >= (size_t)wg::kSmemLimit) return 0;
  return std::min<int>(4, (int)((wg::kSmemLimit - fixed) /
                                (OutGeo<LC>::STAGE + 16)));
}

// The chunk-start planes of every (b, h) and chunk as one 3-D tensor map
// [D columns, D rows, B*H*nc*2 planes], boxes of [64, 64, 1] with the
// 128-byte swizzle (the state pass stores its tiles through it, the
// output pass loads them); rows and columns past D are outside the map.
cudaError_t planes_map(const void* ptr, int D, long planes, CUtensorMap* out) {
  wg::MapKey k = wg::map_key(ptr, 3);
  k.dims[0] = (cuuint64_t)D;
  k.dims[1] = (cuuint64_t)D;
  k.dims[2] = (cuuint64_t)planes;
  k.strides[0] = (cuuint64_t)D * 2;
  k.strides[1] = (cuuint64_t)D * D * 2;
  k.box[0] = 64;
  k.box[1] = 64;
  k.box[2] = 1;
  return wg::tensor_map(k, out);
}

// The three passes' kernels, grids, threads and shared memory over S
// tokens (chunks of LC) at head dim D for B*H (batch row, head) pairs: 0
// the gate pass, 1 the state pass, 2 the output pass.
struct PassLaunch {
  const void* kernel;
  dim3 grid;
  int threads;
  size_t smem;
  int stages, columns;
};

template <int LC>
PassLaunch pass_launch(int pass, int BH, int S, int D) {
  const int nc = (S + LC - 1) / LC;
  if (pass == 0)
    return {(const void*)mlstm_gate_kernel<LC>, dim3(nc, BH),
            Tok<LC>::THREADS, GateGeo<LC>::kSmem, GateGeo<LC>::kStages, LC};
  if (pass == 1) {
    const int st = state_stages<LC>(nc);
    return {(const void*)mlstm_state_kernel<LC>,
            dim3(BH, (D + 63) / 64, (D + kStateN - 1) / kStateN),
            kStateThreads, state_smem<LC>(st, nc), st, kStateN};
  }
  const int st = out_stages<LC>(nc, D);
  return {(const void*)mlstm_output_kernel<LC>,
          dim3(nc, BH, (D + kOutN - 1) / kOutN), Tok<LC>::THREADS,
          out_smem<LC>(st, nc, D), st, kOutN};
}

PassLaunch pass_launch(int pass, int BH, int S, int D) {
  return chunk_for(S) == kShortChunk ? pass_launch<kShortChunk>(pass, BH, S, D)
                                     : pass_launch<kChunk>(pass, BH, S, D);
}

template <int LC>
int launch_passes(const Args& a, cudaStream_t stream) {
  if (!a.gates || !a.c_scr || !a.n_scr) return (int)cudaErrorInvalidValue;
  const int nc = (a.S + LC - 1) / LC;
  const int BH = a.B * a.H;
  PassLaunch p[3];
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 3 && err == cudaSuccess; ++i) {
    p[i] = pass_launch<LC>(i, BH, a.S, a.D);
    if (p[i].stages < 2) return (int)cudaErrorInvalidValue;
    err = paged::reserve_smem(p[i].kernel, p[i].smem);
  }
  CUtensorMap q_map, k_map, v_map, c_map;
  int q_slots = 0, k_slots = 0, v_slots = 0;
  if (err == cudaSuccess)
    err = wg::strided_map(a.q, a.B, a.H, a.S, a.D, a.qs.b, a.qs.h, a.qs.s,
                          LC, &q_map, &q_slots);
  if (err == cudaSuccess)
    err = wg::strided_map(a.k, a.B, a.H, a.S, a.D, a.ks.b, a.ks.h, a.ks.s,
                          LC, &k_map, &k_slots);
  if (err == cudaSuccess)
    err = wg::strided_map(a.v, a.B, a.H, a.S, a.D, a.vs.b, a.vs.h, a.vs.s,
                          LC, &v_map, &v_slots);
  if (err == cudaSuccess)
    err = planes_map(a.c_scr, a.D, (long)BH * nc * 2, &c_map);
  if (err != cudaSuccess) return (int)err;
  bf16* h = reinterpret_cast<bf16*>(a.h);
  mlstm_gate_kernel<LC><<<p[0].grid, p[0].threads, p[0].smem, stream>>>(
      q_map, k_map, q_slots, k_slots, a.log_i, a.log_f, a.is, a.fs, a.gates,
      a.S, a.H, a.D, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_state_kernel<LC><<<p[1].grid, p[1].threads, p[1].smem, stream>>>(
      k_map, v_map, c_map, k_slots, v_slots, a.C, a.n_in, a.m_in, a.rows,
      a.cb, a.nb, a.mb, a.gates, a.n_scr, a.n_out, a.m_out, a.S, a.H, a.D,
      nc, p[1].stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_output_kernel<LC><<<p[2].grid, p[2].threads, p[2].smem, stream>>>(
      q_map, v_map, c_map, q_slots, v_slots, a.m_in, a.rows, a.mb, a.gates,
      a.n_scr, h, a.S, a.H, a.D, nc, p[2].stages);
  return (int)cudaGetLastError();
}

int launch_passes(const Args& a, cudaStream_t stream) {
  return chunk_for(a.S) == kShortChunk ? launch_passes<kShortChunk>(a, stream)
                                       : launch_passes<kChunk>(a, stream);
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
// caller also allocates the passes' scratch (mlstm_chunkwise_plan gives
// the sizes; q, k, v 16-byte aligned with strides of multiples of 8, as
// their tensor maps need), otherwise gates, c_scr and n_scr may be null.
// Returns cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue when D is not a multiple of 32 up to 1024, the
// scratch is missing, a tensor map is refused or S is too long for the
// passes' shared memory. Allocates nothing and does not synchronise: the
// launches go on `stream`.
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

// The kernels a launch of (S, dtype) runs, and for the bf16 passes (in
// chunks of chunk_for(S)) the scratch they need per (batch row, head):
// floats of gates, bf16 elements of chunk-start C planes, floats of
// chunk-start n (info[0..3]).
int mlstm_chunkwise_plan(int S, int D, int is_bf16, long long* info) {
  const bool passes = is_bf16 && S > 1;
  const int LC = chunk_for(S), nc = (S + LC - 1) / LC;
  info[0] = passes ? 3 : 1;
  info[1] = passes ? gate_floats(nc, LC) : 0;
  info[2] = passes ? (long long)nc * 2 * D * D : 0;
  info[3] = passes ? (long long)nc * D : 0;
  return 0;
}

// info[0..5] of bf16 pass `pass` (0 gates, 1 states, 2 outputs) launched
// over S tokens at head dim D: registers, local (spill) bytes, dynamic
// shared memory, resident blocks per SM, tokens a chunk and columns a
// block (its products' N); cudaErrorInvalidValue for another pass or an S
// too long for its shared memory.
int mlstm_chunkwise_pass_attributes(int S, int D, int pass, int* info) {
  if (pass < 0 || pass > 2 || S < 2) return (int)cudaErrorInvalidValue;
  const PassLaunch p = pass_launch(pass, 1, S, D);
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = paged::reserve_smem(p.kernel, p.smem);
  if (err != cudaSuccess) return (int)err;
  const int code = wg::attributes(p.kernel, p.smem, info, p.threads);
  info[4] = kChunk;
  info[5] = p.columns;
  return code;
}

const char* mlstm_chunkwise_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
