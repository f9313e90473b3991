// Paged-attention decode, for Hopper (sm_90a): one query token per
// sequence, over the fused KV pool or over split K and V pools.
//
// Replaces two TPU kernels of src/repro/kernels/paged_attention/kernel.py:
// paged_attention_fused (_fused_kernel), over the fused head-interleaved
// pool [Hkv, P, 2, ps, D], and paged_attention (_kernel), the same function
// over separate K and V pools, each [Hkv, P, ps, D]. GQA through block
// tables, masks k_pos < len and k_pos >= len - window, optional softcap,
// fp32 online softmax; partial != 0 (fused pool) returns the un-normalized
// state (acc, m, l).
//
// Bound on the H100: bytes. Each (row, kv head) reads its live pages once
// (2*ps*D elements each) and does 4*G*D flops per key, about G flops per
// byte in bf16 (3 for llama3.2-3b) against the ~295 at which the tensor
// cores become the limit. The cost is bytes that are not in flight and the
// instructions that feed the products. Both blocks below share:
//   - Split-K. The grid is (B, Hkv x head groups, n_split); the wrapper
//     chooses n_split from shapes only (B, Hkv, G, the table width n, the
//     SM count, the block's occupancy). Each block cuts its row's live page
//     range [j_lo, j_hi) (floor division, the window, no table column past
//     the row's last page; the engine zero-pads tables to a power of two)
//     into n_split near-equal parts on the device: lengths never go to the
//     host.
//   - Merges. A block's warps (or warpgroups) merge once, at the end,
//     through shared memory (finish_block). With n_split > 1 each block
//     writes its fp32 state (acc, m, l) to the caller's scratch, and the
//     last block of its (row, head group), known by an atomic ticket,
//     merges the splits in order (as combine_partials does) and resets the
//     ticket: a decode call stays one launch.
// The rounding is the plain version's: scores in fp32, then the softcap,
// then the mask (masked = -1e30, finite), l summed from the unrounded p, p
// rounded to V's dtype before P.V, out = acc / max(l, 1e-30). A block with
// no pages contributes (0, -1e30, 0); a row of length 0 writes zeros. Both
// pool layouts run the same kernel (the page source is runtime data) with
// the same split plan, so split pools give the fused pool's output bit for
// bit on the same keys. A block holds at most kHeadsPerBlock query heads;
// more take more head groups of the grid.
//
// The tensor-core block (paged_attention_wgmma_kernel), for bf16 at head dim
// 64, 128 or 256 over pages of a multiple of 8 keys dividing its 64-key
// tile (the serving path; takes_wgmma). Decode has G <= 8 query rows per
// (row, kv head), far too few for wgmma's 64-row tiles, so the products
// are turned around and the keys are the M rows:
//   - S^T[64 keys, 8] = K_tile . q^T, one wgmma m64n8k16 per 16 columns of
//     D: A is the tile's K rows from shared memory (K-major, 128-byte
//     swizzle, the layout of attend_wgmma.cuh's K tiles), B is q, the
//     block's heads zero-padded to 8 rows, loaded once into the same
//     layout. A thread holds 4 scores: keys 16w + gq and + 8, heads 2tq and
//     2tq + 1 (warp w, lane 4gq + tq).
//   - O^T[D, 8] += V_tile^T . P^T, one m64n8k16 per 64 rows of D and 16
//     keys: A is the V tile through a transposed (M-major) descriptor, B
//     the tile's bf16 probabilities, written by the threads to one 8 x 64-
//     key swizzle atom (two, alternating) and fenced to the async proxy.
//     O^T is D/64 x 4 registers a thread.
//   - The tile's max over keys spans the 4 warps' M rows: each warp
//     reduces its 16 keys with shuffles, and the 4 warps' maxima meet in
//     shared memory behind a named barrier of the warpgroup; every thread
//     then holds the running m of its two heads and its own share of l.
//   - Loads by TMA, in the layout of attend_wgmma.cuh's PagedTiles: one
//     2-D tensor map over the pool's rows (two for the split pools), one
//     box of [ps, 64 columns] per page and swizzle atom, KT / ps pages a
//     tile; a producer warp fills a ring of kStages tiles (96 KB at D 128:
//     two blocks an SM), each stage with a full mbarrier (arrive.expect_tx,
//     the copies' complete_tx) and an empty one (one arrival a consumer
//     warp), and loads its pages' table entries a tile ahead. Pages past
//     the split's range in its last tile are the range's last page again,
//     and masked.
//   - Each tile j issues S_j and P_{j-1}.V_{j-1} together and computes its
//     softmax while the second is on the tensor cores (the first tile is
//     peeled: a wgmma behind a branch in the loop is serialized).
//   On an H100 llama3.2-3b's serving-like batch (B8) takes 1.4x its bytes'
//   time, and neither a build without the loads nor one without the
//   products gives back more than 0.2 of it: a block's serial chain (q,
//   the first tile's latency, a barrier or two a tile) and the merge of
//   the splits behind the slowest one are what is left.
// The scalar block (paged_attention_decode_kernel), for fp32 (its limit,
// 2e-5 + 2e-5|ref|, rules out bf16 and TF32 operands) and bf16 at other
// head dims or page sizes:
//   - Warps own pages. A block is kWarps warps, with no block-wide barrier
//     in its main loop. Warp w walks chunks w, w + kWarps, ... of its
//     split (a chunk is up to KC keys of one page, its K rows and V rows,
//     at most 4 KB), each copied to shared memory by cp.async, 16 bytes a
//     lane, into a ring of kStages chunks of its own, issued kStages - 1
//     chunks ahead of the one it computes.
//   - Lanes split D. L lanes hold one key row, 8 elements each (16 bytes
//     in bf16), so a warp takes 32 / L keys a step. q of the block's heads
//     sits in registers in fp32; scores are reduced over the L lanes with
//     shuffles; each warp keeps its own fp32 online softmax (one rescale a
//     chunk) and accumulators. On an H100 the block is bound by its
//     instruction stream more than by its loads (a build without the loads
//     took as long), so L is a template argument (the shuffle trees
//     unroll) and a block has 8 warps.
#include <algorithm>

#include "attend_mma.cuh"
#include "attend_wgmma.cuh"
#include "paged_common.cuh"

namespace {

constexpr int kWarps = 8;             // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;            // chunks in a warp's cp.async ring
constexpr int kHeadsPerBlock = 8;     // query heads a block holds, at most
// Key steps (32 / L keys each) of a chunk in bf16; fp32 past D 32 takes
// half as many (two vectors a lane), so a chunk is at most 4 KB of K and V.
constexpr int kSteps = 4;
constexpr unsigned kFull = 0xffffffffu;

// Lanes holding one key row, each 8 of its elements (one 16-byte vector in
// bf16, two in fp32): D / 8 rounded up to a power of two in [8, 32].
inline int lanes_per_key(int D) {
  int L = 8;
  while (L < 32 && L * 8 < D) L *= 2;
  return L;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// The page source is runtime data, so both pool layouts run one kernel:
// page `page` (kv head x P + the table's entry) holds its K rows at
// k + page * page_stride and its V rows at v + page * page_stride. The
// fused pool [Hkv, P, 2, ps, D] is (kv, kv + ps*D, 2*ps*D); split pools
// [Hkv, P, ps, D] are (k, v, ps*D).
struct Args {
  const void* q;                // [B, H, D]
  const void* k;
  const void* v;
  long page_stride;
  const int* block_tables;      // [B, n]
  const int* lengths;           // [B]
  void* out;                    // [B, H, D]: q's dtype, or fp32 acc
  float* m_out;                 // [B, H] when partial
  float* l_out;
  float* part;                  // n_split > 1: acc [S, B*H, D], m, l [S, B*H]
  int* tickets;                 // n_split > 1: [B, gridDim.y], zero
  int B, Hkv, G, D, P, ps, n;
  float scale;
  int window;
  float softcap;
  int partial, n_split;
  int head_groups, group;       // grid.y = Hkv x head_groups, group heads each
  int KC;                       // keys a chunk
  int fused;                    // k, v: the fused pool (else split pools)
};

template <typename T>
__device__ __forceinline__ void write_out(const Args& a, long r, int d,
                                          float acc, float m, float l) {
  if (a.partial) {
    reinterpret_cast<float*>(a.out)[r * a.D + d] = acc;
    if (d == 0) {
      a.m_out[r] = m;
      a.l_out[r] = l;
    }
  } else {
    reinterpret_cast<T*>(a.out)[r * a.D + d] =
        paged::from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

// The barrier of the threads that finish a block: __syncthreads in the
// scalar block, named barrier 3 of the consumer warpgroups in the
// tensor-core block (whose producer warp has left).
template <int kT, bool kNamed>
__device__ __forceinline__ void block_sync() {
  if constexpr (kNamed)
    wg::named_sync(3, kT);
  else
    __syncthreads();
}

// The end of a block, run by its kT threads tid < kT: the states of its W
// warps (or warpgroups) are in shared memory (wm, wl [W][GB], then wacc
// [W][GB][D], written before the call) and are merged (M = max m, weights
// exp(m - M)); then out, or with n_split > 1 the split's state to `part`
// and, in the last split block of this (row, head group) (an atomic
// ticket), the splits merged in order. smem is then reused for the
// splits' weights.
template <typename T, int GB, int W, int kT, bool kNamed>
__device__ void finish_block(const Args& a, unsigned char* smem,
                             int* last_block, long row0, int gn, int sp,
                             int tid) {
  block_sync<kT, kNamed>();
  constexpr int kWarpsHere = kT / 32;
  const int warp = tid >> 5, lane = tid & 31;
  const int D = a.D;
  const long BH = (long)a.B * a.Hkv * a.G;
  const float* wm = reinterpret_cast<const float*>(smem);
  const float* wl = wm + W * GB;
  const float* wacc = wl + W * GB;
  const bool split = a.n_split > 1;
  float* pacc = a.part;
  float* pm = a.part + a.n_split * BH * D;
  float* pl = pm + a.n_split * BH;
  for (int x = tid; x < gn * D; x += kT) {
    const int g = x / D, d = x % D;
    float M = paged::kNegInf;
    for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w * GB + g]);
    float Ls = 0.f, A = 0.f;
    for (int w = 0; w < W; ++w) {
      const float c = expf(wm[w * GB + g] - M);
      Ls += wl[w * GB + g] * c;
      A += wacc[(w * GB + g) * D + d] * c;
    }
    const long r = row0 + g;
    if (split) {
      pacc[(sp * BH + r) * D + d] = A;
      if (d == 0) {
        pm[sp * BH + r] = M;
        pl[sp * BH + r] = Ls;
      }
    } else {
      write_out<T>(a, r, d, A, M, Ls);
    }
  }
  if (!split) return;

  // the last split block of this (row, head group) merges the splits
  __threadfence();
  block_sync<kT, kNamed>();
  int* ticket = a.tickets + (long)blockIdx.x * gridDim.y + blockIdx.y;
  if (tid == 0) *last_block = atomicAdd(ticket, 1) == a.n_split - 1;
  block_sync<kT, kNamed>();
  if (!*last_block) return;
  __threadfence();
  // each head's split weights w[g][t] = exp(m_t - M), M and L, one warp a
  // head
  const int S = a.n_split;
  float* wt = reinterpret_cast<float*>(smem);     // [GB][S]
  float* mls = wt + GB * S;                       // M [GB], then L [GB]
  for (int g = warp; g < gn; g += kWarpsHere) {
    const long r = row0 + g;
    float M = paged::kNegInf;
    for (int t = lane; t < S; t += 32) M = fmaxf(M, __ldcg(pm + t * BH + r));
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
    float Ls = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float c = expf(__ldcg(pm + t * BH + r) - M);
      wt[g * S + t] = c;
      Ls += __ldcg(pl + t * BH + r) * c;
    }
    for (int o = 16; o > 0; o >>= 1) Ls += __shfl_xor_sync(kFull, Ls, o);
    if (lane == 0) {
      mls[g] = M;
      mls[GB + g] = Ls;
    }
  }
  block_sync<kT, kNamed>();
  // acc summed over the splits, 4 columns a thread, eight splits' loads in
  // flight at once (the merge's L2 round trips follow the slowest split)
  const int D4 = D / 4;
  for (int x = tid; x < gn * D4; x += kT) {
    const int g = x / D4, d = (x % D4) * 4;
    const long r = row0 + g;
    const float* w = wt + g * S;
    const float* src = pacc + r * D + d;          // split t at t * BH * D
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < S; t += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = t + u < S ? __ldcg(reinterpret_cast<const float4*>(
                               src + (t + u) * BH * D))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float c = t + u < S ? w[t + u] : 0.f;
        A.x += v[u].x * c;
        A.y += v[u].y * c;
        A.z += v[u].z * c;
        A.w += v[u].w * c;
      }
    }
    write_out<T>(a, r, d, A.x, mls[g], mls[GB + g]);
    write_out<T>(a, r, d + 1, A.y, mls[g], mls[GB + g]);
    write_out<T>(a, r, d + 2, A.z, mls[g], mls[GB + g]);
    write_out<T>(a, r, d + 3, A.w, mls[g], mls[GB + g]);
  }
  if (tid == 0) *ticket = 0;      // ready for the next call
}

// One block: row b, kv head h, heads [g0, g0 + gn) of its group, split sp.
// L lanes a key row with NV 16-byte vectors each, GB >= gn heads in
// registers (the heads past gn hold q = 0 and are never written).
template <typename T, int L, int NV, int GB>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(const Args a) {
  constexpr int VN = Vec<T>::N;
  constexpr int VE = NV * VN;             // elements a lane holds of a row
  constexpr int kpi = 32 / L;             // keys a step
  constexpr int STEPS = kSteps / NV;      // steps a chunk: 4 KB of K and V
  constexpr int ROWS = STEPS * kpi;       // key rows a ring slot holds
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;

  const int b = blockIdx.x;
  const int h = blockIdx.y / a.head_groups;
  const int g0 = (blockIdx.y % a.head_groups) * a.group;
  const int gn = min(a.group, a.G - g0);
  const int sp = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D, ps = a.ps, KC = a.KC;
  const int dv = D / VN;                  // 16-byte vectors a row
  const int kg = lane / L, li = lane % L; // key of the step, vector slot

  // this split's pages [p_lo, p_hi) of the row's live range
  const int length = a.lengths[b];
  const int j_hi = min(paged::floordiv(length + ps - 1, ps), a.n);
  int j_lo = a.window > 0 ? max(paged::floordiv(length - a.window, ps), 0)
                          : 0;
  j_lo = min(j_lo, max(j_hi, 0));
  const int np = max(j_hi - j_lo, 0);
  const int p_lo = j_lo + (int)((long)np * sp / a.n_split);
  const int p_hi = j_lo + (int)((long)np * (sp + 1) / a.n_split);
  const int cpp = (ps + KC - 1) / KC;     // chunks a page
  const int units = (p_hi - p_lo) * cpp;
  const int mine = units > warp ? (units - warp + kWarps - 1) / kWarps : 0;

  const long row0 = (long)b * a.Hkv * a.G + (long)h * a.G + g0;

  float qr[GB][VE];
  const T* q = reinterpret_cast<const T*>(a.q) + row0 * D;
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = v * L + li;
      if (g < gn && vi < dv) {
        Vec<T>::unpack(
            *reinterpret_cast<const uint4*>(q + (long)g * D + vi * VN),
            &qr[g][v * VN]);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) qr[g][v * VN + e] = 0.f;
      }
    }
  int vc[NV];                             // the lane's vectors of a row
#pragma unroll
  for (int v = 0; v < NV; ++v) vc[v] = v * L + li < dv ? v * L + li : 0;
  float acc[GB][VE], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = paged::kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[g][e] = 0.f;
  }

  const int slot = 2 * ROWS * D;          // ROWS K rows, then ROWS V rows
  T* ring = reinterpret_cast<T*>(smem) + (long)warp * kStages * slot;
  const int* bt_row = a.block_tables + (long)b * a.n;
  const long page0 = (long)h * a.P;

  // copy the warp's i-th chunk into its ring slot, rows past the chunk's
  // kc keys zero-filled (so that every step below runs unconditionally);
  // one commit group each, empty past the last chunk, so that the wait
  // below counts uniformly. Lane j fetches the table entry of chunk
  // i + j every 32 chunks, and a shuffle hands each one out.
  int pages = 0;
  auto issue = [&](int i) {
    if (i % 32 == 0 && i < mine) {
      const int uj = warp + (i + lane) * kWarps;
      pages = i + lane < mine ? bt_row[p_lo + uj / cpp] : 0;
    }
    if (i < mine) {
      const int page = __shfl_sync(kFull, pages, i % 32);
      const int u = warp + i * kWarps;
      const int key0 = (u % cpp) * KC;
      const int live = min(KC, ps - key0) * dv;
      const long off = (page0 + page) * a.page_stride + (long)key0 * D;
      const T* k = reinterpret_cast<const T*>(a.k) + off;
      const T* v = reinterpret_cast<const T*>(a.v) + off;
      T* k_dst = ring + (long)(i % kStages) * slot;
      T* v_dst = k_dst + ROWS * D;
      for (int y = lane; y < ROWS * dv; y += 32) {
        const bool on = y < live;
        mma::cp_async16(k_dst + y * VN, k + (on ? y * VN : 0), on ? 16 : 0);
        mma::cp_async16(v_dst + y * VN, v + (on ? y * VN : 0), on ? 16 : 0);
      }
    }
    mma::cp_async_commit();
  };

  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    issue(i + kStages - 1);               // into the slot freed last step
    mma::cp_async_wait<kStages - 1>();    // chunk i has landed
    __syncwarp();
    const int u = warp + i * kWarps;
    const int key0 = (u % cpp) * KC;
    const int kc = min(KC, ps - key0);
    const int kp0 = (p_lo + u / cpp) * ps + key0;
    const T* k_s = ring + (long)(i % kStages) * slot;
    const T* v_s = k_s + ROWS * D;

    // scores of the chunk: fp32 dot products reduced over the L lanes,
    // then scale, softcap, mask; no branch but the uniform softcap one, so
    // that the steps' loads and shuffle trees overlap
    // (a lane past the row's vectors reads the row's first one: its q is
    // 0, and its accumulators are never written out)
    float s[STEPS][GB];
#pragma unroll
    for (int it = 0; it < STEPS; ++it) {
      const T* kr = k_s + (it * kpi + kg) * D;
#pragma unroll
      for (int g = 0; g < GB; ++g) s[it][g] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float kf[VN];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(kr + vc[v] * VN), kf);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < VN; ++e)
            s[it][g] = fmaf(qr[g][v * VN + e], kf[e], s[it][g]);
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o /= 2)
#pragma unroll
      for (int it = 0; it < STEPS; ++it)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          s[it][g] += __shfl_xor_sync(kFull, s[it][g], o);
#pragma unroll
    for (int it = 0; it < STEPS; ++it)
#pragma unroll
      for (int g = 0; g < GB; ++g) s[it][g] *= a.scale;
    if (a.softcap > 0.f) {
#pragma unroll
      for (int it = 0; it < STEPS; ++it)
#pragma unroll
        for (int g = 0; g < GB; ++g)
          s[it][g] = a.softcap * tanhf(s[it][g] / a.softcap);
    }
    float cmax[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) cmax[g] = paged::kNegInf;
#pragma unroll
    for (int it = 0; it < STEPS; ++it) {
      const int key = it * kpi + kg;
      const int kp = kp0 + key;
      const bool ok = kp < length && (a.window <= 0 || length - 1 - kp <
                                                           a.window);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        // a row past the chunk's keys is no key at all: p = 0, l unchanged
        s[it][g] = key < kc ? (ok ? s[it][g] : paged::kNegInf)
                            : __int_as_float(0xff800000);
        cmax[g] = fmaxf(cmax[g], s[it][g]);
      }
    }

    // one online-softmax step for the chunk (m is the same on every lane)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int o = L; o < 32; o *= 2)
        cmax[g] = fmaxf(cmax[g], __shfl_xor_sync(kFull, cmax[g], o));
      const float mx = fmaxf(m[g], cmax[g]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int it = 0; it < STEPS; ++it) {
      float pr[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = expf(s[it][g] - m[g]);
        l[g] += p;                        // each key group's own keys
        pr[g] = paged::to_float(paged::from_float<T>(p));
      }
      const T* vr = v_s + (it * kpi + kg) * D;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float vf[VN];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(vr + vc[v] * VN), vf);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < VN; ++e)
            acc[g][v * VN + e] = fmaf(pr[g], vf[e], acc[g][v * VN + e]);
      }
    }
    __syncwarp();                         // the slot may be refilled
  }
  mma::cp_async_wait<0>();

  // sum l and acc over the warp's key groups
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int o = L; o < 32; o *= 2) {
      l[g] += __shfl_xor_sync(kFull, l[g], o);
#pragma unroll
      for (int e = 0; e < VE; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }

  // merge the warps through shared memory (the rings are done)
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);     // [kWarps][GB]
  float* wl = wm + kWarps * GB;
  float* wacc = wl + kWarps * GB;                 // [kWarps][GB][D]
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      wm[warp * GB + g] = m[g];
      wl[warp * GB + g] = l[g];
    }
  if (kg == 0)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = v * L + li;
        if (vi >= dv) continue;
#pragma unroll
        for (int e = 0; e < VN; ++e)
          wacc[(warp * GB + g) * D + vi * VN + e] = acc[g][v * VN + e];
      }
  finish_block<T, GB, kWarps, kThreads, false>(a, smem, &last_block, row0, gn,
                                               sp, threadIdx.x);
}

// ---------------------------------------------------------------------------
// The tensor-core block (bf16, head dim 64, 128 or 256)
// ---------------------------------------------------------------------------
constexpr int kKeyTile = 64;        // keys a tile: the M rows of a wgmma
constexpr int kConsumers = 1;       // consumer warpgroups a block
constexpr int kWgThreads = 128 * kConsumers + 32;   // and a producer warp

// The block's shared memory (from a 1024-aligned base): [ring: kStages x
// (K tile, V tile), each D/64 swizzle atoms of KT rows x 128 bytes][q: D/64
// atoms of 8 rows][P^T: 2 atoms of 8 heads x 64 keys a consumer][the max
// exchange: 2 x 4 warps x 8 heads floats a consumer][full[S], empty[S]].
template <int D_>
struct DecodeGeo {
  static_assert(D_ == 64 || D_ == 128 || D_ == 256, "head dim 64, 128, 256");
  static constexpr int D = D_;
  static constexpr int KT = kKeyTile;
  static constexpr int KD = D / 16;             // k-steps of K.q^T
  static constexpr int MD = D / 64;             // 64-row blocks of V^T.P^T
  static constexpr int K_BYTES = KT * D * 2;
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int RING = kStages * STAGE;
  static constexpr int Q_OFF = RING;
  static constexpr int P_BYTES = kHeadsPerBlock * KT * 2;
  static constexpr int P_OFF = Q_OFF + kHeadsPerBlock * D * 2;
  static constexpr int RED_OFF = P_OFF + kConsumers * 2 * P_BYTES;
  static constexpr int BAR_OFF = RED_OFF + kConsumers * 2 * 4 *
                                               kHeadsPerBlock * 4;
  static constexpr size_t kSmem = wg::kAlign + BAR_OFF + 16 * kStages;
  // the end's states and the splits' weights reuse the ring
  static constexpr int kMaxSplits = RING / 4 / kHeadsPerBlock - 2;
  static_assert(kConsumers * kHeadsPerBlock * (D + 2) * 4 <= RING,
                "the warpgroups' states fit in the ring");
  // a stage serves one warpgroup only (tile j is stage j % kStages and
  // warpgroup j % kConsumers's), so that its barriers' phases alternate
  // between one waiter and the producer, and two stages at least
  static_assert(kStages % kConsumers == 0 && kStages >= 2 * kConsumers,
                "each warpgroup owns two stages or more");
};

// d (+)= A.B for one warpgroup, m64n8k16, both operands from shared memory
// (B K-major); kTransA: A M-major (the V tile read as V^T).
template <int kTransA>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA));
}

// S^T = K_tile . q^T: for each k-step of 16, one m64n8k16 of the tile's 64
// K rows (k_s) and the 8 query rows (q_s), both K-major.
template <class Geo>
__device__ __forceinline__ void issue_scores(float (&s)[4], uint32_t q_s,
                                             uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < Geo::KD; ++kk)
    wgmma_n8<0>(s,
                wg::sw128_desc(k_s + (kk / 4) * (Geo::KT * 128) +
                               (kk % 4) * 32),
                wg::sw128_desc(q_s + (kk / 4) * 1024 + (kk % 4) * 32),
                kk > 0);
}

// O^T += V_tile^T . P^T: for each 16 keys and 64 rows of D, one m64n8k16 of
// the V tile (v_s, read M-major) and the tile's probabilities (p_s,
// K-major).
template <class Geo>
__device__ __forceinline__ void issue_pv(float (&o)[Geo::MD][4], uint32_t v_s,
                                         uint32_t p_s) {
#pragma unroll
  for (int kk = 0; kk < Geo::KT / 16; ++kk)
#pragma unroll
    for (int mb = 0; mb < Geo::MD; ++mb)
      wgmma_n8<1>(o[mb],
                  wg::sw128_desc(v_s + mb * (Geo::KT * 128) + kk * 16 * 128,
                                 Geo::KT * 128),
                  wg::sw128_desc(p_s + kk * 32), 1);
}

// What a consumer thread sees of its block: keys kp visible when kp < hi
// (the split's end or the row's length) and inside the window.
struct DecodeMask {
  int kp0, hi, length, window;
  float scale, softcap;
};

// The online-softmax step of tile j from its scores s (keys k0 = 16w + gq
// and k0 + 8, heads 2tq and 2tq + 1): s * scale, the softcap, the masks
// (-1e30); the tile's max over its 64 keys (shuffles over the warp's 16,
// then the 4 warps' through `red` behind named barrier `bar`); m, l, corr
// updated; s = exp(s - m) unrounded, summed into this thread's l.
__device__ __forceinline__ void decode_softmax(float (&s)[4], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float* red, int bar, int j,
                                               const DecodeMask& dm, int w,
                                               int gq, int tq) {
#pragma unroll
  for (int x = 0; x < 4; ++x) s[x] *= dm.scale;
  if (dm.softcap > 0.f) {
#pragma unroll
    for (int x = 0; x < 4; ++x) s[x] = dm.softcap * tanhf(s[x] / dm.softcap);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int kp = dm.kp0 + j * kKeyTile + 16 * w + gq + 8 * (x >> 1);
    const bool ok = kp < dm.hi &&
                    (dm.window <= 0 || dm.length - 1 - kp < dm.window);
    s[x] = ok ? s[x] : paged::kNegInf;
  }
  float mx[2] = {fmaxf(s[0], s[2]), fmaxf(s[1], s[3])};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int o = 4; o < 32; o *= 2)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], o));
  if (gq == 0) {
    red[w * kHeadsPerBlock + 2 * tq] = mx[0];
    red[w * kHeadsPerBlock + 2 * tq + 1] = mx[1];
  }
  wg::named_sync(bar, 128);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t = red[2 * tq + i];
#pragma unroll
    for (int v = 1; v < 4; ++v)
      t = fmaxf(t, red[v * kHeadsPerBlock + 2 * tq + i]);
    const float mn = fmaxf(m[i], t);
    corr[i] = expf(m[i] - mn);
    m[i] = mn;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    s[x] = expf(s[x] - m[x & 1]);
    l[x & 1] += s[x];
  }
}

// p rounded to bf16 -> the P^T atom at p_s (generic address p): row = head,
// the 16-byte chunk of keys c at c ^ head (the 128-byte swizzle).
__device__ __forceinline__ void store_p(unsigned char* p, const float (&s)[4],
                                        int w, int gq, int tq) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int key = 16 * w + gq + 8 * (x >> 1), head = 2 * tq + (x & 1);
    *reinterpret_cast<__nv_bfloat16*>(
        p + head * 128 + (((key >> 3) ^ head) << 4) + (key & 7) * 2) =
        __float2bfloat16_rn(s[x]);
  }
}

// One block: row b, kv head h, heads [g0, g0 + gn) of its group, split sp.
// Warpgroup c < kConsumers takes tiles c, c + kConsumers, ... of the split
// with its own (m, l, O); the warp after them is the producer.
template <int D>
__global__ void __launch_bounds__(kWgThreads)
paged_attention_wgmma_kernel(const Args a,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map) {
  using Geo = DecodeGeo<D>;
  constexpr int S = Geo::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last_block;
  unsigned char* base = wg::aligned_smem(smem_raw);
  const uint32_t ring = wg::smem_addr(base);
  const uint32_t full = ring + Geo::BAR_OFF, empty = full + 8 * S;

  const int b = blockIdx.x;
  const int h = blockIdx.y / a.head_groups;
  const int g0 = (blockIdx.y % a.head_groups) * a.group;
  const int gn = min(a.group, a.G - g0);
  const int sp = blockIdx.z;
  const int ps = a.ps;

  // this split's pages [p_lo, p_hi) of the row's live range
  const int length = a.lengths[b];
  const int j_hi = min(paged::floordiv(length + ps - 1, ps), a.n);
  int j_lo = a.window > 0 ? max(paged::floordiv(length - a.window, ps), 0)
                          : 0;
  j_lo = min(j_lo, max(j_hi, 0));
  const int np = max(j_hi - j_lo, 0);
  const int p_lo = j_lo + (int)((long)np * sp / a.n_split);
  const int p_hi = j_lo + (int)((long)np * (sp + 1) / a.n_split);
  const int n_tiles = ((p_hi - p_lo) * ps + Geo::KT - 1) / Geo::KT;
  const long row0 = (long)b * a.Hkv * a.G + (long)h * a.G + g0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // the producer warp: tile j into stage j % S once its last tile is
    // done. Box i of a tile (K boxes, then V; page pg, swizzle atom at) is
    // lane i % 32's (ps >= 8: 64 boxes at most), as PagedTiles lays them
    // out; each lane loads its pages' table entries a tile ahead, so that
    // their latency passes while it waits for the stage.
    const int lane = threadIdx.x & 31;
    constexpr int A = D / 64;
    const int ppt = Geo::KT / ps, boxes = 2 * ppt * A;
    const int* bt_row = a.block_tables + (long)b * a.n;
    int page[2], next[2];
    auto entry = [&](int j, int r) {
      const int i = lane + 32 * r, pg = (i % (ppt * A)) / A;
      return i < boxes && j < n_tiles
                 ? bt_row[min(p_lo + j * ppt + pg, p_hi - 1)] : 0;
    };
    page[0] = entry(0, 0);
    page[1] = entry(0, 1);
    for (int j = 0; j < n_tiles; ++j) {
      next[0] = entry(j + 1, 0);
      next[1] = entry(j + 1, 1);
      const int s = j % S;
      wg::mbar_wait(empty + 8 * s, ((j / S) & 1) ^ 1);
      if (lane == 0) wg::mbar_expect_tx(full + 8 * s, Geo::STAGE);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = lane + 32 * r;
        if (i < boxes) {
          const bool is_v = i >= ppt * A;
          const int x = is_v ? i - ppt * A : i, pg = x / A, at = x % A;
          const int row = ((h * a.P + page[r]) * (a.fused ? 2 : 1) +
                           (a.fused && is_v ? 1 : 0)) * ps;
          wg::tma_load_2d(ring + s * Geo::STAGE + (is_v ? Geo::K_BYTES : 0) +
                              (at * Geo::KT + pg * ps) * 128,
                          is_v ? &v_map : &k_map, full + 8 * s, at * 64, row);
        }
        page[r] = next[r];
      }
    }
    return;
  }

  const int t = threadIdx.x, c = t / 128, w = (t % 128) / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int bar = 1 + c;                  // this warpgroup's named barrier

  // q of the block's heads -> 8 swizzled rows (chunk x of row r at x ^ r),
  // rows past gn zero
  const uint32_t q_s = ring + Geo::Q_OFF;
  const __nv_bfloat16* q = reinterpret_cast<const __nv_bfloat16*>(a.q) +
                           row0 * D;
  for (int i = t; i < kHeadsPerBlock * (D / 8); i += 128 * kConsumers) {
    const int r = i / (D / 8), ch = i % (D / 8);
    const bool live = r < gn;
    wg::cp_async16(q_s + (ch / 8) * 1024 + r * 128 + (((ch % 8) ^ r) << 4),
                   live ? q + r * D + ch * 8 : q, live ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg::named_sync(3, 128 * kConsumers);

  const DecodeMask dm{p_lo * ps, min(p_hi * ps, length), length, a.window,
                      a.scale, a.softcap};
  const uint32_t p_s = ring + Geo::P_OFF + c * 2 * Geo::P_BYTES;
  unsigned char* p_g = base + Geo::P_OFF + c * 2 * Geo::P_BYTES;
  float* red = reinterpret_cast<float*>(base + Geo::RED_OFF) +
               c * 2 * 4 * kHeadsPerBlock;
  const int mine = n_tiles > c ? (n_tiles - c + kConsumers - 1) / kConsumers
                               : 0;

  float o[Geo::MD][4];
#pragma unroll
  for (int mb = 0; mb < Geo::MD; ++mb)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[mb][x] = 0.f;
  float m[2] = {paged::kNegInf, paged::kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float sc[4];

  if (mine > 0) {
    // this warpgroup's first tile alone (O is zero: nothing to rescale),
    // then each tile issues its scores and the previous tile's P.V
    // together: no branch around a product in the loop
    int j = c, st = j % S;
    wg::mbar_wait(full + 8 * st, (j / S) & 1);
    wg::wgmma_fence();
    issue_scores<Geo>(sc, q_s, ring + st * Geo::STAGE);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(sc);
    decode_softmax(sc, m, l, corr, red, bar, j, dm, w, gq, tq);
    store_p(p_g, sc, w, gq, tq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg::named_sync(bar, 128);
    for (int i = 1; i < mine; ++i) {
      const int pst = st;
      j = c + kConsumers * i;
      st = j % S;
      wg::mbar_wait(full + 8 * st, (j / S) & 1);
      wg::wgmma_fence();
      issue_scores<Geo>(sc, q_s, ring + st * Geo::STAGE);
      wg::wgmma_commit();
      issue_pv<Geo>(o, ring + pst * Geo::STAGE + Geo::K_BYTES,
                    p_s + ((i - 1) & 1) * Geo::P_BYTES);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
      wg::fence_regs(sc);
      decode_softmax(sc, m, l, corr, red + (i & 1) * 4 * kHeadsPerBlock, bar,
                     j, dm, w, gq, tq);
      store_p(p_g + (i & 1) * Geo::P_BYTES, sc, w, gq, tq);
      wg::wgmma_wait<0>();   // the previous tile's P.V: its stage goes back
#pragma unroll
      for (int mb = 0; mb < Geo::MD; ++mb) wg::fence_regs(o[mb]);
      if (lane == 0) wg::mbar_arrive(empty + 8 * pst);
#pragma unroll
      for (int mb = 0; mb < Geo::MD; ++mb)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[mb][x] *= corr[x & 1];
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg::named_sync(bar, 128);
    }
    wg::wgmma_fence();
    issue_pv<Geo>(o, ring + st * Geo::STAGE + Geo::K_BYTES,
                  p_s + ((mine - 1) & 1) * Geo::P_BYTES);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < Geo::MD; ++mb) wg::fence_regs(o[mb]);
  }

  // l over the warp's keys (lanes of one tq hold the same two heads), then
  // each warpgroup's m, l and O^T to the end's states in the ring: every
  // tile is consumed once all consumers pass barrier 3, and so is `red`
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int x = 4; x < 32; x *= 2) l[i] += __shfl_xor_sync(kFull, l[i], x);
  wg::named_sync(3, 128 * kConsumers);
  float* wm = reinterpret_cast<float*>(base);     // [kConsumers][8]
  float* wl = wm + kConsumers * kHeadsPerBlock;
  float* wacc = wl + kConsumers * kHeadsPerBlock;  // [kConsumers][8][D]
  if (gq == 0) {                                   // red: [4 warps][8 heads]
    red[w * kHeadsPerBlock + 2 * tq] = l[0];
    red[w * kHeadsPerBlock + 2 * tq + 1] = l[1];
    if (w == 0) {
      wm[c * kHeadsPerBlock + 2 * tq] = m[0];
      wm[c * kHeadsPerBlock + 2 * tq + 1] = m[1];
    }
  }
#pragma unroll
  for (int mb = 0; mb < Geo::MD; ++mb)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      wacc[(c * kHeadsPerBlock + 2 * tq + (x & 1)) * D + 64 * mb + 16 * w +
           gq + 8 * (x >> 1)] = o[mb][x];
  wg::named_sync(bar, 128);
  if (t % 128 < kHeadsPerBlock) {
    const int g = t % 128;
    float ls = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) ls += red[v * kHeadsPerBlock + g];
    wl[c * kHeadsPerBlock + g] = ls;
  }
  finish_block<__nv_bfloat16, kHeadsPerBlock, kConsumers, 128 * kConsumers,
               true>(a, base, &last_block, row0, gn, sp, t);
}

template <typename T, int L, int NV, int GB>
int launch_kernel(const Args& a, cudaStream_t stream) {
  constexpr int rows = kSteps / NV * (32 / L);   // the kernel's ROWS
  const size_t ring = (size_t)kWarps * kStages * 2 * rows * a.D * sizeof(T);
  const size_t merge = (size_t)GB * std::max(kWarps * (a.D + 2),
                                             a.n_split + 2) * sizeof(float);
  const size_t smem = std::max(ring, merge);
  auto kernel = paged_attention_decode_kernel<T, L, NV, GB>;
  // the limit covers the static bytes too (the ticket flag)
  cudaError_t err = paged::reserve_smem(kernel, smem + 1024);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.B, a.Hkv * a.head_groups, a.n_split), kThreads, smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int L, int NV>
int by_heads(const Args& a, cudaStream_t stream) {
  switch (a.group) {
    case 1: return launch_kernel<T, L, NV, 1>(a, stream);
    case 2: return launch_kernel<T, L, NV, 2>(a, stream);
    case 3: return launch_kernel<T, L, NV, 3>(a, stream);
    case 4: return launch_kernel<T, L, NV, 4>(a, stream);
    default: return launch_kernel<T, L, NV, kHeadsPerBlock>(a, stream);
  }
}

using WgmmaKernel = decltype(&paged_attention_wgmma_kernel<128>);

// The tensor-core kernel at head dim D and its block's resources.
struct WgmmaLaunch {
  WgmmaKernel kernel;   // null for a D it is not instantiated for
  size_t smem;
  int max_splits;
};

template <int D>
WgmmaLaunch wgmma_launch() {
  using Geo = DecodeGeo<D>;
  return {paged_attention_wgmma_kernel<D>, Geo::kSmem, Geo::kMaxSplits};
}

// The launch shape at head dim D, its shared memory reserved; err is
// cudaErrorInvalidValue for a D outside {64, 128, 256}.
WgmmaLaunch wgmma_launch(int D, cudaError_t* err) {
  const WgmmaLaunch w = D == 64    ? wgmma_launch<64>()
                        : D == 128 ? wgmma_launch<128>()
                        : D == 256 ? wgmma_launch<256>()
                                   : WgmmaLaunch{nullptr, 0, 0};
  // the limit covers the static bytes too (the ticket flag)
  *err = w.kernel ? paged::reserve_smem(w.kernel, w.smem + 1024)
                  : cudaErrorInvalidValue;
  return w;
}

// Whether a bf16 launch takes the tensor-core block: a head dim it is
// instantiated for, and pages that are whole TMA boxes of its key tile (a
// page size that is a multiple of 8 dividing kKeyTile).
bool takes_wgmma(int D, int ps) {
  return (D == 64 || D == 128 || D == 256) && ps % 8 == 0 &&
         kKeyTile % ps == 0;
}

// The tensor-core launch (a's geometry set by launch()): the pool's tensor
// maps (one over the fused pool's rows [Hkv*P*2*ps, D], or one over each
// split pool's [Hkv*P*ps, D]; boxes of [ps, 64]); cudaErrorInvalidValue for
// shapes takes_wgmma refuses, more splits than the block's merge holds, or
// a pool cuTensorMapEncodeTiled refuses.
int launch_wgmma(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  const WgmmaLaunch w = wgmma_launch(a.D, &err);
  if (err != cudaSuccess) return (int)err;
  if (!takes_wgmma(a.D, a.ps) || a.n_split > w.max_splits)
    return (int)cudaErrorInvalidValue;
  CUtensorMap k_map, v_map;
  const long rows = (long)a.Hkv * a.P * (a.fused ? 2 : 1) * a.ps;
  err = wg::rows_map(a.k, rows, a.D, a.ps, &k_map);
  if (err == cudaSuccess) {
    if (a.fused)
      v_map = k_map;
    else
      err = wg::rows_map(a.v, rows, a.D, a.ps, &v_map);
  }
  if (err != cudaSuccess) return (int)err;
  w.kernel<<<dim3(a.B, a.Hkv * a.head_groups, a.n_split), kWgThreads,
             w.smem, stream>>>(a, k_map, v_map);
  return (int)cudaGetLastError();
}

// The block geometry of a launch (the only owner of it), then the launch:
// bf16 at head dim 64, 128 or 256 over pages of a multiple of 8 keys
// dividing the key tile takes the tensor-core block, everything else the
// scalar one.
template <typename T>
int launch(Args a, cudaStream_t stream) {
  if (a.D % 16 || a.D < 16 || a.D > 256 || a.G < 1 || a.ps < 1 ||
      a.n_split < 1 || a.n_split > 65535 ||
      (a.n_split > 1 && (a.part == nullptr || a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int elt = (int)sizeof(T);
  const int L = lanes_per_key(a.D);
  const int nv = (a.D * elt / 16 + L - 1) / L;   // bf16 1; fp32 1 or 2
  a.head_groups = (a.G + kHeadsPerBlock - 1) / kHeadsPerBlock;
  a.group = (a.G + a.head_groups - 1) / a.head_groups;
  a.KC = std::min(a.ps, kSteps / nv * (32 / L));
  if (a.B == 0 || a.Hkv == 0) return 0;
  if ((long)a.Hkv * a.head_groups > 65535) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (takes_wgmma(a.D, a.ps)) return launch_wgmma(a, stream);
    if (L == 8) return by_heads<T, 8, 1>(a, stream);
    if (L == 16) return by_heads<T, 16, 1>(a, stream);
    return by_heads<T, 32, 1>(a, stream);
  } else {
    if (L == 8) return nv == 1 ? by_heads<T, 8, 1>(a, stream)
                               : by_heads<T, 8, 2>(a, stream);
    if (L == 16) return by_heads<T, 16, 2>(a, stream);
    return by_heads<T, 32, 2>(a, stream);
  }
}

Args make_args(const void* q, const void* k, const void* v, long page_stride,
               const int* bt, const int* lengths, void* out, float* m_out,
               float* l_out, float* part, int* tickets, int B, int Hkv, int G,
               int D, int P, int ps, int n, float scale, int window,
               float softcap, int partial, int n_split, int fused) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.page_stride = page_stride;
  a.block_tables = bt;
  a.lengths = lengths;
  a.out = out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.part = part;
  a.tickets = tickets;
  a.B = B;
  a.Hkv = Hkv;
  a.G = G;
  a.D = D;
  a.P = P;
  a.ps = ps;
  a.n = n;
  a.scale = scale;
  a.window = window;
  a.softcap = softcap;
  a.partial = partial;
  a.n_split = n_split;
  a.fused = fused;
  return a;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head dim that is not a multiple of 16 in
// [16, 256], or n_split > 1 without scratch. Allocates nothing and does not
// synchronise: out (m_out, l_out when partial) and, with n_split > 1, the
// scratch `part` (n_split x B x H x (D + 2) floats) and `tickets` (B x H
// ints, zero; left zero) are the caller's; the launch goes on `stream`.
int paged_attention_fused_launch(const void* q, const void* kv,
                                 const int* block_tables, const int* lengths,
                                 void* out, float* m_out, float* l_out,
                                 float* part, int* tickets, int B, int Hkv,
                                 int G, int D, int P, int ps, int n,
                                 float scale, int window, float softcap,
                                 int partial, int n_split, int is_bf16,
                                 void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t elt = is_bf16 ? 2 : 4;
  const Args a = make_args(
      q, kv, static_cast<const char*>(kv) + (size_t)ps * D * elt,
      2L * ps * D, block_tables, lengths, out, m_out, l_out, part, tickets, B,
      Hkv, G, D, P, ps, n, scale, window, softcap, partial, n_split, 1);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// The split-pool decode: k_pages and v_pages [Hkv, P, ps, D], no partial
// mode; otherwise as paged_attention_fused_launch.
int paged_attention_split_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const int* block_tables,
                                 const int* lengths, void* out, float* part,
                                 int* tickets, int B, int Hkv, int G, int D,
                                 int P, int ps, int n, float scale,
                                 int window, float softcap, int n_split,
                                 int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Args a = make_args(q, k_pages, v_pages, (long)ps * D, block_tables,
                           lengths, out, nullptr, nullptr, part, tickets, B,
                           Hkv, G, D, P, ps, n, scale, window, softcap, 0,
                           n_split, 0);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// info[0..5] = registers, spill bytes, dynamic shared memory, resident
// blocks per SM, query heads a block and keys a tile of the bf16
// tensor-core kernel at head dim D (Dv == D); cudaErrorInvalidValue for a
// D outside {64, 128, 256} or Dv != D (those launches take the scalar
// block). The wrapper's split plan reads the blocks an SM and the key tile
// here.
int paged_attention_mma_attributes(int D, int Dv, int* info) {
  if (Dv != D) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const WgmmaLaunch w = wgmma_launch(D, &err);
  if (err != cudaSuccess) return (int)err;
  info[4] = kHeadsPerBlock;
  info[5] = kKeyTile;
  return wg::attributes(w.kernel, w.smem, info, kWgThreads);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
