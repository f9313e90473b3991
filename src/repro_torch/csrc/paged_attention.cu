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
// cores become the limit. So nothing here uses the tensor cores: the cost
// is bytes that are not in flight, and the design keeps enough of them in
// flight on every SM.
//   - Split-K. The grid is (B, Hkv x head groups, n_split); the wrapper
//     chooses n_split from shapes only (B, Hkv, G, the table width n, the
//     SM count) so that the grid gives every SM about two blocks. Each
//     block cuts its row's live page range [j_lo, j_hi) (floor division,
//     the window, no table column past the row's last page; the engine
//     zero-pads tables to a power of two) into n_split near-equal parts on
//     the device: lengths never go to the host.
//   - Warps own pages. A block is kWarps warps, with no block-wide barrier
//     in its main loop. Warp w walks chunks w, w + kWarps, ... of its
//     split (a chunk is up to KC keys of one page, its K rows and V rows,
//     at most 4 KB), each copied to shared memory by cp.async, 16 bytes a
//     lane, into a ring of kStages chunks of its own, issued kStages - 1
//     chunks ahead of the one it computes.
//   - Lanes split D. L lanes hold one key row, 8 elements each (16 bytes
//     in bf16), so a warp takes 32 / L keys a step. q of the block's heads
//     (at most kHeadsPerBlock) sits in registers in fp32; scores are
//     reduced over the L lanes with shuffles; each warp keeps its own fp32
//     online softmax (one rescale a chunk) and accumulators. On an H100
//     the block is bound by its instruction stream more than by its loads
//     (a build without the loads took as long), so L is a template
//     argument (the shuffle trees unroll) and a block has 8 warps.
//   - Merges. The warps merge once, at the end, through shared memory.
//     With n_split > 1 each block writes its fp32 state (acc, m, l) to the
//     caller's scratch, and the last block of its (row, head group), known
//     by an atomic ticket, merges the splits in order (as combine_partials
//     does) and resets the ticket: a decode call stays one launch.
// The rounding is the plain version's: scores in fp32, then the softcap,
// then the mask (masked = -1e30, finite), l summed from the unrounded p, p
// rounded to V's dtype before P.V, out = acc / max(l, 1e-30). A block with
// no pages contributes (0, -1e30, 0); a row of length 0 writes zeros. Both
// pool layouts run the same kernel (the page source is runtime data) with
// the same split plan, so split pools give the fused pool's output bit for
// bit on the same keys.
#include <algorithm>

#include "attend_mma.cuh"
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

  const long BH = (long)a.B * a.Hkv * a.G;
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
  __syncthreads();

  const bool split = a.n_split > 1;
  float* pacc = a.part;
  float* pm = a.part + a.n_split * BH * D;
  float* pl = pm + a.n_split * BH;
  for (int x = threadIdx.x; x < gn * D; x += kThreads) {
    const int g = x / D, d = x % D;
    float M = paged::kNegInf;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * GB + g]);
    float Ls = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
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
  __syncthreads();
  int* ticket = a.tickets + (long)b * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0)
    last_block = atomicAdd(ticket, 1) == a.n_split - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // each head's split weights w[g][t] = exp(m_t - M), M and L, one warp a
  // head, then acc summed over the splits in four independent runs
  const int S = a.n_split;
  float* wt = reinterpret_cast<float*>(smem);     // [GB][S]
  float* mls = wt + GB * S;                       // M [GB], then L [GB]
  for (int g = warp; g < gn; g += kWarps) {
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
  __syncthreads();
  for (int x = threadIdx.x; x < gn * D; x += kThreads) {
    const int g = x / D, d = x % D;
    const long r = row0 + g;
    const float* w = wt + g * S;
    const float* src = pacc + r * D + d;          // split t at t * BH * D
    float A[4] = {0.f, 0.f, 0.f, 0.f};
    int t = 0;
    for (; t + 4 <= S; t += 4)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        A[j] += __ldcg(src + (t + j) * BH * D) * w[t + j];
    for (; t < S; ++t) A[0] += __ldcg(src + t * BH * D) * w[t];
    write_out<T>(a, r, d, (A[0] + A[1]) + (A[2] + A[3]), mls[g], mls[GB + g]);
  }
  if (threadIdx.x == 0) *ticket = 0;      // ready for the next call
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

// The block geometry of a launch (the only owner of it), then the launch.
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
               float softcap, int partial, int n_split) {
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
      Hkv, G, D, P, ps, n, scale, window, softcap, partial, n_split);
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
                           n_split);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
