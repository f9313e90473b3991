// Ragged chunked-prefill attention over the fused KV pool, for Hopper
// (sm_90a). Serves the engine's prefill rows and speculative-verify rows.
//
// Replaces the TPU kernel paged_prefill_attention_fused
// (src/repro/kernels/paged_prefill_attention/kernel.py, _fused_kernel):
// row r is a chunk of Sq queries at cache offset row_pos[r] with post-chunk
// length lengths[r], attending over its pages through the block table with
// causal, length and window masks and an optional softcap, fp32 online
// softmax; partial != 0 returns the un-normalized state (acc, m, l). A
// split-pool variant (paged_prefill_attention_split_launch) replaces the
// TPU kernel paged_prefill_attention, the same function over separate K
// and V pools.
//
// Bound on the H100: operations at the engine's chunk sizes. A q tile of
// BQ tokens x G heads re-reads each live page, so a chunk of Sq tokens does
// about 4*Sq*G*D flops per key against 4*D bytes of K and V per key (bf16):
// Sq*G flops per byte, well above the 295 where HBM stops being the limit
// for Sq >= 128. So bf16 (the serving dtype) runs on the tensor cores: the
// tile loop of attend_wgmma.cuh (wgmma products fed by a TMA producer warp
// through an mbarrier ring, tiles of 128 keys, 64 at D 256, 128 query rows
// t*G + g a block, D 64, 128 or 256), with split-K over each row's pages
// when the grid is short of the card. fp32 keeps the scalar fp32 FMA loop of paged_common.cuh
// on purpose: its limit (2e-5 + 2e-5|ref|) rules out bf16 and TF32
// operands. Both prune: each (row, kv head, q tile) loops only over pages
// [j_lo, j_hi) that some query of the tile can see (causal frontier,
// window, length), with floor division so that negative shard-local
// positions in partial mode stay exact. Query rows are t*G + g, as in the
// TPU kernel, so a page is read once for all G heads. The split-pool
// variant takes the same two paths (a second tensor map / SplitPagedKV):
// the same tile loop over the same keys gives the fused kernel's bits in
// both dtypes.
#include <algorithm>

#include "attend_wgmma.cuh"
#include "paged_common.cuh"

namespace {

// The q tile qi of row r and kv head h: tokens [q0, q0 + nt) and the pages
// [j_lo, j_hi) some query of it can see (causal frontier, window, length),
// by floor division, so that negative shard-local positions in partial
// mode stay exact.
struct QTile {
  int q0, nt, pos, length, j_lo, j_hi;
  long tok0;   // (row r, token q0, kv head h)

  __device__ QTile(const int* row_pos, const int* lengths, int Sq, int Hkv,
                   int n, int ps, int window, int block_q, int qi, int r,
                   int h) {
    q0 = qi * block_q;
    nt = min(block_q, Sq - q0);
    pos = row_pos[r];
    length = lengths[r];
    const int pages_needed = paged::floordiv(length + ps - 1, ps);
    const int causal_hi = paged::floordiv(pos + q0 + nt - 1, ps) + 1;
    j_hi = min(min(pages_needed, causal_hi), n);
    j_lo = window > 0 ? max(paged::floordiv(pos + q0 - window + 1, ps), 0)
                      : 0;
    j_lo = min(j_lo, max(j_hi, 0));
    tok0 = ((long)r * Sq + q0) * Hkv + h;
  }
};

// The scalar loop; launched for fp32 only (bf16 takes the tensor-core
// kernel below). An fp32 block's tiles fill shared memory alone: no
// minimum of resident blocks.
template <typename T>
__global__ void __launch_bounds__(paged::kThreads, 1)
paged_prefill_attention_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ kv,
    const int* __restrict__ block_tables, const int* __restrict__ row_pos,
    const int* __restrict__ lengths, void* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Hkv,
    int G, int D, int P, int ps, int n, float scale, int window, float softcap,
    int partial, int block_q, int tile_pages) {
  const int r = blockIdx.x, h = blockIdx.y;
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q,
                blockIdx.z, r, h);
  const int pos = t.pos, length = t.length, q0 = t.q0, nt = t.nt;
  const int j_lo = t.j_lo, j_hi = t.j_hi;
  const long tok0 = t.tok0;
  const long tok_stride = (long)Hkv * G * D;
  void* o = partial ? (void*)(reinterpret_cast<float*>(out) + tok0 * G * D)
                    : (void*)(reinterpret_cast<T*>(out) + tok0 * G * D);
  const paged::PagedKV<T> src{kv + (size_t)h * P * 2 * ps * D,
                              block_tables + (size_t)r * n, ps};
  paged::attend_rows<T>(
      q + tok0 * G * D, tok_stride, D, o, tok_stride, D,
      partial ? m_out + tok0 * G : nullptr,
      partial ? l_out + tok0 * G : nullptr, (long)Hkv * G, src, D, D, G,
      nt * G, pos + q0, length, true, window, scale, softcap, j_lo * ps,
      j_hi * ps, tile_pages * ps, partial != 0);
}

// The same prefill over split K and V pools, each [Hkv, P, ps, D]
// (replaces the TPU kernel paged_prefill_attention, kernel.py _kernel,
// which needs Sq % block_q == 0; here any Sq): the fused kernel's page
// pruning and tile loop through a SplitPagedKV source, no partial mode;
// launched for fp32 only (bf16 takes paged_prefill_attention_split_mma_
// kernel).
template <typename T>
__global__ void __launch_bounds__(paged::kThreads, 1)
paged_prefill_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ row_pos, const int* __restrict__ lengths,
    T* __restrict__ out, int Sq, int Hkv, int G, int D, int P, int ps, int n,
    float scale, int window, float softcap, int block_q, int tile_pages) {
  const int r = blockIdx.x, h = blockIdx.y;
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q,
                blockIdx.z, r, h);
  const int pos = t.pos, length = t.length, q0 = t.q0, nt = t.nt;
  const int j_lo = t.j_lo, j_hi = t.j_hi;
  const long tok0 = t.tok0;
  const long tok_stride = (long)Hkv * G * D;
  const size_t head = (size_t)h * P * ps * D;
  const paged::SplitPagedKV<T> src{k_pages + head, v_pages + head,
                                   block_tables + (size_t)r * n, ps};
  paged::attend_rows<T>(
      q + tok0 * G * D, tok_stride, D, out + tok0 * G * D, tok_stride, D,
      nullptr, nullptr, 0, src, D, D, G, nt * G, pos + q0, length, true,
      window, scale, softcap, j_lo * ps, j_hi * ps, tile_pages * ps, false);
}

// The bf16 prefill on the tensor cores, over the fused pool or the split
// pools: the scalar kernel's rows and page pruning, one block of
// attend_wgmma.cuh (a TMA producer warp, two consumer warpgroups of 64 query
// rows t*G + g) per (tile of 128 / G tokens x key split, kv head, row) =
// blockIdx. The
// pool is a 2-D tensor map over its rows (fused: [Hkv*P*2*ps, D], K of page
// p at row ((h*P + p)*2)*ps, V ps rows later; split: k_map and v_map over
// [Hkv*P*ps, D] each), one box of [ps, 64 columns] a page and swizzle atom.
// Both pool layouts run this one kernel with the same split plan, so the
// split pools give the fused pool's bits on the same keys.
//
// Split-K: with n_split > 1 the block's page range [j_lo, j_hi) is cut into
// n_split near-equal runs of pages; block (row, head, q tile, split) writes
// its fp32 state (acc, m, l) to `part` ([n_split, R*Sq*Hkv*G] rows of D,
// then m and l), and the last block of its (row, head, q tile) to finish,
// known by an atomic ticket, merges the splits in order (m* = max m_i, l =
// sum l_i e^(m_i - m*), acc = sum acc_i e^(m_i - m*)), writes out (or the
// merged state with partial) and resets the ticket: a call stays one
// launch. An empty run contributes (0, -1e30, 0).
template <int D>
using PagedGeo = wg::Geometry<D>;

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
paged_prefill_attention_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    const int* __restrict__ block_tables, const int* __restrict__ row_pos,
    const int* __restrict__ lengths, void* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part, int* __restrict__ tickets, int Sq, int Hkv,
    int G, int P, int ps, int n, int mult, int v_off, float scale, int window,
    float softcap, int partial, int block_q, int n_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = PagedGeo<D>;
  unsigned char* base = wg::aligned_smem(smem_raw);
  const int r = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q, qi, r, h);
  int c_lo = t.j_lo, c_hi = t.j_hi;
  if (n_split > 1) {
    const long len = max(t.j_hi - t.j_lo, 0);
    c_lo = t.j_lo + (int)(sp * len / n_split);
    c_hi = t.j_lo + (int)((sp + 1) * len / n_split);
  }
  const int BR = t.nt * G;
  const wg::Ring<Geo> rg(base, BR, c_lo * ps, c_hi * ps);
  rg.init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    wg::produce(rg, wg::PagedTiles{&k_map, &v_map,
                                   block_tables + (size_t)r * n, h * P, mult,
                                   v_off, ps, c_lo, c_hi});
    return;
  }
  wg::consumer_regs();
  const long tok0 = t.tok0;
  const long tok_stride = (long)Hkv * G * D;
  const long rows = (long)gridDim.z * Sq * Hkv * G;   // every query row
  const bool split = n_split > 1;
  float* p_acc = part + ((long)sp * rows + tok0 * G) * D;
  float* p_m = part + (long)n_split * rows * D + sp * rows + tok0 * G;
  float* p_l = p_m + (long)n_split * rows;
  void* o = split ? (void*)p_acc
            : partial ? (void*)(reinterpret_cast<float*>(out) + tok0 * G * D)
                      : (void*)(reinterpret_cast<__nv_bfloat16*>(out) +
                                tok0 * G * D);
  wg::consume(rg, q + tok0 * G * D, tok_stride, D, o, tok_stride, D,
              split ? p_m : (partial ? m_out + tok0 * G : nullptr),
              split ? p_l : (partial ? l_out + tok0 * G : nullptr),
              (long)Hkv * G, G, BR, t.pos + t.q0, t.length, true, window,
              scale, softcap, c_lo * ps, c_hi * ps, split || partial);
  if (!split) return;

  // the last split block of this (row, head, q tile) merges the splits;
  // the consumer warpgroups (threads 128..383) do it
  const int ct = threadIdx.x - 128;
  int* flag = wg::block_flag<Geo>(base);
  int* ticket = tickets + ((long)r * Hkv + h) * (gridDim.x / n_split) + qi;
  __threadfence();
  wg::named_sync(3, 256);
  if (ct == 0) *flag = atomicAdd(ticket, 1) == n_split - 1;
  wg::named_sync(3, 256);
  if (!*flag) return;
  __threadfence();
  // each row's split weights w[row][s] = exp(m_s - M), then M and L, in the
  // ring's shared memory (every tile is consumed)
  float* wt = reinterpret_cast<float*>(base + Geo::Q_BYTES);
  float* ml = wt + BR * n_split;                  // M [BR], then L [BR]
  const float* pm0 = part + (long)n_split * rows * D;
  const float* pl0 = pm0 + (long)n_split * rows;
  for (int x = ct; x < BR; x += 256) {
    const long row = tok0 * G + (x / G) * (long)Hkv * G + x % G;
    float M = wg::kNegInf;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, __ldcg(pm0 + s * rows + row));
    float L = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float c = expf(__ldcg(pm0 + s * rows + row) - M);
      wt[x * n_split + s] = c;
      L += __ldcg(pl0 + s * rows + row) * c;
    }
    ml[x] = M;
    ml[BR + x] = L;
  }
  wg::named_sync(3, 256);
  for (int x = ct; x < BR * (D / 4); x += 256) {
    const int rr = x / (D / 4), d = (x % (D / 4)) * 4;
    const long row = tok0 * G + (rr / G) * (long)Hkv * G + rr % G;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      const float c = wt[rr * n_split + s];
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(part + (s * rows + row) * D + d));
      a.x += v.x * c;
      a.y += v.y * c;
      a.z += v.z * c;
      a.w += v.w * c;
    }
    if (partial) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + row * D + d) =
          a;
      if (d == 0) {
        m_out[row] = ml[rr];
        l_out[row] = ml[BR + rr];
      }
    } else {
      const float den = fmaxf(ml[BR + rr], 1e-30f);
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(out) + row * D + d;
      *reinterpret_cast<uint32_t*>(dst) = wg::pack_bf16(a.x / den, a.y / den);
      *reinterpret_cast<uint32_t*>(dst + 2) =
          wg::pack_bf16(a.z / den, a.w / den);
    }
  }
  if (ct == 0) *ticket = 0;      // ready for the next call
}

// Query tokens per block: as many as fit the block's rows (t*G + g), at
// most kMaxBlockQ.
constexpr int kMaxBlockQ = 64;

template <typename T>
int launch(const void* q, const void* kv, const int* bt, const int* row_pos,
           const int* lengths, void* out, float* m_out, float* l_out, int R,
           int Sq, int Hkv, int G, int D, int P, int ps, int n, float scale,
           int window, float softcap, int partial, cudaStream_t stream) {
  const int block_q = std::max(1, std::min(kMaxBlockQ, paged::max_rows(D) / G));
  const int tile_pages = paged::tile_pages(block_q * G, ps, D, sizeof(T));
  if (tile_pages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      paged::smem_bytes(block_q * G, tile_pages * ps, D, sizeof(T));
  cudaError_t err =
      paged::reserve_smem(paged_prefill_attention_fused_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Sq + block_q - 1) / block_q;
  if (R == 0 || Hkv == 0 || nq == 0) return 0;
  paged_prefill_attention_fused_kernel<T>
      <<<dim3(R, Hkv, nq), paged::kThreads, smem, stream>>>(
          reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(kv), bt,
          row_pos, lengths, out, m_out, l_out, Sq, Hkv, G, D, P, ps, n, scale,
          window, softcap, partial, block_q, tile_pages);
  return (int)cudaGetLastError();
}

using MmaKernel = decltype(&paged_prefill_attention_wgmma_kernel<128>);

// The tensor-core kernel at head dim D and its block shape.
struct MmaLaunch {
  MmaKernel kernel;   // null for a D it is not instantiated for
  int rows, key_tile;
  size_t smem;
};

template <int D>
MmaLaunch mma_launch() {
  using Geo = PagedGeo<D>;
  return {paged_prefill_attention_wgmma_kernel<D>, wg::kRows, Geo::KT,
          Geo::kSmem};
}

// The launch shape at head dim D, its shared memory reserved; err is
// cudaErrorInvalidValue for a D outside {64, 128, 256}.
MmaLaunch mma_launch(int D, cudaError_t* err) {
  MmaLaunch m = D == 64    ? mma_launch<64>()
                : D == 128 ? mma_launch<128>()
                : D == 256 ? mma_launch<256>()
                           : MmaLaunch{nullptr, 0, 0, 0};
  *err = m.kernel ? paged::reserve_smem(m.kernel, m.smem)
                  : cudaErrorInvalidValue;
  return m;
}

// The tensor-core launch over either pool layout (k_pages == v_pages and
// fused != 0: the fused pool [Hkv, P, 2, ps, D]; else the split pools, each
// [Hkv, P, ps, D]): rows / G tokens a block, n_split key splits merged in
// the launch through `part` and `tickets` (R x Hkv x q tiles, zero).
// cudaErrorInvalidValue for more query heads per kv head than rows, D
// outside {64, 128, 256}, a page size that is not a multiple of 8 dividing
// the key tile, splits without scratch, or a pool cuTensorMapEncodeTiled
// refuses.
int launch_mma(const void* q, const void* k_pages, const void* v_pages,
               int fused, const int* bt, const int* row_pos,
               const int* lengths, void* out, float* m_out, float* l_out,
               float* part, int* tickets, int R, int Sq, int Hkv, int G,
               int D, int P, int ps, int n, float scale, int window,
               float softcap, int partial, int n_split, cudaStream_t stream) {
  cudaError_t err;
  const MmaLaunch m = mma_launch(D, &err);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > m.rows || ps < 8 || ps % 8 || m.key_tile % ps)
    return (int)cudaErrorInvalidValue;
  const int block_q = m.rows / G;
  const int nq = (Sq + block_q - 1) / block_q;
  if (R == 0 || Hkv == 0 || nq == 0) return 0;
  n_split = std::max(n_split, 1);
  if (n_split > 1 && !(part && tickets)) return (int)cudaErrorInvalidValue;
  CUtensorMap k_map, v_map;
  const long pool_rows = (long)Hkv * P * (fused ? 2 : 1) * ps;
  err = wg::rows_map(k_pages, pool_rows, D, ps, &k_map);
  if (err == cudaSuccess) {
    if (fused)
      v_map = k_map;
    else
      err = wg::rows_map(v_pages, pool_rows, D, ps, &v_map);
  }
  if (err != cudaSuccess) return (int)err;
  // q tiles (and their splits) fastest: the blocks that read one (row, kv
  // head)'s pages run together, and its pages stay in the L2
  m.kernel<<<dim3(nq * n_split, Hkv, R), wg::kThreads, m.smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), k_map, v_map, bt, row_pos,
      lengths, out, m_out, l_out, part, tickets, Sq, Hkv, G, P, ps, n,
      fused ? 2 : 1, fused ? 1 : 0, scale, window, softcap, partial, block_q,
      n_split);
  return (int)cudaGetLastError();
}

// The scalar split-pool launch, for fp32 (bf16 takes launch_split_mma).
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const int* bt, const int* row_pos, const int* lengths,
                 void* out, int R, int Sq, int Hkv, int G, int D, int P,
                 int ps, int n, float scale, int window, float softcap,
                 cudaStream_t stream) {
  const int block_q = std::max(1, std::min(kMaxBlockQ, paged::max_rows(D) / G));
  const int tile_pages = paged::tile_pages(block_q * G, ps, D, sizeof(float));
  if (tile_pages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      paged::smem_bytes(block_q * G, tile_pages * ps, D, sizeof(float));
  cudaError_t err =
      paged::reserve_smem(paged_prefill_attention_split_kernel<float>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Sq + block_q - 1) / block_q;
  if (R == 0 || Hkv == 0 || nq == 0) return 0;
  paged_prefill_attention_split_kernel<float>
      <<<dim3(R, Hkv, nq), paged::kThreads, smem, stream>>>(
          reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_pages),
          reinterpret_cast<const float*>(v_pages), bt, row_pos, lengths,
          reinterpret_cast<float*>(out), Sq, Hkv, G, D, P, ps, n, scale, window,
          softcap, block_q, tile_pages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when the launch is not taken (bf16: D in {64, 128,
// 256}, G at most the block's rows, a page size that is a multiple of 8
// dividing the key tile). part (n_split x R*Sq*Hkv*G x (D + 2) floats) and
// tickets (R x Hkv x q tiles ints, zero, left zero) are the split-K scratch
// of a bf16 launch with n_split > 1 (null otherwise; fp32 ignores n_split).
// Allocates nothing and does not synchronise: out (and m_out, l_out when
// partial) and the scratch are allocated by the caller, the launch goes on
// `stream`.
int paged_prefill_attention_fused_launch(
    const void* q, const void* kv, const int* block_tables, const int* row_pos,
    const int* lengths, void* out, float* m_out, float* l_out, float* part,
    int* tickets, int R, int Sq, int Hkv, int G, int D, int P, int ps, int n,
    float scale, int window, float softcap, int partial, int n_split,
    int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma(q, kv, kv, 1, block_tables, row_pos, lengths, out,
                      m_out, l_out, part, tickets, R, Sq, Hkv, G, D, P, ps, n,
                      scale, window, softcap, partial, n_split, s);
  return launch<float>(q, kv, block_tables, row_pos, lengths, out, m_out,
                       l_out, R, Sq, Hkv, G, D, P, ps, n, scale, window,
                       softcap, partial, s);
}

// The split-pool prefill: k_pages and v_pages [Hkv, P, ps, D], no partial
// mode; otherwise as paged_prefill_attention_fused_launch (the same bf16
// kernel and split plan).
int paged_prefill_attention_split_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* row_pos, const int* lengths,
    void* out, float* part, int* tickets, int R, int Sq, int Hkv, int G,
    int D, int P, int ps, int n, float scale, int window, float softcap,
    int n_split, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma(q, k_pages, v_pages, 0, block_tables, row_pos, lengths,
                      out, nullptr, nullptr, part, tickets, R, Sq, Hkv, G, D,
                      P, ps, n, scale, window, softcap, 0, n_split, s);
  return launch_split(q, k_pages, v_pages, block_tables, row_pos, lengths,
                      out, R, Sq, Hkv, G, D, P, ps, n, scale, window, softcap,
                      s);
}

// info[0..5] = registers, spill bytes, dynamic shared memory, resident
// blocks per SM, query rows a block and keys a tile of the bf16 tensor-core
// kernel at key width D and value width Dv; cudaErrorInvalidValue for a D
// outside {64, 128, 256} or Dv != D (the page pools hold K and V at one
// width). The wrapper reads the block's rows here (a block takes at most
// that many query heads per kv head).
int paged_prefill_attention_mma_attributes(int D, int Dv, int* info) {
  if (Dv != D) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  const MmaLaunch m = mma_launch(D, &err);
  if (err != cudaSuccess) return (int)err;
  info[4] = m.rows;
  info[5] = m.key_tile;
  return wg::attributes(m.kernel, m.smem, info);
}

const char* paged_prefill_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
