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
// tile loop of attend_mma.cuh (mma.sync bf16 products, a cp.async ring of
// K/V tiles of 64 keys, 128 query rows t*G + g a block, D 64, 128 or
// 256). fp32 keeps the scalar fp32 FMA loop of paged_common.cuh
// on purpose: its limit (2e-5 + 2e-5|ref|) rules out bf16 and TF32
// operands. Both prune: each (row, kv head, q tile) loops only over pages
// [j_lo, j_hi) that some query of the tile can see (causal frontier,
// window, length), with floor division so that negative shard-local
// positions in partial mode stay exact. Query rows are t*G + g, as in the
// TPU kernel, so a page is read once for all G heads. The split-pool
// variant takes the same two paths (SplitPagedRows / SplitPagedKV sources):
// the same tile loop over the same keys gives the fused kernel's bits in
// both dtypes.
#include <algorithm>

#include "attend_mma.cuh"
#include "paged_common.cuh"

namespace {

// The q tile of block (row r, kv head h, tile qi) = blockIdx: tokens [q0,
// q0 + nt) and the pages [j_lo, j_hi) some query of it can see (causal
// frontier, window, length), by floor division, so that negative
// shard-local positions in partial mode stay exact.
struct QTile {
  int q0, nt, pos, length, j_lo, j_hi;
  long tok0;   // (row r, token q0, kv head h)

  __device__ QTile(const int* row_pos, const int* lengths, int Sq, int Hkv,
                   int n, int ps, int window, int block_q) {
    const int r = blockIdx.x;
    q0 = blockIdx.z * block_q;
    nt = min(block_q, Sq - q0);
    pos = row_pos[r];
    length = lengths[r];
    const int pages_needed = paged::floordiv(length + ps - 1, ps);
    const int causal_hi = paged::floordiv(pos + q0 + nt - 1, ps) + 1;
    j_hi = min(min(pages_needed, causal_hi), n);
    j_lo = window > 0 ? max(paged::floordiv(pos + q0 - window + 1, ps), 0)
                      : 0;
    j_lo = min(j_lo, max(j_hi, 0));
    tok0 = ((long)r * Sq + q0) * Hkv + blockIdx.y;
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
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q);
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
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q);
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

// The bf16 prefill on the tensor cores: the same rows, page pruning and
// outputs as the scalar kernel above, one block of 8 warps, 16 query rows
// each, per (row, kv head, tile of 128 / G tokens), through
// attend_mma.cuh. Eight warps of one row block, not four of two: a
// verify-row chunk (R2 Sq4) gives 16 blocks, each walking its whole
// context in series, and on an H100 eight short warps a block walked it
// faster, while the two shapes were close on long chunks.
template <int D>
using PagedGeo = mma::Geometry<D, 8, 1>;

template <int D>
__global__ void __launch_bounds__(PagedGeo<D>::kThreads,
                                  PagedGeo<D>::kMinBlocks)
paged_prefill_attention_fused_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
    const int* __restrict__ block_tables, const int* __restrict__ row_pos,
    const int* __restrict__ lengths, void* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Hkv,
    int G, int P, int ps, int n, float scale, int window, float softcap,
    int partial, int block_q) {
  const int r = blockIdx.x, h = blockIdx.y;
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q);
  const int pos = t.pos, length = t.length, q0 = t.q0, nt = t.nt;
  const int j_lo = t.j_lo, j_hi = t.j_hi;
  const long tok0 = t.tok0;
  const long tok_stride = (long)Hkv * G * D;
  void* o = partial ? (void*)(reinterpret_cast<float*>(out) + tok0 * G * D)
                    : (void*)(reinterpret_cast<__nv_bfloat16*>(out) +
                              tok0 * G * D);
  const mma::PagedRows src{kv + (size_t)h * P * 2 * ps * D,
                           block_tables + (size_t)r * n, ps, D};
  mma::attend_rows<PagedGeo<D>>(
      q + tok0 * G * D, tok_stride, D, o, tok_stride, D,
      partial ? m_out + tok0 * G : nullptr,
      partial ? l_out + tok0 * G : nullptr, (long)Hkv * G, src, G, nt * G,
      pos + q0, length, true, window, scale, softcap, j_lo * ps, j_hi * ps,
      partial != 0);
}

// The split-pool prefill on the tensor cores: the fused kernel's rows,
// page pruning and tile loop over the same keys through SplitPagedRows, so
// it gives the fused kernel's bits; no partial mode.
template <int D>
__global__ void __launch_bounds__(PagedGeo<D>::kThreads,
                                  PagedGeo<D>::kMinBlocks)
paged_prefill_attention_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages,
    const int* __restrict__ block_tables, const int* __restrict__ row_pos,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int Sq,
    int Hkv, int G, int P, int ps, int n, float scale, int window,
    float softcap, int block_q) {
  const int r = blockIdx.x, h = blockIdx.y;
  const QTile t(row_pos, lengths, Sq, Hkv, n, ps, window, block_q);
  const long tok_stride = (long)Hkv * G * D;
  const size_t head = (size_t)h * P * ps * D;
  const mma::SplitPagedRows src{k_pages + head, v_pages + head,
                                block_tables + (size_t)r * n, ps, D};
  mma::attend_rows<PagedGeo<D>>(
      q + t.tok0 * G * D, tok_stride, D, out + t.tok0 * G * D, tok_stride, D,
      nullptr, nullptr, 0, src, G, t.nt * G, t.pos + t.q0, t.length, true,
      window, scale, softcap, t.j_lo * ps, t.j_hi * ps, false);
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

using FusedKernel = decltype(&paged_prefill_attention_fused_mma_kernel<128>);
using SplitKernel = decltype(&paged_prefill_attention_split_mma_kernel<128>);

// The tensor-core kernels at head dim D (fused pool, split pools) and
// their one block shape, PagedGeo<D>.
struct MmaLaunch {
  FusedKernel fused;   // null for a D they are not instantiated for
  SplitKernel split;
  int rows, threads, key_tile;
  size_t smem;
};

template <int D>
MmaLaunch mma_launch() {
  using Geo = PagedGeo<D>;
  return {paged_prefill_attention_fused_mma_kernel<D>,
          paged_prefill_attention_split_mma_kernel<D>, Geo::kRows,
          Geo::kThreads, Geo::KT, Geo::kSmem};
}

// The launch shape at head dim D, both kernels' shared memory reserved;
// err is cudaErrorInvalidValue for a D outside {64, 128, 256}.
MmaLaunch mma_launch(int D, cudaError_t* err) {
  MmaLaunch m = D == 64    ? mma_launch<64>()
                : D == 128 ? mma_launch<128>()
                : D == 256 ? mma_launch<256>()
                           : MmaLaunch{nullptr, nullptr, 0, 0, 0, 0};
  *err = m.fused ? paged::reserve_smem(m.fused, m.smem)
                 : cudaErrorInvalidValue;
  if (*err == cudaSuccess) *err = paged::reserve_smem(m.split, m.smem);
  return m;
}

// Query tokens a tensor-core block: rows / G; cudaErrorInvalidValue (0
// tokens) for more query heads per kv head than rows.
int mma_block_q(const MmaLaunch& m, int G) {
  return G < 1 || G > m.rows ? 0 : m.rows / G;
}

// The tensor-core launch: rows / G tokens a block; cudaErrorInvalidValue
// for more query heads per kv head than rows, or D outside {64, 128, 256}.
int launch_mma(const void* q, const void* kv, const int* bt,
               const int* row_pos, const int* lengths, void* out,
               float* m_out, float* l_out, int R, int Sq, int Hkv, int G,
               int D, int P, int ps, int n, float scale, int window,
               float softcap, int partial, cudaStream_t stream) {
  cudaError_t err;
  const MmaLaunch m = mma_launch(D, &err);
  if (err != cudaSuccess) return (int)err;
  const int block_q = mma_block_q(m, G);
  if (block_q == 0) return (int)cudaErrorInvalidValue;
  const int nq = (Sq + block_q - 1) / block_q;
  if (R == 0 || Hkv == 0 || nq == 0) return 0;
  m.fused<<<dim3(R, Hkv, nq), m.threads, m.smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(kv), bt, row_pos, lengths, out,
      m_out, l_out, Sq, Hkv, G, P, ps, n, scale, window, softcap, partial,
      block_q);
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

// The split-pool tensor-core launch: the fused one's table, shape and
// limits.
int launch_split_mma(const void* q, const void* k_pages, const void* v_pages,
                     const int* bt, const int* row_pos, const int* lengths,
                     void* out, int R, int Sq, int Hkv, int G, int D, int P,
                     int ps, int n, float scale, int window, float softcap,
                     cudaStream_t stream) {
  cudaError_t err;
  const MmaLaunch m = mma_launch(D, &err);
  if (err != cudaSuccess) return (int)err;
  const int block_q = mma_block_q(m, G);
  if (block_q == 0) return (int)cudaErrorInvalidValue;
  const int nq = (Sq + block_q - 1) / block_q;
  if (R == 0 || Hkv == 0 || nq == 0) return 0;
  m.split<<<dim3(R, Hkv, nq), m.threads, m.smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k_pages),
      reinterpret_cast<const __nv_bfloat16*>(v_pages), bt, row_pos, lengths,
      reinterpret_cast<__nv_bfloat16*>(out), Sq, Hkv, G, P, ps, n, scale,
      window, softcap, block_q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when G query heads per kv head do not fit a block at
// this D (bf16: D in {64, 128, 256} and G at most the block's rows).
// Allocates nothing and does not synchronise: out (and m_out, l_out when
// partial) are allocated by the caller, the launch goes on `stream`.
int paged_prefill_attention_fused_launch(
    const void* q, const void* kv, const int* block_tables, const int* row_pos,
    const int* lengths, void* out, float* m_out, float* l_out, int R, int Sq,
    int Hkv, int G, int D, int P, int ps, int n, float scale, int window,
    float softcap, int partial, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mma(q, kv, block_tables, row_pos, lengths, out, m_out,
                      l_out, R, Sq, Hkv, G, D, P, ps, n, scale, window,
                      softcap, partial, s);
  return launch<float>(q, kv, block_tables, row_pos, lengths, out, m_out,
                       l_out, R, Sq, Hkv, G, D, P, ps, n, scale, window,
                       softcap, partial, s);
}

// The split-pool prefill: k_pages and v_pages [Hkv, P, ps, D], no partial
// mode; otherwise as paged_prefill_attention_fused_launch.
int paged_prefill_attention_split_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* row_pos, const int* lengths,
    void* out, int R, int Sq, int Hkv, int G, int D, int P, int ps, int n,
    float scale, int window, float softcap, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_split_mma(q, k_pages, v_pages, block_tables, row_pos,
                            lengths, out, R, Sq, Hkv, G, D, P, ps, n, scale,
                            window, softcap, s);
  return launch_split(q, k_pages, v_pages, block_tables, row_pos,
                             lengths, out, R, Sq, Hkv, G, D, P, ps, n, scale,
                             window, softcap, s);
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
  return mma::attributes(m.fused, m.threads, m.smem, info);
}

const char* paged_prefill_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
