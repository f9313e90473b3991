// Paged-attention decode over the fused KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_attention_fused
// (src/repro/kernels/paged_attention/kernel.py, _fused_kernel): one query
// token per sequence, GQA over the fused head-interleaved pool
// [Hkv, P, 2, ps, D] through block tables, masks k_pos < len and
// k_pos >= len - window, optional softcap, fp32 online softmax;
// partial != 0 returns the un-normalized state (acc, m, l). A split-pool
// variant (paged_attention_split_launch) replaces the TPU kernel
// paged_attention, the same function over separate K and V pools.
//
// Bound on the H100: bytes. Each (row, kv head) reads its ceil(len/ps)
// pages once (2*ps*D elements each) and does 4*G*D flops per key, about
// G flops per byte in bf16, far below the ~295 flops/byte where the tensor
// cores become the limit. The design therefore streams every live page
// exactly once per (row, kv head), K and V in one contiguous run with
// 16-byte loads, several pages per tile so that one block keeps
// tile_pages * 2 * ps * D elements in flight, and never touches block-table
// columns past the row's last page (the engine zero-pads tables to a power
// of two). A block is one (row, kv head); a row with length 0 runs no tile
// and writes zeros.
#include "paged_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_fused_kernel(const T* __restrict__ q,
                             const T* __restrict__ kv,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ lengths,
                             void* __restrict__ out, float* __restrict__ m_out,
                             float* __restrict__ l_out, int Hkv, int G, int D,
                             int P, int ps, int n, float scale, int window,
                             float softcap, int partial, int tile_pages) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int length = lengths[b];
  const int j_hi = min(paged::floordiv(length + ps - 1, ps), n);
  int j_lo = window > 0 ? max(paged::floordiv(length - window, ps), 0) : 0;
  j_lo = min(j_lo, max(j_hi, 0));
  const long row0 = ((long)b * Hkv + h) * G;   // first query head of block
  void* o = partial ? (void*)(reinterpret_cast<float*>(out) + row0 * D)
                    : (void*)(reinterpret_cast<T*>(out) + row0 * D);
  const paged::PagedKV<T> src{kv + (size_t)h * P * 2 * ps * D,
                              block_tables + (size_t)b * n, ps};
  paged::attend_rows<T>(
      q + row0 * D, 0, D, o, 0, D, partial ? m_out + row0 : nullptr,
      partial ? l_out + row0 : nullptr, 0, src, D, G, G, length - 1, length,
      true, window, scale, softcap, j_lo * ps, j_hi * ps, tile_pages * ps,
      partial != 0);
}

// The same decode over split K and V pools, each [Hkv, P, ps, D]
// (replaces the TPU kernel paged_attention, kernel.py _kernel): the fused
// kernel's page range and tile loop through a SplitPagedKV source, no
// partial mode. A separate kernel, so that the fused one's code stays as
// it was.
template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, int Hkv, int G, int D, int P,
                             int ps, int n, float scale, int window,
                             float softcap, int tile_pages) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int length = lengths[b];
  const int j_hi = min(paged::floordiv(length + ps - 1, ps), n);
  int j_lo = window > 0 ? max(paged::floordiv(length - window, ps), 0) : 0;
  j_lo = min(j_lo, max(j_hi, 0));
  const long row0 = ((long)b * Hkv + h) * G;   // first query head of block
  const size_t head = (size_t)h * P * ps * D;
  const paged::SplitPagedKV<T> src{k_pages + head, v_pages + head,
                                   block_tables + (size_t)b * n, ps};
  paged::attend_rows<T>(q + row0 * D, 0, D, out + row0 * D, 0, D, nullptr,
                        nullptr, 0, src, D, G, G, length - 1, length, true,
                        window, scale, softcap, j_lo * ps, j_hi * ps,
                        tile_pages * ps, false);
}

template <typename T>
int launch(const void* q, const void* kv, const int* bt, const int* lengths,
           void* out, float* m_out, float* l_out, int B, int Hkv, int G, int D,
           int P, int ps, int n, float scale, int window, float softcap,
           int partial, cudaStream_t stream) {
  const int tile_pages = paged::tile_pages(G, ps, D, sizeof(T));
  if (tile_pages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = paged::smem_bytes(G, tile_pages * ps, D, sizeof(T));
  cudaError_t err = paged::reserve_smem(paged_attention_fused_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Hkv == 0) return 0;
  paged_attention_fused_kernel<T><<<dim3(B, Hkv), paged::kThreads, smem,
                                    stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(kv), bt,
      lengths, out, m_out, l_out, Hkv, G, D, P, ps, n, scale, window, softcap,
      partial, tile_pages);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split(const void* q, const void* k_pages, const void* v_pages,
                 const int* bt, const int* lengths, void* out, int B, int Hkv,
                 int G, int D, int P, int ps, int n, float scale, int window,
                 float softcap, cudaStream_t stream) {
  const int tile_pages = paged::tile_pages(G, ps, D, sizeof(T));
  if (tile_pages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = paged::smem_bytes(G, tile_pages * ps, D, sizeof(T));
  cudaError_t err = paged::reserve_smem(paged_attention_split_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Hkv == 0) return 0;
  paged_attention_split_kernel<T><<<dim3(B, Hkv), paged::kThreads, smem,
                                    stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k_pages),
      reinterpret_cast<const T*>(v_pages), bt, lengths,
      reinterpret_cast<T*>(out), Hkv, G, D, P, ps, n, scale, window, softcap,
      tile_pages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when G query heads per kv head do not fit a block at
// this D. Allocates nothing and does not synchronise: out (and m_out, l_out
// when partial) are allocated by the caller, the launch goes on `stream`.
int paged_attention_fused_launch(const void* q, const void* kv,
                                 const int* block_tables, const int* lengths,
                                 void* out, float* m_out, float* l_out, int B,
                                 int Hkv, int G, int D, int P, int ps, int n,
                                 float scale, int window, float softcap,
                                 int partial, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kv, block_tables, lengths, out, m_out,
                                 l_out, B, Hkv, G, D, P, ps, n, scale, window,
                                 softcap, partial, s);
  return launch<float>(q, kv, block_tables, lengths, out, m_out, l_out, B,
                       Hkv, G, D, P, ps, n, scale, window, softcap, partial,
                       s);
}

// The split-pool decode: k_pages and v_pages [Hkv, P, ps, D], no partial
// mode; otherwise as paged_attention_fused_launch.
int paged_attention_split_launch(const void* q, const void* k_pages,
                                 const void* v_pages, const int* block_tables,
                                 const int* lengths, void* out, int B,
                                 int Hkv, int G, int D, int P, int ps, int n,
                                 float scale, int window, float softcap,
                                 int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_split<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                       lengths, out, B, Hkv, G, D, P, ps, n,
                                       scale, window, softcap, s);
  return launch_split<float>(q, k_pages, v_pages, block_tables, lengths, out,
                             B, Hkv, G, D, P, ps, n, scale, window, softcap,
                             s);
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
