// Chunked-prefill attention over contiguous K/V, for Hopper (sm_90a).
// Serves the slot engine's prompt chunks: a chunk of Sq queries at cache
// offset q_offset attends over its slot's K/V row, read in place.
//
// Replaces the TPU kernel chunked_prefill_attention
// (src/repro/kernels/chunked_prefill_attention/kernel.py, _kernel): q
// [B, H, Sq, D] over k/v [B, Hkv, Sk, D] with query head h on kv head
// h / G, mask k_pos < lengths[b], plus k_pos <= q_pos when causal and
// q_pos - k_pos < window when window > 0, optional softcap, fp32 online
// softmax, p rounded to V's dtype before the P.V product, out =
// acc / max(l, 1e-30).
//
// Bound on the H100: operations at the engine's chunk sizes. A q tile of
// BQ tokens x G heads reads each live key once, so a chunk of Sq tokens
// does about 4*Sq*G*D flops per key against 4*D bytes of K and V (bf16):
// Sq*G flops per byte, above the 295 where HBM stops being the limit for
// Sq >= 128. This first kernel does the products with scalar fp32 FMA on
// shared-memory tiles (the tile loop of paged_common.cuh), so it runs far
// below the tensor-core peak; what its design does about the bound is
// prune: each (batch row, kv head, q tile) loops only over the keys
// [lo, hi) that some query of the tile can see, lo from the window start
// of the tile's first query and hi = min(lengths[b], last query + 1, Sk),
// so a chunk at offset pos of a 4096-token slot row reads pos + Sq keys,
// not 4096. A tile whose range is empty writes zeros. Every operand is
// addressed through the strides the wrapper passes (unit last stride), so
// the slot cache [B, Smax, Hkv, D] and the kv-major q [B, Sq, Hkv, G, D]
// are read without a copy.
#include <algorithm>

#include "paged_common.cuh"

namespace {

struct Strides {          // elements per step of (batch row, head, position)
  long b, h, s;
};

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
chunked_prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, Strides qs,
    Strides ks, Strides vs, Strides os, int Sq, int Sk, int G, int D,
    int q_offset, int causal, int window, float scale, float softcap,
    int block_q, int tile_keys) {
  const int b = blockIdx.x, h = blockIdx.y, qi = blockIdx.z;
  const int q0 = qi * block_q;
  const int nt = min(block_q, Sq - q0);        // tokens in this q tile
  const int length = lengths[b];
  int hi = min(length, Sk);
  if (causal) hi = min(hi, q_offset + q0 + nt);
  int lo = window > 0 ? max(q_offset + q0 - window + 1, 0) : 0;
  lo = min(lo, max(hi, 0));
  const long qh0 = (long)h * G;                // first query head of block
  const paged::StridedKV<T> src{k + b * ks.b + h * ks.h,
                                v + b * vs.b + h * vs.h, ks.s, vs.s};
  paged::attend_rows<T>(
      q + b * qs.b + qh0 * qs.h + q0 * qs.s, qs.s, qs.h,
      out + b * os.b + qh0 * os.h + q0 * os.s, os.s, os.h, nullptr, nullptr,
      0, src, D, G, nt * G, q_offset + q0, length, causal != 0, window,
      scale, softcap, lo, hi, tile_keys, false);
}

// Query tokens per block: as many as fit the block's rows (t*G + g), at
// most kMaxBlockQ.
constexpr int kMaxBlockQ = 64;

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, Strides qs, Strides ks, Strides vs, Strides os, int B,
           int Sq, int Sk, int Hkv, int G, int D, int q_offset, int causal,
           int window, float scale, float softcap, cudaStream_t stream) {
  const int block_q =
      std::max(1, std::min(kMaxBlockQ, paged::max_rows(D) / G));
  const int tile_keys = paged::tile_keys(block_q * G, D, sizeof(T));
  if (tile_keys == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = paged::smem_bytes(block_q * G, tile_keys, D, sizeof(T));
  cudaError_t err =
      paged::reserve_smem(chunked_prefill_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Sq + block_q - 1) / block_q;
  if (B == 0 || Hkv == 0 || nq == 0) return 0;
  chunked_prefill_attention_kernel<T>
      <<<dim3(B, Hkv, nq), paged::kThreads, smem, stream>>>(
          reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
          reinterpret_cast<const T*>(v), lengths, reinterpret_cast<T*>(out),
          qs, ks, vs, os, Sq, Sk, G, D, q_offset, causal, window, scale,
          softcap, block_q, tile_keys);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, (batch row, head, position) for each operand;
// the head-dim stride is 1. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue when G query heads per kv head do
// not fit a block at this D. Allocates nothing and does not synchronise:
// out is allocated by the caller, the launch goes on `stream`.
int chunked_prefill_attention_launch(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, long long qsb, long long qsh, long long qss, long long ksb,
    long long ksh, long long kss, long long vsb, long long vsh,
    long long vss, long long osb, long long osh, long long oss, int B,
    int Sq, int Sk, int Hkv, int G, int D, int q_offset, int causal,
    int window, float scale, float softcap, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, lengths, out, qs, ks, vs, os, B,
                                 Sq, Sk, Hkv, G, D, q_offset, causal, window,
                                 scale, softcap, s);
  return launch<float>(q, k, v, lengths, out, qs, ks, vs, os, B, Sq, Sk, Hkv,
                       G, D, q_offset, causal, window, scale, softcap, s);
}

const char* chunked_prefill_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
