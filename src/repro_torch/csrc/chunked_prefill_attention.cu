// Chunked-prefill attention over contiguous K/V, for Hopper (sm_90a).
// Serves the slot engine's prompt chunks: a chunk of Sq queries at cache
// offset q_offset attends over its slot's K/V row, read in place.
//
// Replaces the TPU kernel chunked_prefill_attention
// (src/repro/kernels/chunked_prefill_attention/kernel.py, _kernel): q
// [B, H, Sq, D] over k [B, Hkv, Sk, D] and v [B, Hkv, Sk, Dv], out [B, H,
// Sq, Dv] (Dv <= D: deepseek-v3's MLA attends with keys of 192 and values
// of 128), with query head h on kv head h / G, mask k_pos < lengths[b],
// plus k_pos <= q_pos when causal and q_pos - k_pos < window when window >
// 0, optional softcap, fp32 online softmax, p rounded to V's dtype before
// the P.V product, out = acc / max(l, 1e-30).
//
// Bound on the H100: operations at the engine's chunk sizes. A q tile of
// BQ tokens x G heads reads each live key once, so a chunk of Sq tokens
// does about 4*Sq*G*D flops per key against 4*D bytes of K and V (bf16):
// Sq*G flops per byte, above the 295 where HBM stops being the limit for
// Sq >= 128. So bf16 (the serving dtype) runs on the tensor cores: the tile
// loop of attend_wgmma.cuh (wgmma products fed by a TMA producer warp
// through an mbarrier ring, two consumer warpgroups, 128 query rows t*G + g
// a block, tiles of 128 keys, 64 at Dv 256), for the (D, Dv) pairs that
// mma_launch names below. fp32 keeps the scalar fp32 FMA loop
// of paged_common.cuh on purpose, for any D and Dv that are multiples of 8
// up to 256: its limit (2e-5 + 2e-5|ref|) rules out bf16 and TF32
// operands. Both prune: each (batch row, kv head, q tile) loops only over
// the keys [lo, hi) that some query of the tile can see, lo from the
// window start of the tile's first query and hi = min(lengths[b], last
// query + 1, Sk), so a chunk at offset pos of a 4096-token slot row reads
// pos + Sq keys, not 4096. A tile whose range is empty writes zeros.
//
// Split-K (bf16): a short chunk at a deep offset gives few q tiles (8
// blocks for 16 tokens of llama3.2-3b, on 132 SMs), each walking thousands
// of keys in series. With n_split > 1 the key range any query of the chunk
// can see, [key_base, key_end) in key tiles, is cut into n_split runs of
// whole tiles; block (b, h, q tile, split) walks its run's part of [lo, hi)
// and writes the fp32 partial state (acc, m, l) into the caller's scratch,
// and a second kernel merges the splits as combine_partials does (m* = max
// m_i, l = sum l_i e^(m_i - m*), out = sum acc_i e^(m_i - m*) / max(l,
// 1e-30)). An empty run contributes (0, -1e30, 0). The wrapper chooses
// n_split (kernel.py split_plan).
//
// Every operand is addressed through the strides the wrapper passes (unit
// last stride), so the slot cache [B, Smax, Hkv, D] and the kv-major q
// [B, Sq, Hkv, G, D] are read without a copy (and MLA's values, the second
// half of each head's expanded [k_nope | v] row, in place too). In bf16, K
// and V go through TMA tensor maps of those strides, encoded on the host
// (cuTensorMapEncodeTiled) and cached by pointer, shape and strides, so
// their bases and strides must be multiples of 16 bytes (the wrapper
// raises otherwise).
#include <algorithm>

#include "attend_wgmma.cuh"
#include "paged_common.cuh"

namespace {

struct Strides {          // elements per step of (batch row, head, position)
  long b, h, s;
};

// The scalar loop; launched for fp32 only (bf16 takes the tensor-core
// kernel below).
template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
chunked_prefill_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, Strides qs,
    Strides ks, Strides vs, Strides os, int Sq, int Sk, int G, int D, int Dv,
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
      0, src, D, Dv, G, nt * G, q_offset + q0, length, causal != 0, window,
      scale, softcap, lo, hi, tile_keys, false);
}

// The bf16 chunk attention on the tensor cores: one block of attend_wgmma.cuh
// (a TMA producer warp, two consumer warpgroups of 64 query rows t*G + g)
// per (tile of 128 / G tokens x key split, kv head, batch row) = blockIdx;
// K and V are read in place through 4-D tensor maps of the operands' own
// strides.
// Split sp of n_split covers key tiles [sp*key_tiles / n_split,
// (sp+1)*key_tiles / n_split) from key_base; with n_split > 1 the block
// writes its partial state to part_acc [n_split, B, Sq, H, Dv] and part_m,
// part_l [n_split, B, Sq, H], else out directly.
template <int D, int Dv>
using ChunkGeo = wg::Geometry<D, Dv>;

template <int D, int Dv>
__global__ void __launch_bounds__(wg::kThreads, 1)
chunked_prefill_attention_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, int k_slots, int v_slots,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_m,
    float* __restrict__ part_l, Strides qs, Strides os, int B, int Sq, int Sk,
    int G, int q_offset, int causal, int window, float scale, float softcap,
    int block_q, int n_split, int key_base, int key_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Geo = ChunkGeo<D, Dv>;
  constexpr int KT = Geo::KT;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qi = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const int q0 = qi * block_q;
  const int nt = min(block_q, Sq - q0);        // tokens in this q tile
  const int length = lengths[b];
  int hi = min(length, Sk);
  if (causal) hi = min(hi, q_offset + q0 + nt);
  int lo = window > 0 ? max(q_offset + q0 - window + 1, 0) : 0;
  if (n_split > 1) {
    lo = max(lo, key_base + (int)((long)sp * key_tiles / n_split) * KT);
    hi = min(hi, key_base + (int)((long)(sp + 1) * key_tiles / n_split) * KT);
  }
  lo = min(lo, max(hi, 0));
  const wg::Ring<Geo> rg(wg::aligned_smem(smem_raw), nt * G, lo, hi);
  rg.init();
  if (threadIdx.x < 128) {
    wg::producer_regs();
    wg::produce(rg, wg::StridedTiles{&k_map, &v_map, k_slots, v_slots, b, h,
                                     lo});
    return;
  }
  wg::consumer_regs();
  const long qh0 = (long)h * G;                // first query head of block
  const int H = gridDim.y * G;
  const bool split = n_split > 1;
  const long row0 = ((long)sp * B + b) * Sq + q0;   // (split, b, token q0)
  void* o = split ? (void*)(part_acc + (row0 * H + qh0) * Dv)
                  : (void*)(out + b * os.b + qh0 * os.h + q0 * os.s);
  wg::consume(rg, q + b * qs.b + qh0 * qs.h + q0 * qs.s, qs.s, qs.h, o,
              split ? (long)H * Dv : os.s, split ? Dv : os.h,
              split ? part_m + row0 * H + qh0 : nullptr,
              split ? part_l + row0 * H + qh0 : nullptr, H, G, nt * G,
              q_offset + q0, length, causal != 0, window, scale, softcap, lo,
              hi, split);
}

// Merge of the key splits: one thread per 4 elements of an output row
// (b, t, h) of Dv values, in the order of combine_partials.
__global__ void __launch_bounds__(256) chunked_prefill_attention_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, __nv_bfloat16* __restrict__ out,
    Strides os, int B, int Sq, int H, int Dv, int n_split) {
  const long rows = (long)B * Sq * H;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * (Dv / 4)) return;
  const long row = i / (Dv / 4);               // (b * Sq + t) * H + h
  const int c = (int)(i % (Dv / 4)) * 4;
  const int h = (int)(row % H), t = (int)(row / H % Sq), b = (int)(row / H / Sq);
  float m = wg::kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, part_m[s * rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float e = expf(part_m[s * rows + row] - m);
    l += part_l[s * rows + row] * e;
    const float4 a =
        *reinterpret_cast<const float4*>(part_acc + (s * rows + row) * Dv + c);
    acc.x += a.x * e;
    acc.y += a.y * e;
    acc.z += a.z * e;
    acc.w += a.w * e;
  }
  const float d = fmaxf(l, 1e-30f);
  __nv_bfloat16* dst = out + b * os.b + h * os.h + t * os.s + c;
  *reinterpret_cast<uint32_t*>(dst) = wg::pack_bf16(acc.x / d, acc.y / d);
  *reinterpret_cast<uint32_t*>(dst + 2) = wg::pack_bf16(acc.z / d, acc.w / d);
}

// Query tokens per block: as many as fit the block's rows (t*G + g), at
// most kMaxBlockQ.
constexpr int kMaxBlockQ = 64;

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, Strides qs, Strides ks, Strides vs, Strides os, int B,
           int Sq, int Sk, int Hkv, int G, int D, int Dv, int q_offset,
           int causal, int window, float scale, float softcap,
           cudaStream_t stream) {
  const int block_q =
      std::max(1, std::min(kMaxBlockQ, paged::max_rows(Dv) / G));
  const int tile_keys = paged::tile_keys(block_q * G, D, Dv, sizeof(T));
  if (tile_keys == 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      paged::smem_bytes(block_q * G, tile_keys, D, Dv, sizeof(T));
  cudaError_t err =
      paged::reserve_smem(chunked_prefill_attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Sq + block_q - 1) / block_q;
  if (B == 0 || Hkv == 0 || nq == 0) return 0;
  chunked_prefill_attention_kernel<T>
      <<<dim3(B, Hkv, nq), paged::kThreads, smem, stream>>>(
          reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
          reinterpret_cast<const T*>(v), lengths, reinterpret_cast<T*>(out),
          qs, ks, vs, os, Sq, Sk, G, D, Dv, q_offset, causal, window, scale,
          softcap, block_q, tile_keys);
  return (int)cudaGetLastError();
}

using MmaKernel =
    decltype(&chunked_prefill_attention_wgmma_kernel<128, 128>);

// The tensor-core kernel at key width D and value width Dv, and its block
// shape.
struct MmaLaunch {
  MmaKernel kernel;   // null for a pair it is not instantiated for
  int rows, key_tile;
  size_t smem;
};

template <int D, int Dv>
MmaLaunch mma_launch() {
  using Geo = ChunkGeo<D, Dv>;
  return {chunked_prefill_attention_wgmma_kernel<D, Dv>, wg::kRows, Geo::KT,
          Geo::kSmem};
}

// The (D, Dv) pairs the tensor-core kernel is instantiated for: attention
// at head dim 64, 128 and 256, and deepseek-v3's MLA (keys [k_nope | k_rope]
// of 128 + 64, values of 128). A null kernel for any other pair.
MmaLaunch mma_launch(int D, int Dv) {
  return D == 64 && Dv == 64     ? mma_launch<64, 64>()
         : D == 128 && Dv == 128 ? mma_launch<128, 128>()
         : D == 256 && Dv == 256 ? mma_launch<256, 256>()
         : D == 192 && Dv == 128 ? mma_launch<192, 128>()
                                 : MmaLaunch{nullptr, 0, 0, 0};
}

// The launch shape at (D, Dv), its shared memory reserved; err is
// cudaErrorInvalidValue for a pair without a kernel.
MmaLaunch mma_launch(int D, int Dv, cudaError_t* err) {
  const MmaLaunch m = mma_launch(D, Dv);
  *err = m.kernel ? paged::reserve_smem(m.kernel, m.smem)
                  : cudaErrorInvalidValue;
  return m;
}

// The grid of a tensor-core launch: q tiles of rows / G tokens, and the key
// tiles, counted from the tile-aligned window start key_base, that some
// query of the chunk can see (the range the splits cut). The wrapper reads
// q_tiles and key_tiles through chunked_prefill_attention_mma_plan to
// choose the splits.
struct Plan {
  int block_q, q_tiles, key_base, key_tiles;
};

Plan plan(const MmaLaunch& m, int Sq, int Sk, int G, int q_offset,
          int causal, int window) {
  const int KT = m.key_tile;
  const int block_q = m.rows / G;
  const int key_end = causal ? std::min(Sk, q_offset + Sq) : Sk;
  const int key_base =
      (window > 0 ? std::max(q_offset - window + 1, 0) : 0) / KT * KT;
  const int key_tiles =
      key_end > key_base ? (key_end - key_base + KT - 1) / KT : 0;
  return {block_q, (Sq + block_q - 1) / block_q, key_base, key_tiles};
}

// The tensor-core launch: rows / G tokens a block, n_split key splits (cut
// to at most key_tiles, so no split is empty by construction) and, when
// there is more than one, the combine; K and V through tensor maps of their
// strides (cached by pointer, shape and strides). cudaErrorInvalidValue for
// more query heads per kv head than rows, a (D, Dv) pair without a kernel,
// splits without scratch, or an operand cuTensorMapEncodeTiled refuses.
int launch_mma(const void* q, const void* k, const void* v,
               const int* lengths, void* out, float* part_acc, float* part_m,
               float* part_l, Strides qs, Strides ks, Strides vs, Strides os,
               int B, int Sq, int Sk, int Hkv, int G, int D, int Dv,
               int q_offset, int causal, int window, float scale,
               float softcap, int n_split, cudaStream_t stream) {
  cudaError_t err;
  const MmaLaunch m = mma_launch(D, Dv, &err);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > m.rows) return (int)cudaErrorInvalidValue;
  const Plan p = plan(m, Sq, Sk, G, q_offset, causal, window);
  if (B == 0 || Hkv == 0 || p.q_tiles == 0) return 0;
  n_split = std::max(1, std::min(n_split, p.key_tiles));
  if (n_split > 1 && !(part_acc && part_m && part_l))
    return (int)cudaErrorInvalidValue;
  CUtensorMap k_map, v_map;
  int k_slots, v_slots;
  err = wg::strided_map(k, B, Hkv, Sk, D, ks.b, ks.h, ks.s, m.key_tile,
                        &k_map, &k_slots);
  if (err == cudaSuccess)
    err = wg::strided_map(v, B, Hkv, Sk, Dv, vs.b, vs.h, vs.s, m.key_tile,
                          &v_map, &v_slots);
  if (err != cudaSuccess) return (int)err;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
  // q tiles (and their splits) fastest: the blocks that read one (batch
  // row, kv head)'s keys run together, and its K/V stay in the L2
  m.kernel<<<dim3(p.q_tiles * n_split, Hkv, B), wg::kThreads, m.smem,
             stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), k_map, v_map, k_slots,
      v_slots, lengths, o, part_acc, part_m, part_l, qs, os, B, Sq, Sk, G,
      q_offset, causal, window, scale, softcap, p.block_q, n_split,
      p.key_base, p.key_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const long threads = (long)B * Sq * Hkv * G * (Dv / 4);
  chunked_prefill_attention_combine<<<(unsigned)((threads + 255) / 256), 256,
                                      0, stream>>>(
      part_acc, part_m, part_l, o, os, B, Sq, Hkv * G, Dv, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strides are in elements, (batch row, head, position) for each operand;
// the head-dim stride is 1. q and k rows are D wide, v rows and out Dv.
// part_acc [n_split, B, Sq, H, Dv], part_m and
// part_l [n_split, B, Sq, H] (fp32) are the split-K scratch of a bf16 launch
// with n_split > 1 (null otherwise; fp32 ignores n_split). Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue when G query heads per kv head do not fit a block at
// this D (bf16: a (D, Dv) pair of mma_launch and G at most the block's
// rows).
// Allocates nothing and does not synchronise: out and the scratch are
// allocated by the caller, the launches go on `stream`.
int chunked_prefill_attention_launch(
    const void* q, const void* k, const void* v, const int* lengths,
    void* out, float* part_acc, float* part_m, float* part_l, long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss,
    long long osb, long long osh, long long oss, int B, int Sq, int Sk,
    int Hkv, int G, int D, int Dv, int q_offset, int causal, int window,
    float scale, float softcap, int n_split, int is_bf16, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  if (is_bf16)
    return launch_mma(q, k, v, lengths, out, part_acc, part_m, part_l, qs, ks,
                      vs, os, B, Sq, Sk, Hkv, G, D, Dv, q_offset, causal,
                      window, scale, softcap, n_split, s);
  return launch<float>(q, k, v, lengths, out, qs, ks, vs, os, B, Sq, Sk, Hkv,
                       G, D, Dv, q_offset, causal, window, scale, softcap, s);
}

// info[0] = q tiles and info[1] = key tiles of a bf16 launch of Sq queries
// at q_offset over Sk keys (the grid a split covers, and the key range the
// splits cut), as chunked_prefill_attention_launch computes them; the
// wrapper chooses the number of splits from these. cudaErrorInvalidValue
// when the tensor-core kernel does not take G, D and Dv. Makes no CUDA call.
int chunked_prefill_attention_mma_plan(int Sq, int Sk, int G, int D, int Dv,
                                       int q_offset, int causal, int window,
                                       int* info) {
  const MmaLaunch m = mma_launch(D, Dv);
  if (!m.kernel || G < 1 || G > m.rows) return (int)cudaErrorInvalidValue;
  const Plan p = plan(m, Sq, Sk, G, q_offset, causal, window);
  info[0] = p.q_tiles;
  info[1] = p.key_tiles;
  return 0;
}

// info[0..5] = registers, spill bytes, dynamic shared memory, resident
// blocks per SM, query rows a block and keys a tile of the bf16 tensor-core
// kernel at key width D and value width Dv; cudaErrorInvalidValue for a
// pair without a kernel.
int chunked_prefill_attention_mma_attributes(int D, int Dv, int* info) {
  cudaError_t err;
  const MmaLaunch m = mma_launch(D, Dv, &err);
  if (err != cudaSuccess) return (int)err;
  info[4] = m.rows;
  info[5] = m.key_tile;
  return wg::attributes(m.kernel, m.smem, info);
}

const char* chunked_prefill_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
