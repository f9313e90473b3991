// Tensor-core tile loop of the bf16 prefill attention kernels
// (paged_prefill_attention.cu: the fused-pool and split-pool prefill;
// chunked_prefill_attention.cu: a query chunk over a slot row, with
// split-K). The fp32 instantiations keep the scalar loop of
// paged_common.cuh; the decode kernels have their own block. The mLSTM
// kernel (mlstm_chunkwise.cu) uses the mma.sync and cp.async helpers.
//
// One block (Geometry: W warps of MW m16 row blocks) owns kRows query rows
// of one (batch row, kv head): row r = t*G + g (token t, grouped head g;
// rows past nt*G are padding, zero queries that are never written; a warp
// with padding rows only skips the products), so each K/V tile is read once
// for all G heads. Warp w owns rows [16*MW*w, 16*MW*(w + 1)). The block
// walks keys [key_lo, key_hi) in tiles of KT keys:
//   1. K and V rows of tiles j+1 .. j+S-1 -> shared memory through
//      cp.async.cg (16 bytes a copy, one commit group per tile, a ring of
//      S stages) while tile j computes; rows padded by 16 bytes so that
//      ldmatrix is conflict-free; keys at or past key_hi are zero-filled
//      and masked,
//   2. S = Q.K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulators),
//      16*MW x KT per warp; Q's A fragments stay in registers with one row
//      block a warp at D <= 128, else come from shared memory each tile,
//   3. s * scale, the softcap, then the length, causal and window masks
//      (finite -1e30, the reference's order) in registers, each row at its
//      own token's position,
//   4. the fp32 online softmax: row max over a quad with two shuffles, p =
//      exp(s - m) summed unrounded into l, then rounded to bf16, which
//      makes it the A operand of P.V directly (the m16n8 accumulator
//      layout is the m16n8k16 A layout),
//   5. O += P.V with V's B fragments through ldmatrix.trans, O fp32 in
//      registers.
// Finally out = O / max(l, 1e-30) in bf16, or the fp32 partial state
// (O, m, l). An empty key range gives zeros, or (0, -1e30, 0). Q and K rows
// are D wide, V rows, O and the output DV (DV <= D: MLA's values are
// narrower than its keys, 128 against 192); Q.K^T takes D / 16 k-steps,
// P.V DV / 8 n-blocks.
//
// A row whose first tiles are all masked keeps m = -1e30 and takes exp(0)
// = 1 for those entries, until a visible key's corr = exp(-1e30 - m) = 0
// wipes them, as in the scalar loop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

// The shape of one block: W warps, each owning MW m16 blocks of query rows
// (one for values wider than 128, where O alone is 128 floats a thread;
// MLA's values of 128 under keys of 192 keep two, which took its Sq512 chunk
// from 1.66 to 1.11 ms on an NVIDIA H100 80GB HBM3 at 700 W), so kRows = 16
// * MW * W rows t*G + g, for keys D wide and values DV_ wide (D by default).
// More rows a block read each K/V tile for more queries (fewer copies from
// L2 per product); more row blocks a warp use each K and V fragment in more
// products (fewer ldmatrix per mma); more warps a block keep a few-block
// grid's SMs busier. Each kernel picks its shape
// (paged_prefill_attention.cu, chunked_prefill_attention.cu).
template <int D_, int W, int MW_, int DV_ = D_>
struct Geometry {
  static_assert(DV_ <= D_ && DV_ % 16 == 0, "values no wider than keys");
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr int kWarps = W;
  static constexpr int kThreads = 32 * W;
  static constexpr int MW = DV_ > 128 ? 1 : MW_;
  static constexpr int kRows = 16 * MW * W;
  // keys per tile: 64 (4 pages of 16); 32 at D = 256 or with two row
  // blocks a warp, where the registers rule out more
  static constexpr int KT = D_ > 128 || MW > 1 ? 32 : 64;
  // Q's A fragments stay in registers at D <= 128 with one row block a
  // warp (its shared-memory rows are then the last stage's until the first
  // tile is computed); else they come from shared memory every tile
  static constexpr bool kQInRegs = D_ <= 128 && MW == 1;
  // depth of the ring of K/V tiles: two or three tiles in flight while one
  // computes (on an H100 the copies from L2, not their latency, set a
  // two-deep ring's time: a deeper ring won little, fewer copies a product
  // more)
  static constexpr int kStages = D_ > 128 ? 2 : (kQInRegs ? 3 : 4);
  static constexpr int P = D_ + 8;      // row pitch: ldmatrix conflict-free
  static constexpr int PV = DV_ + 8;    // V's row pitch
  static constexpr int SE = KT * (P + PV);   // one stage: a K and a V tile
  static constexpr size_t kSmem =
      ((size_t)kStages * SE + (kQInRegs ? 0 : (size_t)kRows * P)) *
      sizeof(bf16);
  static constexpr int kMinBlocks = W >= 8 ? 1 : 2;   // resident per SM
  static_assert(!kQInRegs || kRows * P <= SE, "Q fits one stage");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even) in one register, the
// first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// KV sources: where key kp's K row and V row start (D contiguous elements);
// any() is a valid address for the zero-filling copies, which read nothing.

// The fused page pool: this kv head's pages [P, 2, ps, D] through the
// row's block table.
struct PagedRows {
  const bf16* kv_head;
  const int* bt_row;
  int ps, D;

  __device__ __forceinline__ const bf16* any() const { return kv_head; }
  __device__ __forceinline__ const bf16* row(int kp, bool is_v) const {
    const int page = bt_row[kp / ps];
    return kv_head +
           ((size_t)(2 * page + (is_v ? 1 : 0)) * ps + kp % ps) * D;
  }
};

// The split page pools: this kv head's K pages and V pages, each [P, ps, D],
// through the row's block table (the same pages as PagedRows, in two pools).
struct SplitPagedRows {
  const bf16* k_head;
  const bf16* v_head;
  const int* bt_row;
  int ps, D;

  __device__ __forceinline__ const bf16* any() const { return k_head; }
  __device__ __forceinline__ const bf16* row(int kp, bool is_v) const {
    return (is_v ? v_head : k_head) +
           ((size_t)bt_row[kp / ps] * ps + kp % ps) * D;
  }
};

// K and V rows at fixed strides (elements between consecutive keys), e.g.
// a slot cache row [S, Hkv, D] read in place.
struct StridedRows {
  const bf16* k;
  const bf16* v;
  long k_stride, v_stride;

  __device__ __forceinline__ const bf16* any() const { return k; }
  __device__ __forceinline__ const bf16* row(int kp, bool is_v) const {
    return is_v ? v + (long)kp * v_stride : k + (long)kp * k_stride;
  }
};

// Tile [k0, k0 + KT) of K and V into shared memory; keys at or past hi are
// zero-filled (their scores are masked; zero V rows add nothing).
template <typename Geo, typename Rows>
__device__ __forceinline__ void load_tile(bf16* k_s, bf16* v_s,
                                          const Rows& rows, int k0, int hi) {
  constexpr int KT = Geo::KT;
  constexpr int CH = Geo::D / 8;          // 16-byte chunks per K row
  constexpr int CHV = Geo::DV / 8;        // and per V row
  constexpr int P = Geo::P;
  constexpr int PV = Geo::PV;
#pragma unroll 4
  for (int i = threadIdx.x; i < KT * (CH + CHV); i += Geo::kThreads) {
    const bool is_v = i >= KT * CH;       // K rows, then V rows
    const int j = is_v ? i - KT * CH : i;
    const int key = is_v ? j / CHV : j / CH;
    const int c = is_v ? j % CHV : j % CH;
    const int kp = k0 + key;
    const bool live = kp < hi;
    const bf16* src = live ? rows.row(kp, is_v) + c * 8 : rows.any();
    cp_async16((is_v ? v_s + key * PV : k_s + key * P) + c * 8, src,
               live ? 16 : 0);
  }
}

// One block's work; the block's query rows are r = t*G + g for t < BR / G.
// Query row r sits at q[t * q_tok + g * q_head], its output at out[t *
// o_tok + g * o_head] (m/l at t * ml_stride + g), its query position is
// q_pos0 + t. Key kp is visible when key_lo <= kp < key_hi, kp < length,
// kp <= qp if causal, and qp - kp < window if window > 0.
template <typename Geo, typename Rows>
__device__ __forceinline__ void attend_rows(
    const bf16* __restrict__ q, long q_tok, long q_head,
    void* __restrict__ out, long o_tok, long o_head,
    float* __restrict__ m_out, float* __restrict__ l_out, long ml_stride,
    const Rows& rows_src, int G, int BR, int q_pos0, int length,
    bool causal, int window, float scale, float softcap, int key_lo,
    int key_hi, bool partial) {
  constexpr int D = Geo::D;
  constexpr int KT = Geo::KT;
  constexpr int P = Geo::P;
  constexpr int PV = Geo::PV;
  constexpr int MW = Geo::MW;           // row blocks per warp
  constexpr int RB = Geo::kRows;        // rows per block
  constexpr int NB = KT / 8;            // n-blocks of S per row block
  constexpr int ND = Geo::DV / 8;       // n-blocks of O per row block
  constexpr int KD = D / 16;            // k-steps of Q.K^T
  constexpr int S = Geo::kStages;
  constexpr int SE = Geo::SE;
  constexpr bool kQInRegs = Geo::kQInRegs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [S][K, V][KT][P]
  bf16* q_s = ring + (kQInRegs ? S - 1 : S) * SE;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;     // mma group, thread in group
  const int w0 = warp * 16 * MW;              // the warp's first row
  const bool active = w0 < BR;   // a warp of padding rows only copies

  // Q rows -> shared memory (padding rows zero), in the first tile's group;
  // then the first S - 1 tiles, one commit group each.
  for (int i = tid; i < RB * (D / 8); i += Geo::kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    const bool live = r < BR;
    const bf16* src =
        live ? q + (r / G) * q_tok + (r % G) * q_head + c * 8 : q;
    cp_async16(q_s + r * P + c * 8, src, live ? 16 : 0);
  }
  const int n_tiles = key_hi > key_lo ? (key_hi - key_lo + KT - 1) / KT : 0;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_tiles)
      load_tile<Geo>(ring + st * SE, ring + st * SE + KT * P, rows_src,
                   key_lo + st * KT, key_hi);
    cp_async_commit();
  }

  // This thread's rows: gq and gq + 8 of each of the warp's row blocks.
  int qp[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    qp[mi][0] = q_pos0 + (w0 + mi * 16 + gq) / G;
    qp[mi][1] = q_pos0 + (w0 + mi * 16 + gq + 8) / G;
  }
  const int qp_lo = q_pos0 + w0 / G;                   // the warp's first
  const int qp_hi = q_pos0 + (w0 + 16 * MW - 1) / G;   // and last position
  const int lim = min(key_hi, length);

  uint32_t qf[kQInRegs ? KD : 1][4];
  float o[MW][ND][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int i = 0; i < ND; ++i)
      o[mi][i][0] = o[mi][i][1] = o[mi][i][2] = o[mi][i][3] = 0.f;
  float m[MW][2], l[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    m[mi][0] = m[mi][1] = kNegInf;
    l[mi][0] = l[mi][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = key_lo + j * KT;
    // tile j has landed (S - 2 later tiles may be in flight); every warp
    // is past tile j - 1, whose stage the copy below refills
    cp_async_wait<S - 2>();
    __syncthreads();
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldmatrix_x4(qf[kk], q_s + (w0 + (lane & 15)) * P + kk * 16 +
                                  (lane >> 4) * 8);
        __syncthreads();   // Q's rows are the last stage's from here on
      }
    }
    if (j + S - 1 < n_tiles) {
      bf16* nxt = ring + ((j + S - 1) % S) * SE;
      load_tile<Geo>(nxt, nxt + KT * P, rows_src, k0 + (S - 1) * KT, key_hi);
    }
    cp_async_commit();
    if (!active) continue;
    const bf16* k_s = ring + (j % S) * SE;
    const bf16* v_s = k_s + KT * P;

    // S = Q.K^T: per k-step, one ldmatrix of K gives two n-blocks of 8
    // keys, each fragment used by every row block of the warp.
    float s[MW][NB][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        s[mi][nb][0] = s[mi][nb][1] = s[mi][nb][2] = s[mi][nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        if constexpr (kQInRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) a[mi][x] = qf[kQInRegs ? kk : 0][x];
        } else {
          ldmatrix_x4(a[mi], q_s + (w0 + mi * 16 + (lane & 15)) * P +
                                 kk * 16 + (lane >> 4) * 8);
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, k_s + (nb * 8 + (lane & 7) + ((lane >> 4) << 3)) * P +
                           kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma_bf16(s[mi][nb], a[mi], b[0], b[1]);
          mma_bf16(s[mi][nb + 1], a[mi], b[2], b[3]);
        }
      }
    }

    // scale, softcap, masks; a warp whose rows all see the whole tile
    // skips the masks
    const bool all_visible =
        k0 + KT <= lim && (!causal || k0 + KT - 1 <= qp_lo) &&
        (window <= 0 || qp_hi - k0 < window);
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float v = s[mi][nb][x] * scale;
          if (softcap > 0.f) v = softcap * tanhf(v / softcap);
          if (!all_visible) {
            const int kp = k0 + nb * 8 + tq * 2 + (x & 1);
            const int qx = qp[mi][x >> 1];
            bool ok = kp < lim && (!causal || kp <= qx);
            if (window > 0) ok = ok && (qx - kp < window);
            v = ok ? v : kNegInf;
          }
          s[mi][nb][x] = v;
        }
      }

    // online softmax: rows gq (x = 0, 1) and gq + 8 (x = 2, 3)
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][nb][0], s[mi][nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][nb][2], s[mi][nb][3]));
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        corr[i] = __expf(m[mi][i] - mx[i]);
        m[mi][i] = mx[i];
        l[mi][i] *= corr[i];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float p = __expf(s[mi][nb][x] - mx[x >> 1]);
          l[mi][x >> 1] += p;
          s[mi][nb][x] = p;
        }
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        o[mi][nd][0] *= corr[0];
        o[mi][nd][1] *= corr[0];
        o[mi][nd][2] *= corr[1];
        o[mi][nd][3] *= corr[1];
      }
    }

    // O += P.V: P's bf16 A fragments straight from the S accumulators,
    // each V fragment used by every row block of the warp
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        a[mi][0] = pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
        a[mi][1] = pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
        a[mi][2] = pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
        a[mi][3] = pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
      }
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + (kk * 16 + (lane & 15)) * PV + nd * 8 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          mma_bf16(o[mi][nd], a[mi], b[0], b[1]);
          mma_bf16(o[mi][nd + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  cp_async_wait<0>();   // no copy outlives the block

#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[mi][i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int r = w0 + mi * 16 + gq + 8 * i;
      if (r >= BR) continue;          // padding row: never written
      const long base = (r / G) * o_tok + (r % G) * o_head;
      if (partial) {
        float* acc = reinterpret_cast<float*>(out) + base;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          *reinterpret_cast<float2*>(acc + nd * 8 + tq * 2) =
              make_float2(o[mi][nd][2 * i], o[mi][nd][2 * i + 1]);
        if (tq == 0) {
          const long ml = (r / G) * ml_stride + r % G;
          m_out[ml] = m[mi][i];
          l_out[ml] = li;
        }
      } else {
        const float d = fmaxf(li, 1e-30f);
        bf16* dst = reinterpret_cast<bf16*>(out) + base;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
          *reinterpret_cast<uint32_t*>(dst + nd * 8 + tq * 2) =
              pack_bf16(o[mi][nd][2 * i] / d, o[mi][nd][2 * i + 1] / d);
      }
    }
}

// info[0..3] = registers, local (spill) bytes, dynamic shared memory and
// resident blocks per SM of a kernel launched with `smem` bytes.
template <typename Kernel>
inline int attributes(Kernel kernel, int threads, size_t smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  return 0;
}

}  // namespace mma
