// Mamba-1 selective scan with a carried state, for Hopper (sm_90a). Serves
// every Mamba call of the slot engine (models/ssm.py mamba_mix): prompt
// chunks of any length S >= 2 (the chunk kernel) and decode steps, S = 1
// (the decode kernel).
//
// Replaces the TPU kernel mamba_scan (src/repro/kernels/mamba_scan/kernel.py,
// _kernel), and reads and writes the state it keeps in VMEM scratch. Per
// (batch row b, channel c), with the state h [n] carried in from state row
// rows[b] (b when rows is null):
//   h_t = exp(dt_t * A_c) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = h_t . C_t + D_c * x_t          (fp32, stored in x's dtype)
// and the final h goes back to the same state row, in place.
//
// What bounds the chunk kernel on an H100, at jamba's B1 S2048 chunk
// (d_inner 16384, d_state 16, bf16; 537 M (token, channel, state) elements):
//   bytes       x and y in bf16 and dt in fp32, 8 bytes a (token, channel):
//               268 MB, 0.081 ms at 3.35 TB/s;
//   the SFU     one MUFU.EX2 an element at 16 a clock an SM: 0.128 ms at
//               1.98 GHz (0.145 at 1.755);
//   the FP32    4 operations an element (dt*a, dtx*B, the update's FMA,
//   pipe        h*C's FMA) at 128 a clock an SM: 0.064 ms at 1.98 GHz;
//   issue       the walk loop is 6.9 warp instructions an element at 2 lanes
//               (tools/mamba_variants.py counts it in cuobjdump -sass: the
//               4, the MUFU, and each step's shared loads of B, C, dt and
//               x, the shuffle of y's parts, y's store, over 8 states a
//               lane): 0.111 ms at one a clock on each of the 528
//               schedulers at 1.98 GHz.
// So the SFU and issue set the floor, near 0.13 ms; the kernel reaches about
// two thirds of either rate (with the exponential replaced by a multiply
// it is only about 12% faster).
//
// Chunk kernel (S >= 2; the engine's prompt chunks, one slot at a time).
// A block is 4 walker warps (kWalkers threads) and one service warp, over
// kChannels = kWalkers / L channels of one batch row.
// * Walkers: L lanes a channel (-DMAMBA_LANES, 2 by default): lane l holds
//   states l*P .. l*P + P-1 (P = 16 / L) and the same slice of A (times
//   log2 e) in registers from the first tile to the last. They wait on a
//   stage's full barrier, walk its kTile steps, and arrive on its done
//   barrier: no block barrier in the walk. The walk takes kGroup steps at a
//   time, their inputs read from the tile first so that the group's
//   exponentials overlap (B and C rows as float4 broadcasts). The update is
//   one multiply-add, h = fma(exp(v), h, dtx*B), and y's part a running
//   multiply-add over the lane's states. After a group the lanes' parts are
//   summed by shuffles (in the order of an xor tree, ((p_0 + p_2) + (p_1 +
//   p_3)) at L 4), and one lane adds D*x to a step's sum and writes y in
//   x's place in the stage: at L 2 each lane of a pair takes every other
//   step, one shuffle a step. (A storer warp summing parts that the
//   walkers left in the stage, built first, was no faster at S 2048 and
//   slower on fp32 tiles and where the service warp also copies.)
// * The service warp fills a ring of kStages stages: x [kTile, kChannels]
//   in x's dtype and dt (fp32) as TMA boxes of 3-D tensor maps over their
//   strides (x stays a column view of in_proj's output), B and C [kTile,
//   16] fp32 likewise. An operand whose map the driver refuses (a row
//   stride that is not a multiple of 16 bytes, as d_state 6's column views
//   of x_proj's output have, or an unaligned base) is copied by the
//   warp's 32 lanes with plain loads into the same stage under the same
//   barrier (states past d_state zero). Once the walkers are done with a
//   stage, the warp stores its y tile by TMA (or with plain stores, where
//   y's map is refused) and refills the stage. TMA fills past S and d with
//   zeros and clips its stores there.
// * The exponential is 2^v of v = dt * (A log2 e), A scaled once a thread:
//   ex2.approx.ftz on the SFU, or for the states j with j % 8 >= 8 -
//   MAMBA_POLY a degree-5 minimax polynomial on the FMA pipe (exp2_poly).
//   The share is chosen by state index, so the lane count does not change
//   which states take which exponential. Its 11 more instructions cost more
//   than the SFU time they free at 2 lanes, so the default share is 0
//   (tools/mamba_variants.py times 0, 1 and 2 of 8). The state is held to
//   chip_smoke.py's limit, not to the plain version's bits (-DMAMBA_EXP2=0
//   builds expf).
// * No split over time: at jamba's width a row has 16384 x 16 = 262,144
//   independent (channel, state) recurrences, about as many as the card
//   holds threads, so a two-pass scan over time would add its passes and
//   its bytes and buy no parallelism.
//
// Decode kernel (S = 1; the engine's decode steps over up to 8 slots by
// rows): bound by the state's bytes (64 bytes of h read and written a
// (row, channel), plus A). It streams: 4 lanes a channel, each reads and
// writes its float4 of h and reads its float4 of A, x, dt and D a channel,
// the row's B and C through the read-only cache; y by an xor-shuffle tree
// of the lanes' parts. One block a (row, 64 channels): 2048 blocks at B 8.
// It keeps expf and the products rounded one by one in the reference's
// order (no contraction), so a decode step's state is the plain version's
// bit for bit.
//
// In-place state writes are safe: each (state row, channel, lane) slice is
// read and written by one thread only. Rows must be distinct.
//
// Diagnostic builds (tools/mamba_variants.py): -DMAMBA_CUT=1 issues none of
// the loads of x, dt, B, C and the state, 2 replaces the exponential by a
// multiply, 3 makes none of the stores of y and the state to device memory
// (y is still formed in the stage; the results are then wrong and only the
// times mean anything).
#include "attend_wgmma.cuh"
#include "paged_common.cuh"

#ifndef MAMBA_LANES
#define MAMBA_LANES 2
#endif
#ifndef MAMBA_POLY
#define MAMBA_POLY 0
#endif
#ifndef MAMBA_EXP2
#define MAMBA_EXP2 1
#endif
#ifndef MAMBA_CUT
#define MAMBA_CUT 0
#endif

namespace {

constexpr int kMaxN = 16;                 // states a channel, at most
constexpr int kLanes = MAMBA_LANES;       // chunk kernel: threads a channel
constexpr int kWalkers = 128;             // chunk kernel: walker threads
constexpr int kChannels = kWalkers / kLanes;      // channels a block
constexpr int kThreads = kWalkers + 32;   // and the service warp
constexpr int kTile = 32;                 // time steps a tile
constexpr int kStages = 4;                // tiles in the ring
// steps whose inputs load together: 64 registers of B and C rows a lane at
// L 2 (the fastest of 2, 4 and 8 steps), 32 at L 1 and 4
constexpr int kGroup = kLanes == 2 ? 8 : 4;
// resident blocks an SM: the walker warps of a row of blocks, one, two or
// four a scheduler, in one wave at jamba's width
constexpr int kBlocks = kLanes;
constexpr int kPoly = MAMBA_POLY;         // states of every 8 off the SFU
constexpr int kDecChannels = 64;          // decode kernel: channels a block
constexpr int kDecLanes = 4;              // decode kernel: threads a channel
constexpr int kDecThreads = kDecChannels * kDecLanes;
constexpr bool kExp2 = MAMBA_EXP2 != 0;
constexpr bool kLoads = MAMBA_CUT != 1;
constexpr bool kExp = MAMBA_CUT != 2;
constexpr bool kStores = MAMBA_CUT != 3;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4, "1, 2 or 4 lanes");
static_assert(kPoly >= 0 && kPoly <= 8, "MAMBA_POLY states of every 8");
static_assert(kMaxN % (4 * kLanes) == 0 && kMaxN % (4 * kDecLanes) == 0,
              "a lane's states are whole float4s");
static_assert(kTile % kGroup == 0 && kGroup % kLanes == 0,
              "whole groups a tile, whole rounds of lanes a group");

// exp2_poly's coefficients: 2^f ~ 1 + f(c1 + f(c2 + f(c3 + f(c4 + f c5))))
// on [-0.5, 0.5], minimax in relative error (6.8e-8), rounded to fp32.
constexpr float kP1 = 0.6931466f, kP2 = 0.24022166f, kP3 = 0.055510473f,
                kP4 = 0.009674952f, kP5 = 0.0013202982f;

// The operands of TMA-able operand slots (bit i of Chunk::tma).
enum : int { kX = 1, kDt = 2, kB = 4, kC = 8, kY = 16 };

// One ring stage, each region 128-byte aligned: dt [kTile][kChannels]
// fp32, B and C [kTile][kMaxN] fp32, x (then y) [kTile][kChannels] in x's
// dtype.
template <typename T>
struct Stage {
  static constexpr int DT = 0;
  static constexpr int B = DT + kTile * kChannels * 4;
  static constexpr int C = B + kTile * kMaxN * 4;
  static constexpr int X = C + kTile * kMaxN * 4;
  static constexpr int BYTES = X + kTile * kChannels * (int)sizeof(T);
  static constexpr size_t SMEM = 128 + (size_t)kStages * BYTES + 16 * kStages;
};

// What a chunk launch reads and writes (element strides; unit last stride).
template <typename T>
struct Chunk {
  const T* x;
  long xsb, xss;
  const float* dt;
  long dsb, dss;
  const float* Bc;
  long bsb, bss;
  const float* Cc;
  long csb, css;
  const float* A;
  const float* D;
  float* h;
  long hb;
  const int* rows;
  T* y;
  int S, d, n, vec_state, tma;
};

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 2^v on the FMA pipe, 12 instructions: v = k + f with k = rint(v) (the
// 1.5 * 2^23 add) and f in [-0.5, 0.5]; 2^f by the degree-5 polynomial in
// Horner multiply-adds; 2^k formed in the exponent bits (0 at k = -127);
// their product flushed to 0 below 2^-126, as ex2.approx.ftz flushes. At
// most 2.15 ulp from 2^v over [-126, 0] (relative 2.2e-7, the SFU's
// ex2.approx is about 2 ulp); v is clamped to [-127, 128].
__device__ __forceinline__ float exp2_poly(float v) {
  v = fminf(fmaxf(v, -127.f), 128.f);
  const float j = __fadd_rn(v, 12582912.f);
  const float f = __fsub_rn(v, __fsub_rn(j, 12582912.f));
  float p = fmaf(kP5, f, kP4);
  p = fmaf(p, f, kP3);
  p = fmaf(p, f, kP2);
  p = fmaf(p, f, kP1);
  p = fmaf(p, f, 1.f);
  const float scale =
      __uint_as_float((__float_as_uint(j) << 23) + 0x3F800000u);
  float r;
  asm("mul.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(p), "f"(scale));
  return r;
}

// exp(dt * A) from v = dt * a: expf(v), or 2^v when a is A log2 e (kEx2),
// on the FMA pipe for a polynomial state.
template <bool kEx2>
__device__ __forceinline__ float step_exp(float v, bool poly = false) {
  if (!kExp) return __fmul_rn(v, 0.5f);
  if (!kEx2) return expf(v);
  return poly ? exp2_poly(v) : ex2_approx(v);
}

// Whether state j0 + i takes the polynomial: j % 8 >= 8 - kPoly. Known at
// compile time when a lane's states start on a multiple of 8 (L 1, 2).
template <int P>
__device__ __forceinline__ bool poly_state(int i, int j0) {
  if (kPoly == 0 || !kExp2) return false;
  return ((P % 8 == 0 ? i : j0 + i) % 8) >= 8 - kPoly;
}

// The lane's P states and its slice of A (times log2 e for kEx2), zero past
// n; float4s when every channel's row is 16 states at 16-byte alignment.
template <int P, bool kEx2>
__device__ __forceinline__ void load_state(float (&hs)[P], float (&a)[P],
                                           const float* hp, const float* ap,
                                           int j0, int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 hv = kLoads ? *reinterpret_cast<const float4*>(hp + 4 * q)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 av = __ldg(reinterpret_cast<const float4*>(ap + 4 * q));
      hs[4 * q] = hv.x, hs[4 * q + 1] = hv.y, hs[4 * q + 2] = hv.z,
      hs[4 * q + 3] = hv.w;
      a[4 * q] = av.x, a[4 * q + 1] = av.y, a[4 * q + 2] = av.z,
      a[4 * q + 3] = av.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      hs[i] = j0 + i < n ? hp[i] : 0.f;
      a[i] = j0 + i < n ? ap[i] : 0.f;
    }
  }
  if (kEx2) {
#pragma unroll
    for (int i = 0; i < P; ++i) a[i] = __fmul_rn(a[i], kLog2e);
  }
}

template <int P>
__device__ __forceinline__ void store_state(float* hp, const float (&hs)[P],
                                            int j0, int n, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < P / 4; ++q)
      *reinterpret_cast<float4*>(hp + 4 * q) =
          make_float4(hs[4 * q], hs[4 * q + 1], hs[4 * q + 2], hs[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (j0 + i < n) hp[i] = hs[i];
  }
}

// P floats from a 16-byte aligned row of shared memory.
template <int P>
__device__ __forceinline__ void load_row(float (&v)[P], const float* p) {
#pragma unroll
  for (int q = 0; q < P / 4; ++q) {
    const float4 w = *reinterpret_cast<const float4*>(p + 4 * q);
    v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z, v[4 * q + 3] = w.w;
  }
}

// One decode step of a lane: its P states advanced in the reference's
// rounding order, and its part of y (h . C over its states).
template <int P, bool kEx2>
__device__ __forceinline__ float lane_step(float (&hs)[P],
                                           const float (&a)[P], float dtt,
                                           float dtx, const float (&bv)[P],
                                           const float (&cv)[P]) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float da = step_exp<kEx2>(__fmul_rn(dtt, a[i]));
    hs[i] = __fadd_rn(__fmul_rn(da, hs[i]), __fmul_rn(dtx, bv[i]));
    part = fmaf(hs[i], cv[i], part);
  }
  return part;
}

// One chunk step of a lane (states j0 ..): the update as one multiply-add,
// and its part of y (h . C over its states).
template <int P>
__device__ __forceinline__ float walk_step(float (&hs)[P],
                                           const float (&a)[P], float dtt,
                                           float dtx, const float (&bv)[P],
                                           const float (&cv)[P], int j0) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float da =
        step_exp<kExp2>(__fmul_rn(dtt, a[i]), poly_state<P>(i, j0));
    hs[i] = fmaf(da, hs[i], __fmul_rn(dtx, bv[i]));
    part = fmaf(hs[i], cv[i], part);
  }
  return part;
}

// The lanes' parts of a channel summed in the order of an xor tree; every
// lane gets the sum.
__device__ __forceinline__ float lanes_sum(float part) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

// Rows [0, nt) of nch <= kChannels elements, row t at src + t * stride,
// into dst [kTile][kChannels] by the service warp's lanes; the channels
// past nch are zero.
template <typename E>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, long stride,
                                          int nt, int nch, int lane) {
#pragma unroll 4
  for (int i = lane; i < nt * kChannels; i += 32) {
    const int t = i / kChannels, c = i % kChannels;
    dst[i] = c < nch ? src[t * stride + c] : paged::from_float<E>(0.f);
  }
}

// Walker warps one, two or four a scheduler (L 1, 2, 4): 128, 256 or 512
// blocks at jamba's width, in one wave. Naming the count keeps ptxas from
// trading registers for more resident blocks.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocks)
mamba_scan_chunk_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dt_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map,
                        const __grid_constant__ CUtensorMap y_map,
                        const Chunk<T> a) {
  using St = Stage<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (128 - wg::smem_addr(smem_raw) % 128) % 128;
  const uint32_t ring = wg::smem_addr(smem);
  const uint32_t full = ring + kStages * St::BYTES;   // full[S], done[S]
  const uint32_t done = full + 8 * kStages;
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * kChannels;
  const int nch = min(kChannels, a.d - ch0);
  const int S = a.S;
  const int n_tiles = (S + kTile - 1) / kTile;
  const bool copies = (a.tma & (kX | kDt | kB | kC)) != (kX | kDt | kB | kC);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the service warp's arrival (with the TMA bytes), and each of its
      // lanes' after their copies
      wg::mbar_init(full + 8 * s, copies ? 33 : 1);
      wg::mbar_init(done + 8 * s, kWalkers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kWalkers) {
    // ---- the service warp: fills the ring, stores y
    const int lane = threadIdx.x - kWalkers;
    uint32_t tx = 0;                          // TMA bytes a stage
    if (a.tma & kX) tx += kTile * kChannels * sizeof(T);
    if (a.tma & kDt) tx += kTile * kChannels * 4;
    if (a.tma & kB) tx += kTile * kMaxN * 4;
    if (a.tma & kC) tx += kTile * kMaxN * 4;
    if (!kLoads) tx = 0;
    auto fill = [&](int k) {
      const int s = k % kStages, t0 = k * kTile, nt = min(kTile, S - t0);
      unsigned char* st = smem + s * St::BYTES;
      const uint32_t sa = ring + s * St::BYTES, bar = full + 8 * s;
      if (lane == 0) {
        if (tx) {
          wg::mbar_expect_tx(bar, tx);
          if (a.tma & kX) wg::tma_load_3d(sa + St::X, &x_map, bar, ch0, t0, b);
          if (a.tma & kDt)
            wg::tma_load_3d(sa + St::DT, &dt_map, bar, ch0, t0, b);
          if (a.tma & kB) wg::tma_load_3d(sa + St::B, &b_map, bar, 0, t0, b);
          if (a.tma & kC) wg::tma_load_3d(sa + St::C, &c_map, bar, 0, t0, b);
        } else {
          wg::mbar_arrive(bar);
        }
      }
      if (!copies) return;
      if (kLoads) {
        if (!(a.tma & kX))
          copy_rows(reinterpret_cast<T*>(st + St::X),
                    a.x + b * a.xsb + (long)t0 * a.xss + ch0, a.xss, nt, nch,
                    lane);
        if (!(a.tma & kDt))
          copy_rows(reinterpret_cast<float*>(st + St::DT),
                    a.dt + b * a.dsb + (long)t0 * a.dss + ch0, a.dss, nt, nch,
                    lane);
        for (int m = 0; m < 2; ++m) {
          if (a.tma & (m ? kC : kB)) continue;
          const float* src = m ? a.Cc + b * a.csb + (long)t0 * a.css
                               : a.Bc + b * a.bsb + (long)t0 * a.bss;
          const long stride = m ? a.css : a.bss;
          float* dst = reinterpret_cast<float*>(st + (m ? St::C : St::B));
          for (int i = lane; i < nt * kMaxN; i += 32) {
            const int t = i / kMaxN, j = i % kMaxN;
            dst[i] = j < a.n ? src[t * stride + j] : 0.f;
          }
        }
      }
      wg::mbar_arrive(bar);
    };
    auto drain = [&](int k) {
      const int s = k % kStages, t0 = k * kTile, nt = min(kTile, S - t0);
      const T* xy = reinterpret_cast<const T*>(smem + s * St::BYTES + St::X);
      wg::mbar_wait(done + 8 * s, (k / kStages) & 1);
      if (!kStores) return;
      if (a.tma & kY) {
        if (lane == 0) {
          wg::tma_store_3d(&y_map, ring + s * St::BYTES + St::X, ch0, t0, b);
          wg::bulk_commit();
          wg::bulk_wait_read();
        }
      } else {
        T* dst = a.y + ((long)b * S + t0) * a.d + ch0;
        for (int i = lane; i < nt * kChannels; i += 32) {
          const int t = i / kChannels, c = i % kChannels;
          if (c < nch) dst[(long)t * a.d + c] = xy[i];
        }
      }
      __syncwarp();
    };
    for (int k = 0; k < n_tiles; ++k) {
      if (k >= kStages) drain(k - kStages);
      fill(k);
    }
    for (int k = max(0, n_tiles - kStages); k < n_tiles; ++k) drain(k);
    if (lane == 0) wg::bulk_wait();
    return;
  }

  // ---- the walkers
  constexpr int P = kMaxN / kLanes;
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int j0 = lane * P;
  const bool live = c < nch;
  const int ch = live ? ch0 + c : ch0;        // dead lanes read channel ch0
  const long r = a.rows ? a.rows[b] : b;
  float hs[P], av[P];
  float* hp = a.h + r * a.hb + (long)ch * a.n + j0;
  load_state<P, kExp2>(hs, av, hp, a.A + (long)ch * a.n + j0, j0, a.n,
                       a.vec_state);
  const float dskip = a.D[ch];

  for (int k = 0; k < n_tiles; ++k) {
    const int s = k % kStages;
    unsigned char* st = smem + s * St::BYTES;
    const float* dt_s = reinterpret_cast<const float*>(st + St::DT);
    const float* b_s = reinterpret_cast<const float*>(st + St::B) + j0;
    const float* c_s = reinterpret_cast<const float*>(st + St::C) + j0;
    T* x_s = reinterpret_cast<T*>(st + St::X);
    const int nt = min(kTile, S - k * kTile);
    wg::mbar_wait(full + 8 * s, (k / kStages) & 1);
    int t = 0;
#pragma unroll 1
    for (; t + kGroup <= nt; t += kGroup) {
      float dtt[kGroup], xv[kGroup], bv[kGroup][P], cv[kGroup][P];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        dtt[u] = dt_s[(t + u) * kChannels + c];
        xv[u] = paged::to_float(x_s[(t + u) * kChannels + c]);
        load_row(bv[u], b_s + (t + u) * kMaxN);
        load_row(cv[u], c_s + (t + u) * kMaxN);
      }
      float part[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        part[u] = walk_step<P>(hs, av, dtt[u], __fmul_rn(dtt[u], xv[u]),
                               bv[u], cv[u], j0);
      if (kLanes == 2) {
        // steps u and u + 1: each lane sends the partner its part of the
        // partner's step and forms y of step u + lane
#pragma unroll
        for (int u = 0; u < kGroup; u += 2) {
          const float send = lane ? part[u] : part[u + 1];
          const float mine = lane ? part[u + 1] : part[u];
          const float sum = mine + __shfl_xor_sync(0xffffffffu, send, 1);
          x_s[(t + u + lane) * kChannels + c] = paged::from_float<T>(
              fmaf(dskip, lane ? xv[u + 1] : xv[u], sum));
        }
      } else {
        // y of step u by lane u % L, over x in the stage
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float sum = lanes_sum(part[u]);
          if (u % kLanes == lane)
            x_s[(t + u) * kChannels + c] =
                paged::from_float<T>(fmaf(dskip, xv[u], sum));
        }
      }
    }
#pragma unroll 1
    for (; t < nt; ++t) {
      const float dtt = dt_s[t * kChannels + c];
      const float xv = paged::to_float(x_s[t * kChannels + c]);
      float bv[P], cv[P];
      load_row(bv, b_s + t * kMaxN);
      load_row(cv, c_s + t * kMaxN);
      const float part = lanes_sum(
          walk_step<P>(hs, av, dtt, __fmul_rn(dtt, xv), bv, cv, j0));
      if (lane == 0)
        x_s[t * kChannels + c] = paged::from_float<T>(fmaf(dskip, xv, part));
    }
    wg::proxy_fence();                // y, before the TMA store reads it
    wg::mbar_arrive(done + 8 * s);
  }
  if (live && kStores) store_state(hp, hs, j0, a.n, a.vec_state);
}

template <typename T>
__global__ void __launch_bounds__(kDecThreads)
mamba_scan_decode_kernel(const T* __restrict__ x, long xsb,
                         const float* __restrict__ dt, long dsb,
                         const float* __restrict__ Bc, long bsb,
                         const float* __restrict__ Cc, long csb,
                         const float* __restrict__ A,
                         const float* __restrict__ Dp, float* h, long hb,
                         const int* __restrict__ rows, T* __restrict__ y,
                         int d, int n, int vec_state) {
  constexpr int P = kMaxN / kDecLanes;
  const int b = blockIdx.y;
  const int c = blockIdx.x * kDecChannels + threadIdx.x / kDecLanes;
  const int lane = threadIdx.x % kDecLanes, j0 = lane * P;
  const bool live = c < d;
  const int ch = live ? c : d - 1;            // dead lanes read channel d-1
  const long r = rows ? rows[b] : b;
  float hs[P], a[P], bv[P], cv[P];
  float* hp = h + r * hb + (long)ch * n + j0;
  load_state<P, false>(hs, a, hp, A + (long)ch * n + j0, j0, n, vec_state);
  const float* bp = Bc + b * bsb + j0;
  const float* cp = Cc + b * csb + j0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    bv[i] = j0 + i < n && kLoads ? __ldg(bp + i) : 0.f;
    cv[i] = j0 + i < n && kLoads ? __ldg(cp + i) : 0.f;
  }
  const float xt = paged::to_float(x[b * xsb + ch]);
  const float dtt = __ldg(dt + b * dsb + ch);
  float sum = lane_step<P, false>(hs, a, dtt, __fmul_rn(dtt, xt), bv, cv);
  // the lanes' parts summed by an xor tree; every lane gets the sum
#pragma unroll
  for (int o = kDecLanes / 2; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (live && (kStores || n < 0)) {
    store_state(hp, hs, j0, n, vec_state);
    if (lane == 0)
      y[(long)b * d + ch] =
          paged::from_float<T>(__fadd_rn(sum, __fmul_rn(__ldg(Dp + ch), xt)));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A 3-D tensor map over an operand [B, S, width] read through its element
// strides (batch row sb, token ss; unit last stride), boxes of [box, kTile,
// 1]; cudaErrorInvalidValue where TMA cannot read it: a base that is not
// 16-byte aligned, a stride that is not a multiple of 16 bytes, or a map
// the driver refuses. At B 1 the batch stride is never stepped, and any
// multiple of 16 bytes stands in for it.
cudaError_t operand_map(const void* ptr, CUtensorMapDataType type, int elt,
                        int B, int S, int width, long sb, long ss, int box,
                        CUtensorMap* out) {
  const long sb_bytes = (B > 1 ? sb : (long)S * ss) * elt;
  if (!aligned16(ptr) || ss <= 0 || (ss * elt) % 16 != 0 || sb_bytes <= 0 ||
      sb_bytes % 16 != 0)
    return cudaErrorInvalidValue;
  wg::MapKey k = wg::map_key(ptr, 3);
  k.dtype = type;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  k.dims[0] = (cuuint64_t)width;
  k.dims[1] = (cuuint64_t)S;
  k.dims[2] = (cuuint64_t)B;
  k.strides[0] = (cuuint64_t)(ss * elt);
  k.strides[1] = (cuuint64_t)sb_bytes;
  k.box[0] = (cuuint32_t)box;
  k.box[1] = kTile;
  k.box[2] = 1;
  return wg::tensor_map(k, out);
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// The chunk kernel's launch: a tensor map for each operand that takes one
// (bit of Chunk::tma), the others copied by the service warp.
template <typename T>
int launch_chunk(Chunk<T> a, int B, cudaStream_t stream) {
  constexpr int elt = sizeof(T);
  constexpr CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap m[5];
  std::memset(m, 0, sizeof(m));
  const int S = a.S, d = a.d, n = a.n;
  a.tma = 0;
  if (operand_map(a.x, map_type<T>(), elt, B, S, d, a.xsb, a.xss, kChannels,
                  &m[0]) == cudaSuccess)
    a.tma |= kX;
  if (operand_map(a.dt, f32, 4, B, S, d, a.dsb, a.dss, kChannels, &m[1]) ==
      cudaSuccess)
    a.tma |= kDt;
  if (operand_map(a.Bc, f32, 4, B, S, n, a.bsb, a.bss, kMaxN, &m[2]) ==
      cudaSuccess)
    a.tma |= kB;
  if (operand_map(a.Cc, f32, 4, B, S, n, a.csb, a.css, kMaxN, &m[3]) ==
      cudaSuccess)
    a.tma |= kC;
  if (operand_map(a.y, map_type<T>(), elt, B, S, d, (long)S * d, d,
                  kChannels, &m[4]) == cudaSuccess)
    a.tma |= kY;
  constexpr size_t smem = Stage<T>::SMEM;
  const cudaError_t err =
      paged::reserve_smem(mamba_scan_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d + kChannels - 1) / kChannels, B);
  mamba_scan_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      m[0], m[1], m[2], m[3], m[4], a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, long xsb, long xss, const float* dt, long dsb,
           long dss, const float* Bc, long bsb, long bss, const float* Cc,
           long csb, long css, const float* A, const float* D, float* h,
           long hb, const int* rows, void* y, int B, int S, int d, int n,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || d == 0) return 0;
  // float4 state slices: rows of 16 states on 16-byte boundaries
  const int vec_state =
      n == kMaxN && aligned16(h) && aligned16(A) && hb % 4 == 0;
  const T* xt = reinterpret_cast<const T*>(x);
  T* yt = reinterpret_cast<T*>(y);
  if (S == 1) {
    const dim3 grid((d + kDecChannels - 1) / kDecChannels, B);
    mamba_scan_decode_kernel<T><<<grid, kDecThreads, 0, stream>>>(
        xt, xsb, dt, dsb, Bc, bsb, Cc, csb, A, D, h, hb, rows, yt, d, n,
        vec_state);
    return (int)cudaGetLastError();
  }
  return launch_chunk<T>({xt, xsb, xss, dt, dsb, dss, Bc, bsb, bss, Cc, csb,
                          css, A, D, h, hb, rows, yt, S, d, n, vec_state, 0},
                         B, stream);
}

}  // namespace

extern "C" {

// Strides are in elements, (batch row, token), with a unit channel stride:
// x [B, S, d] in bf16 or fp32 (is_bf16), dt [B, S, d] fp32, Bc and Cc
// [B, S, n] fp32. A [d, n] and D [d] are fp32 and contiguous. The state h
// [Bs, d, n] is fp32 with contiguous rows and batch stride hb; rows [B]
// (int32, distinct) maps batch row b to state row rows[b], or is null for
// rows[b] = b. h is updated in place; y [B, S, d] (contiguous, x's dtype)
// is allocated by the caller. S = 1 launches the decode kernel, S >= 2 the
// chunk kernel. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue when n is not in 1..16. Allocates
// nothing and does not synchronise: the launch goes on `stream`.
int mamba_scan_launch(const void* x, long long xsb, long long xss,
                      const float* dt, long long dsb, long long dss,
                      const float* Bc, long long bsb, long long bss,
                      const float* Cc, long long csb, long long css,
                      const float* A, const float* D, float* h, long long hb,
                      const int* rows, void* y, int B, int S, int d, int n,
                      int is_bf16, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, xsb, xss, dt, dsb, dss, Bc, bsb, bss, Cc,
                                 csb, css, A, D, h, hb, rows, y, B, S, d, n,
                                 st);
  return launch<float>(x, xsb, xss, dt, dsb, dss, Bc, bsb, bss, Cc, csb, css,
                       A, D, h, hb, rows, y, B, S, d, n, st);
}

// info[0..7]: registers, local (spill) bytes, dynamic shared memory,
// resident blocks an SM, threads a block, lanes a channel, ring stages and
// polynomial states of every 8 of kernel `which`: 0 the bf16 chunk kernel,
// 1 the fp32 chunk kernel, 2 the bf16 decode kernel, 3 the fp32 one.
// cudaErrorInvalidValue for another `which`.
int mamba_scan_attributes(int which, int* info) {
  using bf16 = __nv_bfloat16;
  int err;
  if (which == 0 || which == 1) {
    const size_t smem = which ? Stage<float>::SMEM : Stage<bf16>::SMEM;
    err = which ? (int)paged::reserve_smem(mamba_scan_chunk_kernel<float>,
                                           smem)
                : (int)paged::reserve_smem(mamba_scan_chunk_kernel<bf16>,
                                           smem);
    if (err == 0)
      err = which ? wg::attributes(mamba_scan_chunk_kernel<float>, smem, info,
                                   kThreads)
                  : wg::attributes(mamba_scan_chunk_kernel<bf16>, smem, info,
                                   kThreads);
    info[4] = kThreads, info[5] = kLanes, info[6] = kStages, info[7] = kPoly;
  } else if (which == 2 || which == 3) {
    err = which == 3 ? wg::attributes(mamba_scan_decode_kernel<float>, 0,
                                      info, kDecThreads)
                     : wg::attributes(mamba_scan_decode_kernel<bf16>, 0, info,
                                      kDecThreads);
    info[4] = kDecThreads, info[5] = kDecLanes, info[6] = 0, info[7] = 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err;
}

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
