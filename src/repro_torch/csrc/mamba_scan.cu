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
// and the final h goes back to the same state row, in place. The products
// are rounded one by one (no FMA contraction) in the reference's order.
//
// What bounds it on an H100, at jamba's B1 S2048 chunk (d_inner 16384,
// d_state 16, bf16):
//   bytes       x and y in bf16 and dt in fp32, 8 bytes a (token, channel):
//               268 MB, 0.081 ms at 3.35 TB/s;
//   the SFU     16 exponentials a (token, channel), 537 M MUFU.EX2 at 16 a
//               clock an SM: 0.13-0.15 ms at 1.98-1.75 GHz;
//   issue       the accurate expf is 8 instructions (one of them the
//               MUFU); with dt*A and the rounded update (da*h, dtx*B, the
//               add, h*C) 13 a state element, 7 G thread instructions:
//               0.2-0.26 ms at one warp instruction a clock on each of the
//               528 schedulers.
// So the floor is the SFU or the instruction stream, 2-3x above the bytes.
//
// Why the first port stalled (1.71 ms at that shape): one thread owned a
// channel and its 16 states, 128 threads a block, so the chunk ran 128
// blocks for 132 SMs, one warp per scheduler; and a tile was staged by a
// loop of dependent global loads and a barrier, so no load overlapped the
// walk. Each 2048-step walk issued about 210 instructions a step but took
// about 1,600 cycles a step: stalls, not work.
//
// Chunk kernel (S >= 2; the engine's prompt chunks, one slot at a time).
// * L lanes a channel (kLanes, 2; -DMAMBA_LANES=4 builds 4): lane l holds
//   states l*P .. l*P + P-1 (P = 16 / L) and the same slice of A in
//   registers, loaded and stored as float4s (coalesced across the lanes
//   when d_state is 16; states past d_state are zero and stay zero). A
//   block owns 64 channels of one batch row (64*L threads): 256 blocks at
//   d_inner 16384, two an SM.
// * kTile time steps of x (x's dtype), dt, B and C (fp32) come into a ring
//   of kStages tiles in shared memory by cp.async (16 bytes a thread for x
//   and dt when their rows are 16-byte aligned, else element copies; 4
//   bytes an element for B and C, whose rows are column slices of x_proj's
//   output): the loads of the next two tiles are in flight while this one
//   is walked. The ragged last tile is masked.
// * The walk takes kGroup steps at a time: their inputs are read from the
//   tile first, so that the group's exponentials overlap (a load from the
//   tile may not pass a store to shared memory). Each lane writes its part
//   of y (its states' h*C) to shared memory; after the tile a barrier, and
//   each thread sums the parts of a 16-byte piece of y in the order of an
//   xor tree over the lanes (((p_0 + p_2) + (p_1 + p_3)) at L 4), adds D*x
//   and writes the piece. Summing the parts with shuffles in the walk was
//   slower: their latency sat on every step.
// * The exponential is ex2.approx of dt * (A log2 e), A scaled once a
//   thread: the MUFU and nothing else, against expf's eight instructions.
//   It is 1.5x faster at B1 S2048 (0.274 against 0.425 ms device on an
//   H100 80GB HBM3 at 700 W, tools/mamba_variants.py) and keeps every
//   limit of chip_smoke.py, but the state is no longer the plain version's
//   bit for bit (-DMAMBA_EXP2=0 builds expf). With it, two lanes a channel
//   beat four (0.274 against 0.30-0.31 ms): the eight states of a lane give
//   its warp the independent exponentials that more warps would.
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
// It keeps expf (ex2 buys nothing where bytes bound), so a decode step's
// state is the plain version's bit for bit.
//
// In-place state writes are safe: each (state row, channel, lane) slice is
// read and written by one thread only. Rows must be distinct.
//
// Diagnostic builds (tools/mamba_variants.py): -DMAMBA_CUT=1 issues none of
// the loads of x, dt, B, C and the state, 2 replaces the exponential by a
// multiply, 3 makes none of the stores of y and the state (the results are
// then wrong and only the times mean anything).
#include "attend_mma.cuh"
#include "paged_common.cuh"

#ifndef MAMBA_LANES
#define MAMBA_LANES 2
#endif
#ifndef MAMBA_EXP2
#define MAMBA_EXP2 1
#endif
#ifndef MAMBA_CUT
#define MAMBA_CUT 0
#endif

namespace {

constexpr int kMaxN = 16;                 // states a channel, at most
constexpr int kChannels = 64;             // channels a block
constexpr int kLanes = MAMBA_LANES;       // chunk kernel: threads a channel
constexpr int kThreads = kChannels * kLanes;
constexpr int kTile = 32;                 // time steps a tile
constexpr int kStages = 3;                // tiles in the ring
constexpr int kGroup = 4;                 // steps whose inputs load together
constexpr int kDecLanes = 4;              // decode kernel: threads a channel
constexpr int kDecThreads = kChannels * kDecLanes;
constexpr bool kExp2 = MAMBA_EXP2 != 0;
constexpr bool kLoads = MAMBA_CUT != 1;
constexpr bool kExp = MAMBA_CUT != 2;
constexpr bool kStores = MAMBA_CUT != 3;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMaxN % (4 * kLanes) == 0 && kMaxN % (4 * kDecLanes) == 0,
              "a lane's states are whole float4s");

// Bytes of one ring stage: dt [kTile][kChannels] fp32, B and C
// [kTile][2][kMaxN] fp32, x [kTile][kChannels] in x's dtype.
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kTile * kChannels * 4 + kTile * 2 * kMaxN * 4 +
         kTile * kChannels * (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int chunk_smem() {   // the ring and the parts
  return kStages * stage_bytes<T>() + kTile * kChannels * kLanes * 4;
}

// 4-byte copy global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// exp(dt * A) from v = dt * a: expf(v), or 2^v when a is A log2 e (kEx2).
template <bool kEx2>
__device__ __forceinline__ float step_exp(float v) {
  if (!kExp) return __fmul_rn(v, 0.5f);
  if (kEx2) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
  }
  return expf(v);
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

// One time step of a lane: its P states advanced in the reference's
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

// Rows [0, nt) of nch <= kChannels elements, row t at src + t * stride, into
// dst [kTile][kChannels]: 16-byte cp.async pieces when the rows are aligned
// (vec; the pieces past nch are zero-filled), else element copies.
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, long stride,
                                           int nt, int nch, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(E), kRow = kChannels / kVec;
    for (int i = threadIdx.x; i < nt * kRow; i += kThreads) {
      const int t = i / kRow, c = (i % kRow) * kVec;
      const int bytes = max(0, min(kVec, nch - c)) * (int)sizeof(E);
      mma::cp_async16(dst + t * kChannels + c,
                      src + t * stride + (bytes ? c : 0), bytes);
    }
  } else {
    for (int i = threadIdx.x; i < nt * kChannels; i += kThreads) {
      const int t = i / kChannels, c = i % kChannels;
      if (c < nch) dst[t * kChannels + c] = src[t * stride + c];
    }
  }
}

// Sixteen bytes of y in x's dtype from 16 / sizeof(T) floats.
__device__ __forceinline__ uint4 pack16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint4 pack16(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// Slot of channel c's lane parts in a tile row of the parts buffer: the
// channels of each 16-byte piece of y (kVec of them) are permuted by the
// piece's index, so that the pieces' reads of a quarter warp do not meet
// in a bank (nor do the lanes' writes of a warp).
template <int kVec>
__device__ __forceinline__ int part_slot(int c) {
  return c ^ ((c / kVec) % kVec);
}

// Two blocks an SM, as at jamba's width. Naming the count keeps ptxas from
// trading registers for more resident blocks (without it, it cut the bf16
// kernel to 80 registers and spilled).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
mamba_scan_chunk_kernel(const T* __restrict__ x, long xsb, long xss,
                        const float* __restrict__ dt, long dsb, long dss,
                        const float* __restrict__ Bc, long bsb, long bss,
                        const float* __restrict__ Cc, long csb, long css,
                        const float* __restrict__ A,
                        const float* __restrict__ Dp, float* h, long hb,
                        const int* __restrict__ rows, T* __restrict__ y,
                        int S, int d, int n, int vec_io, int vec_state) {
  constexpr int P = kMaxN / kLanes;
  constexpr int kStage = stage_bytes<T>();
  constexpr int kVec = 16 / sizeof(T), kRow = kChannels / kVec;
  static_assert(kThreads % kRow == 0, "a thread's y pieces share channels");
  extern __shared__ __align__(16) unsigned char smem[];
  float* part_s = reinterpret_cast<float*>(smem + kStages * kStage);
  const int b = blockIdx.y;
  const int ch0 = blockIdx.x * kChannels;
  const int nch = min(kChannels, d - ch0);
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int j0 = lane * P;
  const bool live = c < nch;
  const int ch = live ? ch0 + c : ch0;        // dead lanes read channel ch0
  const long r = rows ? rows[b] : b;
  const T* xb = x + b * xsb + ch0;
  const float* db = dt + b * dsb + ch0;
  const float* bb = Bc + b * bsb;
  const float* cb = Cc + b * csb;
  const int n_tiles = (S + kTile - 1) / kTile;
  // this thread's y pieces: channels g*kVec .. g*kVec + kVec-1 of the block
  const int g = threadIdx.x % kRow;
  T* yb = y + (long)b * S * d + ch0 + g * kVec;
  float dskip[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    dskip[v] = g * kVec + v < nch ? Dp[ch0 + g * kVec + v] : 0.f;

  auto load = [&](int k) {
    unsigned char* st = smem + (k % kStages) * kStage;
    float* dt_s = reinterpret_cast<float*>(st);
    float* bc_s = dt_s + kTile * kChannels;
    T* x_s = reinterpret_cast<T*>(bc_s + kTile * 2 * kMaxN);
    const int t0 = k * kTile, nt = min(kTile, S - t0);
    stage_rows(dt_s, db + t0 * dss, dss, nt, nch, vec_io);
    stage_rows(x_s, xb + t0 * xss, xss, nt, nch, vec_io);
    for (int i = threadIdx.x; i < nt * 2 * kMaxN; i += kThreads) {
      const int t = i / (2 * kMaxN), j = i % kMaxN;
      const float* src = i % (2 * kMaxN) < kMaxN ? bb + (t0 + t) * bss
                                                 : cb + (t0 + t) * css;
      cp_async4(bc_s + i, src + (j < n ? j : 0), j < n ? 4 : 0);
    }
  };
  // y of tile k: the lanes' parts summed in the xor-tree order, plus D*x
  auto store_y = [&](int k, const T* x_s) {
    const int nt = min(kTile, S - k * kTile);
    T* dst = yb + (long)k * kTile * d;
    for (int i = threadIdx.x; i < nt * kRow; i += kThreads) {
      const int t = i / kRow;
      float yv[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int cc = g * kVec + v;
        const float* p =
            part_s + (t * kChannels + part_slot<kVec>(cc)) * kLanes;
        float q[kLanes];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) q[l] = p[l];
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
          for (int l = 0; l < o; ++l) q[l] = q[l] + q[l ^ o];
        const float xv = paged::to_float(x_s[t * kChannels + cc]);
        yv[v] = __fadd_rn(q[0], __fmul_rn(dskip[v], xv));
      }
      if (vec_io) {
        if (g * kVec < nch)
          *reinterpret_cast<uint4*>(dst + (long)t * d) = pack16(yv);
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v)
          if (g * kVec + v < nch)
            dst[(long)t * d + v] = paged::from_float<T>(yv[v]);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_tiles && (kLoads || n < 0)) load(k);
    mma::cp_async_commit();
  }
  float hs[P], a[P];
  float* hp = h + r * hb + (long)ch * n + j0;
  load_state<P, kExp2>(hs, a, hp, A + (long)ch * n + j0, j0, n, vec_state);
  float* part_w = part_s + part_slot<kVec>(c) * kLanes + lane;

  for (int k = 0; k < n_tiles; ++k) {
    mma::cp_async_wait<kStages - 2>();
    // tile k has landed for every thread; tile k-1 is walked and its y
    // written, so its stage takes tile k + kStages-1
    __syncthreads();
    if (k + kStages - 1 < n_tiles && (kLoads || n < 0))
      load(k + kStages - 1);
    mma::cp_async_commit();

    const unsigned char* st = smem + (k % kStages) * kStage;
    const float* dt_s = reinterpret_cast<const float*>(st);
    const float* bc_s = dt_s + kTile * kChannels;
    const T* x_s = reinterpret_cast<const T*>(bc_s + kTile * 2 * kMaxN);
    const int nt = min(kTile, S - k * kTile);
    int t = 0;
    for (; t + kGroup <= nt; t += kGroup) {
      float dtt[kGroup], dtx[kGroup], bv[kGroup][P], cv[kGroup][P];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        dtt[u] = dt_s[(t + u) * kChannels + c];
        dtx[u] = __fmul_rn(dtt[u],
                           paged::to_float(x_s[(t + u) * kChannels + c]));
        load_row(bv[u], bc_s + (t + u) * 2 * kMaxN + j0);
        load_row(cv[u], bc_s + (t + u) * 2 * kMaxN + kMaxN + j0);
      }
      float part[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        part[u] = lane_step<P, kExp2>(hs, a, dtt[u], dtx[u], bv[u], cv[u]);
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        part_w[(t + u) * kChannels * kLanes] = part[u];
    }
    for (; t < nt; ++t) {
      const float dtt = dt_s[t * kChannels + c];
      float bv[P], cv[P];
      load_row(bv, bc_s + t * 2 * kMaxN + j0);
      load_row(cv, bc_s + t * 2 * kMaxN + kMaxN + j0);
      part_w[t * kChannels * kLanes] = lane_step<P, kExp2>(
          hs, a, dtt,
          __fmul_rn(dtt, paged::to_float(x_s[t * kChannels + c])), bv, cv);
    }
    __syncthreads();          // every lane's part of tile k is in part_s
    if (kStores || n < 0) store_y(k, x_s);
  }
  if (live && (kStores || n < 0)) store_state(hp, hs, j0, n, vec_state);
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
  const int c = blockIdx.x * kChannels + threadIdx.x / kDecLanes;
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

template <typename T>
int launch(const void* x, long xsb, long xss, const float* dt, long dsb,
           long dss, const float* Bc, long bsb, long bss, const float* Cc,
           long csb, long css, const float* A, const float* D, float* h,
           long hb, const int* rows, void* y, int B, int S, int d, int n,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || d == 0) return 0;
  const long elt = sizeof(T);
  // float4 state slices: rows of 16 states on 16-byte boundaries
  const int vec_state =
      n == kMaxN && aligned16(h) && aligned16(A) && hb % 4 == 0;
  const dim3 grid((d + kChannels - 1) / kChannels, B);
  const T* xt = reinterpret_cast<const T*>(x);
  T* yt = reinterpret_cast<T*>(y);
  if (S == 1) {
    mamba_scan_decode_kernel<T><<<grid, kDecThreads, 0, stream>>>(
        xt, xsb, dt, dsb, Bc, bsb, Cc, csb, A, D, h, hb, rows, yt, d, n,
        vec_state);
    return (int)cudaGetLastError();
  }
  // 16-byte pieces of x, dt and y: every row start on a 16-byte boundary
  const int vec_io = aligned16(x) && (xsb * elt) % 16 == 0 &&
                     (xss * elt) % 16 == 0 && aligned16(dt) &&
                     (dsb * 4) % 16 == 0 && (dss * 4) % 16 == 0 &&
                     aligned16(y) && (d * elt) % 16 == 0;
  constexpr int smem = chunk_smem<T>();
  const cudaError_t err =
      paged::reserve_smem(mamba_scan_chunk_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  mamba_scan_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      xt, xsb, xss, dt, dsb, dss, Bc, bsb, bss, Cc, csb, css, A, D, h, hb,
      rows, yt, S, d, n, vec_io, vec_state);
  return (int)cudaGetLastError();
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

const char* mamba_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
