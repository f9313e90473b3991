// Mamba-1 selective scan with a carried state, for Hopper (sm_90a). Serves
// every Mamba call of the slot engine (models/ssm.py mamba_mix): prompt
// chunks of any length S >= 1 and decode steps (S = 1).
//
// Replaces the TPU kernel mamba_scan (src/repro/kernels/mamba_scan/kernel.py,
// _kernel), and reads and writes the state it keeps in VMEM scratch. Per
// (batch row b, channel c), with the state h [n] carried in from state row
// rows[b] (b when rows is null):
//   h_t = exp(dt_t * A_c) * h_{t-1} + (dt_t * x_t) * B_t
//   y_t = h_t . C_t + D_c * x_t          (fp32, stored in x's dtype)
// and the final h goes back to the same state row, in place. The products
// are rounded one by one (no FMA contraction) in the reference's order, so
// that the state follows the plain version's arithmetic.
//
// Bound on the H100: bytes at prompt lengths (x, dt, y once: about 8 bytes
// a (token, channel) in bf16 against 16 * 5 flops), and the sequential walk
// over time makes it latency-bound whenever too few blocks run. Channels
// are independent, so the design is the TPU kernel's: parallel over
// channels, sequential over time. One thread owns one (row, channel) and
// keeps its n <= 16 fp32 states and its row of A in registers for the
// whole walk; a block of kThreads channels of one row stages kTile time
// steps at a time in shared memory: x_t and dt_t with coalesced loads
// across the channels, B_t and C_t (shared by all channels of the row)
// once. y_t is stored coalesced across the channels; a ragged last tile is
// masked. What sets the time is the serial walk: a one-row chunk at
// d_inner 16384 is 512 warps, about four per SM, one per scheduler, so the
// latency of each step's dependent chain is exposed (issuing every load
// of a tile into registers first made it slower: 153 registers). In-place
// state writes are safe: each (row, channel) state is read and written by
// one thread only. Rows must be distinct.
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;   // channels per block, one thread each
constexpr int kMaxN = 16;       // state size a thread holds in registers
constexpr int kTile = 32;       // time steps staged per tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ x, long xsb, long xss,
                  const float* __restrict__ dt, long dsb, long dss,
                  const float* __restrict__ Bc, long bsb, long bss,
                  const float* __restrict__ Cc, long csb, long css,
                  const float* __restrict__ A, const float* __restrict__ Dp,
                  float* __restrict__ h, long hb,
                  const int* __restrict__ rows, T* __restrict__ y, int S,
                  int d, int n) {
  __shared__ float x_s[kTile][kThreads];
  __shared__ float dt_s[kTile][kThreads];
  __shared__ float b_s[kTile][kMaxN];
  __shared__ float c_s[kTile][kMaxN];
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int ch = blockIdx.x * kThreads + c;
  const bool live = ch < d;
  const long r = rows ? rows[b] : b;
  float* hrow = h + r * hb + (long)ch * n;

  float hs[kMaxN], a[kMaxN];
#pragma unroll
  for (int j = 0; j < kMaxN; ++j) {
    hs[j] = (live && j < n) ? hrow[j] : 0.f;
    a[j] = (live && j < n) ? A[(long)ch * n + j] : 0.f;
  }
  const float dskip = live ? Dp[ch] : 0.f;
  const T* xb = x + b * xsb + ch;
  const float* db = dt + b * dsb + ch;
  const float* bb = Bc + b * bsb;
  const float* cb = Cc + b * csb;
  T* yb = y + (long)b * S * d + ch;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int nt = min(kTile, S - t0);
    __syncthreads();   // the previous tile is consumed
    if (live) {
      for (int t = 0; t < nt; ++t) {
        x_s[t][c] = paged::to_float(xb[(long)(t0 + t) * xss]);
        dt_s[t][c] = db[(long)(t0 + t) * dss];
      }
    }
    for (int i = c; i < nt * n; i += kThreads) {
      const int t = i / n, j = i % n;
      b_s[t][j] = bb[(long)(t0 + t) * bss + j];
      c_s[t][j] = cb[(long)(t0 + t) * css + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < nt; ++t) {
      const float xt = x_s[t][c], dtt = dt_s[t][c];
      const float dtx = __fmul_rn(dtt, xt);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxN; ++j) {
        if (j < n) {
          const float da = expf(__fmul_rn(dtt, a[j]));
          hs[j] = __fadd_rn(__fmul_rn(da, hs[j]), __fmul_rn(dtx, b_s[t][j]));
          acc = fmaf(hs[j], c_s[t][j], acc);
        }
      }
      yb[(long)(t0 + t) * d] =
          paged::from_float<T>(__fadd_rn(acc, __fmul_rn(dskip, xt)));
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxN; ++j)
      if (j < n) hrow[j] = hs[j];
  }
}

template <typename T>
int launch(const void* x, long xsb, long xss, const float* dt, long dsb,
           long dss, const float* Bc, long bsb, long bss, const float* Cc,
           long csb, long css, const float* A, const float* D, float* h,
           long hb, const int* rows, void* y, int B, int S, int d, int n,
           cudaStream_t stream) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || d == 0) return 0;
  mamba_scan_kernel<T><<<dim3((d + kThreads - 1) / kThreads, B), kThreads,
                         0, stream>>>(
      reinterpret_cast<const T*>(x), xsb, xss, dt, dsb, dss, Bc, bsb, bss, Cc,
      csb, css, A, D, h, hb, rows, reinterpret_cast<T*>(y), S, d, n);
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
// is allocated by the caller. Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue when n is not in 1..16.
// Allocates nothing and does not synchronise: the launch goes on `stream`.
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
