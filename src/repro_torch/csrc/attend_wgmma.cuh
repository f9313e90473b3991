// Hopper tile loop of the bf16 prefill attention kernels
// (paged_prefill_attention.cu: the fused-pool and split-pool prefill;
// chunked_prefill_attention.cu: a query chunk over a slot row, with
// split-K). The fp32 instantiations keep the scalar loop of
// paged_common.cuh.
//
// One block owns kRows = 128 query rows of one (batch row, kv head): row r =
// t*G + g (token t, grouped head g), so each K/V tile is read once for all G
// heads; rows past BR = nt*G are padding, zero queries that are never
// written. The block is three warpgroups (kThreads = 384):
//   - warpgroup 0, the producer: setmaxnreg lowers its registers to
//     kProducerRegs and one warp of it fills a ring of kStages K/V tiles in
//     shared memory with TMA (cp.async.bulk.tensor, 128-byte swizzle, the
//     layout wgmma's descriptors read), one box of [rows, 64 columns] per
//     swizzle atom; each stage has a full mbarrier (the producer's
//     arrive.expect_tx, the copies' complete_tx) and an empty one (one
//     arrival a consumer warp). The source decides where a tile's rows are:
//     PagedTiles, whole pages through the block table (the fused pool
//     [Hkv, P, 2, ps, D] or the split pools [Hkv, P, ps, D], each a 2-D
//     tensor map over its rows), or StridedTiles, rows [k0, k0 + KT) of an
//     operand read in place through its own strides (a 4-D tensor map);
//   - warpgroups 1 and 2, the consumers: setmaxnreg raises their registers
//     to kConsumerRegs; each owns 64 rows, loads its Q rows once (cp.async
//     into the same swizzled layout) and walks the tiles:
//       S_j = Q.K_j^T, one wgmma.mma_async m64nKTk16 per k-step of 16, both
//         operands from shared memory;
//       O += P_{j-1}.V_{j-1}, one m64nDVk16 per 16 keys, issued right after
//         S_j, P from registers (the m64nNk16 accumulator is the mma.sync
//         m16n8 layout repeated, so the S accumulator repacked to bf16
//         pairs is the A operand), V through a transposed (MN-major)
//         descriptor; tile j's softmax runs while P_{j-1}.V_{j-1} is on the
//         tensor cores, and the two warpgroups take turns to issue their
//         products (named barriers), so that one's softmax runs beside the
//         other's products;
//       s * scale, the softcap, then the length, causal and window masks
//         (finite -1e30, the reference's order), each row at its own
//         token's position; the fp32 online softmax, l summed from the
//         unrounded p, p rounded to bf16 for P.V.
//     On an H100 the softmax, not the products, sets the loop's time, so
//     each of its optional steps (softcap, masks) is one warp-uniform
//     branch around its own loop over the tile's scores: with the tests
//     inside the unrolled loop every score paid a branch, and llama3.2-3b's
//     512-token chunk at offset 3584 took 0.100 ms of device time against
//     0.062 (NVIDIA H100 80GB HBM3, 700 W).
// Finally out = O / max(l, 1e-30) in bf16, or the fp32 partial state (O, m,
// l). An empty key range gives zeros, or (0, -1e30, 0). A row whose first
// tiles are all masked keeps m = -1e30 and takes exp(0) = 1 for those
// entries until a visible key's corr = exp(-1e30 - m) = 0 wipes them. Keys
// past the block's range inside its last tile are real rows (a clamped
// page, or the slot row past the range; past the operand's end TMA fills
// zeros) and are masked.
//
// Q and K rows are D wide, V rows, O and the output DV (DV <= D: MLA's
// values are 128 under keys of 192). A tile is KT = 128 keys (64 at DV 256,
// where O alone takes 128 registers a thread), and kStages as many as fit
// in 227 KB beside the Q tile (4 at D 64, 3 at D 128, 2 at MLA's pair and D
// 256).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <cstring>
#include <mutex>
#include <unordered_map>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kConsumers = 2;                    // consumer warpgroups
constexpr int kRows = 64 * kConsumers;           // query rows a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;               // 227 KB a block
constexpr int kAlign = 1024;                     // a 128-byte swizzle atom
constexpr int kBarrierBytes = 256;               // mbarriers and a flag

template <int D_, int DV_ = D_>
struct Geometry {
  static_assert(D_ % 64 == 0 && DV_ % 64 == 0 && DV_ <= D_ && D_ <= 256,
                "head dims are multiples of 64, values no wider than keys");
  static constexpr int D = D_;
  static constexpr int DV = DV_;
  static constexpr int KT = DV_ > 128 ? 64 : 128;   // keys a tile
  static constexpr int KD = D_ / 16;                // k-steps of Q.K^T
  static constexpr int Q_BYTES = kRows * D_ * 2;
  static constexpr int K_BYTES = KT * D_ * 2;
  static constexpr int STAGE = KT * (D_ + DV_) * 2;
  static constexpr int kFit =
      (kSmemLimit - kAlign - kBarrierBytes - Q_BYTES) / STAGE;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two stages fit beside the Q tile");
  static constexpr size_t kSmem =
      (size_t)kAlign + Q_BYTES + (size_t)kStages * STAGE + kBarrierBytes;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `parity` has completed. A wait that outlasts
// about ten seconds of SM clock traps (the launch fails) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory / are complete
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// the generic-proxy writes of this thread to shared memory, before an
// asynchronous-proxy read (wgmma, a TMA store)
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// 16-byte copy global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset `lbo` and stride byte offset 1024 (16-byte
// units), layout 1 (SWIZZLE_128B). K-major operands (Q, K) advance by 32
// bytes a k-step inside a swizzle atom, their 8-row groups 1024 bytes apart
// (the leading offset is not read). The MN-major V tile has its 8-key
// groups 1024 bytes apart and its 64-column atoms `lbo` apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr,
                                               uint32_t lbo = 1024) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of an accumulator across an
// asynchronous product's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A.B for one warpgroup, m64nNk16, bf16 operands, fp32 accumulators
// (N / 2 a thread, the m16n8 layout repeated over N / 8 column blocks):
// ss() takes A and B from shared memory (both K-major; scale_d 0 overwrites
// d), rs() A from registers (the m16n8k16 A fragments) and B MN-major
// (transposed) from shared memory.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Two floats rounded to bf16 (round to nearest even) in one register, the
// first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// K/V tile sources (the producer warp's copies)
// ---------------------------------------------------------------------------

// Whole pages through the block table: the block's table columns [col_lo,
// col_hi), KT / ps pages a tile. Page p of kv head h starts at pool row
// ((h*P + p) * mult + 0) * ps for K and ((h*P + p) * mult + v_off) * ps for
// V (the fused pool: one map, mult 2, v_off 1; split pools: a map each, mult
// 1, v_off 0). A column past col_hi loads the block's last page again: its
// keys lie past the range and are masked.
struct PagedTiles {
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  const int* bt_row;
  int head_page0, mult, v_off, ps, col_lo, col_hi;

  template <class Geo>
  __device__ __forceinline__ void load(uint32_t k_s, uint32_t v_s,
                                       uint32_t bar, int j, int lane) const {
    constexpr int A = Geo::D / 64;             // swizzle atoms a row
    const int ppt = Geo::KT / ps;              // pages a tile
    for (int i = lane; i < 2 * ppt * A; i += 32) {
      const bool is_v = i >= ppt * A;
      const int x = is_v ? i - ppt * A : i;
      const int pg = x / A, a = x % A;
      const int col = min(col_lo + j * ppt + pg, col_hi - 1);
      const int row =
          ((head_page0 + bt_row[col]) * mult + (is_v ? v_off : 0)) * ps;
      tma_load_2d((is_v ? v_s : k_s) + (a * Geo::KT + pg * ps) * 128,
                  is_v ? v_map : k_map, bar, a * 64, row);
    }
  }
};

// Rows [k0, k0 + KT) of K and V of (batch row b, kv head h), each read in
// place through a 4-D tensor map (columns, then the key, head and batch
// axes in the order of their strides: slot s of each of the three sits in
// bits 2s.. of *_slots as 1, 2 or 3). Rows past the operand's end are
// filled with zeros by the copy.
struct StridedTiles {
  const CUtensorMap* k_map;
  const CUtensorMap* v_map;
  int k_slots, v_slots, b, h, lo;

  __device__ __forceinline__ static int coord(int slots, int at, int key,
                                              int head, int batch) {
    return (slots & 3) == at ? key : ((slots >> 2) & 3) == at ? head : batch;
  }

  template <class Geo>
  __device__ __forceinline__ void load(uint32_t k_s, uint32_t v_s,
                                       uint32_t bar, int j, int lane) const {
    constexpr int AK = Geo::D / 64, AV = Geo::DV / 64;
    const int k0 = lo + j * Geo::KT;
    if (lane < AK + AV) {
      const bool is_v = lane >= AK;
      const int a = is_v ? lane - AK : lane;
      const int s = is_v ? v_slots : k_slots;
      tma_load_4d((is_v ? v_s : k_s) + a * Geo::KT * 128,
                  is_v ? v_map : k_map, bar, a * 64, coord(s, 1, k0, h, b),
                  coord(s, 2, k0, h, b), coord(s, 3, k0, h, b));
    }
  }
};

// ---------------------------------------------------------------------------
// The block
// ---------------------------------------------------------------------------

// The 1024-aligned start of the block's dynamic shared memory: [Q tile
// (D/64 atoms of kRows x 128 bytes)][kStages x (K tile (D/64 atoms of KT x
// 128 bytes), V tile (DV/64 atoms))][full[kStages], empty[kStages], flag].
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + (kAlign - smem_addr(raw) % kAlign) % kAlign;
}

template <class Geo>
__device__ __forceinline__ int* block_flag(unsigned char* base) {
  return reinterpret_cast<int*>(base + Geo::Q_BYTES +
                                Geo::kStages * Geo::STAGE +
                                16 * Geo::kStages);
}

// S = Q.K^T of one tile: for each k-step of 16, one m64nKTk16 product of
// this warpgroup's Q rows (qa) and the tile's K (k_s), both K-major in
// 128-byte-swizzled atoms of 64 columns.
template <class Geo>
__device__ __forceinline__ void issue_qk(float (&s)[Geo::KT / 2], uint32_t qa,
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < Geo::KD; ++kk)
    Wgmma<Geo::KT>::ss(
        s, sw128_desc(qa + (kk / 4) * (kRows * 128) + (kk % 4) * 32),
        sw128_desc(k_s + (kk / 4) * (Geo::KT * 128) + (kk % 4) * 32),
        kk > 0);
}

// O += P.V of one tile: for each 16 keys, one m64nDVk16 product of P's bf16
// fragments and the tile's V (v_s, MN-major, atoms of 64 columns KT*128
// bytes apart).
template <class Geo>
__device__ __forceinline__ void issue_pv(float (&o)[Geo::DV / 2],
                                         const uint32_t (&p)[Geo::KT / 16][4],
                                         uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < Geo::KT / 16; ++kk)
    Wgmma<Geo::DV>::rs(o, p[kk],
                       sw128_desc(v_s + kk * 16 * 128, Geo::KT * 128));
}

// What a thread's two rows see: each row's visible keys [lo, hi) (hi =
// min(key_hi, length), and kp <= its position if causal; lo its window's
// first key), the warp's first and last positions and the block's key
// limit (for the all-visible test), the thread's column pair tq, and the
// score transform (softcap > 0: softcap * tanh(s * scale / softcap), the
// division as a multiply by inv_softcap).
struct RowMask {
  int lo0, hi0, lo1, hi1, qp_lo, qp_hi, lim, window, tq;
  bool causal;
  float scale, softcap, inv_softcap;

  __device__ __forceinline__ RowMask(int qp0, int qp1, int qp_lo_, int qp_hi_,
                                     int lim_, int window_, int tq_,
                                     bool causal_, float scale_,
                                     float softcap_)
      : lo0(window_ > 0 ? qp0 - window_ + 1 : INT_MIN),
        hi0(causal_ ? min(lim_, qp0 + 1) : lim_),
        lo1(window_ > 0 ? qp1 - window_ + 1 : INT_MIN),
        hi1(causal_ ? min(lim_, qp1 + 1) : lim_),
        qp_lo(qp_lo_), qp_hi(qp_hi_), lim(lim_), window(window_), tq(tq_),
        causal(causal_), scale(scale_), softcap(softcap_),
        inv_softcap(softcap_ > 0.f ? 1.f / softcap_ : 0.f) {}
};

// Tile [k0, k0 + KT)'s scores -> s * scale, the softcap, the masks (a warp
// whose rows all see the whole tile skips them), then the online softmax:
// m and l updated, corr = exp(m_old - m_new), s = exp(s - m_new) unrounded.
// Each optional step is one warp-uniform branch around its own loop.
template <class Geo>
__device__ __forceinline__ void softmax_tile(float (&s)[Geo::KT / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             const RowMask& rm) {
  constexpr int KT = Geo::KT;
  if (rm.softcap > 0.f) {
#pragma unroll
    for (int x = 0; x < KT / 2; ++x)
      s[x] = rm.softcap * tanhf(s[x] * rm.scale * rm.inv_softcap);
  } else {
#pragma unroll
    for (int x = 0; x < KT / 2; ++x) s[x] *= rm.scale;
  }
  const bool all_visible =
      k0 + KT <= rm.lim && (!rm.causal || k0 + KT - 1 <= rm.qp_lo) &&
      (rm.window <= 0 || rm.qp_hi - k0 < rm.window);
  if (!all_visible) {
    const int kb = k0 + rm.tq * 2;
#pragma unroll
    for (int x = 0; x < KT / 2; ++x) {
      const int kp = kb + (x / 4) * 8 + (x & 1);
      const bool ok = (x & 2) ? (kp >= rm.lo1 && kp < rm.hi1)
                              : (kp >= rm.lo0 && kp < rm.hi0);
      s[x] = ok ? s[x] : kNegInf;
    }
  }
  // rows r0 (x % 4 in {0, 1}) and r0 + 8 ({2, 3}), over the quad
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int x = 0; x < KT / 2; x += 4) {
    mx[0] = fmaxf(mx[0], fmaxf(s[x], s[x + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[x + 2], s[x + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    corr[i] = __expf(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= corr[i];
  }
#pragma unroll
  for (int x = 0; x < KT / 2; ++x) {
    const float e = __expf(s[x] - mx[(x >> 1) & 1]);
    l[(x >> 1) & 1] += e;
    s[x] = e;
  }
}

// P's bf16 A fragments: k-step kk is keys [16kk, 16kk + 16), n-blocks 2kk
// and 2kk + 1 of S (rows r0 and r0 + 8, columns 2tq and 2tq + 8).
template <class Geo>
__device__ __forceinline__ void pack_p(uint32_t (&p)[Geo::KT / 16][4],
                                       const float (&s)[Geo::KT / 2]) {
#pragma unroll
  for (int kk = 0; kk < Geo::KT / 16; ++kk) {
    const float* a = &s[kk * 8];
    p[kk][0] = pack_bf16(a[0], a[1]);
    p[kk][1] = pack_bf16(a[2], a[3]);
    p[kk][2] = pack_bf16(a[4], a[5]);
    p[kk][3] = pack_bf16(a[6], a[7]);
  }
}

// A block's ring: tiles of [key_lo, key_hi), the barriers, the smem base.
template <class Geo>
struct Ring {
  uint32_t q_s, ring, full, empty;   // shared-window addresses
  int n_tiles, n_wg;                 // consumer warpgroups with live rows

  __device__ __forceinline__ Ring(unsigned char* base, int BR, int key_lo,
                                  int key_hi) {
    q_s = smem_addr(base);
    ring = q_s + Geo::Q_BYTES;
    full = ring + Geo::kStages * Geo::STAGE;   // full[S], then empty[S]
    empty = full + 8 * Geo::kStages;
    n_tiles = key_hi > key_lo ? (key_hi - key_lo + Geo::KT - 1) / Geo::KT : 0;
    n_wg = (BR + 63) / 64;
  }

  // Thread 0 sets up the barriers; every thread of the block then syncs.
  // Call before the roles part: the producer warpgroup (threads 0-127)
  // calls producer_regs() and produce() and exits; the consumers call
  // consumer_regs() before they compute anything they keep (a value live
  // across setmaxnreg is spilled), then consume(). The two paths never
  // rejoin, so that setmaxnreg holds.
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < Geo::kStages; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(empty + 8 * s, 4 * n_wg);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// The producer warpgroup (threads 0-127): its first warp copies tile j into
// stage j % S once the consumers have released the stage's previous tile.
template <class Geo, class Src>
__device__ __forceinline__ void produce(const Ring<Geo>& rg, const Src& src) {
  constexpr int S = Geo::kStages;
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  for (int j = 0; j < rg.n_tiles; ++j) {
    const int s = j % S;
    mbar_wait(rg.empty + 8 * s, ((j / S) & 1) ^ 1);
    if (lane == 0) mbar_expect_tx(rg.full + 8 * s, Geo::STAGE);
    __syncwarp();
    const uint32_t k_s = rg.ring + s * Geo::STAGE;
    src.template load<Geo>(k_s, k_s + Geo::K_BYTES, rg.full + 8 * s, j, lane);
  }
}

// The consumer warpgroups (threads 128-383): each with live rows attends
// its 64 rows over the ring's tiles. The
// block's query rows are r = t*G + g for r < BR. Query row r sits at
// q[t * q_tok + g * q_head], its output at out[t * o_tok + g * o_head] (m/l
// at t * ml_stride + g), its query position is q_pos0 + t. Key kp is
// visible when key_lo <= kp < key_hi, kp < length, kp <= qp if causal, and
// qp - kp < window if window > 0. With two live warpgroups they take turns
// to issue their products (named barriers 4 and 5: each waits on its own,
// then signals the other's), so that one's softmax runs beside the other's
// products. Returns once this warpgroup's rows are written; the caller may
// then sync the 256 consumer threads on named barrier 3.
template <class Geo>
__device__ __forceinline__ void consume(
    const Ring<Geo>& rg, const bf16* __restrict__ q, long q_tok, long q_head,
    void* __restrict__ out, long o_tok, long o_head, float* __restrict__ m_out,
    float* __restrict__ l_out, long ml_stride, int G, int BR, int q_pos0,
    int length, bool causal, int window, float scale, float softcap,
    int key_lo, int key_hi, bool partial) {
  constexpr int D = Geo::D;
  constexpr int KT = Geo::KT;
  constexpr int DV = Geo::DV;
  constexpr int S = Geo::kStages;
  const int c = threadIdx.x / 128 - 1;   // this consumer warpgroup
  if (c >= rg.n_wg) return;              // padding rows only: nothing to do
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int gq = lane / 4, tq = lane % 4;   // row group, thread in group
  const int n_tiles = rg.n_tiles;
  const uint32_t ring = rg.ring;

  // Q rows [64c, 64c + 64) -> shared memory, swizzled (chunk x of row r at
  // chunk x ^ (r % 8) of its 128-byte row), padding rows zero
  for (int i = t; i < 64 * (D / 8); i += 128) {
    const int r = 64 * c + i / (D / 8), ch = i % (D / 8);
    const bool live = r < BR;
    const bf16* p = live ? q + (r / G) * q_tok + (r % G) * q_head + ch * 8 : q;
    cp_async16(rg.q_s + (ch / 8) * (kRows * 128) + r * 128 +
                   (((ch % 8) ^ (r & 7)) << 4),
               p, live ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + c, 128);

  // this thread's rows: r0 and r0 + 8
  const int r0 = 64 * c + 16 * w + gq;
  const RowMask rm{q_pos0 + r0 / G, q_pos0 + (r0 + 8) / G,
                   q_pos0 + (64 * c + 16 * w) / G,        // the warp's first
                   q_pos0 + (64 * c + 16 * w + 15) / G,   // and last row
                   min(key_hi, length), window, tq, causal, scale, softcap};
  const uint32_t qa = rg.q_s + c * 64 * 128;
  // turns between two live warpgroups: warpgroup 0 goes first
  const bool turns = rg.n_wg == 2 && n_tiles > 0;
  if (turns && c == 1) named_arrive(4, 256);

  float o[DV / 2];
#pragma unroll
  for (int x = 0; x < DV / 2; ++x) o[x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float s[KT / 2];
  uint32_t p[KT / 16][4];

  if (n_tiles > 0) {
    // tile 0 alone (O is zero: nothing to rescale), then each tile j issues
    // S_j and P_{j-1}.V_{j-1} together and computes its softmax while the
    // second is on the tensor cores: no branch around a product in the loop
    mbar_wait(rg.full, 0);
    if (turns) named_sync(4 + c, 256);
    wgmma_fence();
    issue_qk<Geo>(s, qa, ring);
    wgmma_commit();
    if (turns) named_arrive(5 - c, 256);
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<Geo>(s, m, l, corr, key_lo, rm);
    pack_p<Geo>(p, s);
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % S;
      mbar_wait(rg.full + 8 * st, (j / S) & 1);
      if (turns) named_sync(4 + c, 256);
      wgmma_fence();
      issue_qk<Geo>(s, qa, ring + st * Geo::STAGE);
      wgmma_commit();
      issue_pv<Geo>(o, p, ring + ((j - 1) % S) * Geo::STAGE + Geo::K_BYTES);
      wgmma_commit();
      if (turns) named_arrive(5 - c, 256);
      wgmma_wait<1>();
      fence_regs(s);
      softmax_tile<Geo>(s, m, l, corr, key_lo + j * KT, rm);
      wgmma_wait<0>();   // P_{j-1}.V_{j-1} done: its stage goes back
      fence_regs(o);
      if (lane == 0) mbar_arrive(rg.empty + 8 * ((j - 1) % S));
#pragma unroll
      for (int x = 0; x < DV / 2; ++x) o[x] *= corr[(x >> 1) & 1];
      pack_p<Geo>(p, s);
    }
    // the last tile's P.V (warpgroup 1 signals no turn after its last one)
    if (turns) named_sync(4 + c, 256);
    wgmma_fence();
    issue_pv<Geo>(o, p,
                  ring + ((n_tiles - 1) % S) * Geo::STAGE + Geo::K_BYTES);
    wgmma_commit();
    if (turns && c == 0) named_arrive(5, 256);
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(rg.empty + 8 * ((n_tiles - 1) % S));
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = r0 + 8 * i;
    if (r >= BR) continue;          // padding row: never written
    const long at = (r / G) * o_tok + (r % G) * o_head;
    if (partial) {
      float* acc = reinterpret_cast<float*>(out) + at;
#pragma unroll
      for (int nb = 0; nb < DV / 8; ++nb)
        *reinterpret_cast<float2*>(acc + nb * 8 + tq * 2) =
            make_float2(o[nb * 4 + 2 * i], o[nb * 4 + 2 * i + 1]);
      if (tq == 0) {
        const long ml = (r / G) * ml_stride + r % G;
        m_out[ml] = m[i];
        l_out[ml] = li;
      }
    } else {
      const float d = fmaxf(li, 1e-30f);
      bf16* dst = reinterpret_cast<bf16*>(out) + at;
#pragma unroll
      for (int nb = 0; nb < DV / 8; ++nb)
        *reinterpret_cast<uint32_t*>(dst + nb * 8 + tq * 2) =
            pack_bf16(o[nb * 4 + 2 * i] / d, o[nb * 4 + 2 * i + 1] / d);
    }
  }
}

// info[0..3] = registers, local (spill) bytes, dynamic shared memory and
// resident blocks per SM of a kernel launched with `smem` bytes and
// `threads` threads a block.
template <typename Kernel>
inline int attributes(Kernel kernel, size_t smem, int* info,
                      int threads = kThreads) {
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

// ---------------------------------------------------------------------------
// Tensor maps (host)
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (libcuda), found through the runtime
// (cudaGetDriverEntryPointByVersion, so that the library links against
// nothing but the runtime); null where it is missing.
inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled map, keyed by what it encodes: bf16 with the 128-byte swizzle
// unless the key says otherwise (map_key's defaults).
struct MapKey {
  const void* ptr;
  int device, rank;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  CUtensorMapDataType dtype;
  CUtensorMapSwizzle swizzle;
  bool operator==(const MapKey& o) const {
    return std::memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&k);
    uint64_t h = 1469598103934665603ull;      // FNV-1a
    for (size_t i = 0; i < sizeof(MapKey); ++i) h = (h ^ b[i]) * 1099511628211ull;
    return (size_t)h;
  }
};

// The tensor map of `key`, encoded at its first use and cached in the
// library (the page pools and slot caches persist, so the serving paths
// encode each once); cudaErrorInvalidValue if the encoding is refused.
inline cudaError_t tensor_map(MapKey key, CUtensorMap* out) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  EncodeTiled encode = encoder();
  if (!encode) return cudaErrorInvalidValue;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap m;
  const CUresult res = encode(
      &m, key.dtype, (cuuint32_t)key.rank,
      const_cast<void*>(key.ptr), key.dims, key.strides, key.box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, key.swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, m);
  *out = m;
  return cudaSuccess;
}

inline MapKey map_key(const void* ptr, int rank) {
  MapKey k;
  std::memset(&k, 0, sizeof(k));   // padding bytes take part in the key
  k.ptr = ptr;
  k.rank = rank;
  k.dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  k.swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
  cudaGetDevice(&k.device);
  return k;
}

// A 2-D map over `rows` rows of `width` bf16 (contiguous), boxes of
// [box_rows, 64].
inline cudaError_t rows_map(const void* ptr, long rows, int width,
                            int box_rows, CUtensorMap* out) {
  MapKey k = map_key(ptr, 2);
  k.dims[0] = (cuuint64_t)width;
  k.dims[1] = (cuuint64_t)rows;
  k.strides[0] = (cuuint64_t)width * 2;
  k.box[0] = 64;
  k.box[1] = (cuuint32_t)box_rows;
  return tensor_map(k, out);
}

// A 4-D map over an operand [B, H, S, width] read through its element
// strides (b, h, s; unit last stride), boxes of [box_keys, 64] along the key
// axis: columns first, then the three axes in the order of their strides.
// *slots gets the position (1..3) of the key, head and batch axes in bits
// 0-1, 2-3 and 4-5.
inline cudaError_t strided_map(const void* ptr, int B, int H, int S,
                               int width, long sb, long sh, long ss,
                               int box_keys, CUtensorMap* out, int* slots) {
  struct Axis {
    long stride;
    int size, which;   // 0 key, 1 head, 2 batch
  } ax[3] = {{ss, S, 0}, {sh, H, 1}, {sb, B, 2}};
  std::stable_sort(ax, ax + 3, [](const Axis& a, const Axis& b) {
    return a.stride < b.stride;
  });
  MapKey k = map_key(ptr, 4);
  k.dims[0] = (cuuint64_t)width;
  k.box[0] = 64;
  *slots = 0;
  for (int i = 0; i < 3; ++i) {
    k.dims[i + 1] = (cuuint64_t)ax[i].size;
    k.strides[i] = (cuuint64_t)ax[i].stride * 2;
    k.box[i + 1] = ax[i].which == 0 ? (cuuint32_t)box_keys : 1;
    *slots |= (i + 1) << (2 * ax[i].which);
  }
  return tensor_map(k, out);
}

}  // namespace wg
