// Hopper building blocks of the implicit-GEMM convolutions, shared by
// conv3d.cu (K6, 3x3x3) and conv3x3.cu (K7, 3x3), by K1's epilogue and
// K5's staged box (fuse_warp.cu) and by K3's staged map (msda.cu, one
// 1-D bulk copy): TMA tile loads into a ring of shared-memory stages
// guarded by full / empty mbarriers, wgmma m64n{64,80,128,160,256}k16
// products on K-major bf16 tiles in the 128-byte swizzle, the masked
// channels-last epilogue, the ordered split-K sum and the tensor-map
// encoding (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint,
// so no library needs -lcuda).
//
// The ring: kStages stages, each an A tile of WGM * 64 rows and a B tile
// of BN rows, 128 bytes (64 bf16 of K) a row.  One producer thread waits
// for a stage to be empty, arms its full barrier with the stage's bytes
// and issues the stage's TMA loads; WGM consumer warpgroups wait for it
// to be full, run four k16 products on it with one group in flight, and
// hand the previous stage back (one arrival per consumer warp).

#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoding function is
                   // looked up at run time (cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kStages = 4;  // ring depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait that outlasts ~10^10 cycles traps (a launch error) instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 10000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// One contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), the tile base
// 1024-aligned; a k16 slice starts 32 bytes further.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the async
// products
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D (64 x N, f32) += A (64 x 16) * B (16 x N), A and B bf16 from shared
// memory (K-major), scale-d 1.  N = 80 and 160 are K1's (C and F).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n80(float (&d)[40], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
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
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n160(float (&d)[80], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_bn<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  wgmma_n64(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_bn<80>(float (&d)[40], uint64_t da,
                                             uint64_t db) {
  wgmma_n80(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_bn<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  wgmma_n128(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_bn<160>(float (&d)[80], uint64_t da,
                                              uint64_t db) {
  wgmma_n160(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_bn<256>(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  wgmma_n256(d, da, db);
}

// The ring of WGM consumer warpgroups (BM = 64 * WGM rows) and BN-wide B
// tiles: stage s at base + s * kStage (A, then B at + kA), then the full
// and the empty barriers, 8 bytes each.
template <int WGM, int BN>
struct Ring {
  static constexpr uint32_t kA = WGM * 64 * 128, kB = BN * 128;
  static constexpr uint32_t kStage = kA + kB;
  static constexpr int kThreads = WGM * 128 + 32;  // + one producer warp
  // the ring, 1024 bytes of alignment slack, the barriers
  static constexpr int kSmem = kStages * kStage + 1024 + 2 * kStages * 8;

  // The ring's 1024-aligned base in dynamic shared memory, its barriers
  // initialised (every thread of the block calls this once).
  static __device__ __forceinline__ uint32_t init(uint8_t* smem_raw) {
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(base, s), 1);
        mbar_init(empty(base, s), WGM * 4);  // one arrival per consumer warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    return base;
  }
  static __device__ __forceinline__ uint32_t full(uint32_t base, int s) {
    return base + kStages * kStage + 8 * s;
  }
  static __device__ __forceinline__ uint32_t empty(uint32_t base, int s) {
    return base + kStages * kStage + 8 * (kStages + s);
  }

  // Producer, K step `it`: wait for its stage to be empty and arm the
  // stage's full barrier (`bar`) for the `bytes` its loads bring -- TMA
  // counts a whole box, its zero fill included; an A box may fill fewer
  // than the tile's rows.  Returns the stage's A tile; the B tile is kA
  // further.
  static __device__ __forceinline__ uint32_t acquire(uint32_t base, int it,
                                                     uint32_t bytes,
                                                     uint32_t& bar) {
    const int s = it % kStages;
    if (it >= kStages) mbar_wait(empty(base, s), (it / kStages - 1) & 1);
    bar = full(base, s);
    mbar_expect_tx(bar, bytes);
    return base + s * kStage;
  }

  // Consumers: acc = the sum over the niter K steps of A (this
  // warpgroup's 64 rows) times B, four k16 products per step, one group
  // of products in flight; each stage goes back to the producer once the
  // next step's products are issued.
  static __device__ __forceinline__ void consume(float (&acc)[BN / 2],
                                                 uint32_t base, int niter) {
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    for (int it = 0; it < niter; ++it) {
      const int s = it % kStages;
      mbar_wait(full(base, s), (it / kStages) & 1);
      const uint32_t a = base + s * kStage + wg * 64 * 128;
      const uint32_t bt = base + s * kStage + kA;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_bn<BN>(acc, sw128_desc(a + 32 * k), sw128_desc(bt + 32 * k));
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with their
                        // stage: hand it back to the producer
      if (it > 0 && lane == 0)
        mbar_arrive(empty(base, (it - 1) % kStages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
  }
};

// Epilogue: this thread's accumulators -- rows m and m + 8 of its warp's
// 16, two adjacent channels of each 8-channel column block -- to
// channels-last output rows.  row(m) is the output row of tile row m, or
// -1 where masked (ragged edge, padding rows).  Channels >= Cout are
// masked (Cout % 16 == 0).  S == 1: bf16 into out (rows, Cout); else f32
// into split `split` of the partials out (S, rows, Cout).
template <int BN, typename RowFn>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           int co0, int Cout, int S,
                                           int split, int64_t rows,
                                           void* out, RowFn row) {
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r = row(wg * 64 + wq * 16 + lane / 4 + 8 * h);
    if (r < 0) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (co0 + j * 8 >= Cout) continue;
      const int co = co0 + j * 8 + (lane % 4) * 2;
      const float v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
      if (S == 1)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                           r * Cout + co) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                   (split * rows + r) * Cout + co) =
            make_float2(v0, v1);
    }
  }
}

// y = bf16(sum over s of the S partials, s = 0, 1, ... in order); n % 4 == 0
__global__ void split_sum(const float* __restrict__ ws, bf16* __restrict__ y,
                          int64_t n, int S) {
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < S; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws + s * n + i);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  __nv_bfloat162 q[2] = {__floats2bfloat162_rn(a.x, a.y),
                         __floats2bfloat162_rn(a.z, a.w)};
  *reinterpret_cast<uint2*>(y + i) = *reinterpret_cast<uint2*>(q);
}

int launch_split_sum(const void* ws, void* y, int64_t n, int S,
                     cudaStream_t stream) {
  split_sum<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(y), n, S);
  return (int)cudaGetLastError();
}

// Let `kernel` take `bytes` of dynamic shared memory on the current
// device, once per device: `done` is the caller's own mask of devices
// (a static of each kernel instantiation's launch function).
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && (done >> dev & 1)) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) done |= (uint64_t)1 << dev;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A tensor of `rank` dims (innermost first), dense, of bf16 in the
// 128-byte swizzle unless told otherwise (K5 reads f32 or bf16 boxes
// unswizzled); TMA fills what a box reads outside it with zeros.
int encode(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint32_t* box,
           CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
           CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  cuuint64_t strides[4];
  cuuint64_t s = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(m, type, rank, const_cast<void*>(ptr), dims, strides,
                        box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;  // 1000 + CUresult
}

}  // namespace
