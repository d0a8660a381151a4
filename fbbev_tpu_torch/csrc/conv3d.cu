// 3x3x3 stride-1 zero-padded ("SAME") 3D convolution, channels-last, f32
// accumulation, output in the input type.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_conv3d.py:130 conv3d_3x3x3
// (_kernel :77, pl.pallas_call :157), which DMAs a (TY+2, TX+2, Z, Cin)
// halo slab into VMEM, builds the z-banded im2col (Z, 3*Cin) with sublane
// shifts and multiplies it by the (3*Cin, Cout) weights of each (dy, dx)
// tap on the MXU.
//
//   y[b, oy, ox, oz, co] = sum_{dy, dx, dz, ci} x[b, oy+dy-1, ox+dx-1,
//                                                 oz+dz-1, ci]
//                                              * w[dy, dx, dz, ci, co]
//   x (B, Y, X, Z, Cin), y (B, Y, X, Z, Cout); zero outside the volume
//   (the z edges included).
//
// bf16: an implicit GEMM on Hopper's TMA and wgmma.  M = the output voxels
// of one (TY, TX, Z') box, Z' = Z rounded up to a power of two so that
// TY * TX * Z' = BM (64 or 128); N = BN (64, 128 or 256) output channels;
// K = 27 taps x Cin.  A K step is one tap and 64 input channels: its A
// tile is ONE 5-D TMA box (64 channels, Z', TX, TY, 1) of the
// channels-last input at (k0, dz-1, x0+dx-1, y0+dy-1, b).  TMA zero-fills
// what lies outside the tensor, negative coordinates included -- exactly
// the conv's zero padding, so there is no halo code; the rows z >= Z read
// as zeros and the epilogue drops them.  Its B tile is a TMA box (64, BN,
// 1) of the weights relaid out to (27, Cout, Cin), zero-filled past Cout.
// Both land as 128-byte rows in the 128-byte swizzle that wgmma reads
// K-major.  A ring of kStages stages (A and B each) with full / empty
// mbarriers: one producer thread keeps the TMA loads in flight, BM / 64
// consumer warpgroups run wgmma m64nBNk16 (f32 accumulators in
// registers), one group of four k16 products in flight.  The epilogue
// rounds to bf16 once and stores channels-last, masking the ragged x / y
// edge, z >= Z and channels >= Cout.  Small volumes split K over S = 3 or
// 9 tap ranges (one dy, or one (dy, dx)): each writes f32 partials, and a
// second pass sums them in a fixed order and casts (no atomics: the same
// sum every run).  The tile plan (Z', TY, TX, BM, BN, S) is computed by
// the wrapper (ops/pallas_conv3d.py::plan_bf16) and passed in as ints.
// The tensor maps are encoded here with cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint, so the library needs no -lcuda.
// f32: a plain CUDA-core kernel, one thread per output voxel and four
// output channels (no TF32: f32 stays f32), for the checks.
//
// Bound: operations -- 2 * voxels * 27 * Cin * Cout on the bf16 tensor
// cores (595 GFLOP over the flagship's 16 convs); the bytes (input and
// output once, weights once) sit below that.  What the design does about
// it: every product on wgmma from swizzled shared memory, loads by TMA off
// the consumers' instruction stream, tiles up to 128 x 256 (each K step
// reloads both tiles from L2, so wide tiles move fewer bytes per
// product), split K where the volume is too small for the card.
//
// Requirements (checked by the wrapper and here): bf16 Cin % 64 == 0, f32
// Cin % 16 == 0; Cout % 16 == 0; 1 <= Z <= 32.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoding function is
                   // looked up at run time (cudaGetDriverEntryPoint)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;  // f32 kernel
constexpr int kStages = 4;     // bf16 ring depth

struct Args {
  const void* x;  // (B, Y, X, Z, Cin)
  const void* w;  // f32: (3, 3, 3, Cin, Cout)
  void* y;        // (B, Y, X, Z, Cout)
  int B, Y, X, Z, Cin, Cout;
};

// The bf16 kernel's tile plan.  Block (blockIdx.x, blockIdx.y, blockIdx.z)
// = (M tile ty_i * tiles_x + tx_i, N tile, b * S + split).
struct Plan {
  int B, Y, X, Z, Cin, Cout;
  int Zp, TY, TX, S, tiles_x;
  void* out;  // S == 1: y bf16 (B, Y, X, Z, Cout); else f32 partials
              // (S, B, Y, X, Z, Cout)
};

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
// memory (K-major), scale-d 1.
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
__device__ __forceinline__ void wgmma_bn<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  wgmma_n128(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_bn<256>(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  wgmma_n256(d, da, db);
}

template <int WGM, int BN>
constexpr int smem_bytes() {
  return kStages * (WGM * 64 + BN) * 128 + 1024 + 2 * kStages * 8;
}

// WGM consumer warpgroups (BM = 64 * WGM rows), then one producer warp.
template <int WGM, int BN>
__global__ void __launch_bounds__(WGM * 128 + 32, WGM* BN >= 256 ? 1 : 2)
    conv3d_wgmma(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const Plan p) {
  constexpr uint32_t kA = WGM * 64 * 128, kB = BN * 128, kStage = kA + kB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * kStage;  // full[s]: + 8 s
  const uint32_t empty = full + 8 * kStages;      // empty[s]: + 8 s
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WGM * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int y0 = (blockIdx.x / p.tiles_x) * p.TY;
  const int x0 = (blockIdx.x % p.tiles_x) * p.TX;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z / p.S, split = blockIdx.z % p.S;
  const int kc = p.Cin / 64, taps = 27 / p.S, tap0 = split * taps;
  const int niter = taps * kc;

  if (tid >= WGM * 128) {  // producer warp: one thread issues the loads
    if (tid == WGM * 128) {
      for (int it = 0; it < niter; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const int tap = tap0 + it / kc, k0 = (it % kc) * 64;
        const int dy = tap / 9, dx = (tap / 3) % 3, dz = tap % 3;
        const uint32_t a = base + s * kStage;
        mbar_expect_tx(full + 8 * s, kStage);
        tma_load_5d(a, &xmap, full + 8 * s, k0, dz - 1, x0 + dx - 1,
                    y0 + dy - 1, b);
        tma_load_3d(a + kA, &wmap, full + 8 * s, k0, co0, tap);
      }
    }
    return;
  }

  const int wg = tid / 128, wq = (tid % 128) / 32, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
  for (int it = 0; it < niter; ++it) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    const uint32_t a = base + s * kStage + wg * 64 * 128;
    const uint32_t bt = base + s * kStage + kA;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_bn<BN>(acc, sw128_desc(a + 32 * k), sw128_desc(bt + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their
                      // stage: hand it back to the producer
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);

  // epilogue: thread holds rows m and m + 8 of its warp's 16, two
  // adjacent channels of each 8-channel column block
  const int64_t nvox = (int64_t)p.B * p.Y * p.X * p.Z;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = wg * 64 + wq * 16 + lane / 4 + 8 * h;
    const int z = m % p.Zp, tx = (m / p.Zp) % p.TX, ty = m / (p.Zp * p.TX);
    const int oy = y0 + ty, ox = x0 + tx;
    if (z >= p.Z || ox >= p.X || oy >= p.Y) continue;
    const int64_t vox = (((int64_t)b * p.Y + oy) * p.X + ox) * p.Z + z;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (co0 + j * 8 >= p.Cout) continue;  // Cout % 16 == 0
      const int co = co0 + j * 8 + (lane % 4) * 2;
      const float v0 = acc[j * 4 + 2 * h], v1 = acc[j * 4 + 2 * h + 1];
      if (p.S == 1)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) +
                                           vox * p.Cout + co) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) +
                                   (split * nvox + vox) * p.Cout + co) =
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

// f32: one thread per (output voxel, 4 output channels); a block is 16
// channel groups x 16 voxels.
__global__ void __launch_bounds__(kThreads) conv3d_f32(Args a) {
  const int groups = a.Cout / 4;
  const int64_t nvox = (int64_t)a.B * a.Y * a.X * a.Z;
  const int cg = blockIdx.y * 16 + threadIdx.x % 16;
  const int64_t vox = (int64_t)blockIdx.x * 16 + threadIdx.x / 16;
  if (cg >= groups || vox >= nvox) return;
  const int oz = vox % a.Z, ox = (vox / a.Z) % a.X;
  const int oy = (vox / ((int64_t)a.Z * a.X)) % a.Y;
  const int64_t b = vox / ((int64_t)a.Z * a.X * a.Y);
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int tap = 0; tap < 27; ++tap) {
    const int iy = oy + tap / 9 - 1, ix = ox + (tap / 3) % 3 - 1;
    const int iz = oz + tap % 3 - 1;
    if (iy < 0 || iy >= a.Y || ix < 0 || ix >= a.X || iz < 0 || iz >= a.Z)
      continue;
    const float* xr = x + (((b * a.Y + iy) * a.X + ix) * a.Z + iz) * a.Cin;
    const float* wr = w + (int64_t)tap * a.Cin * a.Cout + cg * 4;
    for (int ci = 0; ci < a.Cin; ++ci) {
      const float xv = xr[ci];
      const float4 w4 =
          *reinterpret_cast<const float4*>(wr + (int64_t)ci * a.Cout);
      acc[0] += xv * w4.x;
      acc[1] += xv * w4.y;
      acc[2] += xv * w4.z;
      acc[3] += xv * w4.w;
    }
  }
  *reinterpret_cast<float4*>(static_cast<float*>(a.y) + vox * a.Cout +
                             cg * 4) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
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

// A 2-byte tensor of `rank` dims (innermost first), dense, 128-byte swizzle.
int encode(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  cuuint64_t strides[4];
  cuuint64_t s = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;  // 1000 + CUresult
}

template <int WGM, int BN>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const Plan& p,
                 int tiles_y, cudaStream_t stream) {
  constexpr int smem = smem_bytes<WGM, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_wgmma<WGM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_y * p.tiles_x, (p.Cout + BN - 1) / BN, p.B * p.S);
  conv3d_wgmma<WGM, BN><<<grid, WGM * 128 + 32, smem, stream>>>(xm, wm, p);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: x (B, Y, X, Z, Cin), w (27, Cin, Cout), y (B, Y, X, Z, Cout).
extern "C" int fbbev_conv3d_f32(const void* x, const void* w, void* y, int B,
                                int Y, int X, int Z, int Cin, int Cout,
                                void* stream) {
  if (Cin % 16 || Cout % 16 || Z < 1 || Z > 32 || B < 0 || Y < 0 || X < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Y == 0 || X == 0 || Cout == 0) return 0;
  const Args a{x, w, y, B, Y, X, Z, Cin, Cout};
  const int64_t nvox = (int64_t)B * Y * X * Z;
  const dim3 grid((unsigned)((nvox + 15) / 16), (Cout / 4 + 15) / 16);
  conv3d_f32<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16: x (B, Y, X, Z, Cin), w (27, Cout, Cin), y (B, Y, X, Z, Cout); ws
// f32 (S, B, Y, X, Z, Cout) when S > 1 (unused otherwise).  The plan: Zp
// (power of two >= Z), TY, TX with TY * TX * Zp = BM in {64, 128}, BN in
// {64, 128, 256} (256 with BM 128 only), S in {1, 3, 9}.
extern "C" int fbbev_conv3d_bf16(const void* x, const void* w, void* y,
                                 void* ws, int B, int Y, int X, int Z,
                                 int Cin, int Cout, int Zp, int TY, int TX,
                                 int BM, int BN, int S, void* stream) {
  if (Cin % 64 || Cout % 16 || Z < 1 || Z > 32 || Zp < Z || Zp > 32 ||
      (Zp & (Zp - 1)) || TY < 1 || TX < 1 || TY * TX * Zp != BM ||
      (BM != 64 && BM != 128) || (BN != 64 && BN != 128 && BN != 256) ||
      (S != 1 && S != 3 && S != 9) || B < 0 || Y < 0 || X < 0 ||
      (S > 1 && ws == nullptr) ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y | (uintptr_t)ws) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Y == 0 || X == 0 || Cout == 0) return 0;
  CUtensorMap xm, wm;
  const cuuint64_t xd[5] = {(cuuint64_t)Cin, (cuuint64_t)Z, (cuuint64_t)X,
                            (cuuint64_t)Y, (cuuint64_t)B};
  const cuuint32_t xb[5] = {64, (cuuint32_t)Zp, (cuuint32_t)TX,
                            (cuuint32_t)TY, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 27};
  const cuuint32_t wb[3] = {64, (cuuint32_t)BN, 1};
  int r = encode(&xm, x, 5, xd, xb);
  if (r == 0) r = encode(&wm, w, 3, wd, wb);
  if (r != 0) return r;
  const int tiles_y = (Y + TY - 1) / TY;
  const Plan p{B, Y, X, Z, Cin, Cout, Zp, TY, TX, S, (X + TX - 1) / TX,
               S == 1 ? y : ws};
  cudaStream_t st = (cudaStream_t)stream;
  if (BM == 128)
    r = BN == 256   ? launch_wgmma<2, 256>(xm, wm, p, tiles_y, st)
        : BN == 128 ? launch_wgmma<2, 128>(xm, wm, p, tiles_y, st)
                    : launch_wgmma<2, 64>(xm, wm, p, tiles_y, st);
  else if (BN == 256)
    return (int)cudaErrorInvalidValue;
  else
    r = BN == 128 ? launch_wgmma<1, 128>(xm, wm, p, tiles_y, st)
                  : launch_wgmma<1, 64>(xm, wm, p, tiles_y, st);
  if (r != 0 || S == 1) return r;
  const int64_t n = (int64_t)B * Y * X * Z * Cout;
  split_sum<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<bf16*>(y), n, S);
  return (int)cudaGetLastError();
}
