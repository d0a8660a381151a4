// The int8 convolution of the int8 serving path: quantize, s8 x s8 -> s32
// implicit GEMM on Hopper's tensor cores, dequantize.  Replaces no TPU
// kernel: the JAX package runs it as XLA convolutions with int32
// accumulation (fbbev_tpu/utils/quantize.py:382, :403, :429, :460).
// Wrapper, plain version, tile plan and the function's definition:
// fbbev_tpu_torch/ops/conv_s8.py.
//
// Three launches a conv, one entry (fbbev_conv_s8):
//   1. quantize_cl: the activation, read once through its strides (NCHW or
//      channels-last, 2D or 3D, f32 / bf16 / f16), quantized (x * m_x[c],
//      or x / s_x; round half to even; clamp to +-127) into an int8
//      channels-last workspace (N, D, H, W, Cp), Cp = C rounded up to 16
//      (TMA's 16-byte stride rule), zeros in the padding.  A block moves a
//      tile of 4096 values (16 to 64 channels) through shared memory,
//      reading along the input's fast axis, up to 8 values a load, and
//      writing 16-byte rows.  Bound: bytes.
//   2. conv_s8_wgmma<WGM, BN>: the implicit GEMM, M = output pixels, N =
//      output channels of a group, K = live taps x channels of the group,
//      launched as the quantize pass's programmatic dependent (its
//      prologue overlaps the pass; its loads wait for it).  An M tile is a
//      (TD, TY, TX) box of output pixels of one image (a 2D conv is a 3D
//      one with D = 1), or, for a 1x1 stride-1 unpadded conv, BM
//      consecutive pixels of the flattened map ("flat").  A K step is one
//      tap x BK channels: its A tile is ONE 5-D TMA box of the workspace at
//      the tap's shifted origin (strides by the map's elementStrides;
//      padding, the ragged edge and channels past Cp by TMA's zero fill,
//      exact since q(0) = 0), its B tile one TMA box of the packed weights
//      (G, taps, Npad, Cpad), K-major.  BK = 128, 64 or 32 channels land
//      in the 128-, 64- or 32-byte swizzle; a group of at most 16 channels
//      (the stem's C = 3 -> Cp = 16) takes BK = 16 unswizzled and two taps
//      a step (the two boxes side by side as the two K halves of one k32
//      product).  A block takes one tile: one producer thread keeps a
//      ring of `stages` stages (full / empty mbarriers) full, WGM consumer
//      warpgroups run wgmma.m64nBNk32.s32.s8.s8 with s32 accumulators in
//      registers, and the epilogue is staged in the ring once every
//      product is done (blocks an SM: as many as fit).  A tap
//      whose shifted box has no input pixel on the map is neither loaded
//      nor multiplied (exact: it only multiplies zeros); the live taps of
//      a tile are a product of per-axis masks, which producer and
//      consumers compute alike.  A grouped conv's box starts at its
//      group's channel offset; the packed weights are zero past Cg, so the
//      other group's channels add nothing.  Small M splits the live K
//      steps S ways into int32 partials (integer sums: any order gives the
//      same result).
//   3. s8_finish (S > 1 only): sums the partials and applies the epilogue.
// Epilogue: float(acc) * scale[o], + bias[o], cast to x's type, stored in
// x's memory format (16-byte stores along channels for channels-last y);
// built with --fmad=false these are the plain version's roundings, so the
// kernel equals it bit for bit (sums and outputs).  Bound: operations
// (int8 tensor cores, in-map products) for the large convs, bytes for the
// small.  The tile plan (box, BM, BN, BK, S, stages) is
// computed by the wrapper (ops/conv_s8.py::plan_s8) and passed as ints.

#include "tma_wgmma.cuh"

#include <cuda_fp16.h>

#include <type_traits>

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxTaps = 64;
// the epilogue's staging of a warpgroup's 64 x 64 int32 sums (rows of 68)
constexpr int kEpiPitch = 68;
constexpr uint32_t kEpiBytes = 64 * kEpiPitch * 4;
// dynamic shared memory a block may take (the static arrays take < 4 KB)
constexpr int kMaxDyn = 227 * 1024 - 4096;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// ------------------------------------------------------------ quantize pass

struct QArgs {
  const void* x;
  const float* mx;  // per-channel multiplier (C,), or null
  const float* sx;  // per-tensor scale (), when mx is null
  int8_t* xq;       // (N, D, H, W, Cp)
  int C, Cp, D, H, W;
  long long P;  // N * D * H * W
  long long xs_n, xs_c, xs_d, xs_h, xs_w;
  int qc;  // channels of a tile: 16, 32 or 64 (pixels: 4096 / qc)
};

constexpr int QT = 4096;  // elements of a tile

// V consecutive elements of x (V * sizeof(T)-byte aligned) as floats.
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    f[i] = a.x;
    f[i + 1] = a.y;
    f[i + 2] = a.z;
    f[i + 3] = a.w;
  }
}
template <int V, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&f)[V]) {
  typedef typename std::conditional<V == 8, uint4, uint2>::type Vec;
  const Vec u = *reinterpret_cast<const Vec*>(p);
  const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_float(h[i]);
}

// x[c] quantized: x * m_x[c] or x / s_x, rounded half to even, +-127.
__device__ __forceinline__ int8_t quant(float f, const float* mx, int c,
                                        float sx) {
  const float s = mx ? f * mx[c] : __fdiv_rn(f, sx);
  return (int8_t)max(-127, min(127, __float2int_rn(s)));
}

// A tile of QT / qc pixels x qc channels: read along x's fast axis
// (channels for channels-last x, pixels otherwise), V elements a load
// (V = 8 or 4: one 16-, 8- or 32-byte load; V = 1: all of a thread's
// loads issued before their values are used), quantized into shared
// memory, written as 16-byte pieces of (pixel, channel) rows.
template <typename T, int V>
__global__ void __launch_bounds__(256) quantize_cl(QArgs a) {
  // the conv's GEMM, launched after this pass as its programmatic
  // dependent, may be scheduled once every block here has started: its
  // prologue overlaps this pass, its loads wait for it (griddepcontrol)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __shared__ long long pix[QT / 16];
  __shared__ __align__(16) int8_t q[QT + (QT / 16) * 16];
  const int QC = a.qc, QP = QT / QC, pitch = QC + 16;
  const long long p0 = (long long)blockIdx.x * QP;
  const int c0 = blockIdx.y * QC;
  for (int i = threadIdx.x; i < QP; i += 256) {
    const long long p = p0 + i;
    long long off = -1;
    if (p < a.P) {
      long long t = p;
      const int w = t % a.W;
      t /= a.W;
      const int h = t % a.H;
      t /= a.H;
      const int d = t % a.D;
      off = (t / a.D) * a.xs_n + d * a.xs_d + h * a.xs_h + w * a.xs_w;
    }
    pix[i] = off;
  }
  __syncthreads();
  // x is the previous kernel's output (launch_dependent)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const float sx = a.mx ? 0.f : *a.sx;
  const bool cfast = a.xs_c == 1;  // channels-last: along channels
  constexpr int L = QT / V / 256;  // loads a thread
  float f[L][V];
  bool in[L];
  int pis[L], cis[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int e = threadIdx.x + i * 256;
    int pi, ci;
    if (cfast) {
      pi = e / (QC / V);
      ci = e % (QC / V) * V;
    } else {
      ci = e / (QP / V);
      pi = e % (QP / V) * V;
    }
    const long long off = pix[pi];
    // V > 1: C (cfast) or the map's row (otherwise) is a multiple of V,
    // so a vector lies wholly inside or outside
    in[i] = off >= 0 && c0 + ci < a.C;
    pis[i] = pi;
    cis[i] = ci;
    if (in[i]) {
      const T* src = x + off + (long long)(c0 + ci) * a.xs_c;
      if constexpr (V == 1)
        f[i][0] = to_float(*src);
      else
        loadv<V>(src, f[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int c = c0 + cis[i];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int8_t v =
          in[i] ? quant(f[i][k], a.mx, cfast ? c + k : c, sx) : (int8_t)0;
      if (cfast)
        q[pis[i] * pitch + cis[i] + k] = v;
      else
        q[(pis[i] + k) * pitch + cis[i]] = v;
    }
  }
  __syncthreads();
  const int chunks = QC / 16;
  const int pi = threadIdx.x / chunks, c = c0 + threadIdx.x % chunks * 16;
  if (p0 + pi < a.P && c < a.Cp)
    *reinterpret_cast<int4*>(a.xq + (p0 + pi) * a.Cp + c) =
        *reinterpret_cast<const int4*>(&q[pi * pitch + (c - c0)]);
}

// The widest V (8, 4, else 1) whose vectors x's layout keeps aligned and
// whole: along channels (channels-last x) C and every pixel offset a
// multiple of V; along pixels, the map's rows and every other stride.
int vec_width(const QArgs& a, int elt) {
  for (int v = 8; v >= 4; v /= 2) {
    if ((uintptr_t)a.x % (v * elt) || (v * elt) % 8) continue;
    const bool ok =
        a.xs_c == 1
            ? a.C % v == 0 && a.xs_w % v == 0 && a.xs_h % v == 0 &&
                  a.xs_d % v == 0 && a.xs_n % v == 0
            : a.xs_w == 1 && a.W % v == 0 && a.xs_c % v == 0 &&
                  a.xs_h % v == 0 && a.xs_d % v == 0 && a.xs_n % v == 0;
    if (ok) return v;
  }
  return 1;
}

// Launch `kernel` as a programmatic dependent of the stream's previous
// kernel: it may start as that one drains; it waits for it
// (griddepcontrol.wait) before reading what that one wrote.
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, int threads,
                     int smem, cudaStream_t st, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T>
int launch_quantize(QArgs a, cudaStream_t st) {
  if (a.P == 0) return 0;
  a.qc = a.Cp <= 16 ? 16 : a.Cp <= 32 ? 32 : 64;
  const int QP = QT / a.qc, v = vec_width(a, sizeof(T));
  const dim3 grid((unsigned)((a.P + QP - 1) / QP), (a.Cp + a.qc - 1) / a.qc);
  return v == 8   ? launch_dependent(quantize_cl<T, 8>, grid, 256, 0, st, a)
         : v == 4 ? launch_dependent(quantize_cl<T, 4>, grid, 256, 0, st, a)
                  : launch_dependent(quantize_cl<T, 1>, grid, 256, 0, st, a);
}

// Space to depth, for a stride-2 conv of an input of C <= 4 channels (the
// stem): xq[n, i, j, (py * 2 + px) * C + c] = q(x[n, c, 2i + py - ph, 2j +
// px - pw]) (0 outside x) for i < H2, j < W2, a 16-byte row a pixel (Cp =
// 16).  The conv is then a stride-1 one of ceil(k / 2)^2 taps on xq
// (ops/conv_s8.py::s2d_geometry).  A thread a pixel; a.H, a.W are x's.
template <typename T>
__global__ void __launch_bounds__(256) quantize_s2d(QArgs a, int H2, int W2,
                                                    int ph, int pw) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long p = (long long)blockIdx.x * 256 + threadIdx.x;
  if (p >= a.P) return;
  const int j = p % W2, i = p / W2 % H2;
  const long long n = p / W2 / H2;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const float sx = a.mx ? 0.f : *a.sx;
  alignas(16) int8_t v[16] = {};
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      const int iy = 2 * i + py - ph, ix = 2 * j + px - pw;
      if (iy < 0 || iy >= a.H || ix < 0 || ix >= a.W) continue;
      const T* src = x + n * a.xs_n + iy * a.xs_h + ix * a.xs_w;
      for (int c = 0; c < a.C; ++c)
        v[(py * 2 + px) * a.C + c] = quant(to_float(src[c * a.xs_c]), a.mx,
                                           c, sx);
    }
  *reinterpret_cast<int4*>(a.xq + p * 16) = *reinterpret_cast<const int4*>(v);
}

int quantize(const QArgs& a, int dtype, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch_quantize<float>(a, st);
    case 1: return launch_quantize<__nv_bfloat16>(a, st);
    case 2: return launch_quantize<__half>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_s2d(const QArgs& a, int H2, int W2, int ph, int pw,
               cudaStream_t st) {
  if (a.P == 0) return 0;
  return launch_dependent(quantize_s2d<T>, dim3((unsigned)((a.P + 255) / 256)),
                          256, 0, st, a, H2, W2, ph, pw);
}

int quantize_s2d_pass(const QArgs& a, int dtype, int H2, int W2, int ph,
                      int pw, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch_s2d<float>(a, H2, W2, ph, pw, st);
    case 1: return launch_s2d<__nv_bfloat16>(a, H2, W2, ph, pw, st);
    case 2: return launch_s2d<__half>(a, H2, W2, ph, pw, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------- int8 products

// D (64 x N, s32) += A (64 x 32) * B (32 x N), s8 from shared memory
// (K-major), scale-d 1.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// wgmma descriptor of a K-major s8 tile: rows of `bk` bytes in the bk-byte
// swizzle (128, 64, 32: 8-row groups 8 * bk bytes apart), or, for bk = 16,
// unswizzled core matrices of 8 rows x 16 bytes, 8-row groups 128 bytes
// apart and the two 16-byte K halves `lbo` bytes apart.
__device__ __forceinline__ uint64_t desc_s8(uint32_t addr, int bk,
                                            uint32_t lbo) {
  const uint64_t layout = bk == 128 ? 1 : bk == 64 ? 2 : bk == 32 ? 3 : 0;
  const uint32_t sbo = bk == 16 ? 128 : 8 * bk;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void fence_int(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// ---------------------------------------------------------- the conv GEMM

struct Geo {
  int N, D, H, W, Cp;  // the quantized input (N, D, H, W, Cp)
  int Do, Ho, Wo, Co;  // the output; Co = G * Ng
  int KD, KH, KW, sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int G, Cg, Ng, ntap;  // ntap = KD * KH * KW
  int flat, TD, TY, TX, BK, S, stages;
  int tiles_d, tiles_y, tiles_x;  // per image; flat: tiles_x M tiles
  int tiles_all;                  // the grid's tiles
  uint32_t a_bytes, stage_bytes;  // a stage's A tile and the whole stage
  uint32_t tx_bytes;              // the bytes a stage's boxes bring
  long long M;                    // N * Do * Ho * Wo
  long long ys_n, ys_c, ys_d, ys_h, ys_w;
  const float* scale;
  const float* bias;
  void* y;
  int32_t* acc;   // the sums in y's layout, or null
  int32_t* part;  // S > 1: int32 partials (S, M, Co)
  int dtype;      // y: 0 f32, 1 bf16, 2 f16
};

// Is a tap at offset k of one axis live for the box's `cnt` outputs from
// o0: does some input coordinate o * s - p + k * dl lie in [0, I)?
__device__ __forceinline__ bool axis_live(int o0, int cnt, int s, int p,
                                          int k, int dl, int I) {
  const int lo = o0 * s - p + k * dl;
  const int j0 = lo >= 0 ? 0 : (-lo + s - 1) / s;
  return j0 < cnt && lo + j0 * s < I;
}

__device__ __forceinline__ void store_y(void* y, int dtype, long long off,
                                        float v) {
  if (dtype == 0)
    static_cast<float*>(y)[off] = v;
  else if (dtype == 1)
    static_cast<__nv_bfloat16*>(y)[off] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(y)[off] = __float2half_rn(v);
}

// The dequantized value of sum s of output channel o: float(s) *
// scale[o], + bias[o], each rounded once.
__device__ __forceinline__ float dequant(const Geo& g, int s, int o) {
  float v = __int2float_rn(s) * g.scale[o];
  if (g.bias) v = v + g.bias[o];
  return v;
}

// The epilogue of one sum: dequantized, cast and stored at y[off] (and the
// sum at acc[off]).
__device__ __forceinline__ void finish_one(const Geo& g, long long off, int o,
                                           int s) {
  if (g.acc) g.acc[off] = s;
  store_y(g.y, g.dtype, off, dequant(g, s, o));
}

// Eight values cast to y's type and stored at y[off] by 16-byte stores
// (off a multiple of 8).
__device__ __forceinline__ void store8(void* y, int dtype, long long off,
                                       const float (&f)[8]) {
  if (dtype == 0) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(y) + off);
    p[0] = make_float4(f[0], f[1], f[2], f[3]);
    p[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else if (dtype == 1) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(y) + off) =
        *reinterpret_cast<const uint4*>(h);
  } else {
    __half2 h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(static_cast<__half*>(y) + off) =
        *reinterpret_cast<const uint4*>(h);
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Output element offset of flat pixel m (n, od, oh, ow) in y's layout.
__device__ __forceinline__ long long out_offset(const Geo& g, long long m) {
  const int ow = m % g.Wo;
  long long t = m / g.Wo;
  const int oh = t % g.Ho;
  t /= g.Ho;
  const int od = t % g.Do;
  return (t / g.Do) * g.ys_n + od * g.ys_d + oh * g.ys_h + ow * g.ys_w;
}

// An M tile's origin: first flat pixel, or image and first output pixel.
struct Tile {
  long long m0;
  int n, od0, oh0, ow0;
};

// The A box of tap t of tile `tl` at channel c into dst, completing on bar.
__device__ __forceinline__ void load_a(const CUtensorMap* xm, const Geo& g,
                                       const Tile& tl, uint32_t dst,
                                       uint32_t bar, int t, int c) {
  if (g.flat) {
    tma_load_5d(dst, xm, bar, c, (int)tl.m0, 0, 0, 0);
  } else {
    const int kd = t / (g.KH * g.KW), kh = (t / g.KW) % g.KH, kw = t % g.KW;
    tma_load_5d(dst, xm, bar, c, tl.ow0 * g.sw - g.pw + kw * g.dw,
                tl.oh0 * g.sh - g.ph + kh * g.dh,
                tl.od0 * g.sd - g.pd + kd * g.dd, tl.n);
  }
}

// Tile row r's output: returns its element offset in y's layout and sets m
// to its flat pixel, or returns -1 where the row is masked (past the map,
// past the box, the ragged edge).
__device__ __forceinline__ long long row_offset(const Geo& g, const Tile& tl,
                                                int r, long long& m) {
  if (g.flat) {
    m = tl.m0 + r;
    if (m >= g.M) return -1;
  } else {
    if (r >= g.TD * g.TY * g.TX) return -1;
    const int od = tl.od0 + r / (g.TY * g.TX);
    const int oh = tl.oh0 + (r / g.TX) % g.TY, ow = tl.ow0 + r % g.TX;
    if (od >= g.Do || oh >= g.Ho || ow >= g.Wo) return -1;
    m = (((long long)tl.n * g.Do + od) * g.Ho + oh) * g.Wo + ow;
  }
  return out_offset(g, m);
}

// The live taps of one axis for a box of T outputs from o0, as a mask.
__device__ __forceinline__ uint32_t axis_mask(int o0, int T, int O, int s,
                                              int p, int K, int dl, int I) {
  const int cnt = min(o0 + T, O) - o0;
  uint32_t m = 0;
  for (int k = 0; k < K; ++k)
    if (axis_live(o0, cnt, s, p, k, dl, I)) m |= 1u << k;
  return m;
}

// Tile t of the grid: N tiles fastest (neighbouring blocks share A tiles),
// then M tiles, then group * S + split.  Its origin, first output channel,
// group, split and live-tap masks (d, h, w); its K steps.
struct Work {
  Tile tl;
  int n0, grp, split;
  uint32_t md, mh, mw;
  int s0, niter;
};

template <int BM, int BN>
__device__ __forceinline__ Work tile_work(const Geo& g, int t) {
  Work w;
  const int tiles_n = (g.Ng + BN - 1) / BN;
  const int mtiles = g.flat ? g.tiles_x
                            : g.N * g.tiles_d * g.tiles_y * g.tiles_x;
  w.n0 = t % tiles_n * BN;
  const int mt = t / tiles_n % mtiles, gs = t / tiles_n / mtiles;
  w.grp = gs / g.S;
  w.split = gs % g.S;
  w.tl = Tile{0, 0, 0, 0, 0};
  int live;
  if (g.flat) {
    w.tl.m0 = (long long)mt * BM;
    w.md = w.mh = w.mw = 1;
    live = 1;
  } else {
    const int per = g.tiles_d * g.tiles_y * g.tiles_x, r = mt % per;
    w.tl.n = mt / per;
    w.tl.od0 = r / (g.tiles_y * g.tiles_x) * g.TD;
    w.tl.oh0 = (r / g.tiles_x) % g.tiles_y * g.TY;
    w.tl.ow0 = r % g.tiles_x * g.TX;
    w.md = axis_mask(w.tl.od0, g.TD, g.Do, g.sd, g.pd, g.KD, g.dd, g.D);
    w.mh = axis_mask(w.tl.oh0, g.TY, g.Ho, g.sh, g.ph, g.KH, g.dh, g.H);
    w.mw = axis_mask(w.tl.ow0, g.TX, g.Wo, g.sw, g.pw, g.KW, g.dw, g.W);
    live = __popc(w.md) * __popc(w.mh) * __popc(w.mw);
  }
  const int steps = g.BK == 16 ? (live + 1) / 2
                               : live * ((g.Cg + g.BK - 1) / g.BK);
  w.s0 = (int)((long long)w.split * steps / g.S);
  w.niter = (int)((long long)(w.split + 1) * steps / g.S) - w.s0;
  return w;
}

// Block blockIdx.x takes tile blockIdx.x (tile_work): WGM consumer
// warpgroups (BM = 64 * WGM rows), then one producer warp.
template <int WGM, int BN>
__global__ void __launch_bounds__(WGM * 128 + 32, WGM* BN >= 256 ? 1 : 2)
    conv_s8_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const Geo g) {
  constexpr int BM = WGM * 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + g.stages * g.stage_bytes;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                       // full
      mbar_init(bars + 8 * (kMaxStages + s), WGM * 4);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const bool pair = g.BK == 16;  // two taps a K step, 16 channels each
  const Work w = tile_work<BM, BN>(g, blockIdx.x);

  if (threadIdx.x >= WGM * 128) {  // producer warp: one thread issues loads
    if (threadIdx.x != WGM * 128) return;
    __shared__ int taps[kMaxTaps];
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&xmap))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(
                     reinterpret_cast<uint64_t>(&wmap))
                 : "memory");
    // the live taps in (kd, kh, kw) order
    int L = 0;
    for (uint32_t d = w.md; d; d &= d - 1)
      for (uint32_t h = w.mh; h; h &= h - 1)
        for (uint32_t x = w.mw; x; x &= x - 1)
          taps[L++] = ((__ffs(d) - 1) * g.KH + __ffs(h) - 1) * g.KW +
                      __ffs(x) - 1;
    const int chunks = pair ? 1 : (g.Cg + g.BK - 1) / g.BK;
    const int cg0 = w.grp * g.Cg;
    // the quantize pass, launched before as this grid's primary, has
    // written the workspace
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int it = 0; it < w.niter; ++it) {
      const int s = it % g.stages;
      if (it >= g.stages)
        mbar_wait(bars + 8 * (kMaxStages + s), (it / g.stages - 1) & 1);
      const uint32_t bar = bars + 8 * s;
      const uint32_t a = base + s * g.stage_bytes, b = a + g.a_bytes;
      mbar_expect_tx(bar, g.tx_bytes);
      const int step = w.s0 + it;
      if (pair) {
        // the odd last tap's partner: its own box again, and the B box
        // past the last tap, all zeros
        const int t0 = taps[2 * step];
        const bool two = 2 * step + 1 < L;
        const int t1 = two ? taps[2 * step + 1] : t0;
        load_a(&xmap, g, w.tl, a, bar, t0, cg0);
        tma_load_4d(b, &wmap, bar, 0, w.n0, t0, w.grp);
        load_a(&xmap, g, w.tl, a + BM * 16, bar, t1, cg0);
        tma_load_4d(b + BN * 16, &wmap, bar, 0, w.n0, two ? t1 : g.ntap,
                    w.grp);
      } else {
        const int tap = taps[step / chunks];
        const int c0 = (step % chunks) * g.BK;
        load_a(&xmap, g, w.tl, a, bar, tap, cg0 + c0);
        tma_load_4d(b, &wmap, bar, c0, w.n0, tap, w.grp);
      }
    }
    return;
  }

  // consumers
  const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, tw = threadIdx.x % 128;
  const int nk = pair ? 1 : g.BK / 32;  // k32 products a stage
  const uint32_t arow = pair ? 16 : g.BK;
  const uint32_t lbo_a = pair ? BM * 16 : 16, lbo_b = pair ? BN * 16 : 16;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_int(acc[i]);
  for (int it = 0; it < w.niter; ++it) {
    const int s = it % g.stages;
    mbar_wait(bars + 8 * s, (it / g.stages) & 1);
    const uint32_t a = base + s * g.stage_bytes + wg * 64 * arow;
    const uint32_t b = base + s * g.stage_bytes + g.a_bytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < nk)
        wgmma_s8(acc, desc_s8(a + 32 * k, g.BK, lbo_a),
                 desc_s8(b + 32 * k, g.BK, lbo_b));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their
                      // stage: hand it back to the producer
    if (it > 0 && lane == 0)
      mbar_arrive(bars + 8 * (kMaxStages + (it - 1) % g.stages));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_int(acc[i]);

  if (g.S > 1) {
    // int32 partials: this thread's rows m and m + 8 of its warp's 16, two
    // adjacent channels of each 8-channel column block (32 bytes a row for
    // a quad of lanes)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      long long m;
      if (row_offset(g, w.tl, wg * 64 + wq * 16 + lane / 4 + 8 * h, m) < 0)
        continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = w.n0 + j * 8 + (lane % 4) * 2 + e;
          if (nn < g.Ng)
            g.part[((long long)w.split * g.M + m) * g.Co + w.grp * g.Ng +
                   nn] = acc[j * 4 + 2 * h + e];
        }
      }
    }
    return;
  }

  // Epilogue through shared memory, 64 columns at a time: each warpgroup
  // stages its 64 x 64 int32 sums in the ring (free once every consumer's
  // products are done), then stores them dequantized along y's fast axis:
  // 8 channels (16 bytes of bf16) a thread for channels-last y, pixels
  // across the lanes otherwise.
  __shared__ long long roff[WGM][64];
  __shared__ __align__(16) float sc[BN], bi[BN];  // this block's columns
  if (tw < 64) {
    long long m;
    roff[wg][tw] = row_offset(g, w.tl, wg * 64 + tw, m);
  }
  for (int i = threadIdx.x; i < BN; i += WGM * 128) {
    const int nn = w.n0 + i, o = w.grp * g.Ng + nn;
    sc[i] = nn < g.Ng ? g.scale[o] : 0.f;
    bi[i] = nn < g.Ng && g.bias ? g.bias[o] : 0.f;
  }
  named_sync(1, WGM * 128);  // all products done: the ring is free
  int32_t* st = reinterpret_cast<int32_t*>(
      smem_raw + (base - smem_u32(smem_raw)) + wg * kEpiBytes);
#pragma unroll
  for (int q = 0; q < BN / 64; ++q) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(
            &st[(wq * 16 + lane / 4 + 8 * h) * kEpiPitch + jj * 8 +
                (lane % 4) * 2]) =
            make_int2(acc[(q * 8 + jj) * 4 + 2 * h],
                      acc[(q * 8 + jj) * 4 + 2 * h + 1]);
    named_sync(2 + wg, 128);
    const int nq = w.n0 + q * 64;  // the chunk's first channel
    if (g.ys_c == 1) {
      for (int e = tw; e < 64 * 8; e += 128) {
        const int r = e / 8, v = e % 8;
        const long long off = roff[wg][r];
        const int nn = nq + v * 8;
        if (off < 0 || nn >= g.Ng) continue;
        const int o = w.grp * g.Ng + nn, cnt = min(8, g.Ng - nn);
        const int4* sp =
            reinterpret_cast<const int4*>(&st[r * kEpiPitch + v * 8]);
        const int4 s0 = sp[0], s1 = sp[1];
        const int sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        if (cnt == 8 && (off + o) % 8 == 0) {
          // float(s) * scale, + bias, each rounded once (--fmad=false)
          const int c = q * 64 + v * 8;
          float f[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (g.acc) g.acc[off + o + i] = sv[i];
            f[i] = __int2float_rn(sv[i]) * sc[c + i];
            if (g.bias) f[i] = f[i] + bi[c + i];
          }
          store8(g.y, g.dtype, off + o, f);
        } else {
          for (int i = 0; i < cnt; ++i)
            finish_one(g, off + o + i, o + i, sv[i]);
        }
      }
    } else {
      for (int e = tw; e < 64 * 64; e += 128) {
        const int r = e % 64, c = e / 64;
        const long long off = roff[wg][r];
        const int nn = nq + c;
        if (off < 0 || nn >= g.Ng) continue;
        const int o = w.grp * g.Ng + nn;
        finish_one(g, off + (long long)o * g.ys_c, o,
                   st[r * kEpiPitch + c]);
      }
    }
    named_sync(2 + wg, 128);  // the stage is read: the next chunk may land
  }
}

// S > 1: the sum of the S int32 partials, then the epilogue.
__global__ void __launch_bounds__(256) s8_finish(const Geo g) {
  const long long n = g.M * g.Co;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    int s = 0;
    for (int k = 0; k < g.S; ++k) s += g.part[k * n + e];
    const int o = e % g.Co;
    finish_one(g, out_offset(g, e / g.Co) + o * g.ys_c, o, s);
  }
}

template <int WGM, int BN>
int launch_gemm(const CUtensorMap& xm, const CUtensorMap& wm, const Geo& g,
                int smem, cudaStream_t st) {
  static uint64_t smem_set = 0;
  const int err = allow_smem(conv_s8_wgmma<WGM, BN>, kMaxDyn, smem_set);
  if (err != 0) return err;
  // a programmatic dependent of the quantize pass
  return launch_dependent(conv_s8_wgmma<WGM, BN>, dim3(g.tiles_all),
                          WGM * 128 + 32, smem, st, xm, wm, g);
}

// A tensor map of int8 `dims` (innermost first, dense), `box`, element
// strides `estr`, swizzled for rows of `bk` bytes (none for 16); TMA fills
// what a box reads outside the tensor with zeros.
int encode_s8(CUtensorMap* m, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint32_t* box,
              const cuuint32_t* estr, int bk) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  cuuint64_t strides[4];
  cuuint64_t s = 1;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = s *= dims[i];
  const CUtensorMapSwizzle sw =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : bk == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;  // 1000 + CUresult
}

}  // namespace

// The quantize pass alone: x (N, C, D, H, W) through its element strides,
// f32 / bf16 / f16 (dtype 0 / 1 / 2), into xq (N, D, H, W, Cp) int8; with
// s2d, the space-to-depth pass into xq (N, 1, H2, W2, 16) (quantize_s2d).
extern "C" int fbbev_s8_quantize(const void* x, const void* mx,
                                 const void* sx, void* xq, int dtype, int N,
                                 int C, int D, int H, int W, int xs_n,
                                 int xs_c, int xs_d, int xs_h, int xs_w,
                                 int Cp, int s2d, int H2, int W2, int ph,
                                 int pw, cudaStream_t stream) {
  if (Cp % 16 || (!mx && !sx) || (uintptr_t)xq % 16 || C < 1 ||
      (s2d ? Cp != 16 || 4 * C > 16 || D != 1 : Cp < C))
    return (int)cudaErrorInvalidValue;
  const QArgs a{x, static_cast<const float*>(mx),
                static_cast<const float*>(sx), static_cast<int8_t*>(xq),
                C, Cp, D, H, W,
                s2d ? (long long)N * H2 * W2 : (long long)N * D * H * W,
                xs_n, xs_c, xs_d, xs_h, xs_w, 0};
  return s2d ? quantize_s2d_pass(a, dtype, H2, W2, ph, pw, stream)
             : quantize(a, dtype, stream);
}

// The conv (its ints in `prm`, named below): x (N, C, D, H, W) through its
// element strides (with s2d: x is (N, C0, H0, W0) and the GEMM's input the
// space-to-depth xq, see quantize_s2d); wk the packed weights (G, ntap,
// Npad, Cpad) int8; scale (Co,), bias (Co,) or null; mx (C,) or null, then
// sx (); y (N, Co, Do, Ho, Wo) through its strides, acc the int32 sums in
// y's layout or null; workspaces xq (N*D*H*W*Cp int8) and, when S > 1,
// part (S * M * Co int32).  The plan: flat (1x1, stride
// 1, no padding) or a box TD x TY x TX <= BM, BM 64 or 128, BN 64, 128 or
// 256, BK 128, 64, 32 (channels of a K step) or 16 (groups of <= 16
// channels), S splits, 2..8 stages.
extern "C" int fbbev_conv_s8(const void* x, const void* wk,
                             const void* scale, const void* bias,
                             const void* mx, const void* sx, void* y,
                             void* acc, void* xq, void* part, const int* prm,
                             cudaStream_t stream) {
  // the call's ints, in this order (one array: a ctypes call's cost grows
  // with its arguments)
  const int dtype = prm[0], N = prm[1], C = prm[2], D = prm[3], H = prm[4],
            W = prm[5], xs_n = prm[6], xs_c = prm[7], xs_d = prm[8],
            xs_h = prm[9], xs_w = prm[10], Cp = prm[11], Co = prm[12],
            Do = prm[13], Ho = prm[14], Wo = prm[15], ys_n = prm[16],
            ys_c = prm[17], ys_d = prm[18], ys_h = prm[19], ys_w = prm[20],
            KD = prm[21], KH = prm[22], KW = prm[23], sd = prm[24],
            sh = prm[25], sw = prm[26], pd = prm[27], ph = prm[28],
            pw = prm[29], dd = prm[30], dh = prm[31], dw = prm[32],
            G = prm[33], Cg = prm[34], Ng = prm[35], Npad = prm[36],
            Cpad = prm[37], flat = prm[38], TD = prm[39], TY = prm[40],
            TX = prm[41], BM = prm[42], BN = prm[43], BK = prm[44],
            S = prm[45], stages = prm[46];
  // space to depth (s2d = 1): N, C, D, H, W above are the stride-1 conv's
  // input xq; x is (N, C0, H0, W0), padded by (ph0, pw0)
  const int s2d = prm[47], C0 = prm[48], H0 = prm[49], W0 = prm[50],
            ph0 = prm[51], pw0 = prm[52];
  const int ntap = KD * KH * KW;
  const bool pair = BK == 16;
  const uint32_t arow = pair ? 32 : BK;  // A bytes a tile row in a stage
  const uint32_t a_bytes = BM * arow, stage = a_bytes + BN * arow;
  // 1024 of alignment, the ring (which stages the epilogue), the barriers
  const int smem = 1024 + stages * stage + 16 * kMaxStages;
  const uint32_t rows = flat ? BM : TD * TY * TX;
  if ((BM != 64 && BM != 128) || (BN != 64 && BN != 128 && BN != 256) ||
      (BK != 16 && BK != 32 && BK != 64 && BK != 128) || (pair && Cg > 16) ||
      S < 1 || stages < 2 || stages > kMaxStages || ntap > kMaxTaps ||
      smem > kMaxDyn || stages * stage < (uint32_t)(BM / 64) * kEpiBytes ||
      KD > 32 || KH > 32 || KW > 32 ||
      Cp % 16 || Cp < C || Cpad % 16 ||
      Cpad < Cg || Npad < Ng || G * Cg != C || G * Ng != Co || Cg < 1 ||
      Ng < 1 || (!mx && !sx) || (S > 1 && part == nullptr) ||
      ((uintptr_t)xq | (uintptr_t)wk) % 16 ||
      (flat && (ntap != 1 || sd != 1 || sh != 1 || sw != 1 || pd || ph ||
                pw || Do != D || Ho != H || Wo != W)) ||
      (!flat && (TD < 1 || TY < 1 || TX < 1 || TD * TY * TX > BM ||
                 TX * sw > 256 || TY * sh > 256 || TD * sd > 256 ||
                 sd > 8 || sh > 8 || sw > 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = stream;
  if (s2d && (Cp != 16 || 4 * C0 != C || D != 1 || C0 < 1))
    return (int)cudaErrorInvalidValue;
  const QArgs q{x, static_cast<const float*>(mx),
                static_cast<const float*>(sx), static_cast<int8_t*>(xq),
                s2d ? C0 : C, Cp, D, s2d ? H0 : H, s2d ? W0 : W,
                (long long)N * D * H * W, xs_n, xs_c, xs_d, xs_h, xs_w, 0};
  int r = s2d ? quantize_s2d_pass(q, dtype, H, W, ph0, pw0, st)
              : quantize(q, dtype, st);
  if (r != 0) return r;
  CUtensorMap xm, wm;
  const long long P = (long long)N * D * H * W;
  if (flat) {
    const cuuint64_t xd[5] = {(cuuint64_t)Cp, (cuuint64_t)P, 1, 1, 1};
    const cuuint32_t xb[5] = {(cuuint32_t)BK, (cuuint32_t)BM, 1, 1, 1};
    const cuuint32_t es[5] = {1, 1, 1, 1, 1};
    r = encode_s8(&xm, xq, 5, xd, xb, es, BK);
  } else {
    const cuuint64_t xd[5] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)D, (cuuint64_t)N};
    const cuuint32_t xb[5] = {(cuuint32_t)BK, (cuuint32_t)(TX * sw),
                              (cuuint32_t)(TY * sh), (cuuint32_t)(TD * sd),
                              1};
    const cuuint32_t es[5] = {1, (cuuint32_t)sw, (cuuint32_t)sh,
                              (cuuint32_t)sd, 1};
    r = encode_s8(&xm, xq, 5, xd, xb, es, BK);
  }
  if (r != 0) return r;
  const cuuint64_t wd[4] = {(cuuint64_t)Cpad, (cuuint64_t)Npad,
                            (cuuint64_t)ntap, (cuuint64_t)G};
  const cuuint32_t wb[4] = {(cuuint32_t)BK, (cuuint32_t)BN, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  r = encode_s8(&wm, wk, 4, wd, wb, ones, BK);
  if (r != 0) return r;
  Geo g;
  g.N = N; g.D = D; g.H = H; g.W = W; g.Cp = Cp;
  g.Do = Do; g.Ho = Ho; g.Wo = Wo; g.Co = Co;
  g.KD = KD; g.KH = KH; g.KW = KW; g.sd = sd; g.sh = sh; g.sw = sw;
  g.pd = pd; g.ph = ph; g.pw = pw; g.dd = dd; g.dh = dh; g.dw = dw;
  g.G = G; g.Cg = Cg; g.Ng = Ng; g.ntap = ntap;
  g.flat = flat; g.TD = TD; g.TY = TY; g.TX = TX; g.BK = BK; g.S = S;
  g.stages = stages;
  g.tiles_d = flat ? 1 : (Do + TD - 1) / TD;
  g.tiles_y = flat ? 1 : (Ho + TY - 1) / TY;
  g.tiles_x = flat ? (int)((P + BM - 1) / BM) : (Wo + TX - 1) / TX;
  g.tiles_all = (flat ? g.tiles_x : N * g.tiles_d * g.tiles_y * g.tiles_x) *
                ((Ng + BN - 1) / BN) * G * S;
  g.a_bytes = a_bytes;
  g.stage_bytes = stage;
  g.tx_bytes = pair ? 2 * (rows * 16 + BN * 16) : rows * BK + BN * BK;
  g.M = (long long)N * Do * Ho * Wo;
  g.ys_n = ys_n; g.ys_c = ys_c; g.ys_d = ys_d; g.ys_h = ys_h; g.ys_w = ys_w;
  g.scale = static_cast<const float*>(scale);
  g.bias = static_cast<const float*>(bias);
  g.y = y;
  g.acc = static_cast<int32_t*>(acc);
  g.part = static_cast<int32_t*>(part);
  g.dtype = dtype;
  if (g.M == 0) return 0;
  if (BM == 128)
    r = BN == 256   ? launch_gemm<2, 256>(xm, wm, g, smem, st)
        : BN == 128 ? launch_gemm<2, 128>(xm, wm, g, smem, st)
                    : launch_gemm<2, 64>(xm, wm, g, smem, st);
  else
    r = BN == 256   ? launch_gemm<1, 256>(xm, wm, g, smem, st)
        : BN == 128 ? launch_gemm<1, 128>(xm, wm, g, smem, st)
                    : launch_gemm<1, 64>(xm, wm, g, smem, st);
  if (r != 0 || S == 1) return r;
  const long long fb = (g.M * Co + 255) / 256;
  s8_finish<<<(unsigned)(fb < 4096 ? fb : 4096), 256, 0, st>>>(g);
  return (int)cudaGetLastError();
}
