// The int8 convolution of the int8 serving path: quantize, s8 x s8 -> s32
// implicit GEMM on the tensor cores, dequantize.  Replaces no TPU kernel:
// the JAX package runs it as XLA convolutions with int32 accumulation
// (fbbev_tpu/utils/quantize.py:382, :403, :429, :460).  Wrapper, plain
// version and the function's definition: fbbev_tpu_torch/ops/conv_s8.py.
//
// GEMM: M = output pixels (N*Do*Ho*Wo), N = output channels of a group,
// K = taps x input channels of the group, k = tap * Cg + c, taps in
// (kd, kh, kw) order; 2D convolutions are 3D ones with D = KD = 1.  A block
// of 256 threads (8 warps) computes a BM x BN tile of one group,
// BK = 32 of K per step:
//   * a table of the step's 32 k (input-channel offset, tap shifts, the
//     channel's quantize multiplier) and one of the tile's 128 rows (base
//     offset, first input coordinates, output offset) in shared memory;
//   * the activation read in its own type through its strides, quantized
//     in registers (x * m_x[c], or x / s_x; round half to even; clamp to
//     +-127), four k of one row packed into a 32-bit word of the A tile;
//     taps outside the map are 0 (q(0) = 0);
//   * the weights, packed K-major and padded (ops/conv_s8.py::pack_weight),
//     by 16-byte loads into the B tile;
//   * mma.sync.m16n8k32.row.col.s32.s8.s8.s32, warp tiles of 64x32 (BN 128)
//     or 32x32 (BN 64).
// Epilogue: float(acc) * scale[o], + bias[o], cast; built with
// --fmad=false, these are the plain version's roundings, so the kernel
// equals it bit for bit.  Bound: operations (int8 tensor cores) for the
// large convs, bytes for the small.  Simple first: no pipelining.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BK = 32, LDS = BK + 4, THREADS = 256;

struct Params {
  const void* x;
  const int8_t* wk;
  const float* scale;
  const float* bias;
  const float* mx;
  const float* sx;
  void* y;
  int32_t* acc;
  int N, C, D, H, W;
  long long xs_n, xs_c, xs_d, xs_h, xs_w;
  int Co, Do, Ho, Wo;
  long long ys_n, ys_c, ys_d, ys_h, ys_w;
  int KD, KH, KW, sd, sh, sw, pd, ph, pw, dd, dh, dw;
  int G, Cg, Ng, K, Kpad, Npad, M, kfast;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T, int BN>
__global__ void __launch_bounds__(THREADS) conv_s8_kernel(Params p) {
  constexpr int WARPS_N = BN / 32;
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  constexpr int WM = BM / WARPS_M;
  constexpr int MT = WM / 16;  // m16 tiles of a warp
  constexpr int NT = 4;        // n8 tiles of a warp (32 columns)

  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  __shared__ long long row_base[BM], row_out[BM];
  __shared__ int row_d[BM], row_h[BM], row_w[BM];
  __shared__ long long k_off[BK];
  __shared__ int k_d[BK], k_h[BK], k_w[BK], k_ok[BK];
  __shared__ float k_m[BK];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int grp = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool per_channel = p.mx != nullptr;
  const float sx = per_channel ? 0.f : *p.sx;

  for (int r = tid; r < BM; r += THREADS) {
    const int m = m0 + r;
    if (m < p.M) {
      int t = m;
      const int ow = t % p.Wo;
      t /= p.Wo;
      const int oh = t % p.Ho;
      t /= p.Ho;
      const int od = t % p.Do;
      const int n = t / p.Do;
      const int id0 = od * p.sd - p.pd, ih0 = oh * p.sh - p.ph,
                iw0 = ow * p.sw - p.pw;
      row_base[r] = n * p.xs_n + id0 * p.xs_d + ih0 * p.xs_h + iw0 * p.xs_w;
      row_out[r] = n * p.ys_n + od * p.ys_d + oh * p.ys_h + ow * p.ys_w;
      row_d[r] = id0;
      row_h[r] = ih0;
      row_w[r] = iw0;
    } else {  // a row past M reads nothing: its d is far out of the map
      row_base[r] = 0;
      row_out[r] = 0;
      row_d[r] = -(1 << 29);
      row_h[r] = 0;
      row_w[r] = 0;
    }
  }

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int8_t* wk = p.wk + ((long long)grp * p.Npad + n0) * p.Kpad;
  for (int k0 = 0; k0 < p.Kpad; k0 += BK) {
    __syncthreads();  // the previous step's tiles and table are consumed
    if (tid < BK) {
      const int k = k0 + tid;
      if (k < p.K) {
        const int tap = k / p.Cg, c = k - tap * p.Cg;
        const int kw = tap % p.KW, kh = (tap / p.KW) % p.KH,
                  kd = tap / (p.KW * p.KH);
        const int cg = grp * p.Cg + c;
        k_d[tid] = kd * p.dd;
        k_h[tid] = kh * p.dh;
        k_w[tid] = kw * p.dw;
        k_off[tid] = cg * p.xs_c + (long long)(kd * p.dd) * p.xs_d +
                     (long long)(kh * p.dh) * p.xs_h +
                     (long long)(kw * p.dw) * p.xs_w;
        k_m[tid] = per_channel ? p.mx[cg] : 0.f;
        k_ok[tid] = 1;
      } else {
        k_d[tid] = k_h[tid] = k_w[tid] = 0;
        k_off[tid] = 0;
        k_m[tid] = 0.f;
        k_ok[tid] = 0;
      }
    }
    // B tile: BN rows of 32 bytes, two 16-byte chunks a row
    for (int i = tid; i < BN * 2; i += THREADS) {
      const int n = i >> 1, h = i & 1;
      const int4 v = *reinterpret_cast<const int4*>(
          wk + (long long)n * p.Kpad + k0 + h * 16);
      uint32_t* d = reinterpret_cast<uint32_t*>(&Bs[n * LDS + h * 16]);
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
    __syncthreads();  // the table is written
    // A tile: 128 rows x 8 words of 4 k; 4 words a thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * THREADS;
      const int r = p.kfast ? (e >> 3) : (e & (BM - 1));
      const int kq = p.kfast ? (e & 7) : (e >> 7);
      const long long base = row_base[r];
      const int d0 = row_d[r], h0 = row_h[r], w0 = row_w[r];
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = kq * 4 + j;
        int q = 0;
        const int id = d0 + k_d[kk], ih = h0 + k_h[kk], iw = w0 + k_w[kk];
        if (k_ok[kk] && (unsigned)id < (unsigned)p.D &&
            (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W) {
          const float v = to_float(x[base + k_off[kk]]);
          const float s = per_channel ? v * k_m[kk] : __fdiv_rn(v, sx);
          q = max(-127, min(127, __float2int_rn(s)));
        }
        word |= (uint32_t)(q & 0xff) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(&As[r * LDS + kq * 4]) = word;
    }
    __syncthreads();  // the tiles are written
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wm * WM + i * 16 + gq;
      a[i][0] = ld32(&As[r * LDS + tq * 4]);
      a[i][1] = ld32(&As[(r + 8) * LDS + tq * 4]);
      a[i][2] = ld32(&As[r * LDS + 16 + tq * 4]);
      a[i][3] = ld32(&As[(r + 8) * LDS + 16 + tq * 4]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn * 32 + j * 8 + gq;
      b[j][0] = ld32(&Bs[n * LDS + tq * 4]);
      b[j][1] = ld32(&Bs[n * LDS + 16 + tq * 4]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[i][j][0]), "+r"(acc[i][j][1]), "+r"(acc[i][j][2]),
              "+r"(acc[i][j][3])
            : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
              "r"(b[j][0]), "r"(b[j][1]));
  }

  T* __restrict__ y = static_cast<T*>(p.y);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm * WM + i * 16 + gq + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + tq * 2 + (e & 1);
        if (m0 + r >= p.M || n >= p.Ng) continue;
        const int o = grp * p.Ng + n;
        const long long off = row_out[r] + o * p.ys_c;
        const int s = acc[i][j][e];
        if (p.acc) p.acc[off] = s;
        float v = __int2float_rn(s) * p.scale[o];
        if (p.bias) v = v + p.bias[o];
        store(y + off, v);
      }
}

template <typename T>
cudaError_t launch(const Params& p, int bn, cudaStream_t stream) {
  const dim3 grid((p.M + BM - 1) / BM, (p.Ng + bn - 1) / bn, p.G);
  if (bn == 128)
    conv_s8_kernel<T, 128><<<grid, THREADS, 0, stream>>>(p);
  else
    conv_s8_kernel<T, 64><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fbbev_conv_s8(
    const void* x, const void* wk, const void* scale, const void* bias,
    const void* mx, const void* sx, void* y, void* acc, int dtype, int N,
    int C, int D, int H, int W, int xs_n, int xs_c, int xs_d, int xs_h,
    int xs_w, int Co, int Do, int Ho, int Wo, int ys_n, int ys_c, int ys_d,
    int ys_h, int ys_w, int KD, int KH, int KW, int sd, int sh, int sw,
    int pd, int ph, int pw, int dd, int dh, int dw, int G, int Cg, int Ng,
    int K, int Kpad, int Npad, int M, int kfast, int bn,
    cudaStream_t stream) {
  if ((bn != 64 && bn != 128) || Npad % 128 || Kpad % BK || Kpad < K ||
      (!mx && !sx))
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const int8_t*>(wk),
           static_cast<const float*>(scale), static_cast<const float*>(bias),
           static_cast<const float*>(mx), static_cast<const float*>(sx),
           y, static_cast<int32_t*>(acc),
           N, C, D, H, W, xs_n, xs_c, xs_d, xs_h, xs_w,
           Co, Do, Ho, Wo, ys_n, ys_c, ys_d, ys_h, ys_w,
           KD, KH, KW, sd, sh, sw, pd, ph, pw, dd, dh, dw,
           G, Cg, Ng, K, Kpad, Npad, M, kfast};
  switch (dtype) {
    case 0: return (int)launch<float>(p, bn, stream);
    case 1: return (int)launch<__nv_bfloat16>(p, bn, stream);
    case 2: return (int)launch<__half>(p, bn, stream);
  }
  return (int)cudaErrorInvalidValue;
}
