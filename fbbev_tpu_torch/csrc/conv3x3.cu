// 3x3 stride-1 zero-padded ("SAME") 2D convolution, channels-last, f32
// accumulation, output in the input type.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_conv.py:67 conv3x3_s1
// (_kernel :51, pl.pallas_call :90), which materialises the nine shifted
// views of the padded input in HBM and multiplies (rows, 9*Cin) panels by
// (9*Cin, Cout) on the MXU.  Here the implicit GEMM is direct: no shifted
// copies are written.
//
//   y[n, oy, ox, co] = sum_{ky, kx, ci} x[n, oy+ky-1, ox+kx-1, ci]
//                                       * w[ky, kx, ci, co]
//   x (N, H, W, Cin), w (3, 3, Cin, Cout), y (N, H, W, Cout); zero outside.
//
// Block: an 8 x 16 tile of output pixels by 64 output channels.  Per
// input-channel chunk the block stages the 10 x 18 pixel halo of the tile
// and the chunk's 9 x KC x 64 weights in shared memory (zeros outside the
// image and past Cout), then
//   bf16: warp w owns output row w of the tile -- 16 pixels, one WMMA
//         M-fragment -- and for each tap (ky, kx) multiplies the halo rows
//         w+ky, columns kx..kx+15 (a 16 x 16 fragment read straight from
//         the halo, leading dimension KC) by the tap's weights, four
//         16 x 16 accumulators over the 64 channels (WMMA bf16, f32
//         accumulate, as K1's epilogue in fuse_warp.cu);
//   f32:  each thread owns 8 pixels x 4 channels and multiplies and adds
//         on the CUDA cores (no TF32: f32 stays f32).
//
// Bound: operations -- 2 * N*H*W * 9*Cin*Cout on the bf16 tensor cores at
// the image-trunk shapes; the bytes (input and output once, weights once)
// sit below that.  This first version stages with plain loads and block
// barriers; wgmma and TMA are later work.
//
// Requirements (checked by the wrapper and here): Cin % 16 == 0 and
// Cout % 16 == 0 -- 16-byte vector loads of whole channel groups and
// whole 16-wide WMMA fragments.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 8;                // output rows per block
constexpr int TW = 16;               // output columns per block
constexpr int BN = 64;               // output channels per block
constexpr int kThreads = 256;        // 8 warps
constexpr int HH = TH + 2;           // halo rows
constexpr int HWD = TW + 2;          // halo columns

template <typename T> struct Chunk;  // input channels staged per step
template <> struct Chunk<bf16> { static constexpr int KC = 16; };
template <> struct Chunk<float> { static constexpr int KC = 8; };

struct Args {
  const void* x;  // (N, H, W, Cin)
  const void* w;  // (3, 3, Cin, Cout)
  void* y;        // (N, H, W, Cout)
  int N, H, W, Cin, Cout;
};

// Stage channel chunk k0: the halo halo[(hy * HWD + hx) * KC + kk] and the
// weights wsm[(tap * KC + kk) * BN + c], zeros outside the image / Cout.
template <typename T>
__device__ __forceinline__ void stage(const Args& a, T* halo, T* wsm, int n,
                                      int ty0, int tx0, int co0, int k0) {
  constexpr int KC = Chunk<T>::KC;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int PV = KC / V;         // vectors per halo pixel
  constexpr int RV = BN / V;         // vectors per weight row
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  for (int e = threadIdx.x; e < HH * HWD * PV; e += kThreads) {
    const int p = e / PV, v = e % PV;
    const int iy = ty0 - 1 + p / HWD, ix = tx0 - 1 + p % HWD;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
      q = *reinterpret_cast<const uint4*>(
          x + (((int64_t)n * a.H + iy) * a.W + ix) * a.Cin + k0 + v * V);
    reinterpret_cast<uint4*>(halo)[e] = q;
  }
  for (int e = threadIdx.x; e < 9 * KC * RV; e += kThreads) {
    const int r = e / RV, v = e % RV;  // r = tap * KC + kk
    const int tap = r / KC, kk = r % KC;
    const int co = co0 + v * V;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (co < a.Cout)
      q = *reinterpret_cast<const uint4*>(
          w + ((int64_t)tap * a.Cin + k0 + kk) * a.Cout + co);
    reinterpret_cast<uint4*>(wsm)[e] = q;
  }
}

__global__ void __launch_bounds__(kThreads) conv3x3_bf16(Args a) {
  constexpr int KC = Chunk<bf16>::KC;
  __shared__ __align__(128) bf16 halo[HH * HWD * KC];
  __shared__ __align__(128) bf16 wsm[9 * KC * BN];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];
  const int tiles_x = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * BN, n = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nfr = min(BN, a.Cout - co0) / 16;  // live 16-channel fragments

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int f = 0; f < BN / 16; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < a.Cin; k0 += KC) {
    __syncthreads();  // every warp is done with the previous chunk
    stage<bf16>(a, halo, wsm, n, ty0, tx0, co0, k0);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, halo + ((warp + ky) * HWD + kx) * KC, KC);
#pragma unroll
      for (int f = 0; f < BN / 16; ++f) {
        if (f < nfr) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, wsm + tap * KC * BN + f * 16, BN);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
    }
  }

  // epilogue: each fragment through this warp's scratch, 8 channels a lane
  const int oy = ty0 + warp;
  const int r = lane / 2, c8 = (lane % 2) * 8;
  const int ox = tx0 + r;
  float* s = scratch[warp];
  bf16* y = static_cast<bf16*>(a.y);
#pragma unroll
  for (int f = 0; f < BN / 16; ++f) {
    if (f >= nfr) break;
    wmma::store_matrix_sync(s, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    if (oy < a.H && ox < a.W) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(s[r * 16 + c8 + 2 * j],
                                     s[r * 16 + c8 + 2 * j + 1]);
      *reinterpret_cast<uint4*>(
          y + (((int64_t)n * a.H + oy) * a.W + ox) * a.Cout + co0 + f * 16 +
          c8) = q;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads) conv3x3_f32(Args a) {
  constexpr int KC = Chunk<float>::KC;
  __shared__ __align__(16) float halo[HH * HWD * KC];
  __shared__ __align__(16) float wsm[9 * KC * BN];
  const int tiles_x = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * BN, n = blockIdx.z;
  const int cg = threadIdx.x % 16;           // channels co0 + 4cg .. +3
  const int pg = threadIdx.x / 16;           // pixel group of 8
  const int row = pg / 2, col0 = (pg % 2) * 8;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  for (int k0 = 0; k0 < a.Cin; k0 += KC) {
    __syncthreads();
    stage<float>(a, halo, wsm, n, ty0, tx0, co0, k0);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const float* hrow = halo + ((row + ky) * HWD + col0 + kx) * KC;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 w4 =
            reinterpret_cast<const float4*>(wsm + (tap * KC + kk) * BN)[cg];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const float xv = hrow[p * KC + kk];
          acc[p][0] += xv * w4.x;
          acc[p][1] += xv * w4.y;
          acc[p][2] += xv * w4.z;
          acc[p][3] += xv * w4.w;
        }
      }
    }
  }

  const int oy = ty0 + row, co = co0 + cg * 4;
  if (oy >= a.H || co >= a.Cout) return;
  float* y = static_cast<float*>(a.y);
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ox = tx0 + col0 + p;
    if (ox < a.W)
      *reinterpret_cast<float4*>(
          y + (((int64_t)n * a.H + oy) * a.W + ox) * a.Cout + co) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  }
}

}  // namespace

// is_bf16 selects the bf16 (WMMA) or the f32 kernel; x, w and y share it.
extern "C" int fbbev_conv3x3(const void* x, const void* w, void* y,
                             int is_bf16, int N, int H, int W, int Cin,
                             int Cout, void* stream) {
  if (Cin % 16 || Cout % 16 || N < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0 || Cout == 0) return 0;
  const Args a{x, w, y, N, H, W, Cin, Cout};
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                  (Cout + BN - 1) / BN, N);
  if (is_bf16)
    conv3x3_bf16<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    conv3x3_f32<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
