// 3x3x3 stride-1 zero-padded ("SAME") 3D convolution, channels-last, f32
// accumulation, output in the input type.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_conv3d.py:130 conv3d_3x3x3
// (_kernel :77, pl.pallas_call :157), which DMAs a (TY+2, TX+2, Z, Cin)
// halo slab into VMEM, builds the z-banded im2col (Z, 3*Cin) with sublane
// shifts and multiplies it by the (3*Cin, Cout) weights of each (dy, dx)
// tap on the MXU.  Here the implicit GEMM is direct: no im2col is built.
//
//   y[b, oy, ox, oz, co] = sum_{dy, dx, dz, ci} x[b, oy+dy-1, ox+dx-1,
//                                                 oz+dz-1, ci]
//                                              * w[dy, dx, dz, ci, co]
//   x (B, Y, X, Z, Cin), w (3, 3, 3, Cin, Cout), y (B, Y, X, Z, Cout);
//   zero outside the volume (the z edges included).
//
// bf16 block: TY output rows (TY = max(1, 8 / Z)) x 16 output columns x
// all Z x 64 output channels.  Per 16-channel input chunk the block stages
// the (TY+2) x 18 x (Z+2) halo -- zero outside the volume, so the z edges
// are zero-filled -- and the chunk's 27 x 16 x 64 weights in shared
// memory.  A WMMA M-fragment is 16 consecutive output columns at one
// (row, z): in the halo, laid out (hy, hx, hz, channel), those are 16
// rows at leading dimension (Z+2)*16, so each of the 27 taps reads its A
// fragment straight out of the halo at a fixed offset.  Warp w owns the
// fragments w, w+8, ... of the block's TY*Z, four 16 x 16 f32
// accumulators (64 channels) each; products on WMMA bf16, f32 accumulate.
// f32: a plain CUDA-core kernel, one thread per output voxel and four
// output channels (no TF32: f32 stays f32), for the checks.
//
// Bound: operations -- 2 * voxels * 27 * Cin * Cout on the bf16 tensor
// cores (595 GFLOP over the flagship's 16 convs); the bytes (input and
// output once, weights once) sit below that.  This first version stages
// with plain loads and block barriers; wgmma and TMA are later work.
//
// Requirements (checked by the wrapper and here): Cin % 16 == 0,
// Cout % 16 == 0, 1 <= Z <= 32.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TW = 16;           // output columns per block
constexpr int HW = TW + 2;       // halo columns
constexpr int BN = 64;           // output channels per block
constexpr int KC = 16;           // input channels per staged chunk
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;

struct Args {
  const void* x;  // (B, Y, X, Z, Cin)
  const void* w;  // (3, 3, 3, Cin, Cout)
  void* y;        // (B, Y, X, Z, Cout)
  int B, Y, X, Z, Cin, Cout, TY;
};

__host__ __device__ inline int halo_elems(int TY, int Z) {
  return (TY + 2) * HW * (Z + 2) * KC;
}

__host__ __device__ inline size_t bf16_smem(int TY, int Z) {
  return (size_t)halo_elems(TY, Z) * 2    // halo, bf16
         + (size_t)27 * KC * BN * 2       // weights of the chunk, bf16
         + (size_t)kWarps * 16 * 16 * 4;  // per-warp epilogue scratch
}

// MF: fragments per warp (ceil(TY * Z / 8) <= MF).
template <int MF>
__global__ void __launch_bounds__(kThreads) conv3d_bf16(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int TY = a.TY, Z = a.Z, ZP = a.Z + 2;
  bf16* halo = reinterpret_cast<bf16*>(smem);
  bf16* wsm = halo + halo_elems(TY, Z);
  float* scratch = reinterpret_cast<float*>(wsm + 27 * KC * BN);
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TY;
  const int ncb = (a.Cout + BN - 1) / BN;
  const int b = blockIdx.z / ncb, co0 = (blockIdx.z % ncb) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nfrag = TY * Z;
  const int nfr = min(BN, a.Cout - co0) / 16;  // live 16-channel fragments
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][BN / 16];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[m][n], 0.f);

  const int npix = (TY + 2) * HW * ZP;
  for (int k0 = 0; k0 < a.Cin; k0 += KC) {
    __syncthreads();  // every warp is done with the previous chunk
    // halo pixel p = (hy * HW + hx) * ZP + hz: two 16-byte vectors
    for (int e = threadIdx.x; e < npix * 2; e += kThreads) {
      const int p = e / 2, v = e % 2;
      const int hz = p % ZP, hx = (p / ZP) % HW, hy = p / (ZP * HW);
      const int iy = y0 - 1 + hy, ix = x0 - 1 + hx, iz = hz - 1;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (iy >= 0 && iy < a.Y && ix >= 0 && ix < a.X && iz >= 0 && iz < Z)
        q = *reinterpret_cast<const uint4*>(
            x + ((((int64_t)b * a.Y + iy) * a.X + ix) * Z + iz) * a.Cin + k0 +
            v * 8);
      reinterpret_cast<uint4*>(halo)[e] = q;
    }
    // weights: row r = tap * KC + kk, BN / 8 vectors
    for (int e = threadIdx.x; e < 27 * KC * (BN / 8); e += kThreads) {
      const int r = e / (BN / 8), v = e % (BN / 8);
      const int tap = r / KC, kk = r % KC;
      const int co = co0 + v * 8;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (co < a.Cout)
        q = *reinterpret_cast<const uint4*>(
            w + ((int64_t)tap * a.Cin + k0 + kk) * a.Cout + co);
      reinterpret_cast<uint4*>(wsm)[e] = q;
    }
    __syncthreads();
    for (int tap = 0; tap < 27; ++tap) {
      const int dy = tap / 9, dx = (tap / 3) % 3, dz = tap % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          fb[BN / 16];
#pragma unroll
      for (int n = 0; n < BN / 16; ++n)
        if (n < nfr)
          wmma::load_matrix_sync(fb[n], wsm + tap * KC * BN + n * 16, BN);
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        const int f = warp + m * kWarps;
        if (f >= nfrag) break;
        const int yl = f / Z, z = f % Z;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(
            fa, halo + (((yl + dy) * HW + dx) * ZP + z + dz) * KC, ZP * KC);
#pragma unroll
        for (int n = 0; n < BN / 16; ++n)
          if (n < nfr) wmma::mma_sync(acc[m][n], fa, fb[n], acc[m][n]);
      }
    }
  }

  // epilogue: each fragment through this warp's scratch, 8 channels a lane
  float* s = scratch + warp * 256;
  bf16* yout = static_cast<bf16*>(a.y);
  const int r = lane / 2, c8 = (lane % 2) * 8;
  const int ox = x0 + r;
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    const int f = warp + m * kWarps;
    if (f >= nfrag) break;
    const int oy = y0 + f / Z, z = f % Z;
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      if (n >= nfr) break;
      wmma::store_matrix_sync(s, acc[m][n], 16, wmma::mem_row_major);
      __syncwarp();
      if (oy < a.Y && ox < a.X) {
        uint4 q;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          h[j] = __floats2bfloat162_rn(s[r * 16 + c8 + 2 * j],
                                       s[r * 16 + c8 + 2 * j + 1]);
        *reinterpret_cast<uint4*>(
            yout + ((((int64_t)b * a.Y + oy) * a.X + ox) * Z + z) * a.Cout +
            co0 + n * 16 + c8) = q;
      }
      __syncwarp();
    }
  }
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

template <int MF>
int launch_bf16(const Args& a, cudaStream_t stream) {
  const size_t smem = bf16_smem(a.TY, a.Z);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_bf16<MF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.X + TW - 1) / TW, (a.Y + a.TY - 1) / a.TY,
                  a.B * ((a.Cout + BN - 1) / BN));
  conv3d_bf16<MF><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// is_bf16 selects the bf16 (WMMA) or the f32 kernel; x, w and y share it.
extern "C" int fbbev_conv3d(const void* x, const void* w, void* y,
                            int is_bf16, int B, int Y, int X, int Z,
                            int Cin, int Cout, void* stream) {
  if (Cin % 16 || Cout % 16 || Z < 1 || Z > 32 || B < 0 || Y < 0 || X < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Y == 0 || X == 0 || Cout == 0) return 0;
  const int TY = Z >= 8 ? 1 : 8 / Z;
  const Args a{x, w, y, B, Y, X, Z, Cin, Cout, TY};
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {
    const int64_t nvox = (int64_t)B * Y * X * Z;
    const dim3 grid((unsigned)((nvox + 15) / 16), (Cout / 4 + 15) / 16);
    conv3d_f32<<<grid, kThreads, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int mf = (TY * Z + kWarps - 1) / kWarps;
  if (mf <= 1) return launch_bf16<1>(a, s);
  if (mf <= 2) return launch_bf16<2>(a, s);
  return launch_bf16<4>(a, s);
}
