// SoloFusion history front end: affine trilinear warp of the ring-slot
// history, sequence-start reset, oldest-slot overwrite and, optionally,
// the fused time-conv / cat-conv epilogue (K1); and the same warp alone on
// an age-ordered history (K5).
//
// K1 replaces the TPU kernel fbbev_tpu/ops/pallas_fuse_warp.py::_body
// (fuse_warp, pl.pallas_call at :392 with the epilogue, :425 without).
// Per output voxel (b, z, y, x) the flow matrix gives source index coords
// (align_corners=True units); the 8 corners' contiguous T*C rows of the
// z-major history are read, weighted by the tent product rounded to the
// history type, and summed in f32.  Zero outside the volume.  Then
//   warped  = warped * (1 - start) + curr * start
//   newhist = slot t == hsel ? curr : warped        (written, bf16)
// and without the epilogue the warped slots are written; with it, per slot
//   y1   = relu(bf16(warped_t) @ kc + tvec_t * ke + kb)
//   acc += bf16(y1) @ ws[t]                          (fused, f32)
// so the T*C-channel slots never reach device memory.  The two products
// run on the tensor cores (WMMA bf16, f32 accumulate).  The TPU's slab
// DMAs, (8, 128) padding and tiling are not carried over: the card
// gathers the corner rows directly and its caches hold the neighbours.
//
// K5 replaces fbbev_tpu/ops/pallas_warp.py::warp_affine_3d (_warp_kernel,
// pl.pallas_call at :234, out_zyx=False): the warp stage alone (kRing
// off), bf16 or f32, of a (B, Z, Y, X, C) volume into (B, Y, X, Z, C) --
// no start reset, no new history, no epilogue.  It is launched as one
// slot of C channels.
//
// Block: 64 consecutive voxels of one sample in (z, y, x) order, 4 warps,
// warp w owns rows 16w..16w+15 through every phase, so only the staging
// of ws[t] (shared by the warps) needs block barriers.  Each lane reads
// 16-byte channel vectors of a corner row: a warp reads 512 contiguous
// bytes of it.
//
// Bound: bytes -- the history is read once and the new history (K1) or
// the warped volume (K5) written once (2 x 205 MB in bf16 at the
// flagship); K1's epilogue, 49 GFLOP, sits below that on the tensor cores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kRows = 64;
constexpr int kThreads = 128;

// A 16-byte vector of T as floats, and the rounding of a weight to T.
template <typename T> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static float round(float w) {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
  __device__ static void unpack(uint4 q, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(h[j]);
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    return q;
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static float round(float w) { return w; }
  __device__ static void unpack(uint4 q, float* f) {
    f[0] = __uint_as_float(q.x);
    f[1] = __uint_as_float(q.y);
    f[2] = __uint_as_float(q.z);
    f[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

struct Args {
  const void* hist;   // (B, Z, Y, X, T*C)
  const void* curr;   // (B, Y, X, Z, C), ring update only
  const float* mat;   // (B, 12) rows 0..2 of the 4x4 flow
  const float* start; // (B,) 0 or 1, ring update only
  const int32_t* hsel;  // (B,) slot overwritten by curr, ring update only
  const bf16* kc;     // (C, C) folded time conv
  const float* brow;  // (B, T, C) tvec * ke + kb
  const bf16* ws;     // (B, T*C, F) cat-conv rows in ring-slot order
  void* new_hist;     // (B, Z, Y, X, T*C), ring update only
  void* slots;        // (B, Y, X, Z, T*C), no epilogue
  float* fused;       // (B, Y, X, Z, F), epilogue
  int Z, Y, X, C, T, F;
};

__host__ __device__ inline size_t epi_smem(int C, int F) {
  return (size_t)kRows * 8 * 8          // corner rows + weights
         + (size_t)kRows * C * 2        // A: warped slot / relu'd y1, bf16
         + (size_t)kRows * C * 4        // Y1: time-conv output, f32
         + (size_t)C * C * 2            // kc
         + (size_t)C * F * 2            // ws[t]
         + (size_t)kRows * F * 4;       // cat-conv accumulator, f32
}

// kEpi: K1's conv epilogue (T = bf16, kRing).  kRing: K1's ring update;
// off, the warp alone (K5).
template <typename T, bool kEpi, bool kRing>
__global__ void __launch_bounds__(kThreads) fuse_warp_kernel(Args a) {
  static_assert(!kEpi || (kRing && sizeof(T) == 2), "epilogue is K1's");
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const T* hist = static_cast<const T*>(a.hist);
  const int b = blockIdx.y;
  const int Z = a.Z, Y = a.Y, X = a.X, C = a.C, T_ = a.T, F = a.F;
  const int V = Z * Y * X;
  const int TC = T_ * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;                 // this warp's first row
  const int v0 = blockIdx.x * kRows;

  int* crow = reinterpret_cast<int*>(smem);           // [kRows][8]
  float* cw = reinterpret_cast<float*>(crow + kRows * 8);
  bf16* A = reinterpret_cast<bf16*>(cw + kRows * 8);  // [kRows][C]
  float* Y1 = reinterpret_cast<float*>(A + kRows * C);
  bf16* KC = reinterpret_cast<bf16*>(Y1 + kRows * C);
  bf16* WS = KC + C * C;
  float* ACC = reinterpret_cast<float*>(WS + C * F);

  if (kEpi) {
    for (int e = threadIdx.x; e < C * C; e += kThreads) KC[e] = a.kc[e];
    for (int e = threadIdx.x; e < kRows * F; e += kThreads) ACC[e] = 0.f;
  }

  // corner rows and weights of this warp's voxels
  const float* m = a.mat + b * 12;
  if (lane < 16) {
    const int r = r0 + lane, v = v0 + r;
    for (int k = 0; k < 8; ++k) {
      crow[r * 8 + k] = -1;
      cw[r * 8 + k] = 0.f;
    }
    if (v < V) {
      const float gx = (float)(v % X), gy = (float)((v / X) % Y);
      const float gz = (float)(v / (X * Y));
      const float xs = m[0] * gx + m[1] * gy + m[3] + m[2] * gz;
      const float ys = m[4] * gx + m[5] * gy + m[7] + m[6] * gz;
      const float zs = m[8] * gx + m[9] * gy + m[11] + m[10] * gz;
      const float x0 = floorf(xs), y0 = floorf(ys), z0 = floorf(zs);
      for (int k = 0; k < 8; ++k) {
        const float ix = x0 + (k & 1), iy = y0 + ((k >> 1) & 1);
        const float iz = z0 + (k >> 2);
        if (ix < 0.f || ix > X - 1 || iy < 0.f || iy > Y - 1 || iz < 0.f ||
            iz > Z - 1)
          continue;
        const float w = (1.f - fabsf(xs - ix)) * (1.f - fabsf(ys - iy)) *
                        (1.f - fabsf(zs - iz));
        crow[r * 8 + k] = ((b * Z + (int)iz) * Y + (int)iy) * X + (int)ix;
        cw[r * 8 + k] = Vec<T>::round(w);
      }
    }
  }
  __syncthreads();

  const float s = kRing ? a.start[b] : 0.f;
  const int hsel = kRing ? a.hsel[b] : -1;
  const int nvec = C / VN;  // 16-byte vectors per slot row
  for (int t = 0; t < T_; ++t) {
    if (kEpi) {
      __syncthreads();  // every warp is done with ws[t-1]
      const uint4* src = reinterpret_cast<const uint4*>(
          a.ws + ((int64_t)b * TC + (int64_t)t * C) * F);
      for (int e = threadIdx.x; e < C * F / 8; e += kThreads)
        reinterpret_cast<uint4*>(WS)[e] = src[e];
    }
    const float mk = (t == hsel) ? 1.f : 0.f;
    for (int e = lane; e < 16 * nvec; e += 32) {
      const int r = r0 + e / nvec, cv = e % nvec;
      const int v = v0 + r;
      float acc[VN] = {};
      if (v >= V) {
        if (kEpi)
          for (int j = 0; j < VN; ++j)
            A[r * C + cv * VN + j] = __float2bfloat16_rn(0.f);
        continue;
      }
      for (int k = 0; k < 8; ++k) {
        const int row = crow[r * 8 + k];
        if (row < 0) continue;
        const float w = cw[r * 8 + k];
        float f[VN];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                           hist + (int64_t)row * TC + t * C + cv * VN),
                       f);
#pragma unroll
        for (int j = 0; j < VN; ++j) acc[j] += w * f[j];
      }
      const int x = v % X, y = (v / X) % Y, z = v / (X * Y);
      const int64_t vox = (((int64_t)b * Y + y) * X + x) * Z + z;
      if (kRing) {
        float cf[VN], hv[VN];
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                           static_cast<const T*>(a.curr) + vox * C + cv * VN),
                       cf);
#pragma unroll
        for (int j = 0; j < VN; ++j) {
          const float w0 = acc[j] * (1.f - s) + cf[j] * s;
          hv[j] = w0 * (1.f - mk) + cf[j] * mk;
          acc[j] = w0;
        }
        *reinterpret_cast<uint4*>(static_cast<T*>(a.new_hist) +
                                  ((int64_t)b * V + v) * TC + t * C +
                                  cv * VN) = Vec<T>::pack(hv);
      }
      const uint4 wq = Vec<T>::pack(acc);
      if (kEpi)
        *reinterpret_cast<uint4*>(A + r * C + cv * VN) = wq;
      else
        *reinterpret_cast<uint4*>(static_cast<T*>(a.slots) + vox * TC +
                                  t * C + cv * VN) = wq;
    }
    if constexpr (kEpi) {
      __syncthreads();  // ws[t] staged; A rows written

      // y1 = A @ kc for this warp's 16 rows
      for (int j = 0; j < C / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> y;
        wmma::fill_fragment(y, 0.f);
        for (int kk = 0; kk < C / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, A + r0 * C + kk * 16, C);
          wmma::load_matrix_sync(fb, KC + kk * 16 * C + j * 16, C);
          wmma::mma_sync(y, fa, fb, y);
        }
        wmma::store_matrix_sync(Y1 + r0 * C + j * 16, y, C,
                                wmma::mem_row_major);
      }
      __syncwarp();
      const float* br = a.brow + ((int64_t)b * T_ + t) * C;
      for (int e = lane; e < 16 * C; e += 32) {
        const int r = r0 + e / C, c = e % C;
        A[r * C + c] = __float2bfloat16_rn(fmaxf(Y1[r * C + c] + br[c], 0.f));
      }
      __syncwarp();
      // acc += relu'd y1 @ ws[t]
      for (int j = 0; j < F / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, ACC + r0 * F + j * 16, F,
                               wmma::mem_row_major);
        for (int kk = 0; kk < C / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, A + r0 * C + kk * 16, C);
          wmma::load_matrix_sync(fb, WS + kk * 16 * F + j * 16, F);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(ACC + r0 * F + j * 16, acc, F,
                                wmma::mem_row_major);
      }
    }
  }
  if constexpr (kEpi) {
    __syncwarp();
    for (int e = lane; e < 16 * (F / 4); e += 32) {
      const int r = r0 + e / (F / 4), c4 = e % (F / 4);
      const int v = v0 + r;
      if (v >= V) continue;
      const int x = v % X, y = (v / X) % Y, z = v / (X * Y);
      const int64_t vox = (((int64_t)b * Y + y) * X + x) * Z + z;
      reinterpret_cast<float4*>(a.fused + vox * F)[c4] =
          reinterpret_cast<const float4*>(ACC + r * F)[c4];
    }
  }
}

}  // namespace

extern "C" size_t fbbev_fuse_warp_smem(int C, int F) { return epi_smem(C, F); }

// K1.  kc == nullptr selects the variant without the epilogue (slots
// written).  bf16 history and curr.
extern "C" int fbbev_fuse_warp(const void* hist, const void* curr,
                               const float* mat, const float* start,
                               const int32_t* hsel, const void* kc,
                               const float* brow, const void* ws,
                               void* new_hist, void* slots, float* fused,
                               int B, int Z, int Y, int X, int C, int T,
                               int F, void* stream) {
  Args a{hist, curr, mat, start, hsel, (const bf16*)kc, brow,
         (const bf16*)ws, new_hist, slots, fused, Z, Y, X, C, T, F};
  const int V = Z * Y * X;
  const dim3 grid((V + kRows - 1) / kRows, B);
  if (B == 0 || V == 0) return 0;
  if (kc != nullptr) {
    const size_t smem = epi_smem(C, F);
    cudaError_t err = cudaFuncSetAttribute(
        fuse_warp_kernel<bf16, true, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fuse_warp_kernel<bf16, true, true>
        <<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  } else {
    fuse_warp_kernel<bf16, false, true>
        <<<grid, kThreads, kRows * 8 * 8, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// K5: vol (B, Z, Y, X, C) -> out (B, Y, X, Z, C), bf16 (is_bf16) or f32;
// C a multiple of 8.
extern "C" int fbbev_warp_affine(const void* vol, const float* mat,
                                 void* out, int is_bf16, int B, int Z, int Y,
                                 int X, int C, void* stream) {
  if (C % 8 || B < 0 || Z < 0 || Y < 0 || X < 0)
    return (int)cudaErrorInvalidValue;
  Args a{vol, nullptr, mat, nullptr, nullptr, nullptr, nullptr, nullptr,
         nullptr, out, nullptr, Z, Y, X, C, 1, 0};
  const int V = Z * Y * X;
  if (B == 0 || V == 0 || C == 0) return 0;
  const dim3 grid((V + kRows - 1) / kRows, B);
  if (is_bf16)
    fuse_warp_kernel<bf16, false, false>
        <<<grid, kThreads, kRows * 8 * 8, (cudaStream_t)stream>>>(a);
  else
    fuse_warp_kernel<float, false, false>
        <<<grid, kThreads, kRows * 8 * 8, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
