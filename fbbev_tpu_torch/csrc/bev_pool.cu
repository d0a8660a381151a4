// LSS voxel pooling over a fixed rig (K2): one pass that writes every
// output row once.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_pool.py::_pool_slabs
// (lss_voxel_pool_planned, pl.pallas_call :169).  Function: for every
// valid frustum point p,
//     out[row(p), c] += depth[p] * feat[pixel(p), c],
// out (B, Y, X, Z, C) f32; feat f32, or bf16 widened exactly to f32 (the
// JAX wrapper casts it so before its kernel).
//
// Bound: bytes.  At the flagship the output alone (80,000 rows x 80 f32,
// 25.6 MB) is 84% of the bytes, the depth and feature tables most of the
// rest: about 9 us at 3.35 TB/s.  So every row is written exactly once,
// empty rows with zeros (no zero fill before the kernel), 16 bytes a
// thread.  What the bytes alone do not show: the feature rows are
// gathered (68 MB of L2 reads in f32 at the flagship, every point's row
// once), and each point's address comes from two dependent loads, so the
// kernel is bound by how many loads it keeps in flight.
//
// The plan (fbbev_tpu_torch/ops/pallas_pool.py::plan_pool, built once per
// rig) sorts the valid points by output row: row_ptr over all rows, pts
// the sorted flat depth indices (a point's feature row is derived here from
// its depth index), and the work: tiles of at most 31 consecutive rows and
// a few dozen points, heaviest first, each packed as first row << 5 | rows.
// One warp walks a tile with its lanes over groups of 4 channels: per 32
// points the lanes load the point indices, feature rows and depths
// coalesced, one a lane; then the warp issues kAhead 16-byte feature loads
// (8 bytes in bf16) before it sums them in point order, passing each point
// to every lane by a shuffle and writing each row when its last point is
// summed.  A tile's rows are contiguous, so its stores are whole sectors.
// Rows hold 2 points at the median but up to 169 at the flagship, and a
// warp's walk is a chain of dependent loads as long as its points: a row
// with more points than a tile takes is a tile alone, walked by a whole
// block, kWarps consecutive ranges of its points summed by one warp each
// and added in order through shared memory.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kAhead = 4;  // feature rows a warp loads before it sums
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // also the ranges of a long row
constexpr unsigned kAll = 0xffffffffu;

struct PoolArgs {
  const float* depth;      // (B*N*D*NR,) f32
  const void* feat;        // (B*N*NR, C) f32 or bf16
  const int32_t* row_ptr;  // (rows + 1,)
  const int32_t* pts;      // (Pv,) flat depth index, by row
  const int32_t* work;     // (n_work,) first row << 5 | rows of each tile
  float* out;              // (rows, C) f32
  int n_work, n_long, C4;
  uint32_t dnr, nr;        // D * NR, NR
  uint64_t m_dnr, m_nr;    // their reciprocals (recip)
};

// n / d as one high multiply by m = recip(d) (0 for d = 1): exact for
// 32-bit n and d, since m * d - 2^64 < d.
inline uint64_t recip(uint32_t d) { return d > 1 ? ~0ull / d + 1 : 0; }
__device__ __forceinline__ uint32_t quot(uint32_t n, uint32_t d,
                                         uint64_t m) {
  return d > 1 ? (uint32_t)__umul64hi(n, m) : n;
}

// Channels 4 cg .. 4 cg + 3 of a feature row as f32.
__device__ __forceinline__ float4 load4(const float* row, int cg) {
  return __ldg(reinterpret_cast<const float4*>(row) + cg);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int cg) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + cg);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void add(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// The warp's walk over rows orow[0 .. nrows - 1] (lane i <= nrows holds the
// start of row i in bnd; lane nrows the end of the last): sums depth * feat
// of each row's points in order and writes every row whose last point it
// has summed.  Returns the sum of the row r it ends in.
template <typename T>
__device__ __forceinline__ float4 walk(const PoolArgs& a, int bnd,
                                       int nrows, float4* orow, int& r) {
  const T* feat = static_cast<const T*>(a.feat);
  const int lane = threadIdx.x & 31, C = 4 * a.C4;
  const bool on = lane < a.C4;
  const int end = __shfl_sync(kAll, bnd, nrows);
  int next = __shfl_sync(kAll, bnd, 1);  // row r ends at next
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = __shfl_sync(kAll, bnd, 0); k0 < end; k0 += 32) {
    const int n = min(32, end - k0);
    uint32_t frow = 0;
    float dl = 0.f;
    if (lane < n) {
      const uint32_t p = (uint32_t)__ldg(a.pts + k0 + lane);
      frow = quot(p, a.dnr, a.m_dnr) * a.nr + (p - quot(p, a.nr, a.m_nr) *
                                                      a.nr);
      dl = __ldg(a.depth + p);
    }
    for (int u0 = 0; u0 < n; u0 += kAhead) {
      float4 f[kAhead];
      float d[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const uint32_t fr = __shfl_sync(kAll, frow, (u0 + u) & 31);
        d[u] = __shfl_sync(kAll, dl, (u0 + u) & 31);
        f[u] = on && u0 + u < n ? load4(feat + (size_t)fr * C, lane)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (u0 + u < n) {
          while (k0 + u0 + u >= next) {  // row r is complete
            if (on) orow[(size_t)r * a.C4] = acc;
            acc = make_float4(0.f, 0.f, 0.f, 0.f);
            ++r;
            next = __shfl_sync(kAll, bnd, r + 1);
          }
          add(acc, make_float4(d[u] * f[u].x, d[u] * f[u].y, d[u] * f[u].z,
                               d[u] * f[u].w));
        }
      }
    }
  }
  return acc;
}

// Blocks 0 .. n_long - 1: one long row each, its points cut into kWarps
// consecutive ranges, one a warp, whose sums warp 0 adds in order.  The
// other blocks: a tile a warp, work[n_long + ...].
template <typename T>
__global__ void __launch_bounds__(kThreads) bev_pool_kernel(
    const PoolArgs a) {
  __shared__ float4 part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const bool split = (int)blockIdx.x < a.n_long;
  const int w = split ? blockIdx.x
                      : a.n_long + (blockIdx.x - a.n_long) * kWarps + warp;
  if (w >= a.n_work) return;  // a whole warp of the last tile block
  const int wk = __ldg(a.work + w), r0 = wk >> 5, nrows = wk & 31;
  int bnd = lane <= nrows ? __ldg(a.row_ptr + r0 + lane) : 0;
  if (split) {
    const int s = __shfl_sync(kAll, bnd, 0);
    const int n = __shfl_sync(kAll, bnd, 1) - s;
    const int per = (n + kWarps - 1) / kWarps;
    bnd = s + min(n, (warp + (lane > 0)) * per);
  }
  float4* orow = reinterpret_cast<float4*>(a.out) + (size_t)r0 * a.C4 + lane;
  int r = 0;
  float4 acc = walk<T>(a, bnd, nrows, orow, r);
  if (split) {
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && lane < a.C4) {
      acc = part[0][lane];
      for (int i = 1; i < kWarps; ++i) add(acc, part[i][lane]);
      *orow = acc;
    }
    return;
  }
  // the row of the last point, then the empty rows after it
  for (; r < nrows; ++r) {
    if (lane < a.C4) orow[(size_t)r * a.C4] = acc;
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// depth f32, feat f32 or bf16 (is_bf16 = 1), out f32 (16-byte aligned,
// feat 16 in f32, 8 in bf16); C a multiple of 4, at most 128; work the
// plan's tiles, the first n_long of them a long row each; dnr = D * NR and
// nr = NR the divisors of a point's flat depth index.
extern "C" int fbbev_bev_pool(const float* depth, const void* feat,
                              const int32_t* row_ptr, const int32_t* pts,
                              const int32_t* work, float* out, int is_bf16,
                              int n_work, int n_long, int C, int dnr, int nr,
                              void* stream) {
  if (C <= 0 || C % 4 || C > 128 || dnr <= 0 || nr <= 0 || n_work < 0 ||
      n_long < 0 || n_long > n_work || (uintptr_t)out % 16 ||
      (uintptr_t)feat % (is_bf16 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  if (n_work == 0) return 0;
  const PoolArgs a{depth, feat, row_ptr, pts, work, out, n_work, n_long,
                   C / 4, (uint32_t)dnr, (uint32_t)nr, recip(dnr),
                   recip(nr)};
  const int blocks = n_long + (n_work - n_long + kWarps - 1) / kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    bev_pool_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(a);
  else
    bev_pool_kernel<float><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
