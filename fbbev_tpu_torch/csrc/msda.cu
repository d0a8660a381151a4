// Deformable-attention sampling: zero-padded bilinear sampling of a
// flattened (H*W, heads, hd) value map at P points per (query, head),
// summed with the attention weights -- mmcv's gather formulation.
//
// K3 replaces the TPU kernel fbbev_tpu/ops/pallas_sample.py::_attend
// (deformable_sample_attend_pallas, pl.pallas_call :139), which built a
// one-hot interpolation matrix in VMEM because the TPU gathers slowly;
// the same kernel serves the BEV self-attention (K4, fbbev_tpu/ops/
// pallas_selfattn.py:198).  loc = (x, y) in [0, 1], pixel coordinates
// x*W - 0.5 (grid_sample align_corners=False).  The weight tent_x *
// tent_y * attn is rounded to the value type before the product, as the
// TPU kernel rounds its one-hot to the value type; sums are f32, per
// channel over points, then corners, in order.
//
// Bound: bytes (value map, locations and weights read once, output written
// once); about 4 * P * 2 flops per output element.
//
// msda_kernel: one thread per (map b, query q, head h) keeps the head's hd
// sums in registers.  It reads its P locations and weights with 16-byte
// loads, computes each point's four corner weights once for all hd
// channels, and reads each corner's hd-channel head row as bf16 pairs
// (4 bytes; f32 pairs 8).  A corner outside the map reads its clamped
// cell with weight 0, so the 4 x hd / 2 reads of a point issue together.
// Threads run (q, h) with h fastest: a warp writes 4 queries' contiguous
// rows.  Staged (kStaged): when a whole map fits the plan's shared memory
// (the cross-attention's 704 x 80 bf16, 112,640 bytes), blocks_per_map
// persistent blocks are given one map each; each copies its map once into
// shared memory with one 1-D cp.async.bulk and walks tiles of its map's
// (q, h) pairs, the corner rows then read from shared memory.  Otherwise
// (the self-attention's 100 x 100 map, 1.6 MB, which sits in L2) each
// thread reads its rows from global memory through L1.  The plan is
// ops/pallas_sample.py::plan_msda; the entry refuses a shared-memory
// byte count other than the map's.
//
// fbbev_msda_corners (K10) is the same sum from precomputed corners: it
// replaces fbbev_tpu/ops/pallas_deform.py::pallas_deformable_sample_attend
// (pl.pallas_call :102), whose bilinear corners -- index clipped into the
// map, weight tent_x * tent_y * attn, zero outside it -- are computed
// outside the kernel: per point one 16-byte row of four int32 cells and
// one of four f32 weights.  It is the same msda_kernel, templated on where
// a point's corners come from (Src), with the same staging, persistent
// loop and sums; each weight is rounded to the value type as K3 rounds its
// own.  Bound: bytes, 85% of them the corner rows (50 MB at K3's
// cross-attention shapes), each read once by the one thread of its
// (query, head).  Read directly (kCorners), each 16-byte load of a warp
// touches 32 rows 128 bytes apart.  Through the ring (kRing) each warp
// copies the corner rows of its next tile of 32 pairs into a two-stage
// ring in shared memory beside the map with cp.async, 512 contiguous bytes
// an instruction, and each lane reads its own rows back from rows padded
// to an odd number of 16-byte units, so the lanes of a quarter warp hit
// eight different bank groups.  The plan (ops/pallas_deform.py::
// plan_corners) takes the ring where a pair has 8 points and at least 3
// warps' stages fit beside the staged map.

#include "tma_wgmma.cuh"

namespace {

__device__ __forceinline__ float round_to(float w, const float*) { return w; }
__device__ __forceinline__ float round_to(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

// Two channels of a bf16 pair held in a word: a bf16 is the top half of
// its f32, one shift or mask a channel.
__device__ __forceinline__ float2 bf16_pair(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Two channels of a head row as floats: a bf16 pair (4 bytes) or an f32
// pair (8 bytes).
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return bf16_pair(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

constexpr int kMsdaThreads = 512;  // the most a block of the plan takes
constexpr int kRingStages = 2;     // K10's ring: stages a warp

// Where a point's corners come from: K3's locations and weights, or
// K10's corner rows from global memory or from the warp's ring.
enum Src : int { kLoc = 0, kCorners = 1, kRing = 2 };

struct MsdaArgs {
  const void* value;   // (B, H*W, heads, hd)
  const float* loc;    // K3: (B, Q, heads, P, 2)
  const float* attn;   // K3: (B, Q, heads, P)
  const int4* idx;     // K10: (B, Q*heads*P) the four cells of a point
  const float4* wgt;   // K10: (B, Q*heads*P) their weights
  float* out;          // (B, Q, heads * hd)
  int B, H, W, Q, heads;
  int blocks_per_map;  // staged: persistent blocks of a map
};

// The head row of HD channels at p (4-byte aligned) as HD / 2 channel
// pairs, from global memory in the fewest 16-byte loads that cover it at
// any 4-byte offset (a load that would hold none of its bytes is not
// issued): the L1 then serves a bf16 row of 10 channels in 2 requests
// instead of 5.
template <typename T, int HD>
__device__ __forceinline__ void wide_row(const T* p, float2 (&v)[HD / 2]) {
  constexpr int RB = HD * sizeof(T);           // bytes of the row
  constexpr int NQ = (RB + 12 + 15) / 16;      // 16-byte loads
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint4* q = reinterpret_cast<const uint4*>(addr & ~(uintptr_t)15);
  const int o = (int)(addr & 15) >> 2;         // first word of the row
  uint32_t wd[4 * NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const uint4 u = i == 0 || 16 * i < 4 * o + RB ? __ldg(q + i)
                                                   : make_uint4(0, 0, 0, 0);
    wd[4 * i] = u.x;
    wd[4 * i + 1] = u.y;
    wd[4 * i + 2] = u.z;
    wd[4 * i + 3] = u.w;
  }
  uint32_t r[RB / 4];
#pragma unroll
  for (int j = 0; j < RB / 4; ++j)
    r[j] = o == 0 ? wd[j] : o == 1 ? wd[j + 1] : o == 2 ? wd[j + 2]
                                                         : wd[j + 3];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) {
    if constexpr (sizeof(T) == 2) {
      v[j] = bf16_pair(r[j]);
    } else {
      v[j] = make_float2(__uint_as_float(r[2 * j]),
                         __uint_as_float(r[2 * j + 1]));
    }
  }
}

// K3's points of (map b, query q, head h), row bq*heads+h: P locations
// and weights, in 16-byte loads.
template <int P>
struct LocPoints {
  float lc[2 * P], at[P];

  __device__ __forceinline__ void load(const MsdaArgs& a, int64_t row) {
#pragma unroll
    for (int i = 0; i < P / 2; ++i)
      *reinterpret_cast<float4*>(lc + 4 * i) =
          __ldg(reinterpret_cast<const float4*>(a.loc + 2 * row * P) + i);
#pragma unroll
    for (int i = 0; i < P / 4; ++i)
      *reinterpret_cast<float4*>(at + 4 * i) =
          __ldg(reinterpret_cast<const float4*>(a.attn + row * P) + i);
  }

  // The four corners of point p: cells clamped into the map, weights
  // tent_x * tent_y * attn rounded to T, 0 for a corner outside the map.
  template <typename T>
  __device__ __forceinline__ void corners(const MsdaArgs& a, int p,
                                          float (&w)[4],
                                          int (&cell)[4]) const {
    const int H = a.H, W = a.W;
    const float x = lc[2 * p] * W - 0.5f, y = lc[2 * p + 1] * H - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xi = x0 + (k & 1), yi = y0 + (k >> 1);
      const bool ok = xi >= 0.f && xi <= W - 1 && yi >= 0.f && yi <= H - 1;
      const float wt = (1.f - fabsf(x - xi)) * (1.f - fabsf(y - yi)) * at[p];
      w[k] = ok ? round_to(wt, static_cast<const T*>(nullptr)) : 0.f;
      cell[k] = (int)fminf(fmaxf(yi, 0.f), (float)(H - 1)) * W +
                (int)fminf(fmaxf(xi, 0.f), (float)(W - 1));
    }
  }
};

// A point's corner rows as cells and weights rounded to T.
template <typename T>
__device__ __forceinline__ void take(int4 k, float4 v, float (&w)[4],
                                     int (&cell)[4]) {
  const T* t = nullptr;
  cell[0] = k.x, cell[1] = k.y, cell[2] = k.z, cell[3] = k.w;
  w[0] = round_to(v.x, t), w[1] = round_to(v.y, t);
  w[2] = round_to(v.z, t), w[3] = round_to(v.w, t);
}

// K10's corner rows of one (query, head), in global memory.
struct CornerRows {
  const int4* idx;
  const float4* wgt;

  template <typename T>
  __device__ __forceinline__ void corners(const MsdaArgs&, int p,
                                          float (&w)[4],
                                          int (&cell)[4]) const {
    take<T>(__ldg(idx + p), __ldg(wgt + p), w, cell);
  }
};

// K10's ring: a stage holds a warp's 32 pairs' index rows, then their
// weight rows, each pair's P rows padded to ring_row bytes (an odd number
// of 16-byte units).
template <int P>
__host__ __device__ constexpr int ring_row() { return 16 * P + 16; }
template <int P>
__host__ __device__ constexpr int ring_stage() {
  return 2 * 32 * ring_row<P>();
}

// The corner rows of one lane's pair in a ring stage (shared memory).
struct RingRows {
  const int4* idx;
  const float4* wgt;

  template <typename T>
  __device__ __forceinline__ void corners(const MsdaArgs&, int p,
                                          float (&w)[4],
                                          int (&cell)[4]) const {
    take<T>(idx[p], wgt[p], w, cell);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// Copy the corner rows of pairs row0 .. row0 + 31, the first n of which
// exist, into the ring stage at dst: lane l copies 16-byte chunks l + 32 i
// (zeros past the n pairs), so each instruction of the warp moves 512
// contiguous bytes.  Commits one group, empty when n <= 0.
template <int P>
__device__ __forceinline__ void ring_fill(const MsdaArgs& a, uint32_t dst,
                                          int64_t row0, int64_t n,
                                          int lane) {
  if (n > 0) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lane + 32 * i, pr = c / P;
      const bool ok = pr < n;
      const int64_t src = ok ? row0 * P + c : 0;
      const uint32_t d = dst + pr * ring_row<P>() + (c % P) * 16;
      cp_async16(d, a.idx + src, ok);
      cp_async16(d + 32 * ring_row<P>(), a.wgt + src, ok);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The sums of (map b, query q, head h) -- row bq*heads+h, its points pts
// -- from the map `vb` (its first row): in shared memory (kStaged) as
// channel pairs, else from global memory (wide_row); written to out.
template <typename T, int HD, int P, bool kStaged, typename Pts>
__device__ __forceinline__ void attend(const T* vb, const MsdaArgs& a,
                                       int64_t row, int h, const Pts& pts) {
  const int C = a.heads * HD;
  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;
  const T* vh = vb + h * HD;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float w[4];
    int cell[4];
    pts.template corners<T>(a, p, w, cell);
    float2 v[4][HD / 2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kStaged) {
#pragma unroll
        for (int j = 0; j < HD / 2; ++j)
          v[k][j] = pair(vh + (int64_t)cell[k] * C + 2 * j);
      } else {
        wide_row<T, HD>(vh + (int64_t)cell[k] * C, v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) {
        acc[2 * j] += w[k] * v[k][j].x;
        acc[2 * j + 1] += w[k] * v[k][j].y;
      }
  }
  float* o = a.out + row * HD;
#pragma unroll
  for (int j = 0; j < HD / 2; ++j)
    *reinterpret_cast<float2*>(o + 2 * j) = make_float2(acc[2 * j],
                                                        acc[2 * j + 1]);
}

// Staged: block -> map blockIdx.x / blocks_per_map, its tiles of
// blockDim.x (q, h) pairs j, j + blocks_per_map, ...; K3's points are
// loaded one tile ahead, K10's rows directly or through the warp's ring
// (one tile ahead), the first while the map arrives.  Else one tile of the
// flattened (b, q, h) pairs a block.
template <typename T, int HD, int P, bool kStaged, int kSrc>
__global__ void __launch_bounds__(kMsdaThreads)
    msda_kernel(const MsdaArgs a) {
  static_assert(kStaged || kSrc != kRing, "the ring sits beside the map");
  const int64_t HWC = (int64_t)a.H * a.W * a.heads * HD;
  const int64_t pairs = (int64_t)a.Q * a.heads;  // of one map
  if constexpr (kStaged) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    const int b = blockIdx.x / a.blocks_per_map;
    const T* src = static_cast<const T*>(a.value) + b * HWC;
    const uint32_t bytes = (uint32_t)(HWC * sizeof(T));
    const uint32_t bar = smem_u32(smem_raw) + bytes;
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      mbar_expect_tx(bar, bytes);
      bulk_load(smem_u32(smem_raw), src, bytes, bar);
    }
    __syncthreads();
    const int64_t stride = (int64_t)a.blocks_per_map * blockDim.x;
    const int64_t first = (int64_t)(blockIdx.x % a.blocks_per_map) *
                              blockDim.x + threadIdx.x;
    const int64_t row0 = b * pairs;
    const T* map = reinterpret_cast<const T*>(smem_raw);
    if constexpr (kSrc == kLoc) {
      LocPoints<P> cur;
      if (first < pairs) cur.load(a, row0 + first);
      mbar_wait(bar, 0);
      for (int64_t i = first; i < pairs; i += stride) {
        LocPoints<P> next;
        if (i + stride < pairs) next.load(a, row0 + i + stride);
        attend<T, HD, P, true>(map, a, row0 + i, (int)(i % a.heads), cur);
        cur = next;
      }
    } else if constexpr (kSrc == kCorners) {
      mbar_wait(bar, 0);
      for (int64_t i = first; i < pairs; i += stride)
        attend<T, HD, P, true>(map, a, row0 + i, (int)(i % a.heads),
                               CornerRows{a.idx + (row0 + i) * P,
                                          a.wgt + (row0 + i) * P});
    } else {
      // the warp's tiles: 32 pairs from base, base + stride, ...
      const int lane = threadIdx.x & 31;
      uint8_t* ring = smem_raw + bytes + 16 +
                      (threadIdx.x >> 5) * kRingStages * ring_stage<P>();
      const int64_t base0 = first - lane;
#pragma unroll
      for (int s = 0; s + 1 < kRingStages; ++s)
        ring_fill<P>(a, smem_u32(ring + s * ring_stage<P>()),
                     row0 + base0 + s * stride, pairs - base0 - s * stride,
                     lane);
      mbar_wait(bar, 0);
      int s = 0;
      for (int64_t base = base0; base < pairs; base += stride) {
        const int64_t ahead = base + (kRingStages - 1) * stride;
        ring_fill<P>(a, smem_u32(ring + (s + kRingStages - 1) % kRingStages *
                                            ring_stage<P>()),
                     row0 + ahead, pairs - ahead, lane);
        asm volatile("cp.async.wait_group %0;" ::"n"(kRingStages - 1)
                     : "memory");
        __syncwarp();
        if (base + lane < pairs) {
          const uint8_t* r = ring + s * ring_stage<P>() +
                             lane * ring_row<P>();
          attend<T, HD, P, true>(
              map, a, row0 + base + lane, (int)((base + lane) % a.heads),
              RingRows{reinterpret_cast<const int4*>(r),
                       reinterpret_cast<const float4*>(
                           r + 32 * ring_row<P>())});
        }
        __syncwarp();  // the stage is refilled next
        s = (s + 1) % kRingStages;
      }
    }
  } else {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.B * pairs) return;
    const T* vb = static_cast<const T*>(a.value) + i / pairs * HWC;
    if constexpr (kSrc == kLoc) {
      LocPoints<P> pts;
      pts.load(a, i);
      attend<T, HD, P, false>(vb, a, i, (int)(i % a.heads), pts);
    } else {
      attend<T, HD, P, false>(vb, a, i, (int)(i % a.heads),
                              CornerRows{a.idx + i * P, a.wgt + i * P});
    }
  }
}

// The shared-memory bytes of a staged launch: the map, its mbarrier and,
// for the ring, kRingStages stages a warp.
template <typename T, int HD, int P, int kSrc>
int64_t staged_smem(const MsdaArgs& a, int threads) {
  return (int64_t)a.H * a.W * a.heads * HD * sizeof(T) + 16 +
         (kSrc == kRing ? (int64_t)(threads / 32) * kRingStages *
                              ring_stage<P>()
                        : 0);
}

template <typename T, int HD, int P, int kSrc>
int launch_hp(const MsdaArgs& a, int staged, int threads, int grid,
              int smem, cudaStream_t st) {
  if (staged) {
    if ((int64_t)a.H * a.W * a.heads * HD * sizeof(T) % 16 ||
        smem != staged_smem<T, HD, P, kSrc>(a, threads))
      return (int)cudaErrorInvalidValue;
    static uint64_t smem_set = 0;  // set once, for the most a block takes
    int r = allow_smem(msda_kernel<T, HD, P, true, kSrc>, 232448, smem_set);
    if (r != 0) return r;
    msda_kernel<T, HD, P, true, kSrc><<<grid, threads, smem, st>>>(a);
  } else if constexpr (kSrc != kRing) {
    if (smem != 0) return (int)cudaErrorInvalidValue;
    msda_kernel<T, HD, P, false, kSrc><<<grid, threads, 0, st>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The (hd, P) the kernel is instantiated for -- ops/pallas_sample.py::
// MSDA_SHAPES lists the same: the flagship's hd 10 and the small config's
// 8, each with the cross-attention's P 8 and the self-attention's 4.
template <typename T, int kSrc>
int launch(const MsdaArgs& a, int hd, int P, int staged, int threads,
           int grid, int smem, cudaStream_t st) {
#define FBBEV_MSDA_CASE(HD_, P_)                                          \
  if (hd == HD_ && P == P_)                                              \
    return launch_hp<T, HD_, P_, kSrc>(a, staged, threads, grid, smem, st);
  FBBEV_MSDA_CASE(10, 8) FBBEV_MSDA_CASE(10, 4)
  FBBEV_MSDA_CASE(8, 8) FBBEV_MSDA_CASE(8, 4)
#undef FBBEV_MSDA_CASE
  return (int)cudaErrorInvalidValue;
}

// The launch of either entry: checks, grid and type.
template <int kSrc>
int launch_any(const MsdaArgs& a, int is_bf16, int hd, int P, int staged,
               int threads, int smem, void* stream) {
  if (((uintptr_t)a.value | (uintptr_t)a.loc | (uintptr_t)a.attn |
       (uintptr_t)a.idx | (uintptr_t)a.wgt | (uintptr_t)a.out) % 16 ||
      a.B < 0 || a.H <= 0 || a.W <= 0 || a.Q < 0 || a.heads <= 0 ||
      threads <= 0 || threads > kMsdaThreads || threads % 32 ||
      a.blocks_per_map <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t pairs = (int64_t)a.B * a.Q * a.heads;
  if (pairs == 0) return 0;
  const int64_t grid = staged ? (int64_t)a.B * a.blocks_per_map
                              : (pairs + threads - 1) / threads;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16, kSrc>(a, hd, P, staged, threads, (int)grid,
                                       smem, st);
  return launch<float, kSrc>(a, hd, P, staged, threads, (int)grid, smem, st);
}

}  // namespace

// value (B, H*W, heads, hd) bf16 (is_bf16=1) or f32; loc (B, Q, heads, P,
// 2) f32; attn (B, Q, heads, P) f32; out (B, Q, heads*hd) f32; every
// pointer 16-byte aligned.  The plan: staged (1) or not, threads a block
// (<= 512, a multiple of 32), the grid (staged: B * blocks_per_map) and
// the shared-memory bytes (staged: the map's + 16, else 0).
extern "C" int fbbev_msda(const void* value, const float* loc,
                          const float* attn, float* out, int is_bf16, int B,
                          int H, int W, int Q, int heads, int P, int hd,
                          int staged, int threads, int blocks_per_map,
                          int smem, void* stream) {
  const MsdaArgs a{value, loc, attn, nullptr, nullptr, out, B, H, W, Q,
                   heads, blocks_per_map};
  return launch_any<kLoc>(a, is_bf16, hd, P, staged, threads, smem, stream);
}

// value (B, HW, heads, hd) bf16 (is_bf16=1) or f32; idx (B, Q*heads*P, 4)
// int32 in [0, HW); wgt (B, Q*heads*P, 4) f32; out (B, Q, heads*hd) f32;
// every pointer 16-byte aligned.  The plan as fbbev_msda's, and ring (1):
// the corner rows through each warp's ring (staged only; smem then also
// holds threads / 32 * 2 stages of 2 * 32 * (16 P + 16) bytes).
extern "C" int fbbev_msda_corners(const void* value, const void* idx,
                                  const void* wgt, float* out, int is_bf16,
                                  int B, int HW, int Q, int heads, int P,
                                  int hd, int staged, int ring, int threads,
                                  int blocks_per_map, int smem,
                                  void* stream) {
  const MsdaArgs a{value, nullptr, nullptr, static_cast<const int4*>(idx),
                   static_cast<const float4*>(wgt), out, B, HW, 1, Q, heads,
                   blocks_per_map};
  return ring ? launch_any<kRing>(a, is_bf16, hd, P, staged, threads, smem,
                                  stream)
              : launch_any<kCorners>(a, is_bf16, hd, P, staged, threads,
                                     smem, stream);
}
