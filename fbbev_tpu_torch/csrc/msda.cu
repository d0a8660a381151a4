// Deformable-attention sampling: zero-padded bilinear sampling of a
// flattened (H*W, heads, hd) value map at P points per (query, head),
// summed with the attention weights -- mmcv's gather formulation.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_sample.py::_attend
// (deformable_sample_attend_pallas), which built a one-hot interpolation
// matrix in VMEM because the TPU gathers slowly; the H100 gathers rows at
// full speed, so each thread here reads its four corners directly.
// One thread per (map, query, channel); loc = (x, y) in [0, 1], pixel
// coordinates x*W - 0.5 (grid_sample align_corners=False).  The weight
// tent_x * tent_y * attn is rounded to the value type before the product,
// as the TPU kernel rounds its one-hot to the value type; sums are f32.
//
// Bound: bytes (value map, locations and weights read once, output written
// once); about 4 * P * 2 flops per output element.
//
// fbbev_msda_corners is the same sum from precomputed corners: it
// replaces fbbev_tpu/ops/pallas_deform.py::pallas_deformable_sample_attend
// (pl.pallas_call :102), whose bilinear corners -- index clipped into the
// map, weight tent_x * tent_y * attn, zero outside it -- are computed
// outside the kernel.  Each thread reads a sample's four (index, weight)
// pairs as one 16-byte int4 and one float4 (the threads of a head share
// the rows) and rounds each weight to the value type at the point K3 does.
// Bound: bytes (value map, corner rows and output once).

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
// outside the kernel.  One thread per (map, query, channel) reads a
// sample's four (index, weight) pairs as one 16-byte int4 and one float4
// (the threads of a head share the rows) and rounds each weight to the
// value type at the point K3 does.  Bound: bytes (value map, corner rows
// and output once).

#include "tma_wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
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

struct MsdaArgs {
  const void* value;  // (B, H*W, heads, hd)
  const float* loc;   // (B, Q, heads, P, 2)
  const float* attn;  // (B, Q, heads, P)
  float* out;         // (B, Q, heads * hd)
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

// The P locations and weights of (map b, query q, head h), row bq*heads+h,
// in 16-byte loads.
template <int P>
__device__ __forceinline__ void load_points(const MsdaArgs& a, int64_t row,
                                            float (&lc)[2 * P],
                                            float (&at)[P]) {
#pragma unroll
  for (int i = 0; i < P / 2; ++i)
    *reinterpret_cast<float4*>(lc + 4 * i) =
        __ldg(reinterpret_cast<const float4*>(a.loc + 2 * row * P) + i);
#pragma unroll
  for (int i = 0; i < P / 4; ++i)
    *reinterpret_cast<float4*>(at + 4 * i) =
        __ldg(reinterpret_cast<const float4*>(a.attn + row * P) + i);
}

// The sums of (map b, query q, head h) -- row bq*heads+h, its points lc,
// at -- from the map `vb` (its first row): in shared memory (kStaged) as
// channel pairs, else from global memory (wide_row); written to out.
template <typename T, int HD, int P, bool kStaged>
__device__ __forceinline__ void attend(const T* vb, const MsdaArgs& a,
                                       int64_t row, int h,
                                       const float (&lc)[2 * P],
                                       const float (&at)[P]) {
  const int H = a.H, W = a.W, C = a.heads * HD;
  float acc[HD];
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;
  const T* vh = vb + h * HD;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float x = lc[2 * p] * W - 0.5f, y = lc[2 * p + 1] * H - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    float w[4];
    int cell[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xi = x0 + (k & 1), yi = y0 + (k >> 1);
      const bool ok = xi >= 0.f && xi <= W - 1 && yi >= 0.f && yi <= H - 1;
      const float wt = (1.f - fabsf(x - xi)) * (1.f - fabsf(y - yi)) * at[p];
      w[k] = ok ? round_to(wt, vb) : 0.f;
      cell[k] = (int)fminf(fmaxf(yi, 0.f), (float)(H - 1)) * W +
                (int)fminf(fmaxf(xi, 0.f), (float)(W - 1));
    }
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
// blockDim.x (q, h) pairs j, j + blocks_per_map, ...  Else one tile of
// the flattened (b, q, h) pairs a block.
template <typename T, int HD, int P, bool kStaged>
__global__ void __launch_bounds__(kMsdaThreads)
    msda_kernel(const MsdaArgs a) {
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
    // each tile's points are loaded one tile ahead, the first while the
    // map arrives
    const int64_t stride = (int64_t)a.blocks_per_map * blockDim.x;
    int64_t i = (int64_t)(blockIdx.x % a.blocks_per_map) * blockDim.x +
                threadIdx.x;
    float lc[2 * P], at[P];
    if (i < pairs) load_points<P>(a, b * pairs + i, lc, at);
    mbar_wait(bar, 0);
    const T* map = reinterpret_cast<const T*>(smem_raw);
    for (; i < pairs; i += stride) {
      float lc2[2 * P], at2[P];
      if (i + stride < pairs) load_points<P>(a, b * pairs + i + stride, lc2,
                                             at2);
      attend<T, HD, P, true>(map, a, b * pairs + i, (int)(i % a.heads), lc,
                             at);
#pragma unroll
      for (int j = 0; j < 2 * P; ++j) lc[j] = lc2[j];
#pragma unroll
      for (int j = 0; j < P; ++j) at[j] = at2[j];
    }
  } else {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.B * pairs) return;
    float lc[2 * P], at[P];
    load_points<P>(a, i, lc, at);
    attend<T, HD, P, false>(
        static_cast<const T*>(a.value) + i / pairs * HWC, a, i,
        (int)(i % a.heads), lc, at);
  }
}

// One thread per (map, query, channel); idx / wgt rows are the samples
// (q, h, p) of map b in that order, four corners each.
template <typename T>
__global__ void msda_corners_kernel(const T* __restrict__ value,
                                    const int4* __restrict__ idx,
                                    const float4* __restrict__ wgt,
                                    float* __restrict__ out, int64_t total,
                                    int HW, int Q, int heads, int P,
                                    int hd) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int C = heads * hd;
  const int c = (int)(i % C);
  const int64_t bq = i / C;            // b * Q + q
  const int64_t b = bq / Q;
  const int h = c / hd;
  const int64_t row = (bq * heads + h) * P;
  const T* vb = value + b * (int64_t)HW * C + c;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const int4 k = idx[row + p];
    const float4 w = wgt[row + p];
    acc += round_to(w.x, vb) * to_f32(vb[(int64_t)k.x * C]);
    acc += round_to(w.y, vb) * to_f32(vb[(int64_t)k.y * C]);
    acc += round_to(w.z, vb) * to_f32(vb[(int64_t)k.z * C]);
    acc += round_to(w.w, vb) * to_f32(vb[(int64_t)k.w * C]);
  }
  out[i] = acc;
}

template <typename T, int HD, int P>
int launch_hp(const MsdaArgs& a, int staged, int threads, int grid,
              int smem, cudaStream_t st) {
  if (staged) {
    const int64_t bytes = (int64_t)a.H * a.W * a.heads * HD * sizeof(T);
    if (bytes % 16 || smem != bytes + 16) return (int)cudaErrorInvalidValue;
    static uint64_t smem_set = 0;  // set once, for the most a block takes
    int r = allow_smem(msda_kernel<T, HD, P, true>, 232448, smem_set);
    if (r != 0) return r;
    msda_kernel<T, HD, P, true><<<grid, threads, smem, st>>>(a);
  } else {
    if (smem != 0) return (int)cudaErrorInvalidValue;
    msda_kernel<T, HD, P, false><<<grid, threads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// The (hd, P) K3 is instantiated for -- ops/pallas_sample.py::MSDA_SHAPES
// lists the same: the flagship's hd 10 and the small config's 8, each with
// the cross-attention's P 8 and the self-attention's 4.
template <typename T>
int launch(const MsdaArgs& a, int hd, int P, int staged, int threads,
           int grid, int smem, cudaStream_t st) {
#define FBBEV_MSDA_CASE(HD_, P_)                                         \
  if (hd == HD_ && P == P_)                                             \
    return launch_hp<T, HD_, P_>(a, staged, threads, grid, smem, st);
  FBBEV_MSDA_CASE(10, 8) FBBEV_MSDA_CASE(10, 4)
  FBBEV_MSDA_CASE(8, 8) FBBEV_MSDA_CASE(8, 4)
#undef FBBEV_MSDA_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_corners(const void* value, const void* idx, const void* wgt,
                   float* out, int B, int HW, int Q, int heads, int P,
                   int hd, void* stream) {
  const int64_t total = (int64_t)B * Q * heads * hd;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    msda_corners_kernel<T>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const T*)value, (const int4*)idx, (const float4*)wgt, out,
            total, HW, Q, heads, P, hd);
  }
  return (int)cudaGetLastError();
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
  if (((uintptr_t)value | (uintptr_t)loc | (uintptr_t)attn |
       (uintptr_t)out) % 16 ||
      B < 0 || H <= 0 || W <= 0 || Q < 0 || heads <= 0 || threads <= 0 ||
      threads > kMsdaThreads || threads % 32 || blocks_per_map <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t pairs = (int64_t)B * Q * heads;
  if (pairs == 0) return 0;
  const int64_t grid = staged ? (int64_t)B * blocks_per_map
                              : (pairs + threads - 1) / threads;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  const MsdaArgs a{value, loc, attn, out, B, H, W, Q, heads, blocks_per_map};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(a, hd, P, staged, threads, (int)grid, smem,
                                 st);
  return launch<float>(a, hd, P, staged, threads, (int)grid, smem, st);
}

// value (B, HW, heads, hd) bf16 (is_bf16=1) or f32; idx (B, Q*heads*P, 4)
// int32 in [0, HW); wgt (B, Q*heads*P, 4) f32; out (B, Q, heads*hd) f32.
// idx and wgt must be 16-byte aligned.
extern "C" int fbbev_msda_corners(const void* value, const void* idx,
                                  const void* wgt, float* out, int is_bf16,
                                  int B, int HW, int Q, int heads, int P,
                                  int hd, void* stream) {
  if (((uintptr_t)idx | (uintptr_t)wgt) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (is_bf16)
    return launch_corners<__nv_bfloat16>(value, idx, wgt, out, B, HW, Q,
                                         heads, P, hd, stream);
  return launch_corners<float>(value, idx, wgt, out, B, HW, Q, heads, P,
                               hd, stream);
}
