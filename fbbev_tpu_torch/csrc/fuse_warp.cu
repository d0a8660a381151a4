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
//   newhist = slot t == hsel ? curr : warped        (written)
// and without the epilogue the warped slots are written; with it, per slot
//   y1   = relu(rnd(warped_t) @ kc + tvec_t * ke + kb)
//   acc += rnd(y1) @ ws[t]                           (fused, f32)
// rnd rounding to the history type, bf16 or f32.
// so the T*C-channel slots never reach device memory.  The TPU's slab
// DMAs, (8, 128) padding and tiling are not carried over: the card
// gathers the corner rows directly and its caches hold the neighbours.
//
// K5 replaces fbbev_tpu/ops/pallas_warp.py::warp_affine_3d (_warp_kernel,
// pl.pallas_call at :234, out_zyx=False): the warp stage alone, bf16 or
// f32, of a (B, Z, Y, X, C) volume into (B, Y, X, Z, C) -- no start
// reset, no new history, no epilogue.
//
// Bound: bytes -- the history is read once and the new history (K1) or
// the warped volume (K5) written once (2 x 205 MB in bf16 at the
// flagship); K1's epilogue, 49 GFLOP, sits below that on the tensor cores.
//
// Four kernels.  fuse_warp_kernel (K1 without the epilogue): 64
// consecutive voxels of one sample in (z, y, x) order a block, 4 warps,
// warp w owns rows 16w..16w+15; each lane reads 16-byte channel vectors of
// a corner row, so a warp reads 512 contiguous bytes of it.
//
// warp_box_kernel (K5) reads each source row about 2.4 times, in bulk
// copies, where a gather reads it about 8 times (a row is a corner of ~8
// output voxels).  Persistent blocks walk tasks: a tile of TY x TX output
// columns over the whole Z crossed with a group of G 32-byte channel
// chunks (16 bf16, 8 f32), the chunks of a group strided so that the
// blocks sharing a tile read and write contiguous bytes together.  Per
// task the block takes the tile's source box from the flow (the extremes
// at its 8 corner voxels, one guard cell each way); if it fits (TY + 2M)
// x (TX + 2M) x Z cells, thread 0 copies each chunk's box with one 5-D
// TMA box into a ring of S shared-memory stages, S chunks ahead, and the
// threads read the corners from there.  Two threads a voxel, one 16-byte
// half of the chunk each: each keeps its voxels' 8 corner weights and box
// cells in registers for the G chunks, issues its 8 reads together, free
// of bank conflicts for neighbouring voxels, and stores whole 32-byte
// sectors (a sector written in two halves by two instructions costs the
// card a read-modify-write).  A tile whose box does not fit (a large
// rotation or translation) reads the volume directly, in the same kernel:
// the choice is made per tile on the device.  The plan (tile, margin,
// stages, threads, group; the shared-memory bytes) is ops/pallas_warp.py::
// plan_warp; the entry refuses a byte count other than the kernel's.
//
// fuse_warp_epi (K1 with the epilogue) puts the epilogue behind the
// gather on Hopper's wgmma.  A block owns BM = 128 voxels in (z, y, x)
// order and has 512 threads in two roles:
//  * 8 gather warps (warpgroups 2, 3; 96 registers each by setmaxnreg):
//    warp w owns rows 16w..16w+15.  Per slot a lane computes a 16-byte
//    chunk (8 channels) of a row's warped slot from its 8 corner rows --
//    all 8 loads issued together: a corner outside the volume reads the
//    clamped row with weight 0, as the plain version does -- applies the
//    start reset, writes the new history's chunk to device memory and the
//    chunk, as bf16, into an A stage in the 128-byte swizzle that wgmma
//    reads K-major (chunk c of row r at chunk position c ^ (r & 7) of its
//    128-byte row, in K step c / 8).  Then fence.proxy.async (wgmma reads
//    through the async proxy) and one arrival on the stage's full barrier.
//  * 2 consumer warpgroups (warpgroups 0, 1; 160 registers): warpgroup g
//    owns rows 64g..64g+63 and waits only for gather warps 4g..4g+3.  Per
//    slot Y1 = A @ kc^T on wgmma m64nCk16 (f32 in registers); + brow,
//    relu, bf16 into the warpgroup's own A2 tile (same layout),
//    fence.proxy.async and a named barrier over its 128 threads; then
//    ACC += A2 @ ws[t]^T on wgmma m64nFk16.  ACC (64 x F f32, F / 2
//    registers a thread) stays in registers over all T slots and is
//    written once to fused (B, Y, X, Z, F) f32, rows past V masked.
//  * Weights by TMA (tma_wgmma.cuh): kc^T (C, C) loaded once per block;
//    ws relaid out to (B*T, F, C) arrives slot by slot through a 2-stage
//    ring (full / empty mbarriers), issued by thread 0.  C = 80 makes two
//    64-channel K steps, the second box zero-filled past C; only the
//    C / 16 k16 slices that hold channels are multiplied.
// The plan (BM, the stages, the shared-memory bytes) is mirrored in
// Python (ops/pallas_fuse_warp.py::plan_epilogue); the entry refuses a
// launch whose byte count differs from the kernel's.
//
// fuse_warp_epi_f32 (K1 with the epilogue on an f32 history) runs both
// products on the FP32 cores, see its definition; its plan is
// ops/pallas_fuse_warp.py::plan_epilogue_f32.
//
// The warp, reset and ring update do the same f32 operations in the same
// order as the plain version, under --fmad=false: the new history is
// bit-identical to it.

#include "tma_wgmma.cuh"

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
  // a bf16 is the top half of its f32: one shift or mask a channel
  __device__ static void unpack(uint4 q, float* f) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(u[j] << 16);
      f[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
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

// The 8 corner rows of voxel v of sample b under the flow m (rows 0..2
// of the 4x4, index units), -1 outside the volume, and their tent weights
// rounded to T, into crow[8] and cw[8].
template <typename T>
__device__ void corner_table(const float* m, int b, int v, int Z, int Y,
                             int X, int* crow, float* cw) {
  for (int k = 0; k < 8; ++k) {
    crow[k] = -1;
    cw[k] = 0.f;
  }
  if (v >= Z * Y * X) return;
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
    crow[k] = ((b * Z + (int)iz) * Y + (int)iy) * X + (int)ix;
    cw[k] = Vec<T>::round(w);
  }
}

// One 16-byte vector, channels cc..cc + VN of slot t, of voxel v of
// sample b: the warp of its corner rows (crow, cw) and the start reset
// (s) into w0, and the ring update (mk: t is the slot overwritten) into
// the new history.  Returns the voxel's (y, x, z)-major index.
template <typename T>
__device__ __forceinline__ int64_t warp_vector(
    const T* hist, const T* curr, T* new_hist, const int* crow,
    const float* cw, int b, int v, int Z, int Y, int X, int C, int TC,
    int t, int cc, float s, float mk, float* w0) {
  constexpr int VN = Vec<T>::N;
  float acc[VN] = {};
  for (int k = 0; k < 8; ++k) {
    const int row = crow[k];
    if (row < 0) continue;
    const float w = cw[k];
    float f[VN];
    Vec<T>::unpack(*reinterpret_cast<const uint4*>(
                       hist + (int64_t)row * TC + t * C + cc),
                   f);
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[j] += w * f[j];
  }
  const int x = v % X, y = (v / X) % Y, z = v / (X * Y);
  const int64_t vox = (((int64_t)b * Y + y) * X + x) * Z + z;
  float cf[VN], hv[VN];
  Vec<T>::unpack(*reinterpret_cast<const uint4*>(curr + vox * C + cc), cf);
#pragma unroll
  for (int j = 0; j < VN; ++j) {
    w0[j] = acc[j] * (1.f - s) + cf[j] * s;
    hv[j] = w0[j] * (1.f - mk) + cf[j] * mk;
  }
  *reinterpret_cast<uint4*>(new_hist + ((int64_t)b * Z * Y * X + v) * TC +
                            t * C + cc) = Vec<T>::pack(hv);
  return vox;
}

struct Args {
  const void* hist;   // (B, Z, Y, X, T*C)
  const void* curr;   // (B, Y, X, Z, C), ring update only
  const float* mat;   // (B, 12) rows 0..2 of the 4x4 flow
  const float* start; // (B,) 0 or 1, ring update only
  const int32_t* hsel;  // (B,) slot overwritten by curr, ring update only
  void* new_hist;     // (B, Z, Y, X, T*C), ring update only
  void* slots;        // (B, Y, X, Z, T*C)
  int Z, Y, X, C, T;
};

// K1 without the epilogue: the warp, the start reset and the ring update.
template <typename T>
__global__ void __launch_bounds__(kThreads) fuse_warp_kernel(Args a) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  const T* hist = static_cast<const T*>(a.hist);
  const int b = blockIdx.y;
  const int Z = a.Z, Y = a.Y, X = a.X, C = a.C, T_ = a.T;
  const int V = Z * Y * X;
  const int TC = T_ * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;                 // this warp's first row
  const int v0 = blockIdx.x * kRows;

  int* crow = reinterpret_cast<int*>(smem);           // [kRows][8]
  float* cw = reinterpret_cast<float*>(crow + kRows * 8);

  // corner rows and weights of this warp's voxels
  if (lane < 16)
    corner_table<T>(a.mat + b * 12, b, v0 + r0 + lane, Z, Y, X,
                    crow + (r0 + lane) * 8, cw + (r0 + lane) * 8);
  __syncthreads();

  const float s = a.start[b];
  const int hsel = a.hsel[b];
  const int nvec = C / VN;  // 16-byte vectors per slot row
  for (int t = 0; t < T_; ++t) {
    const float mk = (t == hsel) ? 1.f : 0.f;
    for (int e = lane; e < 16 * nvec; e += 32) {
      const int r = r0 + e / nvec, cv = e % nvec;
      const int v = v0 + r;
      if (v >= V) continue;
      float w0[VN];
      const int64_t vox = warp_vector<T>(
          hist, static_cast<const T*>(a.curr), static_cast<T*>(a.new_hist),
          crow + r * 8, cw + r * 8, b, v, Z, Y, X, C, TC, t, cv * VN, s, mk,
          w0);
      *reinterpret_cast<uint4*>(static_cast<T*>(a.slots) + vox * TC +
                                t * C + cv * VN) = Vec<T>::pack(w0);
    }
  }
}

// ------------------------------------------------- K1 epilogue on wgmma
constexpr int kEpiRows = 128;      // BM: voxels of a block
constexpr int kEpiThreads = 512;   // 2 consumer warpgroups, 8 gather warps
constexpr int kAStages = 2;        // A ring (warped slots)
constexpr int kWStages = 2;        // ws ring
constexpr int kGatherRegs = 96;    // setmaxnreg: 256 x 96 + 256 x 160
constexpr int kConsumerRegs = 160; // = 65536 registers

// Shared memory of fuse_warp_epi<C, F>, from its 1024-aligned base: the A
// ring, the two warpgroups' A2 tiles, the ws ring, kc^T, the corner table
// (int rows then f32 weights, [BM][8] each), the mbarriers; + 1024 bytes
// of alignment slack.  Every tile is KS K steps of 128-byte rows.
template <int C, int F>
struct EpiLayout {
  static constexpr int KS = (C + 63) / 64;  // 64-channel K steps
  static constexpr int K16 = C / 16;        // k16 slices that hold channels
  static constexpr uint32_t kAStep = kEpiRows * 128, kA = KS * kAStep;
  static constexpr uint32_t kA2Step = 64 * 128, kA2 = KS * kA2Step;
  static constexpr uint32_t kWStep = F * 128, kW = KS * kWStep;
  static constexpr uint32_t kKStep = C * 128, kK = KS * kKStep;
  static constexpr uint32_t oA = 0;
  static constexpr uint32_t oA2 = oA + kAStages * kA;
  static constexpr uint32_t oW = oA2 + 2 * kA2;
  static constexpr uint32_t oK = oW + kWStages * kW;
  static constexpr uint32_t oCorner = oK + kK;
  static constexpr uint32_t oBar = oCorner + kEpiRows * 8 * 8;
  // fullA[2][kAStages], emptyA[2][kAStages], fullW[kWStages],
  // emptyW[kWStages], kc
  static constexpr int kBars = 4 * kAStages + 2 * kWStages + 1;
  static constexpr int kSmem = oBar + kBars * 8 + 1024;
  static_assert(C % 16 == 0 && C <= 128 && F % 16 == 0 && F <= 256, "C, F");
};

struct EpiArgs {
  const bf16* hist;     // (B, Z, Y, X, T*C)
  const bf16* curr;     // (B, Y, X, Z, C)
  const float* mat;     // (B, 12)
  const float* start;   // (B,)
  const int32_t* hsel;  // (B,)
  const float* brow;    // (B, T, C) tvec * ke + kb
  bf16* new_hist;       // (B, Z, Y, X, T*C)
  float* fused;         // (B, Y, X, Z, F)
  int Z, Y, X, T;
};

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// Arm `bar` for and load the ks K steps of row block `row` of the 3-D
// map m (64 channels, all rows, 1) into dst, `step` bytes apart.
__device__ __forceinline__ void load_tiles(uint32_t dst, const CUtensorMap* m,
                                           uint32_t bar, int ks,
                                           uint32_t step, int row) {
  mbar_expect_tx(bar, ks * step);
  for (int k = 0; k < ks; ++k)
    tma_load_3d(dst + k * step, m, bar, k * 64, 0, row);
}

// Byte offset of the 16-byte chunk c (8 channels) of row r in a tile of
// 128-byte rows in the 128-byte swizzle, K step c / 8 at c / 8 * step.
__device__ __forceinline__ uint32_t sw128_chunk(int r, int c, uint32_t step) {
  return (c / 8) * step + r * 128 + (((c % 8) ^ (r & 7)) << 4);
}

template <int C, int F>
__global__ void __launch_bounds__(kEpiThreads, 1)
    fuse_warp_epi(const __grid_constant__ CUtensorMap kcmap,
                  const __grid_constant__ CUtensorMap wsmap,
                  const EpiArgs a) {
  typedef EpiLayout<C, F> L;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bars = base + L::oBar;
  // barrier addresses
  auto full_a = [&](int g, int s) { return bars + 8 * (g * kAStages + s); };
  auto empty_a = [&](int g, int s) {
    return bars + 8 * (2 * kAStages + g * kAStages + s);
  };
  auto full_w = [&](int s) { return bars + 8 * (4 * kAStages + s); };
  auto empty_w = [&](int s) {
    return bars + 8 * (4 * kAStages + kWStages + s);
  };
  const uint32_t kc_bar = bars + 8 * (4 * kAStages + 2 * kWStages);
  if (threadIdx.x == 0) {
    for (int g = 0; g < 2; ++g)
      for (int s = 0; s < kAStages; ++s) {
        mbar_init(full_a(g, s), 128);  // every gather thread of the half
        mbar_init(empty_a(g, s), 4);   // one arrival per consumer warp
      }
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full_w(s), 1);
      mbar_init(empty_w(s), 8);
    }
    mbar_init(kc_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int b = blockIdx.y, T = a.T;
  const int Z = a.Z, Y = a.Y, X = a.X, V = Z * Y * X;
  const int v0 = blockIdx.x * kEpiRows;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x < 256) {  // ----------------------------- consumers
    reg_alloc<kConsumerRegs>();
    const int wg = threadIdx.x / 128, wq = (threadIdx.x % 128) / 32;
    if (threadIdx.x == 0) {  // thread 0 issues the TMA loads
      load_tiles(base + L::oK, &kcmap, kc_bar, L::KS, L::kKStep, 0);
      for (int s = 0; s < kWStages && s < T; ++s)
        load_tiles(base + L::oW + s * L::kW, &wsmap, full_w(s), L::KS,
                   L::kWStep, b * T + s);
    }
    float acc[F / 2];
#pragma unroll
    for (int i = 0; i < F / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < F / 2; ++i) fence_reg(acc[i]);
    mbar_wait(kc_bar, 0);
    const uint32_t a2 = base + L::oA2 + wg * L::kA2;
    for (int t = 0; t < T; ++t) {
      const int sa = t % kAStages, sw = t % kWStages;
      // Y1 = A (this warpgroup's 64 rows) @ kc^T
      float y[C / 2];
#pragma unroll
      for (int i = 0; i < C / 2; ++i) y[i] = 0.f;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) fence_reg(y[i]);
      mbar_wait(full_a(wg, sa), (t / kAStages) & 1);
      const uint32_t at = base + L::oA + sa * L::kA + wg * 64 * 128;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::K16; ++k)
        wgmma_bn<C>(y, sw128_desc(at + (k / 4) * L::kAStep + 32 * (k % 4)),
                    sw128_desc(base + L::oK + (k / 4) * L::kKStep +
                               32 * (k % 4)));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < C / 2; ++i) fence_reg(y[i]);
      if (lane == 0) mbar_arrive(empty_a(wg, sa));
      // relu(Y1 + brow) as bf16 into A2: rows wq*16 + lane/4 (+ 8),
      // channels 8j + 2 (lane % 4) (+ 1) of the accumulator fragment
      const float* br = a.brow + ((int64_t)b * T + t) * C + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(br + 8 * j);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = wq * 16 + lane / 4 + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              sm + L::oA2 + wg * L::kA2 + sw128_chunk(m, j, L::kA2Step) +
              4 * (lane % 4)) =
              __floats2bfloat162_rn(fmaxf(y[j * 4 + 2 * h] + bj.x, 0.f),
                                    fmaxf(y[j * 4 + 2 * h + 1] + bj.y, 0.f));
        }
      }
      fence_async_smem();
      named_bar_sync(1 + wg, 128);
      // ACC += A2 @ ws[t]^T
      mbar_wait(full_w(sw), (t / kWStages) & 1);
      const uint32_t wt = base + L::oW + sw * L::kW;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < L::K16; ++k)
        wgmma_bn<F>(acc, sw128_desc(a2 + (k / 4) * L::kA2Step + 32 * (k % 4)),
                    sw128_desc(wt + (k / 4) * L::kWStep + 32 * (k % 4)));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < F / 2; ++i) fence_reg(acc[i]);
      if (lane == 0) mbar_arrive(empty_w(sw));
      if (threadIdx.x == 0 && t + kWStages < T) {
        mbar_wait(empty_w(sw), (t / kWStages) & 1);
        load_tiles(wt, &wsmap, full_w(sw), L::KS, L::kWStep,
                   b * T + t + kWStages);
      }
      __syncwarp();  // warp 0 reconverges before the next wgmma
    }
    // ACC to fused, (z, y, x) -> (y, x, z), rows past V masked
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v = v0 + wg * 64 + wq * 16 + lane / 4 + 8 * h;
      if (v >= V) continue;
      const int x = v % X, yy = (v / X) % Y, z = v / (X * Y);
      float* out = a.fused + ((((int64_t)b * Y + yy) * X + x) * Z + z) * F +
                   2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < F / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
    }
    return;
  }

  // ----------------------------------------------------------- gather
  reg_dealloc<kGatherRegs>();
  constexpr int NV = C / 8;           // 16-byte chunks of a slot row
  constexpr int NT = 16 * NV / 32;    // chunks per lane per slot
  const int gw = (threadIdx.x - 256) / 32;  // gather warp 0..7
  const int g = gw / 4, r0 = gw * 16;       // its half, its first row
  const int TC = T * C;
  int* crow = reinterpret_cast<int*>(sm + L::oCorner);  // [BM][8]
  float* cw = reinterpret_cast<float*>(crow + kEpiRows * 8);
  if (lane < 16) {
    // corner rows (clamped) and weights (0 outside the volume) of row r;
    // a row past V takes voxel V - 1's (its stores are masked)
    const int r = r0 + lane, v = min(v0 + r, V - 1);
    const float* m = a.mat + b * 12;
    const float gx = (float)(v % X), gy = (float)((v / X) % Y);
    const float gz = (float)(v / (X * Y));
    const float xs = m[0] * gx + m[1] * gy + m[3] + m[2] * gz;
    const float ys = m[4] * gx + m[5] * gy + m[7] + m[6] * gz;
    const float zs = m[8] * gx + m[9] * gy + m[11] + m[10] * gz;
    const float x0 = floorf(xs), y0 = floorf(ys), z0 = floorf(zs);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ix = x0 + (k & 1), iy = y0 + ((k >> 1) & 1);
      const float iz = z0 + (k >> 2);
      const bool ok = ix >= 0.f && ix <= X - 1 && iy >= 0.f &&
                      iy <= Y - 1 && iz >= 0.f && iz <= Z - 1;
      const float w = (1.f - fabsf(xs - ix)) * (1.f - fabsf(ys - iy)) *
                      (1.f - fabsf(zs - iz));
      const int cx = (int)fminf(fmaxf(ix, 0.f), (float)(X - 1));
      const int cy = (int)fminf(fmaxf(iy, 0.f), (float)(Y - 1));
      const int cz = (int)fminf(fmaxf(iz, 0.f), (float)(Z - 1));
      crow[r * 8 + k] = ((b * Z + cz) * Y + cy) * X + cx;
      cw[r * 8 + k] = ok ? Vec<bf16>::round(w) : 0.f;
    }
  }
  __syncwarp();

  const float s = a.start[b];
  const int hsel = a.hsel[b];
  for (int t = 0; t < T; ++t) {
    const int sa = t % kAStages;
    if (t >= kAStages)
      mbar_wait(empty_a(g, sa), (t / kAStages - 1) & 1);
    uint8_t* const at = sm + L::oA + sa * L::kA;
    const float mk = (t == hsel) ? 1.f : 0.f;
#pragma unroll 1
    for (int i = 0; i < NT; ++i) {
      const int e = lane + 32 * i;
      const int r = r0 + e / NV, cv = e % NV;
      const int v = v0 + r, vc = min(v, V - 1);
      const int4 rl = *reinterpret_cast<const int4*>(crow + r * 8);
      const int4 rh = *reinterpret_cast<const int4*>(crow + r * 8 + 4);
      const float4 wl = *reinterpret_cast<const float4*>(cw + r * 8);
      const float4 wh = *reinterpret_cast<const float4*>(cw + r * 8 + 4);
      const int rows[8] = {rl.x, rl.y, rl.z, rl.w, rh.x, rh.y, rh.z, rh.w};
      const float ws_[8] = {wl.x, wl.y, wl.z, wl.w, wh.x, wh.y, wh.z, wh.w};
      const int64_t off = (int64_t)t * C + cv * 8;
      uint4 q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        q[k] = __ldg(reinterpret_cast<const uint4*>(
            a.hist + (int64_t)rows[k] * TC + off));
      const int x = vc % X, yy = (vc / X) % Y, z = vc / (X * Y);
      const int64_t vox = (((int64_t)b * Y + yy) * X + x) * Z + z;
      const uint4 cq =
          __ldg(reinterpret_cast<const uint4*>(a.curr + vox * C + cv * 8));
      float acc[8] = {};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float f[8];
        Vec<bf16>::unpack(q[k], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += ws_[k] * f[j];
      }
      float cf[8], hv[8];
      Vec<bf16>::unpack(cq, cf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w0 = acc[j] * (1.f - s) + cf[j] * s;
        hv[j] = w0 * (1.f - mk) + cf[j] * mk;
        acc[j] = w0;
      }
      if (v < V)
        *reinterpret_cast<uint4*>(a.new_hist + ((int64_t)b * V + v) * TC +
                                  off) = Vec<bf16>::pack(hv);
      *reinterpret_cast<uint4*>(at + sw128_chunk(r, cv, L::kAStep)) =
          Vec<bf16>::pack(acc);
    }
    fence_async_smem();
    mbar_arrive(full_a(g, sa));
  }
}

template <int C, int F>
int launch_epi(const EpiArgs& a, const bf16* kc_t, const bf16* ws_t, int B,
               int smem, cudaStream_t stream) {
  typedef EpiLayout<C, F> L;
  if (smem != L::kSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap km, wm;
  const cuuint64_t kd[3] = {(cuuint64_t)C, (cuuint64_t)C, 1};
  const cuuint32_t kb[3] = {64, (cuuint32_t)C, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)C, (cuuint64_t)F,
                            (cuuint64_t)B * a.T};
  const cuuint32_t wb[3] = {64, (cuuint32_t)F, 1};
  int r = encode(&km, kc_t, 3, kd, kb);
  if (r == 0) r = encode(&wm, ws_t, 3, wd, wb);
  if (r != 0) return r;
  static uint64_t smem_set = 0;
  r = allow_smem(fuse_warp_epi<C, F>, L::kSmem, smem_set);
  if (r != 0) return r;
  const int V = a.Z * a.Y * a.X;
  const dim3 grid((V + kEpiRows - 1) / kEpiRows, B);
  fuse_warp_epi<C, F><<<grid, kEpiThreads, L::kSmem, stream>>>(km, wm, a);
  return (int)cudaGetLastError();
}

// -------------------------------------------- K1 epilogue in float32
// An f32 history (wgmma takes no f32 operands; tf32 would round them):
// both products on the FP32 cores.  A block of kRows = 64 voxels, 128
// threads; kc staged in shared memory once.  Per slot the 4 warps
// gather their 16 rows' warped vectors (warp_vector, as fuse_warp_kernel)
// into the tile A, then thread i owns row i / 2 and the output columns
// of parity i % 2: Y1 = relu(A @ kc + brow) into the tile Y1 and, after a
// barrier, ACC += Y1 @ ws[t] with ws read from device memory (each value
// broadcast to the 32 threads of a warp that share its column parity).
// ACC (F / 2 registers a thread) is written once after the T slots.
template <int C, int F>
struct EpiF32Layout {
  static constexpr int LD = C + 4;  // A and Y1 row stride, 16-byte rows
  static constexpr int oA = kRows * 8 * 8;  // after the corner table
  static constexpr int oY = oA + kRows * LD * 4;
  static constexpr int oK = oY + kRows * LD * 4;
  static constexpr int kSmem = oK + C * C * 4;
  static_assert(C % 4 == 0 && C % 2 == 0 && F % 2 == 0, "C, F");
};

struct EpiF32Args {
  const float* hist;    // (B, Z, Y, X, T*C)
  const float* curr;    // (B, Y, X, Z, C)
  const float* mat;     // (B, 12)
  const float* start;   // (B,)
  const int32_t* hsel;  // (B,)
  const float* kc;      // (C, C) input channel, output channel
  const float* brow;    // (B, T, C) tvec * ke + kb
  const float* ws;      // (B, T*C, F) in ring-slot order
  float* new_hist;      // (B, Z, Y, X, T*C)
  float* fused;         // (B, Y, X, Z, F)
  int Z, Y, X, T;
};

template <int C, int F>
__global__ void __launch_bounds__(kThreads)
    fuse_warp_epi_f32(const EpiF32Args a) {
  typedef EpiF32Layout<C, F> L;
  constexpr int VN = Vec<float>::N, NV = C / VN;
  extern __shared__ __align__(128) unsigned char smem[];
  int* crow = reinterpret_cast<int*>(smem);            // [kRows][8]
  float* cw = reinterpret_cast<float*>(crow + kRows * 8);
  float* As = reinterpret_cast<float*>(smem + L::oA);  // [kRows][LD]
  float* Ys = reinterpret_cast<float*>(smem + L::oY);  // [kRows][LD]
  float* Ks = reinterpret_cast<float*>(smem + L::oK);  // [C][C], kc[c][j]
  const int b = blockIdx.y, T = a.T, TC = T * C;
  const int Z = a.Z, Y = a.Y, X = a.X, V = Z * Y * X;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16, v0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < C * C; i += kThreads) Ks[i] = a.kc[i];
  if (lane < 16)
    corner_table<float>(a.mat + b * 12, b, v0 + r0 + lane, Z, Y, X,
                        crow + (r0 + lane) * 8, cw + (r0 + lane) * 8);
  __syncthreads();

  const float s = a.start[b];
  const int hsel = a.hsel[b];
  const int r = threadIdx.x / 2, h = threadIdx.x % 2;
  float acc[F / 2];
#pragma unroll
  for (int i = 0; i < F / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < T; ++t) {
    const float mk = (t == hsel) ? 1.f : 0.f;
    for (int e = lane; e < 16 * NV; e += 32) {
      const int rr = r0 + e / NV, cv = e % NV, v = v0 + rr;
      float w0[VN] = {};
      if (v < V)
        warp_vector<float>(a.hist, a.curr, a.new_hist, crow + rr * 8,
                           cw + rr * 8, b, v, Z, Y, X, C, TC, t, cv * VN, s,
                           mk, w0);
      *reinterpret_cast<float4*>(As + rr * L::LD + cv * VN) =
          make_float4(w0[0], w0[1], w0[2], w0[3]);
    }
    __syncthreads();  // A written; the last slot's Y1 read
    float y[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) y[i] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float x = As[r * L::LD + c];
#pragma unroll
      for (int i = 0; i < C / 2; ++i) y[i] += x * Ks[c * C + h + 2 * i];
    }
    const float* br = a.brow + ((int64_t)b * T + t) * C;
#pragma unroll
    for (int i = 0; i < C / 2; ++i)
      Ys[r * L::LD + h + 2 * i] = fmaxf(y[i] + br[h + 2 * i], 0.f);
    __syncthreads();  // Y1 written; A read
    const float* w = a.ws + ((int64_t)b * TC + t * C) * F + h;
    for (int c = 0; c < C; ++c) {
      const float x = Ys[r * L::LD + c];
#pragma unroll
      for (int i = 0; i < F / 2; ++i) acc[i] += x * w[c * F + 2 * i];
    }
  }
  const int v = v0 + r;
  if (v >= V) return;
  const int x = v % X, y = (v / X) % Y, z = v / (X * Y);
  float* out = a.fused + ((((int64_t)b * Y + y) * X + x) * Z + z) * F + h;
#pragma unroll
  for (int i = 0; i < F / 2; ++i) out[2 * i] = acc[i];
}

template <int C, int F>
int launch_f32_epi(const EpiF32Args& a, int B, int smem,
                   cudaStream_t stream) {
  typedef EpiF32Layout<C, F> L;
  if (smem != L::kSmem) return (int)cudaErrorInvalidValue;
  static uint64_t smem_set = 0;
  const int r = allow_smem(fuse_warp_epi_f32<C, F>, L::kSmem, smem_set);
  if (r != 0) return r;
  const int V = a.Z * a.Y * a.X;
  const dim3 grid((V + kRows - 1) / kRows, B);
  fuse_warp_epi_f32<C, F><<<grid, kThreads, L::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ K5: the staged box
constexpr int kCell = 32;     // bytes of a voxel's chunk: two 16-byte halves
constexpr int kMaxBoxZ = 8;   // box depth cap; a deeper tile falls back

struct BoxArgs {
  const void* vol;   // (B, Z, Y, X, C)
  const float* mat;  // (B, 12) rows 0..2 of the 4x4 flow
  void* out;         // (B, Y, X, Z, C)
  int B, Z, Y, X, C, BZ;
};

// A task: sample b, the tile's first output row y0 and column x0, and a
// group of nc <= G channel chunks ch0, ch0 + dch, ...  Groups run
// fastest, so a tile's dch groups are taken by neighbouring blocks at
// about the same time, and at their g-th step they read and write chunks
// g dch .. g dch + dch - 1 of the tile's rows: contiguous bytes.
struct Task {
  int b, y0, x0, ch0, dch, nc;
};

template <int TY, int TX, int G>
__device__ __forceinline__ Task task_of(int t, const BoxArgs& a, int nch) {
  const int tiles_x = (a.X + TX - 1) / TX, tiles_y = (a.Y + TY - 1) / TY;
  const int groups = (nch + G - 1) / G;
  Task k;
  k.ch0 = t % groups;
  k.dch = groups;
  k.nc = (nch - k.ch0 + groups - 1) / groups;
  t /= groups;
  k.x0 = (t % tiles_x) * TX;
  t /= tiles_x;
  k.y0 = (t % tiles_y) * TY;
  k.b = t / tiles_y;
  return k;
}

// Source index coordinates of output voxel (gx, gy, gz): the f32
// expressions of every warp of this file and of the plain version.
__device__ __forceinline__ void src_of(const float* m, float gx, float gy,
                                       float gz, float& xs, float& ys,
                                       float& zs) {
  xs = m[0] * gx + m[1] * gy + m[3] + m[2] * gz;
  ys = m[4] * gx + m[5] * gy + m[7] + m[6] * gz;
  zs = m[8] * gx + m[9] * gy + m[11] + m[10] * gz;
}

// The first cell lo of a box of `cells` along an axis of n cells that holds
// every clamped corner coordinate of source coordinates in [mn, mx],
// widened by one cell each way against the rounding between the tile's
// corner voxels and its inner ones; fits is cleared if it does not.
__device__ __forceinline__ int box_axis(float mn, float mx, int n, int cells,
                                        bool& fits) {
  const float top = (float)(n - 1);
  const int lo = (int)fminf(fmaxf(floorf(mn) - 1.f, 0.f), top);
  const int hi = (int)fminf(fmaxf(floorf(mx) + 2.f, 0.f), top);
  fits = fits && hi - lo < cells;
  return lo;
}

struct Box {
  int x, y, z;
  bool fits;
};

// The source box of task k: the flow is affine, so the extremes of the
// source coordinates over the tile (all Z) are at its 8 corner voxels.
// A volume deeper than kMaxBoxZ, or a flow whose terms may reach 2^16
// cells (or is not finite), sends the tile to the fallback: below that, the f32 rounding of any voxel's
// coordinates (a few ulps of 2^16, < 0.02 cells) stays inside the guard.
template <int TY, int TX, int BY, int BX>
__device__ __forceinline__ Box box_of(const Task& k, const float* m,
                                      const BoxArgs& a) {
  bool fits = a.Z <= kMaxBoxZ;  // a staged thread holds kMaxBoxZ levels
#pragma unroll
  for (int r = 0; r < 3; ++r)
    fits = fits && fabsf(m[4 * r]) * (a.X - 1) + fabsf(m[4 * r + 1]) *
                                                     (a.Y - 1) +
                           fabsf(m[4 * r + 2]) * (a.Z - 1) +
                           fabsf(m[4 * r + 3]) <
                       65536.f;
  const float xa = (float)k.x0, xb = (float)(min(k.x0 + TX, a.X) - 1);
  const float ya = (float)k.y0, yb = (float)(min(k.y0 + TY, a.Y) - 1);
  const float inf = __int_as_float(0x7f800000);
  float mn[3] = {inf, inf, inf}, mx[3] = {-inf, -inf, -inf};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float s[3];
    src_of(m, (c & 1) ? xb : xa, (c & 2) ? yb : ya,
           (c & 4) ? (float)(a.Z - 1) : 0.f, s[0], s[1], s[2]);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      mn[d] = fminf(mn[d], s[d]);
      mx[d] = fmaxf(mx[d], s[d]);
    }
  }
  Box r;
  r.fits = fits;
  r.x = box_axis(mn[0], mx[0], a.X, BX, r.fits);
  r.y = box_axis(mn[1], mx[1], a.Y, BY, r.fits);
  r.z = box_axis(mn[2], mx[2], a.Z, a.BZ, r.fits);
  return r;
}

// The 8 trilinear corners of output voxel (x, y, z): weights rounded to T,
// 0 outside the volume, and the clamped cell coordinates -- the f32
// operations of the plain version, in its order.
template <typename T>
__device__ __forceinline__ void corners_of(const float* m, int x, int y,
                                           int z, const BoxArgs& a,
                                           float (&w)[8], int (&cx)[8],
                                           int (&cy)[8], int (&cz)[8]) {
  float xs, ys, zs;
  src_of(m, (float)x, (float)y, (float)z, xs, ys, zs);
  const float x0 = floorf(xs), y0 = floorf(ys), z0 = floorf(zs);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float ix = x0 + (c & 1), iy = y0 + ((c >> 1) & 1);
    const float iz = z0 + (c >> 2);
    const bool ok = ix >= 0.f && ix <= a.X - 1 && iy >= 0.f &&
                    iy <= a.Y - 1 && iz >= 0.f && iz <= a.Z - 1;
    const float wt = (1.f - fabsf(xs - ix)) * (1.f - fabsf(ys - iy)) *
                     (1.f - fabsf(zs - iz));
    w[c] = ok ? Vec<T>::round(wt) : 0.f;
    cx[c] = (int)fminf(fmaxf(ix, 0.f), (float)(a.X - 1));
    cy[c] = (int)fminf(fmaxf(iy, 0.f), (float)(a.Y - 1));
    cz[c] = (int)fminf(fmaxf(iz, 0.f), (float)(a.Z - 1));
  }
}

// One 16-byte half of a chunk (8 bf16 or 4 f32 channels): the weighted
// sum of the 8 corner vectors q, corners in order, into f32, rounded to T.
template <typename T>
__device__ __forceinline__ uint4 blend8(const float (&w)[8],
                                        const uint4 (&q)[8]) {
  constexpr int VN = Vec<T>::N;
  float acc[VN] = {};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float f[VN];
    Vec<T>::unpack(q[c], f);
#pragma unroll
    for (int j = 0; j < VN; ++j) acc[j] += w[c] * f[j];
  }
  return Vec<T>::pack(acc);
}

// Chunk ch of every output voxel of tile k (x fastest, then y, then z),
// its corners read directly from the volume: the fallback of a tile whose
// box does not fit.  Thread pairs as the staged path's.
template <typename T, int TY, int TX, int NT>
__device__ __forceinline__ void warp_direct(const Task& k, int ch,
                                            const float* m,
                                            const BoxArgs& a) {
  constexpr int VN = Vec<T>::N, CC = 2 * VN;
  const T* vol = static_cast<const T*>(a.vol);
#pragma unroll 1
  for (int i = threadIdx.x; i < 2 * TY * TX * a.Z; i += NT) {
    const int h = i & 1, v = i >> 1;
    const int x = k.x0 + v % TX, y = k.y0 + (v / TX) % TY;
    const int z = v / (TX * TY);
    if (x >= a.X || y >= a.Y) continue;
    float w[8];
    int cx[8], cy[8], cz[8];
    corners_of<T>(m, x, y, z, a, w, cx, cy, cz);
    uint4 q[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      q[c] = __ldg(reinterpret_cast<const uint4*>(
          vol + ((((int64_t)k.b * a.Z + cz[c]) * a.Y + cy[c]) * a.X + cx[c]) *
                    a.C +
          ch * CC + h * VN));
    *reinterpret_cast<uint4*>(
        static_cast<T*>(a.out) +
        ((((int64_t)k.b * a.Y + y) * a.X + x) * a.Z + z) * a.C + ch * CC +
        h * VN) = blend8<T>(w, q);
  }
}

// K5.  Persistent blocks walk tasks blockIdx.x, + gridDim.x, ...; a task
// is G steps, one a chunk (a step past the group's chunks is empty).
// Thread 0 stages each step's box through a ring of S stages, S steps
// ahead: one 5-D TMA box (CC channels, BX, BY, BZ, 1) of the volume,
// zero-filled past its edges, completing on the stage's mbarrier; an empty
// step, or one of a task whose box does not fit, only arrives on it.  The
// last __syncthreads of a step frees its stage.  In a staged task each
// thread keeps its IPT items' corner weights and box cells in registers
// for all G chunks: thread t takes half t & 1 of voxels (t >> 1) + i NT / 2.
template <typename T, int TY, int TX, int M, int S, int NT, int G>
__global__ void __launch_bounds__(NT, 1)
    warp_box_kernel(const __grid_constant__ CUtensorMap vmap,
                    const BoxArgs a) {
  constexpr int BY = TY + 2 * M, BX = TX + 2 * M;
  constexpr int VN = Vec<T>::N, CC = 2 * VN;
  constexpr int IPT = 2 * TY * TX * kMaxBoxZ / NT;  // items a thread
  static_assert(IPT * NT == 2 * TY * TX * kMaxBoxZ && NT % 64 == 0, "NT");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 127u) & ~127u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t stage_bytes = (uint32_t)a.BZ * BY * BX * kCell;
  const uint32_t bars = base + S * stage_bytes;
  const int nch = a.C / CC;
  const int ntasks = a.B * ((a.Y + TY - 1) / TY) * ((a.X + TX - 1) / TX) *
                     ((nch + G - 1) / G);
  auto issue = [&](int n, int s) {  // step n of this block into stage s
    const int t = blockIdx.x + (n / G) * gridDim.x, g = n % G;
    if (t >= ntasks) return;
    const Task k = task_of<TY, TX, G>(t, a, nch);
    const float* m = a.mat + k.b * 12;
    const Box box = box_of<TY, TX, BY, BX>(k, m, a);
    const uint32_t bar = bars + 8 * s;
    if (box.fits && g < k.nc) {
      mbar_expect_tx(bar, stage_bytes);
      tma_load_5d(base + s * stage_bytes, &vmap, bar,
                  (k.ch0 + g * k.dch) * CC, box.x, box.y, box.z, k.b);
    } else {
      mbar_arrive(bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < S; ++s) issue(s, s);
  }
  __syncthreads();
  const int h = threadIdx.x & 1;
  int n = 0;  // this block's steps so far
  for (int j = 0;; ++j) {
    const int t = blockIdx.x + j * gridDim.x;
    if (t >= ntasks) break;
    const Task k = task_of<TY, TX, G>(t, a, nch);
    float m[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) m[i] = __ldg(a.mat + k.b * 12 + i);
    const Box box = box_of<TY, TX, BY, BX>(k, m, a);
    if (box.fits) {
      float w[IPT][8];
      uint32_t cell[IPT][4];  // box cells of corners 2i, 2i + 1 (16 bits)
      uint32_t row[IPT];      // output voxel (y, x, z) of sample b, or ~0
#pragma unroll
      for (int it = 0; it < IPT; ++it) {
        const int v = (threadIdx.x >> 1) + it * (NT / 2);
        const int x = k.x0 + v % TX, y = k.y0 + (v / TX) % TY;
        const int z = v / (TX * TY);
        const bool valid = x < a.X && y < a.Y && z < a.Z;
        int cx[8], cy[8], cz[8];
        corners_of<T>(m, min(x, a.X - 1), min(y, a.Y - 1), min(z, a.Z - 1),
                      a, w[it], cx, cy, cz);
#pragma unroll
        for (int c = 0; c < 8; c += 2)
          cell[it][c / 2] =
              (uint32_t)(((cz[c] - box.z) * BY + (cy[c] - box.y)) * BX +
                         (cx[c] - box.x)) |
              (uint32_t)(((cz[c + 1] - box.z) * BY + (cy[c + 1] - box.y)) *
                             BX +
                         (cx[c + 1] - box.x))
                  << 16;
        row[it] = valid ? (uint32_t)((y * a.X + x) * a.Z + z) : ~0u;
      }
      for (int g = 0; g < G; ++g, ++n) {
        const int s = n % S;
        mbar_wait(bars + 8 * s, (n / S) & 1);
        if (g < k.nc) {
          const uint8_t* st = sm + s * stage_bytes + h * 16;
          T* out = static_cast<T*>(a.out) +
                   (int64_t)k.b * a.Y * a.X * a.Z * a.C +
                   (k.ch0 + g * k.dch) * CC + h * VN;
#pragma unroll
          for (int it = 0; it < IPT; ++it) {
            if (row[it] == ~0u) continue;
            uint4 q[8];
#pragma unroll
            for (int c = 0; c < 8; ++c)
              q[c] = *reinterpret_cast<const uint4*>(
                  st + ((cell[it][c / 2] >> (16 * (c & 1))) & 0xffff) *
                           kCell);
            *reinterpret_cast<uint4*>(out + (int64_t)row[it] * a.C) =
                blend8<T>(w[it], q);
          }
        }
        __syncthreads();
        if (threadIdx.x == 0) issue(n + S, s);
      }
    } else {
      for (int g = 0; g < G; ++g, ++n) {
        const int s = n % S;
        mbar_wait(bars + 8 * s, (n / S) & 1);
        if (g < k.nc) warp_direct<T, TY, TX, NT>(k, k.ch0 + g * k.dch, m, a);
        __syncthreads();
        if (threadIdx.x == 0) issue(n + S, s);
      }
    }
  }
}

// Shared-memory bytes of warp_box_kernel: S stages of BZ x BY x BX cells,
// S mbarriers, 128 bytes of alignment slack.  ops/pallas_warp.py::
// plan_warp mirrors it.
template <int TY, int TX, int M, int S>
int box_smem(int BZ) {
  return S * BZ * (TY + 2 * M) * (TX + 2 * M) * kCell + 8 * S + 128;
}

template <typename T, int TY, int TX, int M, int S, int NT, int G>
int launch_box(const BoxArgs& a, int grid, int smem, cudaStream_t stream) {
  constexpr int BY = TY + 2 * M, BX = TX + 2 * M;
  constexpr int CC = 2 * Vec<T>::N;
  if (smem != box_smem<TY, TX, M, S>(a.BZ)) return (int)cudaErrorInvalidValue;
  CUtensorMap vm;
  const cuuint64_t d[5] = {(cuuint64_t)a.C, (cuuint64_t)a.X,
                           (cuuint64_t)a.Y, (cuuint64_t)a.Z,
                           (cuuint64_t)a.B};
  const cuuint32_t bx[5] = {(cuuint32_t)CC, (cuuint32_t)BX, (cuuint32_t)BY,
                            (cuuint32_t)a.BZ, 1};
  int r = encode(&vm, a.vol, 5, d, bx,
                 sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != 0) return r;
  static uint64_t smem_set = 0;  // set once, for the deepest box
  r = allow_smem(warp_box_kernel<T, TY, TX, M, S, NT, G>,
                 box_smem<TY, TX, M, S>(kMaxBoxZ), smem_set);
  if (r != 0) return r;
  warp_box_kernel<T, TY, TX, M, S, NT, G><<<grid, NT, smem, stream>>>(vm, a);
  return (int)cudaGetLastError();
}

// The plans K5 is instantiated for, (TY, TX, M, S, NT, G) -- ops/
// pallas_warp.py::WARP_PLANS lists the same, the first the default.
template <typename T>
int launch_plan(const BoxArgs& a, const int* p, int grid, int smem,
                cudaStream_t st) {
#define FBBEV_K5_PLAN(TY_, TX_, M_, S_, NT_, G_)                           \
  if (p[0] == TY_ && p[1] == TX_ && p[2] == M_ && p[3] == S_ &&          \
      p[4] == NT_ && p[5] == G_)                                         \
    return launch_box<T, TY_, TX_, M_, S_, NT_, G_>(a, grid, smem, st);
  FBBEV_K5_PLAN(4, 20, 2, 4, 640, 4)
  FBBEV_K5_PLAN(8, 16, 2, 3, 512, 2)
  FBBEV_K5_PLAN(4, 20, 2, 4, 640, 8)
#undef FBBEV_K5_PLAN
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K1 without the epilogue: the warped slots (B, Y, X, Z, T*C) and the new
// history.  bf16 (is_bf16) or f32 history and curr, C a multiple of 8 or
// 4 (a 16-byte vector).
extern "C" int fbbev_fuse_warp(const void* hist, const void* curr,
                               const float* mat, const float* start,
                               const int32_t* hsel, void* new_hist,
                               void* slots, int B, int Z, int Y, int X,
                               int C, int T, int is_bf16, void* stream) {
  if (C % (is_bf16 ? 8 : 4) || B < 0 || Z < 0 || Y < 0 || X < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  Args a{hist, curr, mat, start, hsel, new_hist, slots, Z, Y, X, C, T};
  const int V = Z * Y * X;
  if (B == 0 || V == 0 || T == 0) return 0;
  const dim3 grid((V + kRows - 1) / kRows, B);
  if (is_bf16)
    fuse_warp_kernel<bf16>
        <<<grid, kThreads, kRows * 8 * 8, (cudaStream_t)stream>>>(a);
  else
    fuse_warp_kernel<float>
        <<<grid, kThreads, kRows * 8 * 8, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K1 with the epilogue: fused (B, Y, X, Z, F) f32 and the new history.
// kc_t (C, C) is kc transposed (output channel, input channel) and ws_t
// (B*T, F, C) the cat-conv rows of each slot transposed, both bf16; smem
// the plan's shared-memory bytes.  (C, F) = (80, 160), the flagship's, or
// (64, 128), the small config's; every pointer 16-byte aligned.
extern "C" int fbbev_fuse_warp_epi(const void* hist, const void* curr,
                                   const float* mat, const float* start,
                                   const int32_t* hsel, const void* kc_t,
                                   const float* brow, const void* ws_t,
                                   void* new_hist, float* fused, int B,
                                   int Z, int Y, int X, int C, int T, int F,
                                   int smem, void* stream) {
  const uintptr_t align = (uintptr_t)hist | (uintptr_t)curr |
                          (uintptr_t)kc_t | (uintptr_t)ws_t |
                          (uintptr_t)new_hist | (uintptr_t)fused |
                          (uintptr_t)brow;
  if (align % 16 || B < 0 || Z < 0 || Y < 0 || X < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  const int V = Z * Y * X;
  if (B == 0 || V == 0) return 0;
  if (T == 0) return (int)cudaErrorInvalidValue;
  const EpiArgs a{static_cast<const bf16*>(hist),
                  static_cast<const bf16*>(curr), mat, start, hsel, brow,
                  static_cast<bf16*>(new_hist), fused, Z, Y, X, T};
  const bf16* k = static_cast<const bf16*>(kc_t);
  const bf16* w = static_cast<const bf16*>(ws_t);
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 80 && F == 160) return launch_epi<80, 160>(a, k, w, B, smem, st);
  if (C == 64 && F == 128) return launch_epi<64, 128>(a, k, w, B, smem, st);
  return (int)cudaErrorInvalidValue;
}

// K1 with the epilogue on an f32 history: as fbbev_fuse_warp_epi, every
// tensor f32, kc (C, C) and ws (B, T*C, F) as the plain version takes
// them; smem the plan's bytes.  (C, F) = (80, 160) or (64, 128).
extern "C" int fbbev_fuse_warp_epi_f32(
    const float* hist, const float* curr, const float* mat,
    const float* start, const int32_t* hsel, const float* kc,
    const float* brow, const float* ws, float* new_hist, float* fused,
    int B, int Z, int Y, int X, int C, int T, int F, int smem,
    void* stream) {
  const uintptr_t align = (uintptr_t)hist | (uintptr_t)curr |
                          (uintptr_t)new_hist;
  if (align % 16 || B < 0 || Z < 0 || Y < 0 || X < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  const int V = Z * Y * X;
  if (B == 0 || V == 0) return 0;
  if (T == 0) return (int)cudaErrorInvalidValue;
  const EpiF32Args a{hist, curr, mat, start, hsel, kc, brow, ws,
                     new_hist, fused, Z, Y, X, T};
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 80 && F == 160) return launch_f32_epi<80, 160>(a, B, smem, st);
  if (C == 64 && F == 128) return launch_f32_epi<64, 128>(a, B, smem, st);
  return (int)cudaErrorInvalidValue;
}

// K5: vol (B, Z, Y, X, C) -> out (B, Y, X, Z, C), bf16 (is_bf16) or f32,
// C a multiple of the 32-byte chunk (16 bf16, 8 f32 channels), vol and out
// 16-byte aligned; (ty, tx, margin, stages, threads, group) one of the
// instantiated plans, grid its persistent blocks and smem its bytes, which
// the entry refuses if they differ from the kernel's.
extern "C" int fbbev_warp_affine(const void* vol, const float* mat,
                                 void* out, int is_bf16, int B, int Z, int Y,
                                 int X, int C, int ty, int tx, int margin,
                                 int stages, int threads, int group,
                                 int grid, int smem, void* stream) {
  const int cc = is_bf16 ? 16 : 8;
  if (C % cc || B < 0 || Z < 0 || Y < 0 || X < 0 ||
      ((uintptr_t)vol | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Z == 0 || Y == 0 || X == 0 || C == 0) return 0;
  if (ty <= 0 || tx <= 0 || group <= 0 || grid <= 0 ||
      (int64_t)B * ((Y + ty - 1) / ty) * ((X + tx - 1) / tx) * (C / cc) >=
          INT32_MAX ||
      (int64_t)Y * X * Z >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const BoxArgs a{vol, mat, out, B, Z, Y, X, C, min(Z, kMaxBoxZ)};
  const int p[6] = {ty, tx, margin, stages, threads, group};
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) return launch_plan<bf16>(a, p, grid, smem, st);
  return launch_plan<float>(a, p, grid, smem, st);
}
