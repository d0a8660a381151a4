// Occupancy-head tail: multi-scale integer-factor trilinear upsample
// (align_corners=False, edge clamp) and blend of up to four levels with
// per-voxel weights, then -- in the tail mode -- the folded BatchNorm
// affine, relu, the C -> K class product and the argmax to labels.
//
// Tail mode (K8) replaces the TPU kernel
// fbbev_tpu/ops/pallas_occ_tail.py:93 occ_tail (_kernel :69,
// pl.pallas_call :146) together with the Z and Y upsamples its caller runs
// (occ_head.py:258-264) and the argmax after it (occ_head.py:128).  Blend
// mode (K9) replaces fbbev_tpu/ops/pallas_occ_fuse.py:80 fuse_multiscale
// (_kernel :64, pl.pallas_call :124) with its caller's Y upsample
// (occ_head.py:207-209).
//
// Bound: bytes.  At the flagship the blend reads 187 MB of levels and
// weights and writes 164 MB (0.106 ms at 3.35 TB/s); the tail reads 98 MB
// and writes 5 MB of labels (0.031 ms).  Both are stencils whose cost on
// the card is instructions and shared-memory traffic per byte, so the
// design lerps each axis at the coarsest resolution it can (a separable
// upsample: 4.2 lerps per output element at factors 1/2/4/8 where a
// per-voxel design does 21) and reads each coarse element from global
// memory once per tile.
//
// Rounding, as the JAX package rounds every op of a bf16 array
// (Python-float weights take the array's type), R = round to T:
//   lerp = R(R(w0 * v0) + R(w1 * v1))      never fused into an FMA
// in the JAX order -- Z, then Y, then X for the tail (Z and Y outside the
// TPU kernel, X inside); Y, then Z, then X for the blend.  Then
//   acc = R(v_0 * w_0); acc = R(acc + R(v_i * w_i))       (level order)
//   h   = max(R(R(acc * a) + b), 0)                        (tail)
//   logit_k = R(sum_c h_c * k2[c, k])   (f32 sums, 16 channels a step)
//   label = first argmax_k logit_k
// bf16 pairs are computed with mul.rn.bf16x2 / add.rn.bf16x2 (the
// __hmul2 / __hadd2 of cuda_bf16.h on sm_90; never an fma): one rounding
// of the exact product or sum, which is what f32-then-round gives for two
// bf16 operands (tests/test_torch_occ.py holds that claim).  The build's
// --fmad=false keeps the f32 instantiations' products and sums apart.
//
// Design.  The plan (tile, chunk, channel groups, shared-memory layout) is
// ops/pallas_occ_tail.py::plan_occ; this file takes its offsets.  A tile
// is TY x TX output columns (y, x) with the whole Z -- in the port's
// (B, C, Y, X, Z) layout each tile row of a channel is one contiguous
// span -- and its channels are walked in chunks of CC.  Blocks are
// persistent: as many as fit the card at once, each walking tiles.
//   * Per chunk, (A) every staged level's clamped coarse neighbourhood --
//     sy x sx coarse columns of nz values, halo rows and columns clamped
//     to [0, n - 1] -- is copied to shared memory with cp.async, one chunk
//     ahead into the other of two buffers; (B) the first axis is lerped at
//     coarse resolution and (C) the second, each into shared memory; (D)
//     the X lerp at full resolution goes to registers and is blended.  An
//     axis of factor 1 is skipped (its buffer is the one before).
//   * Lerp weights depend only on the output phase o % f: each tile gets a
//     (TY + TX + Z)-entry tap table per level, computed in double and
//     rounded to T, once.
//   * Blend (K9): 256 threads, a tile of 8 x 16 columns (Z = 16), 8
//     channels a chunk.  A thread owns 8 z values of one column: level 0
//     (factor 1) is read straight from global memory with 16-byte loads,
//     the levels' weights and X taps stay in registers across the channel
//     loop, and the blend is stored with 16-byte stores.
//   * Tail (K8): 512 threads, a tile of 8 x 8 columns, 16 channels (one k16
//     slice) a chunk; level 0 is staged like the others.  A warp owns kMT
//     m16 tiles, each one z column of 16 voxels (row r <-> z = 2r for
//     r < 8, z = 2(r - 8) + 1 else), so a lane's two rows are a bf16 pair
//     along z and the A fragment of mma.sync.m16n8k16 is built from the
//     lane's own h values with two byte permutes: no shared A tile.  The
//     lane blends its 2 voxels x 4 channels level by level, applies the BN
//     affine and relu, and the warp issues one mma per n8 class tile (k2
//     zero-padded to a multiple of 8 classes, transposed in shared
//     memory).  The argmax compares the bf16-rounded logits of the classes
//     < K across the quad's lanes by shuffles, lowest class first on ties.
//     The f32 instantiation runs the same product on the CUDA cores
//     through a per-warp shared tile.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBlendThreads = 256;
constexpr int kTailThreads = 512;
constexpr int kMaxLevels = 4;
constexpr int kMaxK = 32;
constexpr int kZV = 8;        // blend: z values per thread in pass D
constexpr int kMT = 4;        // tail: m16 tiles per warp
constexpr int kTailCC = 16;   // tail: channels per chunk, one k16 slice
constexpr int kScratchLd = 17;  // tail f32: row stride of a warp's h tile
constexpr int kPlanHead = 13;
constexpr int kPlanLevel = 6;

template <int kBf16> struct Ty;
template <> struct Ty<1> {
  typedef bf16 T;
  typedef uint32_t P;  // two bf16, the lower address in the low half
  __device__ static P mul(P a, P b) {
    P d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static P add(P a, P b) {
    P d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ static P relu(P a) {
    P d;
    asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
    return d;
  }
  __device__ static P pack(float lo, float hi) {  // exact for bf16 values
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<P*>(&v);
  }
  __device__ static float lo(P v) { return __uint_as_float(v << 16); }
  __device__ static float hi(P v) { return __uint_as_float(v & 0xffff0000u); }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float get(const T* p) { return __bfloat162float(*p); }
  __device__ static void put(T* p, float v) { *p = __float2bfloat16_rn(v); }
  __device__ static P ld1(const T* p0, const T* p1) {
    return (uint32_t)*reinterpret_cast<const uint16_t*>(p0) |
           ((uint32_t)*reinterpret_cast<const uint16_t*>(p1) << 16);
  }
  __device__ static P ld2(const T* p) {
    return *reinterpret_cast<const P*>(p);
  }
  __device__ static void st2(T* p, P v) { *reinterpret_cast<P*>(p) = v; }
  __device__ static void ld8(const T* p, P* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  }
  __device__ static void st8(T* p, const P* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Ty<0> {
  typedef float T;
  typedef float2 P;
  __device__ static P mul(P a, P b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  __device__ static P add(P a, P b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  __device__ static P relu(P a) {
    return make_float2(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f));
  }
  __device__ static P pack(float lo, float hi) { return make_float2(lo, hi); }
  __device__ static float lo(P v) { return v.x; }
  __device__ static float hi(P v) { return v.y; }
  __device__ static float round(float v) { return v; }
  __device__ static float get(const T* p) { return *p; }
  __device__ static void put(T* p, float v) { *p = v; }
  __device__ static P ld1(const T* p0, const T* p1) {
    return make_float2(*p0, *p1);
  }
  __device__ static P ld2(const T* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void st2(T* p, P v) { *reinterpret_cast<float2*>(p) = v; }
  __device__ static void ld8(const T* p, P* v) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = make_float2(a.x, a.y), v[1] = make_float2(a.z, a.w);
    v[2] = make_float2(b.x, b.y), v[3] = make_float2(b.z, b.w);
  }
  __device__ static void st8(T* p, const P* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0].x, v[0].y, v[1].x,
                                                  v[1].y);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[2].x, v[2].y, v[3].x,
                                                  v[3].y);
  }
};

template <int kBf16>
__device__ __forceinline__ typename Ty<kBf16>::P lerp(
    typename Ty<kBf16>::P w0, typename Ty<kBf16>::P v0,
    typename Ty<kBf16>::P w1, typename Ty<kBf16>::P v1) {
  typedef Ty<kBf16> S;
  return S::add(S::mul(w0, v0), S::mul(w1, v1));
}

// One output coordinate's 2-tap lerp: o = i * f + k samples coarse
// coordinate (k + .5) / f - .5; weights as the JAX package computes them
// in Python floats, rounded to T; indices local to the staged span that
// starts at coarse index lo.
struct Tap {
  int i0, i1;
  float w0, w1;
};

template <int kBf16>
__device__ __forceinline__ Tap make_tap(int o, int f, int n, int lo) {
  if (f == 1) return Tap{o - lo, o - lo, 1.f, 0.f};
  const int i = o / f, k = o % f;
  const double c = (k + 0.5) / f - 0.5;
  const double w = c < 0 ? c + 1.0 : c;
  return Tap{(c < 0 ? max(i - 1, 0) : i) - lo,
             (c < 0 ? i : min(i + 1, n - 1)) - lo,
             Ty<kBf16>::round((float)(1.0 - w)),
             Ty<kBf16>::round((float)w)};
}

__device__ __forceinline__ int span_lo(int t0, int f) {
  return f == 1 ? t0 : t0 / f - 1;
}
__device__ __forceinline__ int r8(int v) { return (v + 7) & ~7; }
// A channel stride of n elements of es bytes, padded to 4 (mod 32) words:
// a warp of the tail's last pass reads 8 words of each of channels 2t and
// 2t + 1 (or 2t + 8, 2t + 9), t < 4, and they fall into distinct banks.
__device__ __forceinline__ int pad_ch(int n, int es) {
  const int w = n * es / 4;
  return (w + ((4 - w) & 31)) * 4 / es;
}

struct Level {
  const void* p;  // (B, C, ny, nx, nz)
  int ny, nx, nz, fy, fx, fz;
  int sy, sx;           // staged rows and columns (plan_occ)
  int s0, s1, s2, tap;  // shared byte offsets; s0 < 0: read from global;
                        // s1, s2 < 0: the buffer before (axis skipped)
};

struct Args {
  Level lv[kMaxLevels];
  const void* w;      // (B, n, Y, X, Z) blend weights
  const float* a;     // (C,) BN scale, rounded to T (tail)
  const float* bb;    // (C,) BN shift, rounded to T (tail)
  const float* k2;    // (C, K) class weights, rounded to T (tail)
  int64_t* labels;    // (B, Y, X, Z) (tail)
  void* logits;       // (B, Y, X, Z, K) or nullptr (tail)
  void* out;          // (B, C, Y, X, Z) (blend)
  int B, C, Y, X, Z, n, K;
  int TY, TX, CC, cpg, groups, gx, gy;
  int k2off, aoff, boff, scratch, woff;
};

// A staged level's buffers: S0 [cc][sy][r8(sx * cz)] (coarse z columns of
// nz values, cz = Zp at z factor 1), two copies, one per chunk parity;
// after the first lerp S1 and after the second S2, the last of them
// [cc][TY][sx * Zp].  Channel strides padded by pad_ch.
struct Bufs {
  int s0, s1, s2;        // byte offsets for this chunk
  int rs0, rs2;          // row strides (elements)
  int chs0, chs1, chs2;  // channel strides (elements)
};

template <int kTail>
__device__ __forceinline__ Bufs bufs(const Level& L, int TY, int CC, int Zp,
                                     int es, int par) {
  Bufs u;
  const int cz = L.fz == 1 ? Zp : L.nz;
  u.rs0 = r8(L.sx * cz);
  u.rs2 = L.sx * Zp;
  u.chs0 = pad_ch(L.sy * u.rs0, es);
  u.chs1 = pad_ch(kTail ? L.sy * u.rs2 : TY * u.rs0, es);
  u.chs2 = pad_ch(TY * u.rs2, es);
  u.s0 = L.s0 + par * CC * u.chs0 * es;
  u.s1 = L.s1 >= 0 ? L.s1 : u.s0;
  u.s2 = L.s2 >= 0 ? L.s2 : u.s1;
  return u;
}

__device__ __forceinline__ void copy_async(char* d, const char* s, int wd) {
  const unsigned da = (unsigned)__cvta_generic_to_shared(d);
  if (wd == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(da),
                 "l"(s) : "memory");
  else if (wd == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(da),
                 "l"(s) : "memory");
  else if (wd == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(da),
                 "l"(s) : "memory");
  else
    *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// (A) the clamped coarse neighbourhood of every staged level, channels
// c0 .. c0 + nc - 1, into the S0 copy of parity par.
template <int kBf16, int kTail, int kThr>
__device__ __forceinline__ void stage(const Args& a, char* sm, int b, int c0,
                                      int nc, int y0, int x0, int Zp,
                                      int par) {
  typedef typename Ty<kBf16>::T T;
  constexpr int es = sizeof(T);
#pragma unroll 1
  for (int l = 0; l < a.n; ++l) {
    const Level& L = a.lv[l];
    if (L.s0 < 0) continue;
    const Bufs u = bufs<kTail>(L, a.TY, a.CC, Zp, es, par);
    const int loy = span_lo(y0, L.fy), lox = span_lo(x0, L.fx);
    const int cz = L.fz == 1 ? Zp : L.nz;
    const int bytes = L.nz * es;
    const int wd = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8
                 : bytes % 4 == 0 ? 4 : 2;
    const int pieces = bytes / wd;
    const int64_t plane = (int64_t)L.ny * L.nx * bytes;
    const char* src = static_cast<const char*>(L.p) +
                      ((int64_t)b * a.C + c0) * plane;
    for (int e = threadIdx.x; e < L.sy * L.sx * pieces; e += kThr) {
      const int pc = e % pieces, col = e / pieces;
      const int ix = col % L.sx, iy = col / L.sx;
      const int gy = min(max(loy + iy, 0), L.ny - 1);
      const int gx = min(max(lox + ix, 0), L.nx - 1);
      const char* s = src + ((int64_t)gy * L.nx + gx) * bytes + pc * wd;
      char* d = sm + u.s0 + (iy * u.rs0 + ix * cz) * es + pc * wd;
#pragma unroll 2
      for (int cc = 0; cc < nc; ++cc, s += plane, d += u.chs0 * es)
        copy_async(d, s, wd);
    }
  }
}

// dst[cc][r][2j..] = lerp over rows tap[r] of src[cc][.][2j..], r < R,
// j < np: a lerp along y at coarse x (and coarse or full z).
template <int kBf16, int kThr>
__device__ __forceinline__ void lerp_rows(char* sm, int src, int src_chs,
                                          int dst, int dst_chs, int rs,
                                          int np, const Tap* tap, int R,
                                          int nc) {
  typedef Ty<kBf16> S;
  typedef typename S::T T;
  const T* sp = reinterpret_cast<const T*>(sm + src);
  T* dp = reinterpret_cast<T*>(sm + dst);
  for (int e = threadIdx.x; e < R * np; e += kThr) {
    const int j = e % np, r = e / np;
    const Tap t = tap[r];
    const typename S::P w0 = S::pack(t.w0, t.w0), w1 = S::pack(t.w1, t.w1);
    const T* p0 = sp + t.i0 * rs + 2 * j;
    const T* p1 = sp + t.i1 * rs + 2 * j;
    T* q = dp + r * rs + 2 * j;
#pragma unroll 2
    for (int cc = 0; cc < nc; ++cc)
      S::st2(q + cc * dst_chs,
             lerp<kBf16>(w0, S::ld2(p0 + cc * src_chs), w1,
                         S::ld2(p1 + cc * src_chs)));
  }
}

// dst[cc][r][ix][z] (columns of Zp) = lerp over z of src[cc][r][ix][.]
// (columns of nz, rows of rs), z in pairs: the z lerp at coarse y or x.
template <int kBf16, int kThr>
__device__ __forceinline__ void lerp_z(char* sm, int src, int src_chs,
                                       int dst, int dst_chs, int rs, int nz,
                                       int R, int sx, int Zp, const Tap* tap,
                                       int nc) {
  typedef Ty<kBf16> S;
  typedef typename S::T T;
  const T* sp = reinterpret_cast<const T*>(sm + src);
  T* dp = reinterpret_cast<T*>(sm + dst);
  const int hz = Zp / 2;
  for (int e = threadIdx.x; e < R * sx * hz; e += kThr) {
    const int zp = e % hz, col = e / hz;
    const int ix = col % sx, r = col / sx;
    const Tap ta = tap[2 * zp], tb = tap[2 * zp + 1];
    const typename S::P w0 = S::pack(ta.w0, tb.w0),
                        w1 = S::pack(ta.w1, tb.w1);
    const T* p = sp + r * rs + ix * nz;
    T* q = dp + (r * sx + ix) * Zp + 2 * zp;
#pragma unroll 2
    for (int cc = 0; cc < nc; ++cc, p += src_chs)
      S::st2(q + cc * dst_chs,
             lerp<kBf16>(w0, S::ld1(p + ta.i0, p + tb.i0), w1,
                         S::ld1(p + ta.i1, p + tb.i1)));
  }
}

// (B) and (C): the two lerps at coarse resolution of every staged level,
// in the JAX order (blend: y then z; tail: z then y).  second: which one.
template <int kBf16, int kTail, int kThr>
__device__ __forceinline__ void lerp_pass(const Args& a, char* sm, int nc,
                                          int Zp, bool second, int par) {
  constexpr int es = sizeof(typename Ty<kBf16>::T);
  const int TY = a.TY, TX = a.TX;
#pragma unroll 1
  for (int l = 0; l < a.n; ++l) {
    const Level& L = a.lv[l];
    if (L.s0 < 0) continue;
    const Tap* tap = reinterpret_cast<const Tap*>(sm + L.tap);
    const Bufs u = bufs<kTail>(L, TY, a.CC, Zp, es, par);
    if (!kTail && !second && L.fy > 1)  // y: S0 [sy] -> S1 [TY]
      lerp_rows<kBf16, kThr>(sm, u.s0, u.chs0, u.s1, u.chs1, u.rs0,
                             (L.sx * (L.fz == 1 ? Zp : L.nz) + 1) / 2, tap,
                             TY, nc);
    if (!kTail && second && L.fz > 1)   // z: S1 [TY] -> S2 [TY]
      lerp_z<kBf16, kThr>(sm, u.s1, u.chs1, u.s2, u.chs2, u.rs0, L.nz, TY,
                          L.sx, Zp, tap + TY + TX, nc);
    if (kTail && !second && L.fz > 1)   // z: S0 [sy] -> S1 [sy]
      lerp_z<kBf16, kThr>(sm, u.s0, u.chs0, u.s1, u.chs1, u.rs0, L.nz, L.sy,
                          L.sx, Zp, tap + TY + TX, nc);
    if (kTail && second && L.fy > 1)    // y: S1 [sy] -> S2 [TY]
      lerp_rows<kBf16, kThr>(sm, u.s1, u.chs1, u.s2, u.chs2, u.rs2,
                             u.rs2 / 2, tap, TY, nc);
  }
}

// Tail: m16 tile mt of a tile, the z column (ty, tx) of 16 voxels from z
// (ty = tx = 0 where there is no such column: v0 = v1 = false); lane
// group g holds its rows g (z) and g + 8 (z + 1).
struct MTile {
  int ty, tx, z;
  bool v0, v1;
};

__device__ __forceinline__ MTile mtile(int mt, int g, const Args& a, int y0,
                                       int x0) {
  const int mz = (a.Z + 15) / 16, col = mt / mz;
  MTile m{col / a.TX, col % a.TX, mt % mz * 16 + 2 * g, false, false};
  const bool ok = col < a.TY * a.TX && y0 + m.ty < a.Y && x0 + m.tx < a.X;
  if (!ok) m.ty = m.tx = 0;
  m.v0 = ok && m.z < a.Z;
  m.v1 = ok && m.z + 1 < a.Z;
  return m;
}

// One tile (tile column tile_x, tile row tile_y, sample and channel group
// tile_z) of the grid plan_occ lays out.
template <int kBf16, int kTail, int kNT>
__device__ __forceinline__ void occ_tile(const Args& a, char* sm,
                                         int tile_x, int tile_y,
                                         int tile_z) {
  constexpr int kThr = kTail ? kTailThreads : kBlendThreads;
  constexpr int kWarps = kThr / 32;
  typedef Ty<kBf16> S;
  typedef typename S::T T;
  typedef typename S::P P;
  constexpr int es = sizeof(T);
  const int tid = threadIdx.x;
  const int C = a.C, Y = a.Y, X = a.X, Z = a.Z, TY = a.TY, TX = a.TX;
  const int n = a.n, CC = a.CC;
  const int Zp = r8(Z);
  const int y0 = tile_y * TY, x0 = tile_x * TX;
  const int b = tile_z / a.groups, grp = tile_z % a.groups;
  const int64_t V = (int64_t)Y * X * Z;
  const int nchunks = (C + CC - 1) / CC;
  const int q0 = grp * a.cpg, q1 = min(q0 + a.cpg, nchunks);
  if (q0 < q1)  // the first chunk's copies, in flight during the set-up
    stage<kBf16, kTail, kThr>(a, sm, b, q0 * CC, min(CC, C - q0 * CC), y0,
                              x0, Zp, 0);

  // tap tables, once per tile: [TY] y, [TX] x, [Zp] z per staged level
#pragma unroll 1
  for (int l = 0; l < n; ++l) {
    const Level& L = a.lv[l];
    if (L.s0 < 0) continue;
    Tap* tb = reinterpret_cast<Tap*>(sm + L.tap);
    const int loy = span_lo(y0, L.fy), lox = span_lo(x0, L.fx);
    for (int e = tid; e < TY + TX + Zp; e += kThr) {
      if (e < TY)
        tb[e] = make_tap<kBf16>(min(y0 + e, Y - 1), L.fy, L.ny, loy);
      else if (e < TY + TX)
        tb[e] = make_tap<kBf16>(min(x0 + e - TY, X - 1), L.fx, L.nx, lox);
      else
        tb[e] = make_tap<kBf16>(min(e - TY - TX, Z - 1), L.fz, L.nz, 0);
    }
  }
  [[maybe_unused]] const int Cp = (C + 15) & ~15, Kp = kNT * 8;
  if constexpr (kTail) {
    // the blend weights of the tile, [n][TY * TX][Zp], read once
    char* ws = sm + a.woff;
    const bool vec = Z * es % 16 == 0;
    const int pieces = vec ? Zp * es / 16 : Zp;
    for (int e = tid; e < n * TY * TX * pieces; e += kThr) {
      const int pc = e % pieces, col = (e / pieces) % (TY * TX);
      const int l = e / (pieces * TY * TX);
      const int y = y0 + col / TX, x = x0 + col % TX;
      const bool ok = y < Y && x < X;
      const T* src = static_cast<const T*>(a.w) + ((int64_t)b * n + l) * V +
                     ((int64_t)y * X + x) * Z;
      T* dst = reinterpret_cast<T*>(ws) + (l * TY * TX + col) * Zp;
      if (vec && ok)
        copy_async(reinterpret_cast<char*>(dst) + pc * 16,
                   reinterpret_cast<const char*>(src) + pc * 16, 16);
      else if (vec)
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(dst) + pc * 16) =
            make_uint4(0, 0, 0, 0);
      else
        S::put(dst + pc, ok && pc < Z ? S::get(src + pc) : 0.f);
    }
  }

  // blend: this thread's 8 z values of one column, the levels' weights
  // and X taps kept in registers
  [[maybe_unused]] const int ZG = (Z + kZV - 1) / kZV;
  [[maybe_unused]] const int bz = (tid % ZG) * kZV, bcol = tid / ZG;
  [[maybe_unused]] const int bty = bcol / TX, btx = bcol % TX;
  [[maybe_unused]] const bool bok =
      !kTail && bty < TY && y0 + bty < Y && x0 + btx < X;
  [[maybe_unused]] const bool vec8 = Z % kZV == 0;
  [[maybe_unused]] const int64_t bvox =
      bok ? ((int64_t)(y0 + bty) * X + x0 + btx) * Z + bz : 0;
  [[maybe_unused]] P bw[kTail ? 1 : kMaxLevels][4];
  [[maybe_unused]] int boff0[kTail ? 1 : kMaxLevels];
  [[maybe_unused]] int boff1[kTail ? 1 : kMaxLevels];
  [[maybe_unused]] P bwx0[kTail ? 1 : kMaxLevels];
  [[maybe_unused]] P bwx1[kTail ? 1 : kMaxLevels];
  if constexpr (!kTail) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= n) break;
      const T* wp = static_cast<const T*>(a.w) + ((int64_t)b * n + l) * V +
                    bvox;
      if (bok && vec8) {
        S::ld8(wp, bw[l]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bw[l][i] = S::pack(bok && bz + 2 * i < Z ? S::get(wp + 2 * i) : 0.f,
                             bok && bz + 2 * i + 1 < Z ? S::get(wp + 2 * i + 1)
                                                       : 0.f);
      }
    }
  }
  __syncthreads();  // tap tables (and, in the first tile, class weights)
  if constexpr (!kTail) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= n) break;
      const Level& L = a.lv[l];
      if (L.s0 < 0) continue;
      const int tx = min(btx, TX - 1);
      const Tap t = reinterpret_cast<const Tap*>(sm + L.tap)[TY + tx];
      const int row = min(bty, TY - 1) * L.sx * Zp + bz;
      boff0[l] = row + (L.fx == 1 ? tx : t.i0) * Zp;
      boff1[l] = row + (L.fx == 1 ? tx : t.i1) * Zp;
      bwx0[l] = S::pack(t.w0, t.w0);
      bwx1[l] = S::pack(t.w1, t.w1);
    }
  }

  // tail: this warp's m16 tiles, one z column of 16 voxels each
  [[maybe_unused]] const int warp = tid / 32, lane = tid % 32, g = lane / 4,
                             t4 = lane % 4;
  [[maybe_unused]] float acc[kTail ? kMT : 1][kTail ? kNT : 1][4];
  if constexpr (kTail) {
#pragma unroll
    for (int j = 0; j < kMT; ++j)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
  }

  // Chunk q's copies were issued during chunk q - 1 (or the set-up) into
  // the S0 copy of its parity; the barrier after the wait also orders the
  // last pass of chunk q - 1 before this chunk's writes.
  for (int q = q0; q < q1; ++q) {
    const int c0 = q * CC, nc = min(CC, C - c0), par = (q - q0) & 1;
    wait_async();
    __syncthreads();
    if (q + 1 < q1)
      stage<kBf16, kTail, kThr>(a, sm, b, c0 + CC, min(CC, C - c0 - CC), y0,
                                x0, Zp, par ^ 1);
    lerp_pass<kBf16, kTail, kThr>(a, sm, nc, Zp, false, par);
    __syncthreads();
    lerp_pass<kBf16, kTail, kThr>(a, sm, nc, Zp, true, par);
    __syncthreads();

    if constexpr (!kTail) if (bok) {  // (D) blend: X lerp, blend, store
      T* op = static_cast<T*>(a.out) + ((int64_t)b * C + c0) * V + bvox;
      int base[kMaxLevels], chs[kMaxLevels];
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l >= n) break;
        const Bufs u = bufs<kTail>(a.lv[l], TY, CC, Zp, es, par);
        base[l] = u.s2;
        chs[l] = u.chs2;
      }
      for (int cc = 0; cc < nc; ++cc, op += V) {
        P o[4];
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l) {
          if (l >= n) break;
          P v[4];
          if (a.lv[l].s0 < 0) {
            const T* gp = static_cast<const T*>(a.lv[l].p) +
                          ((int64_t)b * C + c0 + cc) * V + bvox;
            if (vec8) {
              S::ld8(gp, v);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[i] = S::pack(bz + 2 * i < Z ? S::get(gp + 2 * i) : 0.f,
                               bz + 2 * i + 1 < Z ? S::get(gp + 2 * i + 1)
                                                  : 0.f);
            }
          } else {
            const T* sp = reinterpret_cast<const T*>(sm + base[l]) +
                          cc * chs[l];
            if (a.lv[l].fx == 1) {
              S::ld8(sp + boff0[l], v);
            } else {
              P p0[4], p1[4];
              S::ld8(sp + boff0[l], p0);
              S::ld8(sp + boff1[l], p1);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                v[i] = lerp<kBf16>(bwx0[l], p0[i], bwx1[l], p1[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const P t = S::mul(v[i], bw[l][i]);
            o[i] = l == 0 ? t : S::add(o[i], t);
          }
        }
        if (vec8) {
          S::st8(op, o);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (bz + 2 * i < Z) S::put(op + 2 * i, S::lo(o[i]));
            if (bz + 2 * i + 1 < Z) S::put(op + 2 * i + 1, S::hi(o[i]));
          }
        }
      }
    }

    if constexpr (kTail) {  // (D) tail: blend, BN, relu, class product
      const T* as = reinterpret_cast<const T*>(sm + a.aoff) + c0;
      const T* bs = reinterpret_cast<const T*>(sm + a.boff) + c0;
      const T* k2s = reinterpret_cast<const T*>(sm + a.k2off);
      uint32_t bf[kNT][2];
      if constexpr (kBf16) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const T* kr = k2s + (nt * 8 + g) * Cp + c0 + 2 * t4;
          bf[nt][0] = *reinterpret_cast<const uint32_t*>(kr);
          bf[nt][1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < kMT; ++j) {
        const MTile m = mtile(warp + kWarps * j, g, a, y0, x0);
        const int ty = m.ty, tx = m.tx, z = m.z;
        const bool v0 = m.v0;
        const T* ws = reinterpret_cast<const T*>(sm + a.woff) +
                      (ty * TX + tx) * Zp + z;
        // channels 2t, 2t + 1, 2t + 8, 2t + 9 of the chunk, level by
        // level (each channel's sum still in level order)
        P h[4];
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l) {
          if (l >= n) break;
          const Level& L = a.lv[l];
          const Bufs u = bufs<kTail>(L, TY, CC, Zp, es, par);
          const P wl = v0 ? S::ld2(ws + l * TY * TX * Zp) : S::pack(0.f, 0.f);
          const Tap tp = L.fx == 1 ? Tap{tx, tx, 1.f, 0.f}
                                   : reinterpret_cast<const Tap*>(
                                         sm + L.tap)[TY + tx];
          const P w0 = S::pack(tp.w0, tp.w0), w1 = S::pack(tp.w1, tp.w1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cc = 2 * t4 + (e & 1) + (e & 2) * 4;
            P v = S::pack(0.f, 0.f);
            if (v0) {  // z < Z: inside the column (every level staged)
              const T* sp = reinterpret_cast<const T*>(sm + u.s2) +
                            cc * u.chs2 + ty * u.rs2 + z;
              v = L.fx == 1 ? S::ld2(sp + tx * Zp)
                            : lerp<kBf16>(w0, S::ld2(sp + tp.i0 * Zp), w1,
                                          S::ld2(sp + tp.i1 * Zp));
            }
            const P t = S::mul(v, wl);
            h[e] = l == 0 ? t : S::add(h[e], t);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // BN affine and relu; 0 past C
          const int cc = 2 * t4 + (e & 1) + (e & 2) * 4;
          const float av = S::get(as + cc), bv = S::get(bs + cc);
          h[e] = cc < nc && v0 ? S::relu(S::add(S::mul(h[e], S::pack(av, av)),
                                                S::pack(bv, bv)))
                               : S::pack(0.f, 0.f);
        }
        if constexpr (kBf16) {
          uint32_t af[4];
          const uint32_t* hu = reinterpret_cast<const uint32_t*>(h);
          af[0] = __byte_perm(hu[0], hu[1], 0x5410);  // row g, k 2t..2t+1
          af[1] = __byte_perm(hu[0], hu[1], 0x7632);  // row g + 8
          af[2] = __byte_perm(hu[2], hu[3], 0x5410);  // row g, k 2t+8..
          af[3] = __byte_perm(hu[2], hu[3], 0x7632);  // row g + 8
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};"
                : "+f"(acc[j][nt][0]), "+f"(acc[j][nt][1]),
                  "+f"(acc[j][nt][2]), "+f"(acc[j][nt][3])
                : "r"(af[0]), "r"(af[1]), "r"(af[2]), "r"(af[3]),
                  "r"(bf[nt][0]), "r"(bf[nt][1]));
        } else {  // f32: the same product on the CUDA cores
          float* hs = reinterpret_cast<float*>(sm + a.scratch) +
                      warp * 16 * kScratchLd;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cc = 2 * t4 + (e & 1) + (e & 2) * 4;
            hs[g * kScratchLd + cc] = S::lo(h[e]);
            hs[(g + 8) * kScratchLd + cc] = S::hi(h[e]);
          }
          __syncwarp();
          const float* kf = reinterpret_cast<const float*>(k2s) + c0 * Kp;
#pragma unroll 1
          for (int c = 0; c < kTailCC; ++c) {  // each sum in channel order
            const float h0 = hs[g * kScratchLd + c];
            const float h1 = hs[(g + 8) * kScratchLd + c];
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const float k0 = kf[c * Kp + nt * 8 + 2 * t4];
              const float k1 = kf[c * Kp + nt * 8 + 2 * t4 + 1];
              acc[j][nt][0] = __fadd_rn(acc[j][nt][0], __fmul_rn(h0, k0));
              acc[j][nt][1] = __fadd_rn(acc[j][nt][1], __fmul_rn(h0, k1));
              acc[j][nt][2] = __fadd_rn(acc[j][nt][2], __fmul_rn(h1, k0));
              acc[j][nt][3] = __fadd_rn(acc[j][nt][3], __fmul_rn(h1, k1));
            }
          }
          __syncwarp();
        }
      }
    }
  }

  if constexpr (kTail) {  // argmax of the rounded logits of classes < K
#pragma unroll
    for (int j = 0; j < kMT; ++j) {
      const MTile m = mtile(warp + kWarps * j, g, a, y0, x0);
      const bool v0 = m.v0, v1 = m.v1;
      const int vox = ((y0 + m.ty) * X + x0 + m.tx) * Z + m.z;
      float bv[2] = {0.f, 0.f};
      int bi[2] = {kMaxK, kMaxK};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i / 2, k = nt * 8 + 2 * t4 + (i & 1);
          const float v = S::round(acc[j][nt][i]);
          if (k < a.K && (bi[r] == kMaxK || v > bv[r])) {
            bv[r] = v;
            bi[r] = k;
          }
          if (a.logits != nullptr && k < a.K && (r ? v1 : v0))
            S::put(static_cast<T*>(a.logits) +
                       ((int64_t)b * V + vox + r) * a.K + k,
                   v);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 1; m < 4; m *= 2) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv[r], m);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[r], m);
          if (oi != kMaxK &&
              (bi[r] == kMaxK || ov > bv[r] || (ov == bv[r] && oi < bi[r]))) {
            bv[r] = ov;
            bi[r] = oi;
          }
        }
      if (t4 == 0) {
        if (v0) a.labels[(int64_t)b * V + vox] = bi[0];
        if (v1) a.labels[(int64_t)b * V + vox + 1] = bi[1];
      }
    }
  }
}

// Persistent blocks, as many as fit the card at once, each walking the
// tiles: the class weights are read once per block, and a tile's set-up
// overlaps the tail of the one before on the other blocks of its SM.
template <int kBf16, int kTail, int kNT>
__global__ void __launch_bounds__(kTail ? kTailThreads : kBlendThreads,
                                  kTail ? 1 : 2) occ_kernel(const Args a) {
  typedef Ty<kBf16> S;
  typedef typename S::T T;
  constexpr int kThr = kTail ? kTailThreads : kBlendThreads;
  extern __shared__ __align__(16) char sm[];
  if constexpr (kTail) {  // k2 (bf16: (Kp, Cp), transposed; f32: (Cp, Kp))
    const int Cp = (a.C + 15) & ~15, Kp = kNT * 8;
    T* k2s = reinterpret_cast<T*>(sm + a.k2off);
    for (int e = threadIdx.x; e < Kp * Cp; e += kThr) {
      const int k = kBf16 ? e / Cp : e % Kp, c = kBf16 ? e % Cp : e / Kp;
      S::put(k2s + e, k < a.K && c < a.C ? a.k2[c * a.K + k] : 0.f);
    }
    for (int c = threadIdx.x; c < Cp; c += kThr) {
      S::put(reinterpret_cast<T*>(sm + a.aoff) + c, c < a.C ? a.a[c] : 0.f);
      S::put(reinterpret_cast<T*>(sm + a.boff) + c, c < a.C ? a.bb[c] : 0.f);
    }
  }
  const int ntiles = a.gx * a.gy * a.B * a.groups;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    occ_tile<kBf16, kTail, kNT>(a, sm, t % a.gx, t / a.gx % a.gy,
                                t / (a.gx * a.gy));
    __syncthreads();  // the next tile reuses the shared memory
  }
}

template <int kBf16, int kTail, int kNT>
int launch(const Args& a, int smem, cudaStream_t s) {
  auto* kernel = occ_kernel<kBf16, kTail, kNT>;
  constexpr int threads = kTail ? kTailThreads : kBlendThreads;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (int64_t)a.gx * a.gy * a.B * a.groups;
  const int blocks = (int)(tiles < (int64_t)sms * per_sm ? tiles
                                                         : sms * per_sm);
  kernel<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int kBf16>
int launch_mode(const Args& a, int tail, int smem, cudaStream_t s) {
  if (!tail) return launch<kBf16, 0, 0>(a, smem, s);
  switch ((a.K + 7) / 8) {
    case 1: return launch<kBf16, 1, 1>(a, smem, s);
    case 2: return launch<kBf16, 1, 2>(a, smem, s);
    case 3: return launch<kBf16, 1, 3>(a, smem, s);
    default: return launch<kBf16, 1, 4>(a, smem, s);
  }
}

}  // namespace

// levels: n pointers (B, C, dims[3l], dims[3l+1], dims[3l+2]), each dim a
// divisor of Y / X / Z.  tail != 0: K8 (a, b, k2, labels, optional
// logits); tail == 0: K9 (out).  plan: kPlanHead ints (TY, TX, CC, chunks
// per group, groups, shared bytes, k2 / a / b / scratch offsets, grid x,
// grid y, blend-weight offset) then kPlanLevel per level (sy, sx, s0, s1,
// s2, tap offsets), as ops/pallas_occ_tail.py::plan_occ lays them out.
extern "C" int fbbev_occ_tail(const void* const* levels, const int* dims,
                              int n, const void* w, const float* a,
                              const float* b, const float* k2,
                              int64_t* labels, void* logits, void* out,
                              int is_bf16, int tail, int B, int C, int Y,
                              int X, int Z, int K, const int* plan,
                              void* stream) {
  if (n < 1 || n > kMaxLevels || (tail && (K < 1 || K > kMaxK)) || C < 1)
    return (int)cudaErrorInvalidValue;
  Args g{};
  for (int l = 0; l < n; ++l) {
    Level& L = g.lv[l];
    L.p = levels[l];
    L.ny = dims[3 * l];
    L.nx = dims[3 * l + 1];
    L.nz = dims[3 * l + 2];
    if (L.ny < 1 || L.nx < 1 || L.nz < 1 || Y % L.ny || X % L.nx ||
        Z % L.nz)
      return (int)cudaErrorInvalidValue;
    L.fy = Y / L.ny;
    L.fx = X / L.nx;
    L.fz = Z / L.nz;
    const int* p = plan + kPlanHead + kPlanLevel * l;
    L.sy = p[0];
    L.sx = p[1];
    L.s0 = p[2];
    L.s1 = p[3];
    L.s2 = p[4];
    L.tap = p[5];
    if (tail && L.s0 < 0) return (int)cudaErrorInvalidValue;
  }
  g.w = w;
  g.a = a;
  g.bb = b;
  g.k2 = k2;
  g.labels = labels;
  g.logits = logits;
  g.out = out;
  g.B = B;
  g.C = C;
  g.Y = Y;
  g.X = X;
  g.Z = Z;
  g.n = n;
  g.K = K;
  g.TY = plan[0];
  g.TX = plan[1];
  g.CC = plan[2];
  g.cpg = plan[3];
  g.groups = plan[4];
  const int smem = plan[5];
  g.k2off = plan[6];
  g.aoff = plan[7];
  g.boff = plan[8];
  g.scratch = plan[9];
  g.woff = plan[12];
  if ((int64_t)Y * X * Z >= (int64_t)1 << 31 || smem > 232448 || g.TY < 1 ||
      g.TX < 1 || g.CC < 1 || g.groups < 1 ||
      (tail && (g.groups != 1 || g.CC != kTailCC)))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)B * Y * X * Z == 0) return 0;
  g.gx = plan[10];
  g.gy = plan[11];
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_mode<1>(g, tail, smem, s)
                 : launch_mode<0>(g, tail, smem, s);
}
