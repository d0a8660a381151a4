// Occupancy-head tail: multi-scale integer-factor trilinear upsample
// (align_corners=False, edge clamp) and softmax blend of up to four
// levels, then -- in the tail mode -- the folded BatchNorm affine, relu,
// the C -> K class product and the argmax to labels.
//
// Tail mode (K8) replaces the TPU kernel
// fbbev_tpu/ops/pallas_occ_tail.py:93 occ_tail (_kernel :69,
// pl.pallas_call :146) together with the Z and Y upsamples its caller runs
// (occ_head.py:258-264) and the argmax after it (occ_head.py:128).  Blend
// mode (K9) replaces fbbev_tpu/ops/pallas_occ_fuse.py:80 fuse_multiscale
// (_kernel :64, pl.pallas_call :124) with its caller's Y upsample
// (occ_head.py:207-209).
//
// One thread per output voxel (b, y, x, z), all channels: each level's
// value is built from its (up to) 8 coarse neighbours by three 2-tap
// lerps, each rounded to the levels' type as the JAX package rounds every
// op of a bf16 array (Python-float weights take the array's type):
//   lerp = R(R(w0 * v0) + R(w1 * v1)),  R = round to T
// in the JAX order -- Z, then Y, then X for the tail (Z and Y outside the
// TPU kernel, X inside); Y, then Z, then X for the blend.  Then
//   acc = R(v_0 * w_0); acc = R(acc + R(v_i * w_i))       (blend, T)
//   h   = max(R(R(acc * a) + b), 0)                        (tail)
//   logit_k = R(sum_c h_c * k2[c, k])    (f32 sum of exact products)
//   label = first argmax_k logit_k
// so labels agree with the plain version except where f32 sums taken in
// another order round to another bf16 logit at a near-tie.  An axis of
// factor 1 inside an upsampled level is the lerp (v, v) with weights
// (1, 0): the same value (a zero may change sign), and straight-line code
// whose 8 loads can all be in flight.  The corner offsets and lerp weights
// are computed once per voxel; the channel loop only loads, lerps and
// accumulates.
//
// Layout: the port's (B, C, Y, X, Z) tensors as they are: neighbouring
// threads take neighbouring z, so every read of a full-resolution level,
// of the blend weights (B, n, Y, X, Z) and every write of the blend is
// coalesced; the coarse levels' reads hit the caches.  No copy to
// channels-last is made.
//
// Bound: bytes -- the levels and weights read once, labels (and, when
// asked, logits or the blend) written once; the flagship tail is 0.044 ms
// of HBM time, its ~5 GFLOP of f32 lerp arithmetic below that.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 4;
constexpr int kMaxK = 32;

template <typename T> struct Num;
template <> struct Num<bf16> {
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float load(const bf16* p) { return __bfloat162float(*p); }
  __device__ static void store(bf16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};
template <> struct Num<float> {
  __device__ static float round(float v) { return v; }
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
};

struct Args {
  const void* lv[kMaxLevels];  // (B, C, Yi, Xi, Zi)
  int ly[kMaxLevels], lx[kMaxLevels], lz[kMaxLevels];
  const void* w;     // (B, n, Y, X, Z) blend weights
  const float* a;    // (C,) BN scale, already rounded to T (tail)
  const float* bb;   // (C,) BN shift, already rounded to T (tail)
  const float* k2;   // (C, K) class product, already rounded to T (tail)
  int64_t* labels;   // (B, Y, X, Z) (tail)
  void* logits;      // (B, Y, X, Z, K) or nullptr (tail)
  void* out;         // (B, C, Y, X, Z) (blend)
  int B, C, Y, X, Z, n, K;
};

// One output coordinate's 2-tap lerp: o = i * s + k samples input
// coordinate (k + .5) / s - .5, weights as the JAX package computes them
// in Python floats, rounded to T.  Factor 1 is the lerp (v, v) with
// weights (1, 0), which gives v itself.
struct Tap {
  int i0, i1;
  float w0, w1;
};

template <typename T>
__device__ Tap tap(int o, int s, int n) {
  if (s == 1) return Tap{o, o, 1.f, 0.f};
  const int i = o / s, k = o % s;
  const double c = (k + 0.5) / s - 0.5;
  const double w = c < 0 ? c + 1.0 : c;
  return Tap{c < 0 ? max(i - 1, 0) : i, c < 0 ? i : min(i + 1, n - 1),
             Num<T>::round((float)(1.0 - w)), Num<T>::round((float)w)};
}

template <typename T>
__device__ __forceinline__ float lerp(const Tap& t, float v0, float v1) {
  return Num<T>::round(Num<T>::round(t.w0 * v0) + Num<T>::round(t.w1 * v1));
}

// kTail: K8 (Z, Y, X lerp order; BN, relu, product, argmax); else K9
// (Y, Z, X order; the blend written).
template <typename T, bool kTail>
__global__ void __launch_bounds__(kThreads) occ_tail_kernel(Args a) {
  extern __shared__ float sm[];  // k2 [C][K], a [C], b [C] (tail)
  const int C = a.C, K = a.K, Y = a.Y, X = a.X, Z = a.Z;
  if (kTail) {
    for (int e = threadIdx.x; e < C * K; e += kThreads) sm[e] = a.k2[e];
    for (int e = threadIdx.x; e < C; e += kThreads) {
      sm[C * K + e] = a.a[e];
      sm[C * K + C + e] = a.bb[e];
    }
    __syncthreads();
  }
  const int64_t V = (int64_t)Y * X * Z;
  const int64_t gv = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (gv >= (int64_t)a.B * V) return;
  const int b = gv / V;
  const int64_t v = gv % V;
  const int z = v % Z, x = (v / Z) % X, y = v / ((int64_t)Z * X);

  // per level: the lerp taps in lerp order -- axis A first, B second, X
  // last (tail: A = Z, B = Y; blend: A = Y, B = Z) -- and the offsets,
  // within one channel plane, of the 8 coarse corners [x tap][B tap][A tap]
  Tap ta[kMaxLevels], tb[kMaxLevels], tx[kMaxLevels];
  bool same[kMaxLevels];  // factor 1 on every axis: the level's own value
  int off[kMaxLevels][8];
  const T* base[kMaxLevels];  // this sample's channel c of each level
  int plane[kMaxLevels];      // elements per channel of each level
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l >= a.n) break;
    const Tap ty = tap<T>(y, Y / a.ly[l], a.ly[l]);
    const Tap tz = tap<T>(z, Z / a.lz[l], a.lz[l]);
    tx[l] = tap<T>(x, X / a.lx[l], a.lx[l]);
    ta[l] = kTail ? tz : ty;
    tb[l] = kTail ? ty : tz;
    const int ry = a.lx[l] * a.lz[l];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int xi = (e & 4) ? tx[l].i1 : tx[l].i0;
      const int ib = (e & 2) ? tb[l].i1 : tb[l].i0;
      const int ia = (e & 1) ? ta[l].i1 : ta[l].i0;
      off[l][e] = (kTail ? ib : ia) * ry + xi * a.lz[l] + (kTail ? ia : ib);
    }
    same[l] = a.ly[l] == Y && a.lx[l] == X && a.lz[l] == Z;
    plane[l] = a.ly[l] * ry;
    base[l] = static_cast<const T*>(a.lv[l]) + (int64_t)b * C * plane[l];
  }
  const T* w = static_cast<const T*>(a.w);
  float wl[kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l < a.n) wl[l] = Num<T>::load(w + ((int64_t)b * a.n + l) * V + v);

  float logit[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) logit[k] = 0.f;

  for (int c = 0; c < C; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= a.n) break;
      const T* p = base[l];
      base[l] += plane[l];
      float v;
      if (same[l]) {
        v = Num<T>::load(p + off[l][0]);
      } else {  // straight-line: all 8 loads can be in flight at once
        float q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) q[e] = Num<T>::load(p + off[l][e]);
        v = lerp<T>(tx[l],
                    lerp<T>(tb[l], lerp<T>(ta[l], q[0], q[1]),
                            lerp<T>(ta[l], q[2], q[3])),
                    lerp<T>(tb[l], lerp<T>(ta[l], q[4], q[5]),
                            lerp<T>(ta[l], q[6], q[7])));
      }
      const float t = Num<T>::round(v * wl[l]);
      acc = l == 0 ? t : Num<T>::round(acc + t);
    }
    if (!kTail) {
      Num<T>::store(static_cast<T*>(a.out) + ((int64_t)b * C + c) * V + v,
                    acc);
      continue;
    }
    const float h = fmaxf(
        Num<T>::round(Num<T>::round(acc * sm[C * K + c]) + sm[C * K + C + c]),
        0.f);
    const float* kr = sm + c * K;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) logit[k] += h * kr[k];
  }
  if (!kTail) return;
  int best = 0;
  float bv = Num<T>::round(logit[0]);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= K) break;
    const float lk = Num<T>::round(logit[k]);
    if (a.logits != nullptr)
      Num<T>::store(static_cast<T*>(a.logits) + gv * K + k, lk);
    if (lk > bv) {
      bv = lk;
      best = k;
    }
  }
  a.labels[gv] = best;
}

template <typename T, bool kTail>
int launch(const Args& a, cudaStream_t s) {
  const int64_t n = (int64_t)a.B * a.Y * a.X * a.Z;
  const size_t smem = kTail ? (size_t)(a.C * a.K + 2 * a.C) * 4 : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        occ_tail_kernel<T, kTail>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  occ_tail_kernel<T, kTail>
      <<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// levels: n pointers (B, C, dims[3l], dims[3l+1], dims[3l+2]), each dim a
// divisor of Y / X / Z.  tail != 0: K8 (a, b, k2, labels, optional
// logits); tail == 0: K9 (out).
extern "C" int fbbev_occ_tail(const void* const* levels, const int* dims,
                              int n, const void* w, const float* a,
                              const float* b, const float* k2,
                              int64_t* labels, void* logits, void* out,
                              int is_bf16, int tail, int B, int C, int Y,
                              int X, int Z, int K, void* stream) {
  if (n < 1 || n > kMaxLevels || (tail && (K < 1 || K > kMaxK)) || C < 1)
    return (int)cudaErrorInvalidValue;
  Args g{};
  for (int l = 0; l < n; ++l) {
    g.lv[l] = levels[l];
    g.ly[l] = dims[3 * l];
    g.lx[l] = dims[3 * l + 1];
    g.lz[l] = dims[3 * l + 2];
    if (g.ly[l] < 1 || g.lx[l] < 1 || g.lz[l] < 1 || Y % g.ly[l] ||
        X % g.lx[l] || Z % g.lz[l])
      return (int)cudaErrorInvalidValue;
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
  if ((int64_t)B * Y * X * Z == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return tail ? launch<bf16, true>(g, s) : launch<bf16, false>(g, s);
  return tail ? launch<float, true>(g, s) : launch<float, false>(g, s);
}
