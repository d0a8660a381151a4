// 3x3 stride-1 zero-padded ("SAME") 2D convolution, channels-last, f32
// accumulation, output in the input type.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_conv.py:67 conv3x3_s1
// (_kernel :51, pl.pallas_call :90), which materialises the nine shifted
// views of the padded input in HBM and multiplies (rows, 9*Cin) panels by
// (9*Cin, Cout) on the MXU; its VJP (:132-156) takes the input gradient as
// the same convolution on flipped, io-transposed weights.  Here the
// implicit GEMM is direct: no shifted copies are written.
//
//   y[n, oy, ox, co] = sum_{ky, kx, ci} x[n, oy+ky-1, ox+kx-1, ci]
//                                       * w[ky, kx, ci, co]
//   x (N, H, W, Cin), y (N, H, W, Cout); zero outside the image.
//
// bf16: the implicit GEMM of K6 (conv3d.cu) on Hopper's TMA and wgmma,
// with 9 taps instead of 27 and a 4-D box instead of a 5-D one.  M = the
// output pixels of one (TY, TX) box of one image in a tile of BM = 64 or
// 128 rows (TY * TX <= BM: a box such as 5 x 25 tiles a 100 x 100 image
// exactly; the tile rows past it are never loaded, their products never
// stored); N = BN (64, 128 or 256) output channels; K = 9 taps x Cin in
// 64-channel steps, taps outer.  A K step's A tile is ONE 4-D TMA box
// (64 channels, TX, TY, 1) of the channels-last input at (k0, x0+dx-1,
// y0+dy-1, n): TMA zero-fills what lies outside the tensor, negative
// coordinates and channels >= Cin included -- exactly the conv's zero
// padding and the ragged edge, so there is no halo code.  Its B tile is a
// TMA box (64, BN, 1) of the weights relaid out to (9, Cout, Cin), zero
// past Cout and Cin: a first small kernel (relayout) writes them from w's
// own strides -- for the input gradient from w with its channels swapped
// and its taps flipped -- into the wrapper's workspace, so the wrapper
// issues no PyTorch copy.  Both tiles land as 128-byte rows in the
// 128-byte swizzle that wgmma reads K-major.  The ring (tma_wgmma.cuh, kStages stages, full /
// empty mbarriers), one producer thread keeping the loads in flight, BM /
// 64 consumer warpgroups on wgmma m64nBNk16 with f32 accumulators in
// registers.  The epilogue rounds once to bf16 and stores channels-last,
// masking the ragged x / y edge and channels >= Cout.  Small convs split
// the 9 * ceil(Cin / 64) K steps into S equal ranges: each writes f32
// partials, and a second pass sums them in split order and casts (no
// atomics: the same sum every run).  The tile plan (TY, TX, BM, BN, S) is
// computed by the wrapper (ops/pallas_conv.py::plan_bf16) and passed in as
// ints.
// f32: a plain CUDA-core kernel (no TF32: f32 stays f32), for the checks:
// an 8 x 16 pixel by 64 channel block stages its input halo and weights
// per 8-channel chunk in shared memory.
//
// Bound: operations -- 2 * N*H*W * 9*Cin*Cout on the bf16 tensor cores
// at the image-trunk and z-slab shapes; the bytes (input and output once,
// weights once) sit below that.  What the design does about it: every
// product on wgmma from swizzled shared memory, loads by TMA off the
// consumers' instruction stream, tiles up to 128 x 256, split K where the
// conv is too small to fill the card.
//
// Requirements (checked by the wrapper and here): Cin % 16 == 0, Cout %
// 16 == 0; bf16 tensors 16-byte aligned (TMA).

#include "tma_wgmma.cuh"

namespace {

// The conv's weights Wc (O, I, 3, 3): Wc[o][i][ky][kx] = w[o * so + i * si
// + ky * sy + kx * sx] (element strides; the input gradient's conv is the
// forward's w with o and i swapped), with `flip` Wc[o][i][2 - ky][2 - kx].
struct Weights {
  const void* w;
  int O, I, so, si, sy, sx, flip;
};

// Wc tap-major into wk: (9, O, I) with `k_major` (the bf16 kernel's B
// operand, K = I contiguous), else (9, I, O) (the f32 kernel's).
template <typename T>
__global__ void relayout(Weights a, T* __restrict__ wk, int k_major) {
  const int plane = a.O * a.I;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 9 * plane;
       e += gridDim.x * blockDim.x) {
    const int t = e / plane, r = e % plane;
    const int o = k_major ? r / a.I : r % a.O;
    const int i = k_major ? r % a.I : r / a.O;
    const int tap = a.flip ? 8 - t : t;
    wk[e] = static_cast<const T*>(a.w)[(int64_t)o * a.so + (int64_t)i * a.si +
                                       (tap / 3) * a.sy + (tap % 3) * a.sx];
  }
}

template <typename T>
int launch_relayout(const Weights& a, T* wk, int k_major, cudaStream_t st) {
  const int blocks = (9 * a.O * a.I + 255) / 256;
  relayout<T><<<blocks < 1024 ? blocks : 1024, 256, 0, st>>>(a, wk, k_major);
  return (int)cudaGetLastError();
}

// Byte offset of the split-K partials in the workspace, after the relaid
// weights (9 * O * I elements of `elt` bytes).
int64_t partials_offset(int O, int I, int elt) {
  return ((int64_t)9 * O * I * elt + 255) / 256 * 256;
}

// The bf16 kernel's tile plan.  Block (blockIdx.x, blockIdx.y, blockIdx.z)
// = (M tile ty_i * tiles_x + tx_i, N tile, n * S + split).
struct Plan {
  int N, H, W, Cin, Cout;
  int TY, TX, S, tiles_x;
  int steps;  // K steps per split: 9 * ceil(Cin / 64) / S
  void* out;  // S == 1: y bf16 (N, H, W, Cout); else f32 partials
              // (S, N, H, W, Cout)
};

// WGM consumer warpgroups (BM = 64 * WGM rows), then one producer warp.
template <int WGM, int BN>
__global__ void __launch_bounds__(WGM * 128 + 32, WGM* BN >= 256 ? 1 : 2)
    conv3x3_wgmma(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const Plan p) {
  typedef Ring<WGM, BN> R;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = R::init(smem_raw);
  const int y0 = (blockIdx.x / p.tiles_x) * p.TY;
  const int x0 = (blockIdx.x % p.tiles_x) * p.TX;
  const int co0 = blockIdx.y * BN;
  const int n = blockIdx.z / p.S, split = blockIdx.z % p.S;
  const int kc = (p.Cin + 63) / 64, step0 = split * p.steps;
  const int box = p.TY * p.TX;  // A tile rows the box fills (<= BM)

  if (threadIdx.x >= WGM * 128) {  // producer warp: one thread issues loads
    if (threadIdx.x == WGM * 128) {
      for (int it = 0; it < p.steps; ++it) {
        uint32_t bar;
        const uint32_t a = R::acquire(base, it, box * 128 + R::kB, bar);
        const int tap = (step0 + it) / kc, k0 = ((step0 + it) % kc) * 64;
        tma_load_4d(a, &xmap, bar, k0, x0 + tap % 3 - 1, y0 + tap / 3 - 1,
                    n);
        tma_load_3d(a + R::kA, &wmap, bar, k0, co0, tap);
      }
    }
    return;
  }

  float acc[BN / 2];
  R::consume(acc, base, p.steps);
  // tile row m = ty * TX + tx; the rows past the box (never loaded) and
  // the ragged x / y edge are not stored
  store_tile<BN>(acc, co0, p.Cout, p.S, split, (int64_t)p.N * p.H * p.W,
                 p.out, [&](int m) {
                   const int oy = y0 + m / p.TX, ox = x0 + m % p.TX;
                   if (m >= box || ox >= p.W || oy >= p.H) return (int64_t)-1;
                   return ((int64_t)n * p.H + oy) * p.W + ox;
                 });
}

template <int WGM, int BN>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const Plan& p,
                 int tiles_y, cudaStream_t stream) {
  typedef Ring<WGM, BN> R;
  static uint64_t smem_set = 0;
  const int err = allow_smem(conv3x3_wgmma<WGM, BN>, R::kSmem, smem_set);
  if (err != 0) return err;
  const dim3 grid(tiles_y * p.tiles_x, (p.Cout + BN - 1) / BN, p.N * p.S);
  conv3x3_wgmma<WGM, BN><<<grid, R::kThreads, R::kSmem, stream>>>(xm, wm, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- f32
constexpr int TH = 8;          // output rows per block
constexpr int TW = 16;         // output columns per block
constexpr int BNF = 64;        // output channels per block
constexpr int KC = 8;          // input channels staged per step
constexpr int kThreads = 256;  // 8 warps
constexpr int HH = TH + 2;     // halo rows
constexpr int HWD = TW + 2;    // halo columns

struct Args {
  const float* x;  // (N, H, W, Cin)
  const float* w;  // (9, Cin, Cout)
  float* y;        // (N, H, W, Cout)
  int N, H, W, Cin, Cout;
};

// Stage channel chunk k0: the halo halo[(hy * HWD + hx) * KC + kk] and the
// weights wsm[(tap * KC + kk) * BNF + c], zeros outside the image / Cout.
__device__ __forceinline__ void stage(const Args& a, float* halo, float* wsm,
                                      int n, int ty0, int tx0, int co0,
                                      int k0) {
  constexpr int PV = KC / 4;   // 16-byte vectors per halo pixel
  constexpr int RV = BNF / 4;  // vectors per weight row
  for (int e = threadIdx.x; e < HH * HWD * PV; e += kThreads) {
    const int p = e / PV, v = e % PV;
    const int iy = ty0 - 1 + p / HWD, ix = tx0 - 1 + p % HWD;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
      q = *reinterpret_cast<const float4*>(
          a.x + (((int64_t)n * a.H + iy) * a.W + ix) * a.Cin + k0 + v * 4);
    reinterpret_cast<float4*>(halo)[e] = q;
  }
  for (int e = threadIdx.x; e < 9 * KC * RV; e += kThreads) {
    const int r = e / RV, v = e % RV;  // r = tap * KC + kk
    const int tap = r / KC, kk = r % KC;
    const int co = co0 + v * 4;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (co < a.Cout)
      q = *reinterpret_cast<const float4*>(
          a.w + ((int64_t)tap * a.Cin + k0 + kk) * a.Cout + co);
    reinterpret_cast<float4*>(wsm)[e] = q;
  }
}

// Each thread owns 8 pixels x 4 channels and multiplies and adds on the
// CUDA cores.
__global__ void __launch_bounds__(kThreads) conv3x3_f32(Args a) {
  __shared__ __align__(16) float halo[HH * HWD * KC];
  __shared__ __align__(16) float wsm[9 * KC * BNF];
  const int tiles_x = (a.W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * BNF, n = blockIdx.z;
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
    stage(a, halo, wsm, n, ty0, tx0, co0, k0);
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      const float* hrow = halo + ((row + ky) * HWD + col0 + kx) * KC;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 w4 =
            reinterpret_cast<const float4*>(wsm + (tap * KC + kk) * BNF)[cg];
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
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int ox = tx0 + col0 + p;
    if (ox < a.W)
      *reinterpret_cast<float4*>(
          a.y + (((int64_t)n * a.H + oy) * a.W + ox) * a.Cout + co) =
          make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
  }
}

}  // namespace

// Both entries take x (N, H, W, Cin), the conv's weights as strides of w
// (O = Cout, I = Cin; see Weights) and y (N, H, W, Cout), and a workspace
// ws: the weights relaid out (9 * Cout * Cin of x's type), then, for the
// bf16 kernel with S > 1, the f32 partials (S, N, H, W, Cout) at
// partials_offset.  They launch the relayout, then the conv.

extern "C" int fbbev_conv3x3_f32(const void* x, const void* w, void* y,
                                 void* ws, int N, int H, int W, int Cin,
                                 int Cout, int so, int si, int sy, int sx,
                                 int flip, void* stream) {
  if (Cin % 16 || Cout % 16 || N < 0 || H < 0 || W < 0 ||
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)ws) % 16)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0 || Cout == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* wk = static_cast<float*>(ws);
  const int r = launch_relayout(Weights{w, Cout, Cin, so, si, sy, sx, flip},
                                wk, 0, st);
  if (r != 0) return r;
  const Args a{static_cast<const float*>(x), wk, static_cast<float*>(y), N,
               H, W, Cin, Cout};
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW),
                  (Cout + BNF - 1) / BNF, N);
  conv3x3_f32<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// bf16.  The plan: an output box TY x TX of at most BM in {64, 128}
// pixels, BN in {64, 128, 256} (256 with BM 128 only), S dividing the
// 9 * ceil(Cin / 64) K steps.
extern "C" int fbbev_conv3x3_bf16(const void* x, const void* w, void* y,
                                  void* ws, int N, int H, int W, int Cin,
                                  int Cout, int so, int si, int sy, int sx,
                                  int flip, int TY, int TX, int BM, int BN,
                                  int S, void* stream) {
  const int steps = 9 * ((Cin + 63) / 64);
  if (Cin % 16 || Cout % 16 || Cin < 16 || TY < 1 || TX < 1 ||
      TY * TX > BM || (BM != 64 && BM != 128) ||
      (BN != 64 && BN != 128 && BN != 256) || (BN == 256 && BM != 128) ||
      S < 1 || steps % S || N < 0 || H < 0 || W < 0 || ws == nullptr ||
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)ws) % 16)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || H == 0 || W == 0 || Cout == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  bf16* wk = static_cast<bf16*>(ws);
  void* parts = static_cast<char*>(ws) + partials_offset(Cout, Cin, 2);
  int r = launch_relayout(Weights{w, Cout, Cin, so, si, sy, sx, flip}, wk, 1,
                          st);
  if (r != 0) return r;
  CUtensorMap xm, wm;
  const cuuint64_t xd[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)N};
  const cuuint32_t xb[4] = {64, (cuuint32_t)TX, (cuuint32_t)TY, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
  const cuuint32_t wb[3] = {64, (cuuint32_t)BN, 1};
  r = encode(&xm, x, 4, xd, xb);
  if (r == 0) r = encode(&wm, wk, 3, wd, wb);
  if (r != 0) return r;
  const int tiles_y = (H + TY - 1) / TY;
  const Plan p{N, H, W, Cin, Cout, TY, TX, S, (W + TX - 1) / TX, steps / S,
               S == 1 ? y : parts};
  if (BM == 128)
    r = BN == 256   ? launch_wgmma<2, 256>(xm, wm, p, tiles_y, st)
        : BN == 128 ? launch_wgmma<2, 128>(xm, wm, p, tiles_y, st)
                    : launch_wgmma<2, 64>(xm, wm, p, tiles_y, st);
  else
    r = BN == 128 ? launch_wgmma<1, 128>(xm, wm, p, tiles_y, st)
                  : launch_wgmma<1, 64>(xm, wm, p, tiles_y, st);
  if (r != 0 || S == 1) return r;
  return launch_split_sum(parts, y, (int64_t)N * H * W * Cout, S, st);
}
