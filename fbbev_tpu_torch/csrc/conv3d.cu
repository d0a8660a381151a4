// 3x3x3 stride-1 zero-padded ("SAME") 3D convolution, channels-last, f32
// accumulation, output in the input type.
//
// Replaces the TPU kernel fbbev_tpu/ops/pallas_conv3d.py:130 conv3d_3x3x3
// (_kernel :77, pl.pallas_call :157), which DMAs a (TY+2, TX+2, Z, Cin)
// halo slab into VMEM, builds the z-banded im2col (Z, 3*Cin) with sublane
// shifts and multiplies it by the (3*Cin, Cout) weights of each (dy, dx)
// tap on the MXU.
//
//   y[b, oy, ox, oz, co] = sum_{dy, dx, dz, ci} x[b, oy+dy-1, ox+dx-1,
//                                                 oz+dz-1, ci]
//                                              * w[dy, dx, dz, ci, co]
//   x (B, Y, X, Z, Cin), y (B, Y, X, Z, Cout); zero outside the volume
//   (the z edges included).
//
// bf16: an implicit GEMM on Hopper's TMA and wgmma.  M = the output voxels
// of one (TY, TX, Z') box, Z' = Z rounded up to a power of two so that
// TY * TX * Z' = BM (64 or 128); N = BN (64, 128 or 256) output channels;
// K = 27 taps x Cin.  A K step is one tap and 64 input channels: its A
// tile is ONE 5-D TMA box (64 channels, Z', TX, TY, 1) of the
// channels-last input at (k0, dz-1, x0+dx-1, y0+dy-1, b).  TMA zero-fills
// what lies outside the tensor, negative coordinates included -- exactly
// the conv's zero padding, so there is no halo code; the rows z >= Z read
// as zeros and the epilogue drops them.  Its B tile is a TMA box (64, BN,
// 1) of the weights relaid out to (27, Cout, Cin), zero-filled past Cout.
// Both land as 128-byte rows in the 128-byte swizzle that wgmma reads
// K-major.  A ring of kStages stages (A and B each) with full / empty
// mbarriers: one producer thread keeps the TMA loads in flight, BM / 64
// consumer warpgroups run wgmma m64nBNk16 (f32 accumulators in
// registers), one group of four k16 products in flight.  The epilogue
// rounds to bf16 once and stores channels-last, masking the ragged x / y
// edge, z >= Z and channels >= Cout.  Small volumes split K over S = 3 or
// 9 tap ranges (one dy, or one (dy, dx)): each writes f32 partials, and a
// second pass sums them in a fixed order and casts (no atomics: the same
// sum every run).  The tile plan (Z', TY, TX, BM, BN, S) is computed by
// the wrapper (ops/pallas_conv3d.py::plan_bf16) and passed in as ints.
// The ring, the wgmma products, the epilogue, the split sum and the
// tensor maps are tma_wgmma.cuh's, shared with K7 (conv3x3.cu).
// f32: a plain CUDA-core kernel, one thread per output voxel and four
// output channels (no TF32: f32 stays f32), for the checks.
//
// Bound: operations -- 2 * voxels * 27 * Cin * Cout on the bf16 tensor
// cores (595 GFLOP over the flagship's 16 convs); the bytes (input and
// output once, weights once) sit below that.  What the design does about
// it: every product on wgmma from swizzled shared memory, loads by TMA off
// the consumers' instruction stream, tiles up to 128 x 256 (each K step
// reloads both tiles from L2, so wide tiles move fewer bytes per
// product), split K where the volume is too small for the card.
//
// Requirements (checked by the wrapper and here): bf16 Cin % 64 == 0, f32
// Cin % 16 == 0; Cout % 16 == 0; 1 <= Z <= 32.

#include "tma_wgmma.cuh"

namespace {

constexpr int kThreads = 256;  // f32 kernel

struct Args {
  const void* x;  // (B, Y, X, Z, Cin)
  const void* w;  // f32: (3, 3, 3, Cin, Cout)
  void* y;        // (B, Y, X, Z, Cout)
  int B, Y, X, Z, Cin, Cout;
};

// The bf16 kernel's tile plan.  Block (blockIdx.x, blockIdx.y, blockIdx.z)
// = (M tile ty_i * tiles_x + tx_i, N tile, b * S + split).
struct Plan {
  int B, Y, X, Z, Cin, Cout;
  int Zp, TY, TX, S, tiles_x;
  void* out;  // S == 1: y bf16 (B, Y, X, Z, Cout); else f32 partials
              // (S, B, Y, X, Z, Cout)
};

// WGM consumer warpgroups (BM = 64 * WGM rows), then one producer warp.
template <int WGM, int BN>
__global__ void __launch_bounds__(WGM * 128 + 32, WGM* BN >= 256 ? 1 : 2)
    conv3d_wgmma(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const Plan p) {
  typedef Ring<WGM, BN> R;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = R::init(smem_raw);
  const int y0 = (blockIdx.x / p.tiles_x) * p.TY;
  const int x0 = (blockIdx.x % p.tiles_x) * p.TX;
  const int co0 = blockIdx.y * BN;
  const int b = blockIdx.z / p.S, split = blockIdx.z % p.S;
  const int kc = p.Cin / 64, taps = 27 / p.S, tap0 = split * taps;
  const int niter = taps * kc;

  if (threadIdx.x >= WGM * 128) {  // producer warp: one thread issues loads
    if (threadIdx.x == WGM * 128) {
      for (int it = 0; it < niter; ++it) {
        uint32_t bar;
        const uint32_t a = R::acquire(base, it, R::kStage, bar);
        const int tap = tap0 + it / kc, k0 = (it % kc) * 64;
        const int dy = tap / 9, dx = (tap / 3) % 3, dz = tap % 3;
        tma_load_5d(a, &xmap, bar, k0, dz - 1, x0 + dx - 1, y0 + dy - 1, b);
        tma_load_3d(a + R::kA, &wmap, bar, k0, co0, tap);
      }
    }
    return;
  }

  float acc[BN / 2];
  R::consume(acc, base, niter);
  // tile row m = (ty * TX + tx) * Zp + z; rows z >= Z and the ragged x / y
  // edge are not stored
  store_tile<BN>(acc, co0, p.Cout, p.S, split,
                 (int64_t)p.B * p.Y * p.X * p.Z, p.out, [&](int m) {
                   const int z = m % p.Zp, tx = (m / p.Zp) % p.TX;
                   const int oy = y0 + m / (p.Zp * p.TX), ox = x0 + tx;
                   if (z >= p.Z || ox >= p.X || oy >= p.Y) return (int64_t)-1;
                   return (((int64_t)b * p.Y + oy) * p.X + ox) * p.Z + z;
                 });
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

template <int WGM, int BN>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const Plan& p,
                 int tiles_y, cudaStream_t stream) {
  typedef Ring<WGM, BN> R;
  static uint64_t smem_set = 0;
  const int err = allow_smem(conv3d_wgmma<WGM, BN>, R::kSmem, smem_set);
  if (err != 0) return err;
  const dim3 grid(tiles_y * p.tiles_x, (p.Cout + BN - 1) / BN, p.B * p.S);
  conv3d_wgmma<WGM, BN><<<grid, R::kThreads, R::kSmem, stream>>>(xm, wm, p);
  return (int)cudaGetLastError();
}

}  // namespace

// f32: x (B, Y, X, Z, Cin), w (27, Cin, Cout), y (B, Y, X, Z, Cout).
extern "C" int fbbev_conv3d_f32(const void* x, const void* w, void* y, int B,
                                int Y, int X, int Z, int Cin, int Cout,
                                void* stream) {
  if (Cin % 16 || Cout % 16 || Z < 1 || Z > 32 || B < 0 || Y < 0 || X < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Y == 0 || X == 0 || Cout == 0) return 0;
  const Args a{x, w, y, B, Y, X, Z, Cin, Cout};
  const int64_t nvox = (int64_t)B * Y * X * Z;
  const dim3 grid((unsigned)((nvox + 15) / 16), (Cout / 4 + 15) / 16);
  conv3d_f32<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16: x (B, Y, X, Z, Cin), w (27, Cout, Cin), y (B, Y, X, Z, Cout); ws
// f32 (S, B, Y, X, Z, Cout) when S > 1 (unused otherwise).  The plan: Zp
// (power of two >= Z), TY, TX with TY * TX * Zp = BM in {64, 128}, BN in
// {64, 128, 256} (256 with BM 128 only), S in {1, 3, 9}.
extern "C" int fbbev_conv3d_bf16(const void* x, const void* w, void* y,
                                 void* ws, int B, int Y, int X, int Z,
                                 int Cin, int Cout, int Zp, int TY, int TX,
                                 int BM, int BN, int S, void* stream) {
  if (Cin % 64 || Cout % 16 || Z < 1 || Z > 32 || Zp < Z || Zp > 32 ||
      (Zp & (Zp - 1)) || TY < 1 || TX < 1 || TY * TX * Zp != BM ||
      (BM != 64 && BM != 128) || (BN != 64 && BN != 128 && BN != 256) ||
      (S != 1 && S != 3 && S != 9) || B < 0 || Y < 0 || X < 0 ||
      (S > 1 && ws == nullptr) ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y | (uintptr_t)ws) % 16)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Y == 0 || X == 0 || Cout == 0) return 0;
  CUtensorMap xm, wm;
  const cuuint64_t xd[5] = {(cuuint64_t)Cin, (cuuint64_t)Z, (cuuint64_t)X,
                            (cuuint64_t)Y, (cuuint64_t)B};
  const cuuint32_t xb[5] = {64, (cuuint32_t)Zp, (cuuint32_t)TX,
                            (cuuint32_t)TY, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 27};
  const cuuint32_t wb[3] = {64, (cuuint32_t)BN, 1};
  int r = encode(&xm, x, 5, xd, xb);
  if (r == 0) r = encode(&wm, w, 3, wd, wb);
  if (r != 0) return r;
  const int tiles_y = (Y + TY - 1) / TY;
  const Plan p{B, Y, X, Z, Cin, Cout, Zp, TY, TX, S, (X + TX - 1) / TX,
               S == 1 ? y : ws};
  cudaStream_t st = (cudaStream_t)stream;
  if (BM == 128)
    r = BN == 256   ? launch_wgmma<2, 256>(xm, wm, p, tiles_y, st)
        : BN == 128 ? launch_wgmma<2, 128>(xm, wm, p, tiles_y, st)
                    : launch_wgmma<2, 64>(xm, wm, p, tiles_y, st);
  else if (BN == 256)
    return (int)cudaErrorInvalidValue;
  else
    r = BN == 128 ? launch_wgmma<1, 128>(xm, wm, p, tiles_y, st)
                  : launch_wgmma<1, 64>(xm, wm, p, tiles_y, st);
  if (r != 0 || S == 1) return r;
  return launch_split_sum(ws, y, (int64_t)B * Y * X * Z * Cout, S, st);
}
