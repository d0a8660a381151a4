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

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_to(float w, const float*) { return w; }
__device__ __forceinline__ float round_to(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

template <typename T>
__global__ void msda_kernel(const T* __restrict__ value,
                            const float* __restrict__ loc,
                            const float* __restrict__ attn,
                            float* __restrict__ out, int64_t total, int H,
                            int W, int Q, int heads, int P, int hd) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int C = heads * hd;
  const int c = (int)(i % C);
  const int64_t bq = i / C;            // b * Q + q
  const int64_t b = bq / Q;
  const int h = c / hd;
  const int64_t la = (bq * heads + h) * P;
  const T* vb = value + b * (int64_t)H * W * C + c;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) {
    const float x = loc[(la + p) * 2] * W - 0.5f;
    const float y = loc[(la + p) * 2 + 1] * H - 0.5f;
    const float a = attn[la + p];
    const float x0 = floorf(x), y0 = floorf(y);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xi = x0 + (k & 1), yi = y0 + (k >> 1);
      if (xi < 0.f || xi > W - 1 || yi < 0.f || yi > H - 1) continue;
      const float w = (1.f - fabsf(x - xi)) * (1.f - fabsf(y - yi)) * a;
      const int64_t cell = (int64_t)yi * W + (int64_t)xi;
      acc += round_to(w, vb) * to_f32(vb[cell * C]);
    }
  }
  out[i] = acc;
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

template <typename T>
int launch(const void* value, const float* loc, const float* attn,
           float* out, int B, int H, int W, int Q, int heads, int P, int hd,
           void* stream) {
  const int64_t total = (int64_t)B * Q * heads * hd;
  if (total > 0) {
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    msda_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)value, loc, attn, out, total, H, W, Q, heads, P, hd);
  }
  return (int)cudaGetLastError();
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
// 2) f32; attn (B, Q, heads, P) f32; out (B, Q, heads*hd) f32.
extern "C" int fbbev_msda(const void* value, const float* loc,
                          const float* attn, float* out, int is_bf16, int B,
                          int H, int W, int Q, int heads, int P, int hd,
                          void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(value, loc, attn, out, B, H, W, Q, heads,
                                 P, hd, stream);
  return launch<float>(value, loc, attn, out, B, H, W, Q, heads, P, hd,
                       stream);
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
