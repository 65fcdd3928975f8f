// RoIAlign forward (kernel B3) for sm_90a: NHWC features [B, H, W, C]
// (float32 or bfloat16) and pixel-space xyxy rois [B, R, 4] (float32) ->
// [B, R, out, out, C] float32.
//
// Replaces driving_dirty_tpu/pallas/roialign.py:roi_align_fused (the Pallas
// TPU kernel, pallas_call at :84) and, on the card, the XLA path it was
// measured against (driving_dirty_tpu/ops/detection.py:_roi_align_fwd_impl,
// which batched_roi_align runs). Semantics are those two functions' and the
// plain version's (driving_dirty_tpu_torch/kernels/roialign.py:
// roialign_plain): torchvision's RoIAlign with a fixed sampling ratio s.
// For roi (x0, y0, x1, y1) scaled by spatial_scale, bin (i, j) averages the
// s * s bilinear samples at
//     y = y0 + (i + (k + 0.5) / s) * (y1 - y0) / out,  k = 0 .. s-1
// (x likewise), minus 0.5 when `aligned`. Each sample coordinate is CLIPPED
// to [0, H - 1] (not zeroed outside the map as in torchvision); its taps are
// floor(y) and min(floor(y) + 1, H - 1) with weights 1 - frac and frac.
// Every step of the coordinate arithmetic is written with __fmul_rn /
// __fadd_rn / __fdiv_rn, so nvcc contracts nothing into an fma and the taps
// and weights are the plain version's to the bit.
//
// What bounds it on the H100: bytes. At the detection path's shape
// ([8, 400, 400, 32] features, 1000 rois an image, out 7, s 2) the output is
// 50.2 MB written once (15 us at 3.35 TB/s) and the rois read at most the
// 164 MB (f32) feature map once; the arithmetic is 16 taps x 2 operations
// per output value, 0.4 GFLOP (6 us at 67 TFLOP/s).
//
// Design. One block per (roi, image). The block first computes the out * s
// sample rows and columns of its roi (tap indices and fractions) into shared
// memory, one per thread. Then the block's threads run over the roi's
// out * out * C outputs in their storage order (bin-major, channel-minor):
// consecutive threads take consecutive channels of one bin, so each tap is a
// coalesced read of one pixel's C channels (128 B for 32 channels in f32,
// 64 B in bf16) and the [out, out, C] result is written contiguously. Each
// output accumulates its s * s samples of 4 taps in f32 registers and is
// scaled by 1 / s^2 once; bf16 features are widened on load, the weights
// stay f32. Nothing of the TPU formulation is carried over: no dense
// interpolation matrices By / Bx, no 128-lane padding of W, no channel-major
// relayout of the features, no padding of R to 32-roi blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SAMPLES = 256;  // out * s, per axis

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Sample n of one axis of a roi (lo, hi already scaled): tap indices and the
// fraction of the upper tap.
__device__ __forceinline__ void sample(float lo, float hi, int n, int out, int s, int size,
                                       int aligned, int* t0, int* t1, float* frac) {
  const int i = n / s, k = n - i * s;
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)out);
  const float off = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)s);
  float v = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)i, off), bin));
  if (aligned) v = __fsub_rn(v, 0.5f);
  v = fminf(fmaxf(v, 0.f), (float)(size - 1));
  const int c0 = (int)floorf(v);
  *t0 = c0;
  *t1 = min(c0 + 1, size - 1);
  *frac = __fsub_rn(v, (float)c0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
roialign_kernel(const T* __restrict__ feats, const float* __restrict__ rois,
                float* __restrict__ out, int R, int H, int W, int C, int out_size, int s,
                float spatial_scale, int aligned) {
  __shared__ int s_y0[MAX_SAMPLES], s_y1[MAX_SAMPLES], s_x0[MAX_SAMPLES], s_x1[MAX_SAMPLES];
  __shared__ float s_fy[MAX_SAMPLES], s_fx[MAX_SAMPLES];

  const int roi = blockIdx.x, item = blockIdx.y;
  const int P = out_size * s;
  const float* rp = rois + ((size_t)item * R + roi) * 4;
  for (int n = threadIdx.x; n < 2 * P; n += THREADS) {
    if (n < P) {
      sample(__fmul_rn(rp[1], spatial_scale), __fmul_rn(rp[3], spatial_scale), n, out_size, s,
             H, aligned, &s_y0[n], &s_y1[n], &s_fy[n]);
    } else {
      const int m = n - P;
      sample(__fmul_rn(rp[0], spatial_scale), __fmul_rn(rp[2], spatial_scale), m, out_size, s,
             W, aligned, &s_x0[m], &s_x1[m], &s_fx[m]);
    }
  }
  __syncthreads();

  const T* img = feats + (size_t)item * H * W * C;
  float* dst = out + ((size_t)item * R + roi) * out_size * out_size * C;
  const int total = out_size * out_size * C;
  const float inv = 1.f / (float)(s * s);
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int bin = idx / C, c = idx - bin * C;
    const int i = bin / out_size, j = bin - i * out_size;
    float acc = 0.f;
    for (int ky = 0; ky < s; ++ky) {
      const int py = i * s + ky;
      const float fy = s_fy[py], gy = 1.f - fy;
      const T* row0 = img + (size_t)s_y0[py] * W * C + c;
      const T* row1 = img + (size_t)s_y1[py] * W * C + c;
      for (int kx = 0; kx < s; ++kx) {
        const int px = j * s + kx;
        const float fx = s_fx[px], gx = 1.f - fx;
        const size_t a = (size_t)s_x0[px] * C, b = (size_t)s_x1[px] * C;
        acc += gy * (gx * load(row0 + a) + fx * load(row0 + b)) +
               fy * (gx * load(row1 + a) + fx * load(row1 + b));
      }
    }
    dst[idx] = acc * inv;
  }
}

}  // namespace

// C entry for ctypes: dtype 0 = float32 features, 1 = bfloat16; features
// [B, H, W, C], rois float32 [B, R, 4], out float32 [B, R, out, out, C], all
// contiguous on the device. Returns a cudaError_t.
extern "C" int dd_roialign_forward(int dtype, const void* feats, const void* rois, void* out,
                                   int B, int R, int H, int W, int C, int out_size,
                                   int sampling_ratio, float spatial_scale, int aligned,
                                   void* stream) {
  if (B < 1 || B > 65535 || R < 1 || H < 1 || W < 1 || C < 1 || out_size < 1 ||
      sampling_ratio < 1 || out_size * sampling_ratio > MAX_SAMPLES)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(R, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    roialign_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(feats), r, o, R,
                                                     H, W, C, out_size, sampling_ratio,
                                                     spatial_scale, aligned);
  } else if (dtype == 1) {
    roialign_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(feats), r, o, R, H, W, C, out_size, sampling_ratio,
        spatial_scale, aligned);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
