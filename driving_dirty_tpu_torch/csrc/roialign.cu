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
// and weights are the plain version's to the bit; that code lives in
// roialign_common.cuh, which the backward (roialign_bwd.cu) shares.
//
// What bounds it on the H100: bytes. At the detection path's shape
// ([8, 400, 400, 32] features, 1000 rois an image, out 7, s 2) the output is
// 50.2 MB written once (15 us at 3.35 TB/s) and the rois read at most the
// 164 MB (f32) feature map once; the arithmetic is 16 taps x 2 operations
// per output value, 0.4 GFLOP (6 us at 67 TFLOP/s). The taps themselves
// are 16 reads an output, 802 MB in f32, which L1 and L2 serve; with one
// channel a thread they were 16 load instructions for 4 (f32) or 2 (bf16)
// bytes each, and the load instructions, not the bytes, bound the kernel.
//
// Design. Each thread owns V consecutive channels of one bin of one roi:
// V = 4 in f32 and V = 8 in bf16, 16 B of features, so each tap is one
// 16-B read-only load (ld.global.nc.v4) of V channels, and the V f32 sums
// leave as float4 streaming stores (st.global.cs), which keep the 50 MB
// output from evicting the per-image feature map (20.5 MB in f32) from
// L2. A block of 7 warps takes 2 consecutive rois of one image (784 items
// in f32 at C = 32, 392 in bf16). It first computes the rois' out * s
// sample rows and columns (tap indices and fractions) into shared memory,
// one per thread, then its threads run over the items in storage order
// (roi, bin, channel group), so consecutive threads read consecutive 16-B
// pieces of a pixel and write consecutive 16-B pieces of the output.
// Blocks walk the rois of one image before the next image's, and the rois
// that the resident blocks hold (5 blocks an SM at 56 registers a thread)
// span about 1.3 images at 1000 rois an image, whose features (20.5 MB an
// image in f32) stay in L2. Blocks of 4 (f32) or 8 (bf16) rois, whose
// items fill whole warps, hold 2.6 or 5.3 images and were slower on the
// H100. Each output
// accumulates its s * s samples of 4 taps in f32 registers and is scaled by
// 1 / s^2 once; bf16 features are widened on load, the weights stay f32.
// Where C is not a multiple of V, or the features do not start on 16 B, the
// wrapper launches the V = 1 instantiation of the same kernel (one channel
// a thread, scalar loads and stores). Nothing of the TPU formulation is
// carried over: no dense interpolation matrices By / Bx, no 128-lane
// padding of W, no channel-major relayout of the features, no padding of R
// to 32-roi blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roialign_common.cuh"

namespace {

constexpr int THREADS = 224;          // 7 warps
constexpr int ROIS = 2;               // rois a block
using dd_roialign::MAX_SAMPLES;       // out * s, per axis

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// V consecutive channels from p (16-B aligned when V > 1), widened to f32.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = load(p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(V == 4, "16 B of f32");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(V == 8, "16 B of bf16");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
roialign_kernel(const T* __restrict__ feats, const float* __restrict__ rois,
                float* __restrict__ out, int R, int H, int W, int C, int out_size, int s,
                float spatial_scale, int aligned) {
  constexpr int TABLE = ROIS * MAX_SAMPLES;  // sample entries per axis
  __shared__ int s_y0[TABLE], s_y1[TABLE], s_x0[TABLE], s_x1[TABLE];
  __shared__ float s_fy[TABLE], s_fx[TABLE];

  const int item = blockIdx.y, roi0 = blockIdx.x * ROIS;
  const int nr = min(ROIS, R - roi0);  // rois of this block
  const int P = out_size * s;
  const float* rp0 = rois + ((size_t)item * R + roi0) * 4;
  // entry m = (roi rl, sample k) at rl * P + k; rows first, then columns
  for (int n = threadIdx.x; n < 2 * nr * P; n += THREADS) {
    const bool rows = n < nr * P;
    const int m = rows ? n : n - nr * P;
    const int rl = m / P;
    const float* rp = rp0 + 4 * rl;
    if (rows) {
      dd_roialign::roi_sample(rp, true, m - rl * P, out_size, s, H, spatial_scale, aligned, &s_y0[m],
                              &s_y1[m], &s_fy[m]);
    } else {
      dd_roialign::roi_sample(rp, false, m - rl * P, out_size, s, W, spatial_scale, aligned, &s_x0[m],
                              &s_x1[m], &s_fx[m]);
    }
  }
  __syncthreads();

  const T* img = feats + (size_t)item * H * W * C;
  float* dst = out + ((size_t)item * R + roi0) * out_size * out_size * C;
  const int groups = C / V;
  const int per_roi = out_size * out_size * groups;
  const float inv = 1.f / (float)(s * s);
  for (int idx = threadIdx.x; idx < nr * per_roi; idx += THREADS) {
    const int rl = idx / per_roi, rem = idx - rl * per_roi;
    const int bin = rem / groups, c = (rem - bin * groups) * V;
    const int i = bin / out_size, j = bin - i * out_size;
    const int ty = rl * P + i * s, tx = rl * P + j * s;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int ky = 0; ky < s; ++ky) {
      const float fy = s_fy[ty + ky], gy = 1.f - fy;
      const T* row0 = img + (size_t)s_y0[ty + ky] * W * C + c;
      const T* row1 = img + (size_t)s_y1[ty + ky] * W * C + c;
      for (int kx = 0; kx < s; ++kx) {
        const float fx = s_fx[tx + kx], gx = 1.f - fx;
        const size_t a = (size_t)s_x0[tx + kx] * C, b = (size_t)s_x1[tx + kx] * C;
        float t00[V], t01[V], t10[V], t11[V];
        load_vec<V>(row0 + a, t00);
        load_vec<V>(row0 + b, t01);
        load_vec<V>(row1 + a, t10);
        load_vec<V>(row1 + b, t11);
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] += gy * (gx * t00[v] + fx * t01[v]) + fy * (gx * t10[v] + fx * t11[v]);
      }
    }
    // item idx holds outputs idx * V .. + V - 1 of the block's rois
    float* o = dst + (size_t)idx * V;
    if constexpr (V == 1) {
      __stcs(o, acc[0] * inv);
    } else {
#pragma unroll
      for (int v = 0; v < V; v += 4)
        __stcs(reinterpret_cast<float4*>(o + v),
               make_float4(acc[v] * inv, acc[v + 1] * inv, acc[v + 2] * inv, acc[v + 3] * inv));
    }
  }
}

template <typename T, int V>
cudaError_t launch(const void* feats, const float* rois, float* out, int B, int R, int H, int W, int C,
                   int out_size, int s, float spatial_scale, int aligned, cudaStream_t st) {
  const dim3 grid((R + ROIS - 1) / ROIS, B);
  roialign_kernel<T, V><<<grid, THREADS, 0, st>>>(static_cast<const T*>(feats), rois, out, R, H, W, C,
                                                  out_size, s, spatial_scale, aligned);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes: dtype 0 = float32 features, 1 = bfloat16; vec the
// channels a thread owns: 1, or 4 (float32) / 8 (bfloat16), which needs C a
// multiple of vec and 16-B aligned features (kernels/roialign.py:
// channels_per_thread picks it); features [B, H, W, C], rois float32
// [B, R, 4], out float32 [B, R, out, out, C], all contiguous on the device.
// Returns a cudaError_t.
extern "C" int dd_roialign_forward(int dtype, int vec, const void* feats, const void* rois, void* out,
                                   int B, int R, int H, int W, int C, int out_size,
                                   int sampling_ratio, float spatial_scale, int aligned,
                                   void* stream) {
  if (B < 1 || B > 65535 || R < 1 || H < 1 || W < 1 || C < 1 || out_size < 1 ||
      sampling_ratio < 1 || out_size * sampling_ratio > MAX_SAMPLES)
    return (int)cudaErrorInvalidValue;
  const int wide = dtype == 0 ? 4 : 8;
  if (vec != 1 && (vec != wide || C % vec != 0 || reinterpret_cast<uintptr_t>(feats) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    return (int)(vec == 1 ? launch<float, 1>(feats, r, o, B, R, H, W, C, out_size, sampling_ratio,
                                             spatial_scale, aligned, st)
                          : launch<float, 4>(feats, r, o, B, R, H, W, C, out_size, sampling_ratio,
                                             spatial_scale, aligned, st));
  }
  if (dtype == 1) {
    return (int)(vec == 1 ? launch<__nv_bfloat16, 1>(feats, r, o, B, R, H, W, C, out_size,
                                                     sampling_ratio, spatial_scale, aligned, st)
                          : launch<__nv_bfloat16, 8>(feats, r, o, B, R, H, W, C, out_size,
                                                     sampling_ratio, spatial_scale, aligned, st));
  }
  return (int)cudaErrorInvalidValue;
}
