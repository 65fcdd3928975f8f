// RoIAlign backward (kernel B3-bwd) for sm_90a: the gradient g of B3's
// output, float32 [B, R, out, out, C], and the rois [B, R, 4] -> dF
// [B, H, W, C] in the features' dtype (float32 or bfloat16), summed in f32
// and rounded once. No gradient goes to the rois.
//
// dF is the exact adjoint of B3's forward (roialign.cu): for every bin
// (r, i, j), every one of its s * s samples and every one of the sample's 4
// taps, it adds g[r, i, j, c] * w_y * w_x / s^2 into dF at that tap's pixel.
// The taps and weights are the forward's bit for bit: both kernels take
// them from roialign_common.cuh. It replaces, on the card, the JAX
// package's backward of roi_align (driving_dirty_tpu/ops/detection.py:
// _roi_align_bwd, dF = sum_r By_r^T g_r Bx_r as dense separable matmuls in
// XLA; the Pallas kernel has no backward), which is the plain version here
// (kernels/roialign.py: roialign_backward_plain).
//
// What bounds it on the H100: bytes. At the detection path's shape
// ([8, 400, 400, 32] features, 512 sampled rois an image, out 7, s 2) it
// must read g once (25.7 MB) and write dF once (164 MB in f32, 82 MB in
// bf16): 0.057 / 0.032 ms at 3.35 TB/s. The taps are 3.2 M sample taps of
// 32 channels, 0.2 GFLOP. The dense formulation does 294 GFLOP a step and
// writes a 1.47 GB temporary.
//
// Design: deterministic, with no atomics and no memset. One block of 256
// threads owns a 16 x 16 pixel tile of dF of one image, one pixel a thread,
// and at most 32 channels of it in registers (more channels take further
// passes). It culls the image's rois by the clipped footprint of their
// sample taps (from the first and last sample of each axis: the sample
// coordinates are monotone in the sample index), compacts the survivors in
// roi order, and walks them in rounds of up to 8 between two barriers: the
// block computes the round's sample rows and columns (taps and fractions)
// into shared memory, then for each tile row and column and roi the range
// of samples with a tap on it (one range, by the monotonicity), and each
// thread adds, for every sample row in its row's range and every sample
// column in its column's range, the product of the two tap weights times g
// of that bin into its sums, roi by roi in order. So every output element
// is summed by one thread in a fixed order and written once: two launches
// on the same inputs give the same bits. Where C is a multiple of 4 and g
// starts on 16 B, g is read as 16-B vectors (V = 4) and f32 dF written as
// 16-B vectors; otherwise the same kernel reads one channel at a time
// (V = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roialign_common.cuh"

namespace {

using dd_roialign::MAX_SAMPLES;
constexpr int TILE = 16;                // tile side, pixels
constexpr int THREADS = TILE * TILE;    // one pixel a thread
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;               // channels a thread sums at once
constexpr int ROUND = 8;                // surviving rois a round between two barriers
constexpr int TABLE = 2 * MAX_SAMPLES;  // sample entries per axis of a round (ROUND * P at most)

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Whether any tap of the roi at rp lands in rows [lo, hi] (rows = true) or
// columns [lo, hi]: its taps span [min, max] of the first and last sample's.
__device__ __forceinline__ bool meets(const float* rp, bool rows, int lo, int hi, int out, int s, int size,
                                      float scale, int aligned) {
  int a0, a1, b0, b1;
  float f;
  dd_roialign::roi_sample(rp, rows, 0, out, s, size, scale, aligned, &a0, &a1, &f);
  dd_roialign::roi_sample(rp, rows, out * s - 1, out, s, size, scale, aligned, &b0, &b1, &f);
  return min(a0, b0) <= hi && max(a1, b1) >= lo;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
roialign_bwd_kernel(const float* __restrict__ g, const float* __restrict__ rois, T* __restrict__ dF,
                    int R, int H, int W, int C, int out_size, int s, float spatial_scale, int aligned) {
  __shared__ int s_t0[2][TABLE], s_t1[2][TABLE];  // [rows, cols][roi of the round * P + sample]
  __shared__ float s_f[2][TABLE];
  __shared__ int2 s_rng[2][ROUND][TILE];          // samples with a tap on each tile row / column
  __shared__ int s_list[THREADS];                 // surviving rois of one cull pass, in roi order
  __shared__ int s_warp[WARPS + 1];

  const int item = blockIdx.z;
  const int ty = blockIdx.y * TILE, tx = blockIdx.x * TILE;
  const int ly = threadIdx.x / TILE, lx = threadIdx.x % TILE;
  const int y = ty + ly, x = tx + lx;
  const bool mine = y < H && x < W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = out_size * s;
  const int round = min(ROUND, TABLE / P);  // rois a round
  const int bin_stride = out_size * C;      // floats between bins i and i + 1 of a roi
  const float* rbase = rois + (size_t)item * R * 4;
  const float* gbase = g + (size_t)item * R * out_size * out_size * C;
  const float inv = 1.f / (float)(s * s);

  for (int c0 = 0; c0 < C; c0 += CHUNK) {
    const int nc = min(CHUNK, C - c0);
    float acc[CHUNK];
#pragma unroll
    for (int v = 0; v < CHUNK; ++v) acc[v] = 0.f;

    for (int base = 0; base < R; base += THREADS) {
      // cull: the rois base .. base + THREADS - 1 whose taps meet the tile
      const int r = base + threadIdx.x;
      bool hit = false;
      if (r < R) {
        const float* rp = rbase + 4 * r;
        hit = meets(rp, true, ty, ty + TILE - 1, out_size, s, H, spatial_scale, aligned) &&
              meets(rp, false, tx, tx + TILE - 1, out_size, s, W, spatial_scale, aligned);
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp + 1] = __popc(ballot);
      __syncthreads();
      if (threadIdx.x == 0) {
        s_warp[0] = 0;
        for (int k = 1; k <= WARPS; ++k) s_warp[k] += s_warp[k - 1];
      }
      __syncthreads();
      if (hit) s_list[s_warp[warp] + __popc(ballot & ((1u << lane) - 1u))] = r;
      const int n = s_warp[WARPS];
      __syncthreads();

      for (int k0 = 0; k0 < n; k0 += round) {
        const int m = min(round, n - k0);
        // the round's sample rows and columns: taps and fractions
        for (int t = threadIdx.x; t < 2 * m * P; t += THREADS) {
          const int axis = t / (m * P), e = t - axis * m * P;
          const int kk = e / P;
          dd_roialign::roi_sample(rbase + 4 * s_list[k0 + kk], axis == 0, e - kk * P, out_size, s,
                                  axis == 0 ? H : W, spatial_scale, aligned, &s_t0[axis][e], &s_t1[axis][e],
                                  &s_f[axis][e]);
        }
        __syncthreads();
        // for each tile row (column) and roi, the samples with a tap on it:
        // one range, since the taps are monotone in the sample index
        for (int t = threadIdx.x; t < 2 * m * TILE; t += THREADS) {
          const int axis = t / (m * TILE), e = t - axis * m * TILE;
          const int kk = e / TILE, pos = (axis == 0 ? ty : tx) + e - kk * TILE;
          int first = -1, last = -2;
          for (int n_s = 0; n_s < P; ++n_s) {
            const int i = kk * P + n_s;
            if (s_t0[axis][i] == pos || s_t1[axis][i] == pos) {
              if (first < 0) first = n_s;
              last = n_s;
            }
          }
          s_rng[axis][kk][e - kk * TILE] = make_int2(first, last);
        }
        __syncthreads();
        if (mine) {
          for (int kk = 0; kk < m; ++kk) {
            const int2 py = s_rng[0][kk][ly], qx = s_rng[1][kk][lx];
            if (py.x < 0 || qx.x < 0) continue;
            const float* gr = gbase + (size_t)s_list[k0 + kk] * out_size * bin_stride + c0;
            for (int p = py.x; p <= py.y; ++p) {
              // the weight of this pixel's row among sample p's two row taps
              // (both, where clipping puts them on one row)
              const int ip = kk * P + p;
              const float fy = s_f[0][ip];
              float wy = s_t0[0][ip] == y ? 1.f - fy : 0.f;
              if (s_t1[0][ip] == y) wy += fy;
              if (wy == 0.f) continue;
              const float* gi = gr + (size_t)(p / s) * bin_stride;
              for (int q = qx.x; q <= qx.y; ++q) {
                const int iq = kk * P + q;
                const float fx = s_f[1][iq];
                float wx = s_t0[1][iq] == x ? 1.f - fx : 0.f;
                if (s_t1[1][iq] == x) wx += fx;
                if (wx == 0.f) continue;
                const float w = wy * wx;
                const float* gp = gi + (q / s) * C;
                if constexpr (V == 4) {
#pragma unroll
                  for (int v = 0; v < CHUNK; v += 4) {
                    if (v < nc) {
                      const float4 t4 = __ldg(reinterpret_cast<const float4*>(gp + v));
                      acc[v] += w * t4.x;
                      acc[v + 1] += w * t4.y;
                      acc[v + 2] += w * t4.z;
                      acc[v + 3] += w * t4.w;
                    }
                  }
                } else {
#pragma unroll
                  for (int v = 0; v < CHUNK; ++v)
                    if (v < nc) acc[v] += w * __ldg(gp + v);
                }
              }
            }
          }
        }
        __syncthreads();  // the next round's tables overwrite these
      }
    }

    if (mine) {
      T* o = dF + (((size_t)item * H + y) * W + x) * C + c0;
      if constexpr (V == 4 && sizeof(T) == 4) {
#pragma unroll
        for (int v = 0; v < CHUNK; v += 4)
          if (v < nc)
            *reinterpret_cast<float4*>(o + v) =
                make_float4(acc[v] * inv, acc[v + 1] * inv, acc[v + 2] * inv, acc[v + 3] * inv);
      } else {
#pragma unroll
        for (int v = 0; v < CHUNK; ++v)
          if (v < nc) store(o + v, acc[v] * inv);
      }
    }
  }
}

template <typename T, int V>
cudaError_t launch(const float* g, const float* rois, void* dF, int B, int R, int H, int W, int C,
                   int out_size, int s, float spatial_scale, int aligned, cudaStream_t st) {
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  roialign_bwd_kernel<T, V><<<grid, THREADS, 0, st>>>(g, rois, static_cast<T*>(dF), R, H, W, C, out_size, s,
                                                      spatial_scale, aligned);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes: dtype 0 = float32 dF, 1 = bfloat16; vec 4 reads g as
// 16-B vectors (needs C a multiple of 4 and g and dF on 16 B; kernels/
// roialign.py: grad_channels_per_load picks it), 1 one float at a time;
// g float32 [B, R, out, out, C], rois float32 [B, R, 4], dF [B, H, W, C],
// all contiguous on the device. Every element of dF is written. Returns a
// cudaError_t.
extern "C" int dd_roialign_backward(int dtype, int vec, const void* g, const void* rois, void* dF,
                                    int B, int R, int H, int W, int C, int out_size, int sampling_ratio,
                                    float spatial_scale, int aligned, void* stream) {
  if (B < 1 || B > 65535 || R < 1 || H < 1 || W < 1 || C < 1 || out_size < 1 || sampling_ratio < 1 ||
      out_size * sampling_ratio > MAX_SAMPLES || (H + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && (vec != 4 || C % 4 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(dF) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* r = static_cast<const float*>(rois);
  if (dtype == 0) {
    return (int)(vec == 1 ? launch<float, 1>(gf, r, dF, B, R, H, W, C, out_size, sampling_ratio, spatial_scale,
                                             aligned, st)
                          : launch<float, 4>(gf, r, dF, B, R, H, W, C, out_size, sampling_ratio, spatial_scale,
                                             aligned, st));
  }
  if (dtype == 1) {
    return (int)(vec == 1 ? launch<__nv_bfloat16, 1>(gf, r, dF, B, R, H, W, C, out_size, sampling_ratio,
                                                     spatial_scale, aligned, st)
                          : launch<__nv_bfloat16, 4>(gf, r, dF, B, R, H, W, C, out_size, sampling_ratio,
                                                     spatial_scale, aligned, st));
  }
  return (int)cudaErrorInvalidValue;
}
