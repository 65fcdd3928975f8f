// RoIAlign sample geometry shared by the forward (roialign.cu, kernel B3)
// and its adjoint (roialign_bwd.cu, kernel B3-bwd), so that the backward
// writes to the very taps, with the very weights, that the forward reads.
//
// For roi (x0, y0, x1, y1) scaled by spatial_scale, sample n = i * s + k of
// an axis (bin i, sample k of the bin) sits at
//     lo + (i + (k + 0.5) / s) * (hi - lo) / out,
// minus 0.5 when `aligned`, CLIPPED to [0, size - 1]. Its taps are
// floor(v) and min(floor(v) + 1, size - 1), with weights 1 - frac and frac.
// Every step is written with __fmul_rn / __fadd_rn / __fdiv_rn, so nvcc
// contracts nothing into an fma and the taps and weights are those of the
// plain versions (kernels/roialign.py: sample_coords) to the bit.
#pragma once

#include <cuda_runtime.h>

namespace dd_roialign {

constexpr int MAX_SAMPLES = 256;  // out * s, per axis

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

// Sample n of the rows (rows = true: y, against H) or the columns (x,
// against W) of the roi at rp (x0, y0, x1, y1, unscaled).
__device__ __forceinline__ void roi_sample(const float* rp, bool rows, int n, int out, int s, int size,
                                           float spatial_scale, int aligned, int* t0, int* t1,
                                           float* frac) {
  const float lo = __fmul_rn(rp[rows ? 1 : 0], spatial_scale);
  const float hi = __fmul_rn(rp[rows ? 3 : 2], spatial_scale);
  sample(lo, hi, n, out, s, size, aligned, t0, t1, frac);
}

}  // namespace dd_roialign
