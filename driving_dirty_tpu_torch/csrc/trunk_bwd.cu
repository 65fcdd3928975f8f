// The trunk's backward (B1-bwd) for sm_90a: every gradient of
// c3 = trunk(x, w1, b1, w2, b2, w3, b3) (csrc/trunk.cu) that autograd asks
// for, from the tensors the forward saved (B1-save: c1, c2 and c3), with
// no recompute.
//
// Replaces the backward that the JAX package leaves to XLA: the custom VJP
// of driving_dirty_tpu/pallas/trunk.py:fused_trunk differentiates
// jax.vjp(xla_trunk) (pallas/trunk.py:303-305); the Pallas kernel has no
// backward of its own. For NHWC tensors, C = 32, and the ReLU masks taken
// from the saved post-ReLU tensors (c > 0), as autograd's
// threshold_backward takes them:
//
//   gz3 = g3 * [c3 > 0]
//   dW3[o][i][ky][kx] = sum gz3[oy][ox][o] * c2[2oy-1+ky][2ox-1+kx][i]   db3 = sum gz3
//   g2[y][x][i] = sum gz3[oy][ox][o] * W3[o][i][ky][kx], y = 2oy-1+ky, x = 2ox-1+kx
//   gz2 = g2 * [c2 > 0]
//   dW2 = sum gz2 (x) c1 shifted, db2 = sum gz2, g1 = conv^T(gz2, W2), gz1 = g1 * [c1 > 0]
//   dW1 = sum gz1 (x) x shifted,  db1 = sum gz1, dx = conv^T(gz1, W1) (only when asked)
//
// Bound on the H100 at the main path's [8, 256, 1836, 3], without dx:
// 179.8 GFLOP of products and 1.25 GB in f32 (g3 120 MB + c3 120 MB + c2
// 481 MB + c1 481 MB + x 45 MB read once, the weight gradients written):
// in f32 three TF32 products a product, 539 GFLOP, 1.090 ms at 495 TFLOP/s
// against 0.373 ms of bytes, so bound by operations; in bf16 624 MB, 0.186
// ms of bytes against 0.182 ms of bf16 products, bound by bytes.
//
// Design. Every product runs on the tensor cores as mma.sync.m16n8k8 with
// TF32 operands and f32 accumulators, over shared-memory tiles stored as
// the forward stores c1 and c2: [pixel][32 channels] f32, 16-B chunks
// XOR-swizzled by pixel (trunk_common.cuh: tf32::sw). In f32 each product
// is taken as three TF32 products of split operands, as in the forward
// (the tolerance is 1e-4 of sums of up to 3.7 M terms). In bf16 every
// operand is a bf16 value (saved tensors, g3, the weights rounded as the
// forward rounds them, and gz2 and gz1 rounded to bf16 where the plain
// backward rounds them), which TF32 holds exactly, so one TF32 product is
// exact and the f32 sums are those of a bf16 mma.sync with f32
// accumulators; both dtypes share one code path (SPLIT below), widening
// bf16 to f32 as tiles are loaded.
//
// Three persistent kernels of 8 warps (the first two at two CTAs an SM)
// and one reduction, launched by the C entry dd_trunk_bwd in turn (one call
// of the op):
//
// 1. c3 pass, over 4 x 16 tiles of c3: gz3 (tile plus one row and column
//    of halo) is formed as g3 and c3 are loaded; c2 under the tile's
//    receptive field (9 x 33) is loaded. dW3 (M = 32 o, N = 288 (tap, i),
//    K = the tile's 64 positions; each tile's sums added to registers that
//    the CTA keeps over its walk, add_to) and db3. The stride-2 dgrad of c3
//    is split by output parity: the c2 positions (2j + py, 2l + px) of one
//    parity take 1, 2 or 4 taps of W3, so no product falls on a
//    zero-inserted position; each m16 tile is 16 such positions of one row
//    (A by ldmatrix from gz3), N = 32, with W3 as transposed, tap-flipped B
//    fragments (kernels/trunk.py:prepare_bwd_weights). The result is
//    masked by c2 > 0 and written to device memory as gz2, in the
//    activation dtype.
// 2. c2 pass, over 8 x 16 tiles of c1 / c2 positions: gz2 and c1 with a
//    halo of one, and x under the tile. dW2 (K = the tile's 128
//    positions) and db2; g1 = conv^T(gz2, W2), an implicit GEMM as the
//    forward's c2 (one m16 row a warp, 36 k-steps), masked by c1 > 0 into
//    a shared tile gz1 (written to device memory only when dx is asked
//    for); dW1 (N = 27 (tap, ci) padded to 32) and db1 from gz1 and x.
// 3. dx pass (only when asked for): conv^T(gz1, W1) over 8 x 16 tiles,
//    N = 3 padded to 8.
// 4. The weight gradients: each CTA of passes 1 and 2 keeps its partial
//    dW / db (9,216 + 32, and 9,216 + 32 + 864 + 32 f32) in registers over
//    its walk and writes it once to a scratch buffer the wrapper allocates
//    for the grid it launches (dd_trunk_bwd_grids); a last kernel sums the
//    partials of each element in CTA order. No atomics: two launches give
//    the same bits.
//
// gz2 goes through device memory (written once by pass 1, read by pass 2
// with a halo of one): keeping it in shared memory for a c2 tile plus the
// halo that g1 needs would make pass 1 recompute the dgrad of c3 on that
// halo for every tile, and its 9 x 33 c2 window and W3's fragments already
// take most of a CTA's budget at two CTAs an SM. gz1 stays in shared memory.
// In the weight-gradient GEMMs K runs over positions, the slow axis of the
// [pixel][channel] tiles, which ldmatrix cannot transpose at 32 bits. So
// dW3 and dW2 (wgrad32) number their tiles' rows and columns by channel
// residue, and one 16-B load of a pixel's channel chunk gives a lane its A
// values of both m-tiles or its B values of a tap's four n-tiles; dW1 (27
// columns from the 3-channel input) gathers with scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "trunk_common.cuh"

namespace {

using namespace tf32;  // sw, split, BPair, mma (trunk_common.cuh)

constexpr int WARPS = 8, THREADS = 32 * WARPS;
// The c3 and c2 passes run two CTAs an SM (__launch_bounds__(THREADS,
// MIN_CTAS)), so one CTA's tile loads overlap the other's products, and
// ptxas holds them to 128 registers: at [8, 256, 1836, 3] on the H100
// (chip_smoke.py) B1-bwd took 4% less time in f32 and 26% less in bf16
// than at one CTA an SM (161-191 registers).
constexpr int MIN_CTAS = 2;
constexpr int KSTEPS = 36;                   // k8 steps of a 3 x 3 x 32 dgrad
constexpr int FRAG = 2 * 32;                 // uint4 per k-step: 2 n-pairs x 32 lanes
constexpr int WD_U4 = KSTEPS * FRAG;         // 2,304 uint4 = 36,864 B: one 32 -> 32 dgrad weight
constexpr int WD1_F2 = KSTEPS * 32;          // 1,152 float2 = 9,216 B: W1's dgrad, N = 3 padded to 8
constexpr int NW = C * C * 9, NW1 = C * CIN * 9;        // 9,216 and 864 weight-gradient entries
constexpr int PART3 = NW + C;                           // pass 1's partial: dW3 | db3
constexpr int PART2 = NW + C + NW1 + C;                 // pass 2's: dW2 | db2 | dW1 | db1

// ----- loads and stores of the activation dtype, widened to f32

__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// v as the dtype T holds it (bf16: rounded to nearest even), in f32.
template <typename T>
__device__ __forceinline__ float as_dtype(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16_rn(v));
}

// ----- shared tiles: [pixel][32] f32, swizzled (sw)

__device__ __forceinline__ float ld_ch(const unsigned char* buf, int p, int ch) {
  return *reinterpret_cast<const float*>(buf + sw(p, ch >> 2) + 4 * (ch & 3));
}

// Pixels (r, q) < (R, Q) of a region whose (0, 0) is global (y0, x0) of
// image b of a [B, H, W, 32] tensor, into dst; zero outside the image.
// With MASK, the pixels of g where act > 0, else zero (threshold_backward).
template <typename T, bool MASK>
__device__ __forceinline__ void load_region(unsigned char* dst, const T* g, const T* act, int b, int y0, int x0,
                                            int R, int Q, int H, int W, int tid) {
  for (int i = tid; i < R * Q * 8; i += THREADS) {
    const int p = i >> 3, c = i & 7, r = p / Q, q = p - r * Q;
    const int gy = y0 + r, gx = x0 + q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside(gy, gx, H, W)) {
      const size_t off = (((size_t)b * H + gy) * W + gx) * C + 4 * c;
      v = load4(g + off);
      if constexpr (MASK) {
        const float4 a = load4(act + off);
        v = make_float4(a.x > 0.f ? v.x : 0.f, a.y > 0.f ? v.y : 0.f, a.z > 0.f ? v.z : 0.f,
                        a.w > 0.f ? v.w : 0.f);
      }
    }
    *reinterpret_cast<float4*>(dst + sw(p, c)) = v;
  }
}

// The input under a region as above, [pixel][3] f32 unswizzled.
template <typename T>
__device__ __forceinline__ void load_input(float* dst, const T* x, int b, int y0, int x0, int R, int Q, int H,
                                           int W, int tid) {
  for (int i = tid; i < R * Q * CIN; i += THREADS) {
    const int p = i / CIN, ci = i - p * CIN, r = p / Q, q = p - r * Q;
    const int gy = y0 + r, gx = x0 + q;
    dst[i] = inside(gy, gx, H, W) ? load1(x + (((size_t)b * H + gy) * W + gx) * CIN + ci) : 0.f;
  }
}

// ----- TF32 operands: split in three products (SPLIT, f32), or taken as
// they are (bf16 values, exact in TF32)

template <bool SPLIT>
__device__ __forceinline__ void prep(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    split(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

template <bool SPLIT>
__device__ __forceinline__ void prep_a(const uint32_t (&a)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) prep<SPLIT>(__uint_as_float(a[e]), ah[e], al[e]);
}

template <bool SPLIT>
__device__ __forceinline__ BPair prep_b(const uint4& w) {
  BPair f;
  prep<SPLIT>(__uint_as_float(w.x), f.hi[0], f.lo[0]);
  prep<SPLIT>(__uint_as_float(w.y), f.hi[1], f.lo[1]);
  prep<SPLIT>(__uint_as_float(w.z), f.hi[2], f.lo[2]);
  prep<SPLIT>(__uint_as_float(w.w), f.hi[3], f.lo[3]);
  return f;
}

// d += a * b for one n8 tile (b0, b1 its B fragment), the small products first.
template <bool SPLIT>
__device__ __forceinline__ void mma_x(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                      uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if constexpr (SPLIT) {
    mma(d, al, bh0, bh1);
    mma(d, ah, bl0, bl1);
  }
  mma(d, ah, bh0, bh1);
}

// All four n8 tiles of N = 32: pair b0 holds n-tiles 0, 1 and b1 2, 3.
template <bool SPLIT>
__device__ __forceinline__ void mma_n32(float (&d)[4][4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                        const BPair& b0, const BPair& b1) {
  mma_x<SPLIT>(d[0], ah, al, b0.hi[0], b0.hi[1], b0.lo[0], b0.lo[1]);
  mma_x<SPLIT>(d[1], ah, al, b0.hi[2], b0.hi[3], b0.lo[2], b0.lo[3]);
  mma_x<SPLIT>(d[2], ah, al, b1.hi[0], b1.hi[1], b1.lo[0], b1.lo[1]);
  mma_x<SPLIT>(d[3], ah, al, b1.hi[2], b1.hi[3], b1.lo[2], b1.lo[3]);
}

// One k-step (8 positions) of a dgrad on a 16-position A tile: A by
// ldmatrix at a row address of this lane (pixel pix, channels 8h ..), B
// the tap-flipped fragments of k-step s.
template <bool SPLIT>
__device__ __forceinline__ void dgrad_step(float (&acc)[4][4], uint32_t abuf, int pix, int h, const uint4* wd,
                                           int s, int lane) {
  const BPair b0 = prep_b<SPLIT>(wd[(2 * s) * 32 + lane]), b1 = prep_b<SPLIT>(wd[(2 * s + 1) * 32 + lane]);
  uint32_t a[4], ah[4], al[4];
  ldsm_x4(a, abuf + sw(pix, 2 * h + (lane >> 4)));
  prep_a<SPLIT>(a, ah, al);
  mma_n32<SPLIT>(acc, ah, al, b0, b1);
}

// A weight gradient's partial (dW1, N = 27 (tap, ci) padded to 32), dW[o][n]
// += sum over KS k-steps of 8 positions of gz[pos][o] * act[pos shifted by
// n's tap][n's channel]: M = o in two m16 tiles, N in n8 tiles. This warp takes m-tile mt and the NT
// n-tiles from nt0. apix(s, k): the pixel of gz under position k of k-step
// s; bval(s, k, n): B at (position k of k-step s, column n).
template <bool SPLIT, int NT, int KS, class APix, class BVal>
__device__ __forceinline__ void wgrad(float (&acc)[NT][4], const unsigned char* gz, int mt, int nt0, int lane,
                                      APix apix, BVal bval) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 1
  for (int s = 0; s < KS; ++s) {
    uint32_t ah[4], al[4];
    // a[e]: o = 16 mt + g + 8 (e & 1), position tg + 4 (e >> 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) prep<SPLIT>(ld_ch(gz, apix(s, tg + 4 * (e >> 1)), 16 * mt + g + 8 * (e & 1)), ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // b0: position tg, b1: position tg + 4; column 8 nt + g
      uint32_t bh0, bl0, bh1, bl1;
      prep<SPLIT>(bval(s, tg, 8 * (nt0 + j) + g), bh0, bl0);
      prep<SPLIT>(bval(s, tg + 4, 8 * (nt0 + j) + g), bh1, bl1);
      mma_x<SPLIT>(acc[j], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// The 16-B chunk g (channels 4g .. 4g + 3) of pixel p of a swizzled tile.
__device__ __forceinline__ float4 ld_chunk(const unsigned char* buf, int p, int g) {
  return *reinterpret_cast<const float4*>(buf + sw(p, g));
}

__device__ __forceinline__ float part_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A 32 x 288 weight gradient's partial (dW3, dW2), dW[o][tap][i] += sum over
// KS k-steps of 8 positions of gz[pos][o] * act[pos shifted by tap][i]. The
// m16n8k8 tiles' rows and columns are channel residues, so that one 16-B
// load serves several tiles: lane g loads chunk g of a pixel (channels
// 4g .. 4g + 3), which holds its A values of both m-tiles (rows g and g + 8
// of m-tile mt are channels 4g + 2mt and 4g + 2mt + 1) or its B values of
// one tap's four n-tiles (column g of n-tile j is channel 4g + j). This warp
// takes all eight (m, n) tiles of tap `tap` (acc[4 mt + j]) and tile (xm,
// xn) of tap 8 (acc[8]). apix(s, k): the gz pixel of position k of k-step
// s; bpix(s, k, t): the act pixel under it at tap t.
template <bool SPLIT, int KS, class APix, class BPix>
__device__ __forceinline__ void wgrad32(float (&acc)[9][4], const unsigned char* gz, const unsigned char* act,
                                        int tap, int xm, int xn, int lane, APix apix, BPix bpix) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 1
  for (int s = 0; s < KS; ++s) {
    // positions tg (a0, a1 / b0) and tg + 4 (a2, a3 / b1)
    const float4 alo = ld_chunk(gz, apix(s, tg), g), ahi = ld_chunk(gz, apix(s, tg + 4), g);
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      prep<SPLIT>(part_of(alo, 2 * mt), ah[mt][0], al[mt][0]);
      prep<SPLIT>(part_of(alo, 2 * mt + 1), ah[mt][1], al[mt][1]);
      prep<SPLIT>(part_of(ahi, 2 * mt), ah[mt][2], al[mt][2]);
      prep<SPLIT>(part_of(ahi, 2 * mt + 1), ah[mt][3], al[mt][3]);
    }
    const float4 blo = ld_chunk(act, bpix(s, tg, tap), g), bhi = ld_chunk(act, bpix(s, tg + 4, tap), g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      prep<SPLIT>(part_of(blo, j), bh0, bl0);
      prep<SPLIT>(part_of(bhi, j), bh1, bl1);
      mma_x<SPLIT>(acc[j], ah[0], al[0], bh0, bh1, bl0, bl1);
      mma_x<SPLIT>(acc[4 + j], ah[1], al[1], bh0, bh1, bl0, bl1);
    }
    uint32_t bh0, bl0, bh1, bl1, xh[4], xl[4];
    prep<SPLIT>(ld_ch(act, bpix(s, tg, 8), 4 * g + xn), bh0, bl0);
    prep<SPLIT>(ld_ch(act, bpix(s, tg + 4, 8), 4 * g + xn), bh1, bl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // selects, not a runtime index into registers
      xh[e] = xm ? ah[1][e] : ah[0][e];
      xl[e] = xm ? al[1][e] : al[0][e];
    }
    mma_x<SPLIT>(acc[8], xh, xl, bh0, bh1, bl0, bl1);
  }
}

// sum += acc, in f32 adds rounded to nearest. The weight gradients take
// each tile's products on the tensor cores into a fresh accumulator and add
// the tiles' sums here: one mma.sync accumulator chained over a CTA's whole
// walk (about 28 K positions a CTA at [8, 256, 1836, 3]) drifted from
// cuDNN's f32 dW1 and dW2 by about twice GRAD_TOL (1e-4 of the largest
// entry) on the card.
template <int NT>
__device__ __forceinline__ void add_to(float (&sum)[NT][4], const float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] += acc[j][e];
}

// A bias gradient's partial: thread t sums channel t & 31 of the n
// positions p = t >> 5, + 8, .. (pixel pix(p) of gz).
template <class Pix>
__device__ __forceinline__ float bias_sum(const unsigned char* gz, int n, int tid, Pix pix) {
  float s = 0.f;
  for (int p = tid >> 5; p < n; p += THREADS / 32) s += ld_ch(gz, pix(p), tid & 31);
  return s;
}

// The 8 threads' partials of each channel in fixed order -> dst[32].
__device__ __forceinline__ void bias_out(float* red, float v, float* dst, int tid) {
  red[tid] = v;
  __syncthreads();
  if (tid < C) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) s += red[k * 32 + tid];
    dst[tid] = s;
  }
  __syncthreads();
}

// dW[o][i][tap] (OIHW) from wgrad32's accumulators: accumulator row g
// (+ 8) of m-tile mt is o = 4g + 2mt (+ 1), column 2tg (+ 1) of n-tile j is
// i = 4 (2tg (+ 1)) + j.
__device__ __forceinline__ void write_w32(const float (&acc)[9][4], float* dst, int tap, int xm, int xn,
                                          int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int idx = 0; idx < 9; ++idx) {
    const int mt = idx < 8 ? idx >> 2 : xm, j = idx < 8 ? idx & 3 : xn, t = idx < 8 ? tap : 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 4 * g + 2 * mt + (e >> 1), i = 4 * (2 * tg + (e & 1)) + j;
      dst[o * (C * 9) + i * 9 + t] = acc[idx][e];
    }
  }
}

// ===================== pass 1: c3 -> dW3, db3, gz2 =====================

constexpr int TH3 = 4, TW3 = 16;                    // c3 tile
constexpr int RG3 = TH3 + 1, QG3 = TW3 + 1;         // gz3 with one row / column of halo: 5 x 17
constexpr int R2 = 2 * TH3 + 1, Q2 = 2 * TW3 + 1;   // c2 under the tile: 9 x 33
static_assert(TW3 == 16 && 4 * TH3 == 2 * WARPS, "two parity m-tiles a warp");
static_assert(TH3 * TW3 % 8 == 0, "whole k-steps");
constexpr int P1_GZ = WD_U4 * 16;
constexpr int P1_C2 = align128(P1_GZ + RG3 * QG3 * 128);
constexpr int P1_RED = align128(P1_C2 + R2 * Q2 * 128);
constexpr int P1_SMEM = P1_RED + THREADS * 4;

// The c2 positions of one parity (py, px) in c3 row j of the tile:
// (2 (oy0 + j) + py, 2 (ox0 + l) + px), l = 0 .. 15 the m16 tile's rows.
// Their g2 takes the taps ky = 1 (py 0), or ky = 0 from c3 row j + 1 and
// ky = 2 from row j (py 1); likewise kx. Masked by c2 > 0 into gz2.
template <typename T, bool SPLIT>
__device__ __forceinline__ void dgrad3(uint32_t gza, const uint4* wd, const unsigned char* c2s, T* gz2, Tile tl,
                                       int H, int W, int j, int py, int px, int lane) {
  const int g = lane >> 2, tg = lane & 3, lrow = lane & 15;
  float acc[4][4] = {};
#pragma unroll 1
  for (int a = 0; a < 1 + py; ++a) {
    const int ky = py ? 2 * a : 1, dr = py ? 1 - a : 0;
#pragma unroll 1
    for (int c = 0; c < 1 + px; ++c) {
      const int kx = px ? 2 * c : 1, dc = px ? 1 - c : 0;
      const int tf = 8 - (3 * ky + kx);  // the tap's place in the flipped layout
      const int pix = (j + dr) * QG3 + lrow + dc;
#pragma unroll
      for (int h = 0; h < 4; ++h) dgrad_step<SPLIT>(acc, gza, pix, h, wd, 4 * tf + h, lane);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = g + 8 * hh;
    const int y = 2 * (tl.oy0 + j) + py, x = 2 * (tl.ox0 + l) + px;
    if (y >= H || x >= W) continue;
    const int p2 = (2 * j + py + 1) * Q2 + 2 * l + px + 1;  // its c2 in the window
    T* dst = gz2 + (((size_t)tl.b * H + y) * W + x) * C;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = 8 * nt + 2 * tg;
      store2(dst + i, ld_ch(c2s, p2, i) > 0.f ? acc[nt][2 * hh] : 0.f,
             ld_ch(c2s, p2, i + 1) > 0.f ? acc[nt][2 * hh + 1] : 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
bwd_c3_kernel(const T* __restrict__ g3, const T* __restrict__ c3, const T* __restrict__ c2,
              const uint4* __restrict__ wd3, T* __restrict__ gz2, float* __restrict__ part, int B, int H,
              int W, int Ho, int Wo) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* wds = reinterpret_cast<const uint4*>(smem);
  unsigned char* gzs = smem + P1_GZ;
  unsigned char* c2s = smem + P1_C2;
  float* red = reinterpret_cast<float*>(smem + P1_RED);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xm = warp & 1, xn = warp >> 1;  // this warp's tile of tap 8 (wgrad32; its own tap is `warp`)
  if (gz2 != nullptr) stage(smem, wd3, WD_U4, nullptr, 0, tid, THREADS);

  const int tiles_x = (Wo + TW3 - 1) / TW3;
  const long long per_img = (long long)tiles_x * ((Ho + TH3 - 1) / TH3);
  const long long total = per_img * B;
  float acc[9][4] = {};
  float db = 0.f;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at<TH3, TW3>(t, per_img, tiles_x);
    load_region<T, true>(gzs, g3, c3, tl.b, tl.oy0, tl.ox0, RG3, QG3, Ho, Wo, tid);
    load_region<T, false>(c2s, c2, nullptr, tl.b, 2 * tl.oy0 - 1, 2 * tl.ox0 - 1, R2, Q2, H, W, tid);
    __syncthreads();
    if (part != nullptr) {
      // position k of k-step s: c3 (s / 2, 8 (s % 2) + k); its c2 under tap t in the window
      float tile_acc[9][4] = {};
      wgrad32<SPLIT, TH3 * TW3 / 8>(
          tile_acc, gzs, c2s, warp, xm, xn, lane, [](int s, int k) { return (s >> 1) * QG3 + 8 * (s & 1) + k; },
          [](int s, int k, int t) { return (2 * (s >> 1) + t / 3) * Q2 + 2 * (8 * (s & 1) + k) + t % 3; });
      add_to(acc, tile_acc);
      db += bias_sum(gzs, TH3 * TW3, tid, [](int p) { return (p / TW3) * QG3 + p % TW3; });
    }
    if (gz2 != nullptr) {
      // units u = warp, warp + 8: c3 row u % 4, parity (1, 1), (0, 1), (0, 0), (1, 0) by u / 4
#pragma unroll 1
      for (int u = warp; u < 4 * TH3; u += WARPS) {
        const int par = u / TH3;
        dgrad3<T, SPLIT>(smem_addr(gzs), wds, c2s, gz2, tl, H, W, u % TH3, par == 0 || par == 3, par <= 1, lane);
      }
    }
    __syncthreads();  // the next tile overwrites gzs and c2s
  }
  if (part != nullptr) {
    float* dst = part + (size_t)blockIdx.x * PART3;
    write_w32(acc, dst, warp, xm, xn, lane);
    bias_out(red, db, dst + NW, tid);
  }
}

// ===================== pass 2: gz2 -> dW2, db2, gz1 -> dW1, db1 =====================

constexpr int TH = 8, TW = 16;                      // c1 / c2 tile
constexpr int RG = TH + 2, QG = TW + 2;             // gz2, c1 and x with a halo of one: 10 x 18
static_assert(TH == WARPS && TW == 16, "one m16 row of g1 a warp");
static_assert(TH * TW % 8 == 0, "whole k-steps");
constexpr int P2_GZ2 = WD_U4 * 16;
constexpr int P2_C1 = align128(P2_GZ2 + RG * QG * 128);
constexpr int P2_GZ1 = align128(P2_C1 + RG * QG * 128);
constexpr int P2_X = align128(P2_GZ1 + TH * TW * 128);
constexpr int P2_RED = align128(P2_X + RG * QG * CIN * 4);
constexpr int P2_SMEM = P2_RED + THREADS * 4;

// The tile's own position k of k-step s: (s / 2, 8 (s % 2) + k).
__device__ __forceinline__ int own_row(int s) { return s >> 1; }
__device__ __forceinline__ int own_col(int s, int k) { return 8 * (s & 1) + k; }

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
bwd_c2_kernel(const T* __restrict__ gz2, const T* __restrict__ c1, const T* __restrict__ x,
              const uint4* __restrict__ wd2, T* __restrict__ gz1, float* __restrict__ part, int flags,
              int B, int H, int W) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const bool do_w2 = flags & 1, do_g1 = flags & 2, do_w1 = flags & 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* wds = reinterpret_cast<const uint4*>(smem);
  unsigned char* gz2s = smem + P2_GZ2;
  unsigned char* c1s = smem + P2_C1;
  unsigned char* gz1s = smem + P2_GZ1;
  float* xs = reinterpret_cast<float*>(smem + P2_X);
  float* red = reinterpret_cast<float*>(smem + P2_RED);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3, lrow = lane & 15;
  const int xm = warp & 1, xn = warp >> 1;  // dW2: this warp's tile of tap 8 (its own tap is `warp`); dW1's tile
  if (do_g1) stage(smem, wd2, WD_U4, nullptr, 0, tid, THREADS);

  const int tiles_x = (W + TW - 1) / TW;
  const long long per_img = (long long)tiles_x * ((H + TH - 1) / TH);
  const long long total = per_img * B;
  float acc2[9][4] = {}, acc1[1][4] = {};
  float db2 = 0.f, db1 = 0.f;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(t, per_img, tiles_x);
    const int y0 = tl.oy0, x0 = tl.ox0;
    load_region<T, false>(gz2s, gz2, nullptr, tl.b, y0 - 1, x0 - 1, RG, QG, H, W, tid);
    load_region<T, false>(c1s, c1, nullptr, tl.b, y0 - 1, x0 - 1, RG, QG, H, W, tid);
    if (do_w1) load_input(xs, x, tl.b, y0 - 1, x0 - 1, RG, QG, H, W, tid);
    __syncthreads();
    if (do_w2) {
      // own position (r, q) is window pixel (r + 1, q + 1); c1 under tap (ky, kx) at (r + ky, q + kx)
      float tile_acc[9][4] = {};
      wgrad32<SPLIT, TH * TW / 8>(
          tile_acc, gz2s, c1s, warp, xm, xn, lane,
          [](int s, int k) { return (own_row(s) + 1) * QG + own_col(s, k) + 1; },
          [](int s, int k, int t) { return (own_row(s) + t / 3) * QG + own_col(s, k) + t % 3; });
      add_to(acc2, tile_acc);
      db2 += bias_sum(gz2s, TH * TW, tid, [](int p) { return (p / TW + 1) * QG + p % TW + 1; });
    }
    if (do_g1) {
      // g1 on own row r = warp: conv^T(gz2, W2) as a correlation with the
      // flipped taps (ky', kx'), which read the window at (r + ky', l + kx')
      const int r = warp;
      float acc[4][4] = {};
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int pix = (r + tap / 3) * QG + lrow + tap % 3;
#pragma unroll
        for (int h = 0; h < 4; ++h) dgrad_step<SPLIT>(acc, smem_addr(gz2s), pix, h, wds, 4 * tap + h, lane);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int l = g + 8 * hh, y = y0 + r, xx = x0 + l;
        const bool in = y < H && xx < W;
        const int p1 = (r + 1) * QG + l + 1;  // its c1 in the window
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int i = 8 * nt + 2 * tg;
          const float v0 = in && ld_ch(c1s, p1, i) > 0.f ? as_dtype<T>(acc[nt][2 * hh]) : 0.f;
          const float v1 = in && ld_ch(c1s, p1, i + 1) > 0.f ? as_dtype<T>(acc[nt][2 * hh + 1]) : 0.f;
          *reinterpret_cast<float2*>(gz1s + sw(r * TW + l, i >> 2) + 4 * (i & 3)) = make_float2(v0, v1);
          if (gz1 != nullptr && in) store2(gz1 + (((size_t)tl.b * H + y) * W + xx) * C + i, v0, v1);
        }
      }
    }
    __syncthreads();  // gz1s complete
    if (do_w1) {
      // column n = 3 tap + ci (n < 27), the input at (r + ky, q + kx) of the window
      float tile_acc[1][4] = {};
      wgrad<SPLIT, 1, TH * TW / 8>(
          tile_acc, gz1s, xm, xn, lane, [](int s, int k) { return own_row(s) * TW + own_col(s, k); },
          [xs](int s, int k, int n) {
            if (n >= 9 * CIN) return 0.f;
            const int tap = n / CIN, ci = n - CIN * tap, ky = tap / 3, kx = tap - 3 * ky;
            return xs[((own_row(s) + ky) * QG + own_col(s, k) + kx) * CIN + ci];
          });
      add_to(acc1, tile_acc);
      db1 += bias_sum(gz1s, TH * TW, tid, [](int p) { return p; });
    }
    __syncthreads();  // the next tile overwrites the shared tiles
  }
  if (part != nullptr) {
    float* dst = part + (size_t)blockIdx.x * PART2;
    write_w32(acc2, dst, warp, xm, xn, lane);
    bias_out(red, db2, dst + NW, tid);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = 16 * xm + g + 8 * (e >> 1), n = 8 * xn + 2 * tg + (e & 1);
      if (n < 9 * CIN) {
        const int tap = n / CIN, ci = n - CIN * tap;
        dst[NW + C + o * (CIN * 9) + ci * 9 + tap] = acc1[0][e];
      }
    }
    bias_out(red, db1, dst + NW + C + NW1, tid);
  }
}

// ===================== pass 3: dx = conv^T(gz1, W1) =====================

constexpr int P3_GZ1 = WD1_F2 * 8;
constexpr int P3_SMEM = P3_GZ1 + RG * QG * 128;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dx_kernel(const T* __restrict__ gz1, const float2* __restrict__ wd1, T* __restrict__ dx, int B, int H,
              int W) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const float2* wds = reinterpret_cast<const float2*>(smem);
  unsigned char* gzs = smem + P3_GZ1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3, lrow = lane & 15;
  stage(smem, reinterpret_cast<const uint4*>(wd1), WD1_F2 / 2, nullptr, 0, tid, THREADS);

  const int tiles_x = (W + TW - 1) / TW;
  const long long per_img = (long long)tiles_x * ((H + TH - 1) / TH);
  const long long total = per_img * B;
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(t, per_img, tiles_x);
    load_region<T, false>(gzs, gz1, nullptr, tl.b, tl.oy0 - 1, tl.ox0 - 1, RG, QG, H, W, tid);
    __syncthreads();
    const int r = warp;
    float acc[4] = {};
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int pix = (r + tap / 3) * QG + lrow + tap % 3;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float2 w = wds[(4 * tap + h) * 32 + lane];
        uint32_t bh0, bl0, bh1, bl1, a[4], ah[4], al[4];
        prep<SPLIT>(w.x, bh0, bl0);
        prep<SPLIT>(w.y, bh1, bl1);
        ldsm_x4(a, smem_addr(gzs) + sw(pix, 2 * h + (lane >> 4)));
        prep_a<SPLIT>(a, ah, al);
        mma_x<SPLIT>(acc, ah, al, bh0, bh1, bl0, bl1);
      }
    }
    // thread (g, tg) holds input channels 2 tg, 2 tg + 1 of positions g, g + 8
    if (tg < 2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int y = tl.oy0 + r, xx = tl.ox0 + g + 8 * hh;
        if (y >= H || xx >= W) continue;
        T* dst = dx + (((size_t)tl.b * H + y) * W + xx) * CIN + 2 * tg;
        store1(dst, acc[2 * hh]);
        if (tg == 0) store1(dst + 1, acc[2 * hh + 1]);
      }
    }
    __syncthreads();  // the next tile overwrites gzs
  }
}

// ===================== the weight gradients: partials summed in CTA order =====================

__global__ void reduce_kernel(const float* __restrict__ part, int parts, int n, float* __restrict__ out,
                              int round_bf16) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * n + e];
  out[e] = round_bf16 ? __bfloat162float(__float2bfloat16_rn(s)) : s;
}

cudaError_t reduce(const float* part, int parts, int n, float* out, int round_bf16, cudaStream_t s) {
  reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, parts, n, out, round_bf16);
  return cudaGetLastError();
}

long long tiles_of(int B, int H, int W, int th, int tw) {
  return (long long)((W + tw - 1) / tw) * ((H + th - 1) / th) * B;
}

template <typename T>
cudaError_t grids(int B, int H, int W, int* out) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  cudaError_t err = persistent_grid(bwd_c3_kernel<T>, THREADS, P1_SMEM, tiles_of(B, Ho, Wo, TH3, TW3), out);
  if (err != cudaSuccess) return err;
  return persistent_grid(bwd_c2_kernel<T>, THREADS, P2_SMEM, tiles_of(B, H, W, TH, TW), out + 1);
}

// needs: 1 dx, 2 dW1 / db1, 4 dW2 / db2, 8 dW3 / db3.
template <typename T>
cudaError_t backward(int needs, const void* g3, const void* x, const void* c1, const void* c2, const void* c3,
                     const float* wd, void* gz2, void* gz1, float* part, int grid3, int grid2, float* dw3,
                     float* dw21, void* dx, int B, int H, int W, cudaStream_t s) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int round = std::is_same<T, float>::value ? 0 : 1;
  const float2* wd1 = reinterpret_cast<const float2*>(wd);
  const uint4* wd2 = reinterpret_cast<const uint4*>(wd + 2 * WD1_F2);
  const uint4* wd3 = wd2 + WD_U4;
  float* part2 = part + (size_t)grid3 * PART3;
  int want[2] = {0, 0};  // (and the kernels' shared-memory attribute set)
  cudaError_t err = grids<T>(B, H, W, want);
  if (err != cudaSuccess) return err;
  if (grid3 != want[0] || grid2 != want[1]) return cudaErrorInvalidValue;
  const bool lower = needs & 7;  // anything below c3
  if (needs & 15) {
    bwd_c3_kernel<T><<<grid3, THREADS, P1_SMEM, s>>>(
        static_cast<const T*>(g3), static_cast<const T*>(c3), static_cast<const T*>(c2), wd3,
        lower ? static_cast<T*>(gz2) : nullptr, (needs & 8) ? part : nullptr, B, H, W, Ho, Wo);
    if ((err = cudaGetLastError())) return err;
  }
  if ((needs & 8) && (err = reduce(part, grid3, PART3, dw3, round, s))) return err;
  if (lower) {
    const int flags = ((needs & 4) ? 1 : 0) | ((needs & 3) ? 2 : 0) | ((needs & 2) ? 4 : 0);
    bwd_c2_kernel<T><<<grid2, THREADS, P2_SMEM, s>>>(
        static_cast<const T*>(gz2), static_cast<const T*>(c1), static_cast<const T*>(x), wd2,
        (needs & 1) ? static_cast<T*>(gz1) : nullptr, (needs & 6) ? part2 : nullptr, flags, B, H, W);
    if ((err = cudaGetLastError())) return err;
  }
  if ((needs & 6) && (err = reduce(part2, grid2, PART2, dw21, round, s))) return err;
  if (needs & 1) {
    err = launch_persistent(bwd_dx_kernel<T>, THREADS, P3_SMEM, tiles_of(B, H, W, TH, TW), s,
                            static_cast<const T*>(gz1), wd1, static_cast<T*>(dx), B, H, W);
    if (err) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The grids that dd_trunk_bwd launches its c3 and c2 passes with, for
// x [B, H, W, 3] of dtype (0 float32, 1 bfloat16): grids[0], grids[1]. The
// caller allocates grids[0] * 9,248 + grids[1] * 10,144 f32 of partials.
extern "C" int dd_trunk_bwd_grids(int dtype, int B, int H, int W, int* grids_out) {
  if (dtype == 0) return (int)grids<float>(B, H, W, grids_out);
  if (dtype == 1) return (int)grids<__nv_bfloat16>(B, H, W, grids_out);
  return (int)cudaErrorInvalidValue;
}

// The C entry for ctypes (kernels/trunk.py:trunk_bwd). needs: 1 dx, 2 dW1
// and db1, 4 dW2 and db2, 8 dW3 and db3. g3, c3 [B, Ho, Wo, 32], c1, c2
// [B, H, W, 32] and x [B, H, W, 3] in dtype (0 float32, 1 bfloat16); wd
// the dgrad weight layout (kernels/trunk.py:prepare_bwd_weights, 20,736
// f32); gz2 [B, H, W, 32] scratch in dtype (needs & 7), gz1 the same
// (needs & 1); part the partials for the grids of dd_trunk_bwd_grids; dw3
// [9,248] f32: dW3 (OIHW) | db3; dw21 [10,144] f32: dW2 | db2 | dW1 |
// db1 (bf16: each rounded to bf16 once); dx [B, H, W, 3] in dtype.
// Returns a cudaError_t.
extern "C" int dd_trunk_bwd(int dtype, int needs, const void* g3, const void* x, const void* c1, const void* c2,
                            const void* c3, const float* wd, void* gz2, void* gz1, float* part, int grid3,
                            int grid2, float* dw3, float* dw21, void* dx, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)backward<float>(needs, g3, x, c1, c2, c3, wd, gz2, gz1, part, grid3, grid2, dw3, dw21, dx, B, H,
                                W, s);
  if (dtype == 1)
    return (int)backward<__nv_bfloat16>(needs, g3, x, c1, c2, c3, wd, gz2, gz1, part, grid3, grid2, dw3, dw21,
                                        dx, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
