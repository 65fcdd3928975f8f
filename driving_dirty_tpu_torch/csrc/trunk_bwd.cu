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
// 179.8 GFLOP of products (c3 pass 34.7, c2 pass 145.1) and 1.25 GB in f32
// (g3 120 MB + c3 120 MB + c2 481 MB + c1 481 MB + x 45 MB read once, the
// weight gradients written): in f32 three TF32 products a product, 539
// GFLOP, 1.090 ms at 495 TFLOP/s against 0.373 ms of bytes, so bound by
// operations; in bf16 624 MB, 0.186 ms of bytes against 0.182 ms of bf16
// products, bound by bytes.
//
// Three passes and a reduction, launched by the C entry dd_trunk_bwd in
// turn (one call of the op): the c3 pass (dW3, db3 and the stride-2 dgrad
// of c3, masked into gz2, which goes through device memory), the c2 pass
// (dW2, db2; g1 = conv^T(gz2, W2), masked into gz1 in shared memory; dW1,
// db1), the dx pass when asked, and a last kernel that sums the per-CTA
// weight-gradient partials of each element in CTA order. No atomics: two
// launches give the same bits. Each dtype has its own kernels for the c3
// and c2 passes; the dx pass and the reduction are shared. gz2 goes through
// device memory (written once, read with a halo of one, about 0.14 ms of
// bytes in bf16 at the shape above): holding it in shared memory for a c2
// tile plus the halo that g1 needs would recompute the parity-split dgrad
// of c3 on that halo for every tile.
//
// bfloat16 (namespace bf): native bf16 products, mma.sync.m16n8k16 with f32
// accumulators, on tiles stored as bf16 [pixel][32 channels], 64 B a pixel,
// swizzled as the forward's (csrc/trunk.cu). What it does about the costs
// of the first design, which widened bf16 to f32 and ran it through the
// float32 kernels below:
//  * Tiles stay bf16 in shared memory (half the footprint and the
//    shared-memory traffic), and a product is one k16 mma, twice the K of
//    a TF32 k8 one. Both products are exact, so only the order of the f32
//    sums changes.
//  * Loads are asynchronous, in a ring of two stages: one persistent CTA an
//    SM copies the next tile's windows with cp.async (16 B a copy, the
//    conv padding and the image edges zero-filled by a source size of 0)
//    while the current tile's products run; x's window (3 channels, not 16-B
//    aligned) comes through registers, loaded a tile ahead. gz3 = g3 *
//    [c3 > 0] is applied in shared memory, each thread on the chunks it
//    copied, once the copies have landed.
//  * The weight gradients take K over positions, so their operands are read
//    by ldmatrix .trans straight from the [pixel][channel] tiles. Each warp
//    of 0-3 owns one 8-channel chunk i of dW (all o, all nine taps; 72 f32
//    accumulators a thread): each A fragment of gz is loaded once per warp
//    and k-step and feeds 18 products, and in the c2 pass the B fragments of
//    a c1 window row serve the three k-steps that read it (a rotation of
//    registers in an unrolled loop).
//  * Bias sums are products too: db3 and db2 by a ones column (B = 1.0) on
//    the dW warps' A fragments, each warp on a quarter of the k-steps; db1
//    is column 27 of dW1's B operand, an im2col of x built once a tile in
//    shared memory from a 4-channel x window, one 8-B load a tap ((tap, ci)
//    = 27 columns, 1.0, zeros to 32).
//  * The accumulators of each warp chain over the CTA's whole walk (in bf16
//    the weight gradients are rounded to bf16 once, far above the drift of
//    f32 sums over ~28 K positions), and are written once as the CTA's
//    partial.
//  * Larger tiles, to cut the halo. Eight warps a CTA, one CTA an SM
//    (__launch_bounds__(256, 1)), warp-specialized:
//    c3 pass, 8 x 16 c3 tiles: warps 0-3 dW3 (8 k-steps), warps 4-7 the
//      parity-split dgrad of two c3 rows each (the c2 positions of one
//      parity take 1, 2 or 4 taps of W3, so no product falls on a
//      zero-inserted position), 144 mma a warp either way. Shared memory:
//        W3's fragments                         18,432 B
//        2 stages x (gz3 9 x 17 + c3 9 x 17 + c2 17 x 33, even columns
//        first) x 64 B                          110,976 B
//        total                                  129,408 B
//    c2 pass, 16 x 16 c1 / c2 tiles (a 18 x 18 window: 27% halo, against
//      41% for the first design's 8 x 16): warps 0-3 dW2 (16 k-steps),
//      warps 4-7 g1 on four own rows each (per (kx', channel half) three
//      taps' B fragments from shared memory, each A fragment of a window
//      row once), 288 mma a warp either way; then, after a barrier, dW1 on
//      all eight warps (two k-steps each). Two barriers a tile. Shared
//      memory:
//        W2's fragments                         18,432 B
//        2 stages x (gz2 + c1) 18 x 18 x 64 B   82,944 B
//        gz1 16 x 16 x 64 B                     16,384 B
//        im2col of x 256 x 64 B                 16,384 B
//        x window 18 x 18 x 4 x 2 B              2,592 B
//        total with 128-B alignment            136,832 B
//
// float32 (bwd_c3_kernel, bwd_c2_kernel): split TF32, the first design.
// Every product runs as mma.sync.m16n8k8 with TF32 operands and f32
// accumulators, over shared-memory tiles stored as the forward stores c1
// and c2: [pixel][32 channels] f32, 16-B chunks XOR-swizzled by pixel
// (trunk_common.cuh: tf32::sw). Each product is taken as three TF32
// products of split operands, as in the forward (the tolerance is 1e-4 of
// sums of up to 3.7 M terms); each tile sums into fresh accumulators added
// in f32 to the CTA's (add_to). These passes are bound by their split-TF32
// instruction stream, not by their loads: on the bf16 kernels' ring of
// cp.async tiles, one CTA an SM (172 and 152 registers, no spills), they
// took longer at [8, 256, 1836, 3] on the H100 than here, where two CTAs
// an SM of 8 warps load synchronously:
//
// 1. c3 pass, over 4 x 16 tiles of c3: gz3 (tile plus one row and column
//    of halo) is formed as g3 and c3 are loaded; c2 under the tile's
//    receptive field (9 x 33) is loaded. dW3 (M = 32 o, N = 288 (tap, i),
//    K = the tile's 64 positions) and db3. The parity-split dgrad of c3 as
//    in bf16 (A by ldmatrix from gz3, N = 32, W3 as transposed, tap-flipped
//    B fragments, kernels/trunk.py:prepare_bwd_weights), masked by c2 > 0
//    into gz2.
// 2. c2 pass, over 8 x 16 tiles of c1 / c2 positions: gz2 and c1 with a
//    halo of one, and x under the tile. dW2 (K = the tile's 128 positions)
//    and db2; g1 = conv^T(gz2, W2), an implicit GEMM as the forward's c2
//    (one m16 row a warp, 36 k-steps), masked by c1 > 0 into a shared tile
//    gz1 (written to device memory only when dx is asked for); dW1 (N = 27
//    (tap, ci) padded to 32) and db1 from gz1 and x.
// 3. dx pass (only when asked for, both dtypes): conv^T(gz1, W1) over 8 x 16
//    tiles, N = 3 padded to 8.
// 4. The weight gradients: each CTA of passes 1 and 2 keeps its partial
//    dW / db (9,216 + 32, and 9,216 + 32 + 864 + 32 f32) in registers over
//    its walk and writes it once to a scratch buffer the wrapper allocates
//    for the grid it launches (dd_trunk_bwd_grids); a last kernel sums the
//    partials of each element in CTA order.
//
// In the f32 weight-gradient GEMMs K runs over positions, the slow axis of
// the [pixel][channel] tiles, which ldmatrix cannot transpose at 32 bits.
// So dW3 and dW2 (wgrad32) number their tiles' rows and columns by channel
// residue, and one 16-B load of a pixel's channel chunk gives a lane its A
// values of both m-tiles or its B values of a tap's four n-tiles; dW1 (27
// columns from the 3-channel input) gathers with scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "trunk_common.cuh"

namespace {

using namespace tf32;  // sw, split, BPair, split_b, mma (trunk_common.cuh)

constexpr int WARPS = 8, THREADS = 32 * WARPS;
// The float32 c3 and c2 passes run two CTAs an SM (__launch_bounds__(THREADS,
// MIN_CTAS)), so one CTA's tile loads overlap the other's products, and
// ptxas holds them to 128 registers: at [8, 256, 1836, 3] on the H100
// (chip_smoke.py) they took 4% less time than at one CTA an SM (161-191
// registers).
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

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
__device__ __forceinline__ void load_input(float* dst, const float* x, int b, int y0, int x0, int R, int Q, int H,
                                           int W, int tid) {
  for (int i = tid; i < R * Q * CIN; i += THREADS) {
    const int p = i / CIN, ci = i - p * CIN, r = p / Q, q = p - r * Q;
    const int gy = y0 + r, gx = x0 + q;
    dst[i] = inside(gy, gx, H, W) ? load1(x + (((size_t)b * H + gy) * W + gx) * CIN + ci) : 0.f;
  }
}

// ----- TF32 operands: split in three products (SPLIT: the float32 passes
// and f32 dx), or taken as they are (bf16 dx: values exact in TF32)

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
__device__ __forceinline__ void mma_n32(float (&d)[4][4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                        const BPair& b0, const BPair& b1) {
  mma_x<true>(d[0], ah, al, b0.hi[0], b0.hi[1], b0.lo[0], b0.lo[1]);
  mma_x<true>(d[1], ah, al, b0.hi[2], b0.hi[3], b0.lo[2], b0.lo[3]);
  mma_x<true>(d[2], ah, al, b1.hi[0], b1.hi[1], b1.lo[0], b1.lo[1]);
  mma_x<true>(d[3], ah, al, b1.hi[2], b1.hi[3], b1.lo[2], b1.lo[3]);
}

// One k-step (8 positions) of a dgrad on a 16-position A tile: A by
// ldmatrix at a row address of this lane (pixel pix, channels 8h ..), B
// the tap-flipped fragments of k-step s.
__device__ __forceinline__ void dgrad_step(float (&acc)[4][4], uint32_t abuf, int pix, int h, const uint4* wd,
                                           int s, int lane) {
  const BPair b0 = split_b(wd[(2 * s) * 32 + lane]), b1 = split_b(wd[(2 * s + 1) * 32 + lane]);
  uint32_t a[4], ah[4], al[4];
  ldsm_x4(a, abuf + sw(pix, 2 * h + (lane >> 4)));
  prep_a<true>(a, ah, al);
  mma_n32(acc, ah, al, b0, b1);
}

// A weight gradient's partial (dW1, N = 27 (tap, ci) padded to 32), dW[o][n]
// += sum over KS k-steps of 8 positions of gz[pos][o] * act[pos shifted by
// n's tap][n's channel]: M = o in two m16 tiles, N in n8 tiles. This warp takes m-tile mt and the NT
// n-tiles from nt0. apix(s, k): the pixel of gz under position k of k-step
// s; bval(s, k, n): B at (position k of k-step s, column n).
template <int NT, int KS, class APix, class BVal>
__device__ __forceinline__ void wgrad(float (&acc)[NT][4], const unsigned char* gz, int mt, int nt0, int lane,
                                      APix apix, BVal bval) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 1
  for (int s = 0; s < KS; ++s) {
    uint32_t ah[4], al[4];
    // a[e]: o = 16 mt + g + 8 (e & 1), position tg + 4 (e >> 1)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(ld_ch(gz, apix(s, tg + 4 * (e >> 1)), 16 * mt + g + 8 * (e & 1)), ah[e], al[e]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // b0: position tg, b1: position tg + 4; column 8 nt + g
      uint32_t bh0, bl0, bh1, bl1;
      split(bval(s, tg, 8 * (nt0 + j) + g), bh0, bl0);
      split(bval(s, tg + 4, 8 * (nt0 + j) + g), bh1, bl1);
      mma_x<true>(acc[j], ah, al, bh0, bh1, bl0, bl1);
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
template <int KS, class APix, class BPix>
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
      split(part_of(alo, 2 * mt), ah[mt][0], al[mt][0]);
      split(part_of(alo, 2 * mt + 1), ah[mt][1], al[mt][1]);
      split(part_of(ahi, 2 * mt), ah[mt][2], al[mt][2]);
      split(part_of(ahi, 2 * mt + 1), ah[mt][3], al[mt][3]);
    }
    const float4 blo = ld_chunk(act, bpix(s, tg, tap), g), bhi = ld_chunk(act, bpix(s, tg + 4, tap), g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split(part_of(blo, j), bh0, bl0);
      split(part_of(bhi, j), bh1, bl1);
      mma_x<true>(acc[j], ah[0], al[0], bh0, bh1, bl0, bl1);
      mma_x<true>(acc[4 + j], ah[1], al[1], bh0, bh1, bl0, bl1);
    }
    uint32_t bh0, bl0, bh1, bl1, xh[4], xl[4];
    split(ld_ch(act, bpix(s, tg, 8), 4 * g + xn), bh0, bl0);
    split(ld_ch(act, bpix(s, tg + 4, 8), 4 * g + xn), bh1, bl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // selects, not a runtime index into registers
      xh[e] = xm ? ah[1][e] : ah[0][e];
      xl[e] = xm ? al[1][e] : al[0][e];
    }
    mma_x<true>(acc[8], xh, xl, bh0, bh1, bl0, bl1);
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
__device__ __forceinline__ void dgrad3(uint32_t gza, const uint4* wd, const unsigned char* c2s, float* gz2, Tile tl,
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
      for (int h = 0; h < 4; ++h) dgrad_step(acc, gza, pix, h, wd, 4 * tf + h, lane);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int l = g + 8 * hh;
    const int y = 2 * (tl.oy0 + j) + py, x = 2 * (tl.ox0 + l) + px;
    if (y >= H || x >= W) continue;
    const int p2 = (2 * j + py + 1) * Q2 + 2 * l + px + 1;  // its c2 in the window
    float* dst = gz2 + (((size_t)tl.b * H + y) * W + x) * C;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int i = 8 * nt + 2 * tg;
      store2(dst + i, ld_ch(c2s, p2, i) > 0.f ? acc[nt][2 * hh] : 0.f,
             ld_ch(c2s, p2, i + 1) > 0.f ? acc[nt][2 * hh + 1] : 0.f);
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
bwd_c3_kernel(const float* __restrict__ g3, const float* __restrict__ c3, const float* __restrict__ c2,
              const uint4* __restrict__ wd3, float* __restrict__ gz2, float* __restrict__ part, int B, int H,
              int W, int Ho, int Wo) {
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
    load_region<float, true>(gzs, g3, c3, tl.b, tl.oy0, tl.ox0, RG3, QG3, Ho, Wo, tid);
    load_region<float, false>(c2s, c2, nullptr, tl.b, 2 * tl.oy0 - 1, 2 * tl.ox0 - 1, R2, Q2, H, W, tid);
    __syncthreads();
    if (part != nullptr) {
      // position k of k-step s: c3 (s / 2, 8 (s % 2) + k); its c2 under tap t in the window
      float tile_acc[9][4] = {};
      wgrad32<TH3 * TW3 / 8>(
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
        dgrad3(smem_addr(gzs), wds, c2s, gz2, tl, H, W, u % TH3, par == 0 || par == 3, par <= 1, lane);
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

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
bwd_c2_kernel(const float* __restrict__ gz2, const float* __restrict__ c1, const float* __restrict__ x,
              const uint4* __restrict__ wd2, float* __restrict__ gz1, float* __restrict__ part, int flags,
              int B, int H, int W) {
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
    load_region<float, false>(gz2s, gz2, nullptr, tl.b, y0 - 1, x0 - 1, RG, QG, H, W, tid);
    load_region<float, false>(c1s, c1, nullptr, tl.b, y0 - 1, x0 - 1, RG, QG, H, W, tid);
    if (do_w1) load_input(xs, x, tl.b, y0 - 1, x0 - 1, RG, QG, H, W, tid);
    __syncthreads();
    if (do_w2) {
      // own position (r, q) is window pixel (r + 1, q + 1); c1 under tap (ky, kx) at (r + ky, q + kx)
      float tile_acc[9][4] = {};
      wgrad32<TH * TW / 8>(
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
        for (int h = 0; h < 4; ++h) dgrad_step(acc, smem_addr(gz2s), pix, h, wds, 4 * tap + h, lane);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int l = g + 8 * hh, y = y0 + r, xx = x0 + l;
        const bool in = y < H && xx < W;
        const int p1 = (r + 1) * QG + l + 1;  // its c1 in the window
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int i = 8 * nt + 2 * tg;
          const float v0 = in && ld_ch(c1s, p1, i) > 0.f ? acc[nt][2 * hh] : 0.f;
          const float v1 = in && ld_ch(c1s, p1, i + 1) > 0.f ? acc[nt][2 * hh + 1] : 0.f;
          *reinterpret_cast<float2*>(gz1s + sw(r * TW + l, i >> 2) + 4 * (i & 3)) = make_float2(v0, v1);
          if (gz1 != nullptr && in) store2(gz1 + (((size_t)tl.b * H + y) * W + xx) * C + i, v0, v1);
        }
      }
    }
    __syncthreads();  // gz1s complete
    if (do_w1) {
      // column n = 3 tap + ci (n < 27), the input at (r + ky, q + kx) of the window
      float tile_acc[1][4] = {};
      wgrad<1, TH * TW / 8>(
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

// ===================== bfloat16: native bf16 products on a ring of cp.async tiles =====================

namespace bf {

constexpr int KS = 18;                  // k16 steps of a 3 x 3 x 32 dgrad
constexpr int WD_U4 = KS * 2 * 32;      // 1,152 uint4 = 18,432 B: one 32 -> 32 dgrad weight, bf16 fragments
constexpr uint32_t ONES = 0x3f803f80u;  // two bf16 1.0: the B fragment of a bias sum

// Byte offset of 16-B chunk `chunk` (channels 8 chunk .. + 7) of pixel p in a
// [pixel][32] bf16 tile: the chunks XOR-swizzled by (p >> 1) & 3, so that the
// rows of an ldmatrix at any 8 consecutive pixels fall in 8 distinct 16-B
// bank groups (csrc/trunk.cu's bf16 layout).
__device__ __forceinline__ int sw(int p, int chunk) { return (p << 6) | ((chunk ^ ((p >> 1) & 3)) << 4); }

// 16 B from src to shared memory at dst, asynchronously; zeros where !in
// (src is then not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix .trans: lane (g, tg) gets elements (row 2tg, column g) and (row
// 2tg + 1, column g) of each 8 x 8 matrix, i.e. two consecutive pixels of one
// channel: the fragment of an operand whose K runs over pixels.
__device__ __forceinline__ void ldsm_t4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_t2(uint32_t& a0, uint32_t& a1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n" : "=r"(a0), "=r"(a1) : "r"(addr));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Each bf16 half of v where the same half of act is > 0, else 0
// (threshold_backward); a bf16 is > 0 iff its bits as an int16 are.
__device__ __forceinline__ uint32_t mask2(uint32_t v, uint32_t act) {
  const uint32_t lo = static_cast<int16_t>(act & 0xffffu) > 0 ? 0x0000ffffu : 0u;
  const uint32_t hi = static_cast<int16_t>(act >> 16) > 0 ? 0xffff0000u : 0u;
  return v & (lo | hi);
}

// Issue the copies of the pixels (r, q) < (R, Q) of the window whose (0, 0)
// is global (y0, x0) of image b of a [B, H, W, 32] bf16 tensor into the tile
// at dst, pixel at(r, q); zeros outside the image (the convs' padding).
// Chunk i of the window is copied by thread i % THREADS.
template <int R, int Q, class At>
__device__ __forceinline__ void copy_window(uint32_t dst, const __nv_bfloat16* src, int b, int y0, int x0, int H,
                                            int W, int tid, At at) {
  for (int i = tid; i < R * Q * 4; i += THREADS) {
    const int p = i >> 2, c = i & 3, r = p / Q, q = p - r * Q;
    const int gy = y0 + r, gx = x0 + q;
    const bool in = inside(gy, gx, H, W);
    cp16(dst + sw(at(r, q), c), in ? src + (((size_t)b * H + gy) * W + gx) * C + 8 * c : src, in);
  }
}

// The accumulators of a CTA's eight warps: warps 0-3 keep a weight
// gradient's there over the whole walk (acc[9 mt + tap], an n8 tile a tap
// and m-tile), warps 4-7 their dgrad tile's, zeroed for each, in the same
// registers: one array, so ptxas does not hold both roles' live at once.
constexpr int ACC = 18;

// This warp's partial of a 32 x 288 weight gradient (OIHW) from the
// accumulators of its channel chunk ic: row g (+ 8) of m-tile mt is o, column
// 2tg (+ 1) is i = 8 ic + 2tg (+ 1), one n8 tile a tap.
__device__ __forceinline__ void write_w(const float (&acc)[ACC][4], float* dst, int ic, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[(16 * mt + g + 8 * (e >> 1)) * (C * 9) + (8 * ic + 2 * tg + (e & 1)) * 9 + tap] = acc[9 * mt + tap][e];
}

// A warp's bias partial from the accumulators of its ones column (every
// column holds the sum; lanes tg = 0 write theirs) into red[32].
__device__ __forceinline__ void stash_bias(const float (&bsum)[2][4], float* red, int lane) {
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    red[16 * mt + (lane >> 2)] = bsum[mt][0];
    red[16 * mt + (lane >> 2) + 8] = bsum[mt][2];
  }
}

// The four dW warps' bias partials (red[4][32]) summed in warp order into
// dst[32], by threads 0-31.
__device__ __forceinline__ void bias_out(const float* red, float* dst, int tid) {
  if (tid >= C) return;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) v += red[w * C + tid];
  dst[tid] = v;
}

// ----- pass 1: c3 -> dW3, db3, gz2

constexpr int TH3 = 8, TW3 = 16;                                  // c3 tile
constexpr int RG3 = TH3 + 1, QG3 = TW3 + 1, NG3 = RG3 * QG3;      // g3 / c3 with one row and column of halo: 9 x 17
constexpr int R2 = 2 * TH3 + 1, Q2 = 2 * TW3 + 1, N2 = R2 * Q2;   // c2 under the tile: 17 x 33
constexpr int Q2E = (Q2 + 1) / 2;                                 // c2's even window columns, stored first
static_assert(TW3 == 16, "a c3 row is one k16 step of dW3 and one m16 tile of a parity");
static_assert(TH3 == 2 * (WARPS / 2), "warps 4-7 take two c3 rows each");
constexpr int P1_C3 = NG3 * 64, P1_C2 = 2 * NG3 * 64;             // within a stage: gz3 | c3 | c2
constexpr int P1_STAGE = P1_C2 + N2 * 64;                         // 55,488 B
constexpr int P1_RING = WD_U4 * 16;                               // after W3's fragments
constexpr int P1_SMEM = P1_RING + 2 * P1_STAGE;                   // 129,408 B

// c2 window column q's stored column: even columns first, so the stride-2
// reads of a c3 row (window columns 2l + kx) are consecutive pixels.
__device__ __forceinline__ int c2_col(int q) { return (q & 1) ? Q2E + (q >> 1) : (q >> 1); }

__device__ __forceinline__ void p1_issue(uint32_t st, const __nv_bfloat16* g3, const __nv_bfloat16* c3,
                                         const __nv_bfloat16* c2, Tile tl, int H, int W, int Ho, int Wo, int tid) {
  const auto own = [](int r, int q) { return r * QG3 + q; };
  copy_window<RG3, QG3>(st, g3, tl.b, tl.oy0, tl.ox0, Ho, Wo, tid, own);
  copy_window<RG3, QG3>(st + P1_C3, c3, tl.b, tl.oy0, tl.ox0, Ho, Wo, tid, own);
  copy_window<R2, Q2>(st + P1_C2, c2, tl.b, 2 * tl.oy0 - 1, 2 * tl.ox0 - 1, H, W, tid,
                      [](int r, int q) { return r * Q2 + c2_col(q); });
}

// dW3 of one tile for channel chunk ic, i = 8 ic .. 8 ic + 7, all o and
// taps: M = o (two m16 tiles), N = (tap, i), K = the tile's c3 positions, a
// c3 row s (16 positions l) a k16 step. A = gz3 and B = c2 under the
// positions at each tap, both by ldmatrix .trans from the [pixel][channel]
// tiles; one A fragment feeds nine taps' products. Where bias, db3's ones
// column on the k-steps s = ic mod 4 (a quarter on each dW warp).
__device__ __forceinline__ void dw3_tile(float (&acc)[ACC][4], float (&bsum)[2][4], uint32_t gz, uint32_t c2s,
                                         int ic, bool bias, int lane) {
  const int j = lane >> 3, r8 = lane & 7, l = r8 + 8 * (j & 1);  // l: this lane's B row (position)
#pragma unroll 1
  for (int s = 0; s < TH3; ++s) {
    uint32_t a[2][4], b[9][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldsm_t4(a[mt], gz + sw(s * QG3 + r8 + 8 * (j >> 1), 2 * mt + (j & 1)));
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) {  // taps 2tp (matrices 0, 1) and 2tp + 1 (2, 3)
      const int tap = 2 * tp + (j >> 1), ky = tap / 3, kx = tap - 3 * ky;
      uint32_t t4[4];
      ldsm_t4(t4, c2s + sw((2 * s + ky) * Q2 + c2_col(2 * l + kx), ic));
      b[2 * tp][0] = t4[0];
      b[2 * tp][1] = t4[1];
      b[2 * tp + 1][0] = t4[2];
      b[2 * tp + 1][1] = t4[3];
    }
    ldsm_t2(b[8][0], b[8][1], c2s + sw((2 * s + 2) * Q2 + c2_col(2 * l + 2), ic));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma(acc[9 * mt + tap], a[mt], b[tap][0], b[tap][1]);
    if (bias && (s & 3) == ic) {
      mma(bsum[0], a[0], ONES, ONES);
      mma(bsum[1], a[1], ONES, ONES);
    }
  }
}

// g2 at the c2 positions of the tile's c3 rows j0 and j0 + 1, parity by
// parity: the positions (2 (oy0 + j) + py, 2 (ox0 + l) + px) take the taps
// ky = 1 (py 0), or ky = 0 from c3 row j + 1 and ky = 2 from row j (py 1);
// likewise kx. Each m16 tile is one row's 16 positions l (A by ldmatrix from
// gz3), N = 32, B W3's transposed, tap-flipped fragments from shared memory.
// Masked by c2 > 0, rounded to bf16 once, written to gz2.
__device__ __forceinline__ void dgrad3(float (&acc)[ACC][4], uint32_t gz, const unsigned char* c2s,
                                       const uint4* wds, __nv_bfloat16* gz2, Tile tl, int H, int W, int j0,
                                       int lane) {
  const int g = lane >> 2, tg = lane & 3, lrow = lane & 15, csel = lane >> 4;
#pragma unroll
  for (int par = 0; par < 4; ++par) {
    const int py = par >> 1, px = par & 1;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;  // [4 jr + nt]
#pragma unroll
    for (int a = 0; a <= py; ++a) {
      const int ky = py ? 2 * a : 1, dr = py ? 1 - a : 0;
#pragma unroll
      for (int c = 0; c <= px; ++c) {
        const int kx = px ? 2 * c : 1, dc = px ? 1 - c : 0;
        const int tf = 8 - (3 * ky + kx);  // the tap's place in the flipped layout
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = 2 * tf + h;
          const uint4 b0 = wds[(2 * s) * 32 + lane], b1 = wds[(2 * s + 1) * 32 + lane];
#pragma unroll
          for (int jr = 0; jr < 2; ++jr) {
            uint32_t av[4];
            ldsm_x4(av, gz + sw((j0 + jr + dr) * QG3 + lrow + dc, 2 * h + csel));
            mma(acc[4 * jr], av, b0.x, b0.y);
            mma(acc[4 * jr + 1], av, b0.z, b0.w);
            mma(acc[4 * jr + 2], av, b1.x, b1.y);
            mma(acc[4 * jr + 3], av, b1.z, b1.w);
          }
        }
      }
    }
#pragma unroll
    for (int jr = 0; jr < 2; ++jr)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int jj = j0 + jr, l = g + 8 * hh;
        const int y = 2 * (tl.oy0 + jj) + py, x = 2 * (tl.ox0 + l) + px;
        if (y >= H || x >= W) continue;
        const int p2 = (2 * jj + py + 1) * Q2 + c2_col(2 * l + px + 1);  // its c2 in the window
        uint32_t* dst = reinterpret_cast<uint32_t*>(gz2 + (((size_t)tl.b * H + y) * W + x) * C) + tg;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          dst[4 * nt] = mask2(pack(acc[4 * jr + nt][2 * hh], acc[4 * jr + nt][2 * hh + 1]),
                              *reinterpret_cast<const uint32_t*>(c2s + sw(p2, nt) + 4 * tg));
      }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
c3_pass(const __nv_bfloat16* __restrict__ g3, const __nv_bfloat16* __restrict__ c3,
        const __nv_bfloat16* __restrict__ c2, const uint4* __restrict__ wd3, __nv_bfloat16* __restrict__ gz2,
        float* __restrict__ part, int B, int H, int W, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool do_w3 = part != nullptr, do_g2 = gz2 != nullptr;
  const int tiles_x = (Wo + TW3 - 1) / TW3;
  const long long per_img = (long long)tiles_x * ((Ho + TH3 - 1) / TH3);
  const long long total = per_img * B;
  if (do_g2)
    for (int i = tid; i < WD_U4; i += THREADS) cp16(base + 16 * i, wd3 + i, true);
  long long t = blockIdx.x;
  if (t < total) p1_issue(base + P1_RING, g3, c3, c2, tile_at<TH3, TW3>(t, per_img, tiles_x), H, W, Ho, Wo, tid);
  commit();
  float acc[ACC][4] = {}, bsum[2][4] = {};
  for (int i = 0; t < total; ++i, t += gridDim.x) {
    const Tile tl = tile_at<TH3, TW3>(t, per_img, tiles_x);
    const long long tn = t + gridDim.x;
    if (tn < total)  // the next tile into the other stage, read last in the previous iteration
      p1_issue(base + P1_RING + ((i + 1) & 1) * P1_STAGE, g3, c3, c2, tile_at<TH3, TW3>(tn, per_img, tiles_x), H,
               W, Ho, Wo, tid);
    commit();
    wait_group<1>();  // this thread's copies of this tile (and of W3) have landed
    unsigned char* st = smem + P1_RING + (i & 1) * P1_STAGE;
    for (int k = tid; k < NG3 * 4; k += THREADS) {  // gz3 = g3 * [c3 > 0], on the chunks this thread copied
      uint4* v = reinterpret_cast<uint4*>(st + sw(k >> 2, k & 3));
      const uint4 m = *reinterpret_cast<const uint4*>(st + P1_C3 + sw(k >> 2, k & 3));
      *v = make_uint4(mask2(v->x, m.x), mask2(v->y, m.y), mask2(v->z, m.z), mask2(v->w, m.w));
    }
    __syncthreads();
    if (warp < 4) {
      if (do_w3) dw3_tile(acc, bsum, smem_addr(st), smem_addr(st + P1_C2), warp, true, lane);
    } else if (do_g2) {
      dgrad3(acc, smem_addr(st), st + P1_C2, reinterpret_cast<const uint4*>(smem), gz2, tl, H, W, 2 * (warp - 4),
             lane);
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }
  if (!do_w3) return;
  wait_group<0>();
  __syncthreads();  // the ring is free: the dW warps' db3 partials go there
  float* red = reinterpret_cast<float*>(smem + P1_RING);
  float* dst = part + (size_t)blockIdx.x * PART3;
  if (warp < 4) {
    write_w(acc, dst, warp, lane);
    stash_bias(bsum, red + warp * C, lane);
  }
  __syncthreads();
  bias_out(red, dst + NW, tid);
}

// ----- pass 2: gz2 -> dW2, db2, gz1 -> dW1, db1

constexpr int TH = 16, TW = 16, NP = TH * TW;                 // c1 / c2 tile, 256 own positions
constexpr int RG = TH + 2, QG = TW + 2, NG = RG * QG;         // gz2, c1 and x with a halo of one: 18 x 18
constexpr int XPX = (NG + THREADS - 1) / THREADS;             // x window pixels a thread
static_assert(NP == THREADS, "one im2col row a thread");
static_assert(TH == 4 * (WARPS / 2) && TH == 2 * WARPS, "g1: four rows a warp of 4-7; dW1: two k-steps a warp");
constexpr int P2_STAGE = 2 * NG * 64;                         // gz2 | c1 windows: 41,472 B
constexpr int P2_RING = WD_U4 * 16;                           // after W2's fragments
constexpr int P2_GZ1 = P2_RING + 2 * P2_STAGE;                // gz1 on the own positions, 16,384 B
constexpr int P2_COL = P2_GZ1 + NP * 64;                      // dW1's B: im2col of x, 16,384 B
constexpr int P2_X = P2_COL + NP * 64;                        // x under the window, 4 channels a pixel: 2,592 B
constexpr int P2_SMEM = align128(P2_X + NG * 8);              // 136,832 B
static_assert(WARPS * 32 * 32 * 4 + 4 * C * 4 <= 2 * P2_STAGE, "dW1's and db2's partials fit in the ring");

__device__ __forceinline__ void p2_issue(uint32_t st, const __nv_bfloat16* gz2, const __nv_bfloat16* c1, Tile tl,
                                         int H, int W, int tid) {
  const auto at = [](int r, int q) { return r * QG + q; };
  copy_window<RG, QG>(st, gz2, tl.b, tl.oy0 - 1, tl.ox0 - 1, H, W, tid, at);
  copy_window<RG, QG>(st + NG * 64, c1, tl.b, tl.oy0 - 1, tl.ox0 - 1, H, W, tid, at);
}

// This thread's pixels of the x window (pixel i is global (oy0 - 1 + i / QG,
// ox0 - 1 + i % QG)), zero outside the image: loaded into registers while
// the previous tile computes, and read only when stored (store_x), a tile
// later, so that no thread waits for them.
__device__ __forceinline__ void fetch_x(unsigned short (&xr)[XPX][CIN], const unsigned short* x, Tile tl, int H,
                                        int W, int tid) {
#pragma unroll
  for (int k = 0; k < XPX; ++k) {
    const int i = tid + k * THREADS, r = i / QG, q = i - r * QG;
    const int gy = tl.oy0 - 1 + r, gx = tl.ox0 - 1 + q;
    const bool in = i < NG && inside(gy, gx, H, W);
    const unsigned short* px = x + (in ? (((size_t)tl.b * H + gy) * W + gx) * CIN : 0);
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) xr[k][ci] = in ? __ldg(px + ci) : static_cast<unsigned short>(0);
  }
}

// The pixels of fetch_x into the x window, 4 channels a pixel (the 3 and a
// zero).
__device__ __forceinline__ void store_x(uint2* xs, const unsigned short (&xr)[XPX][CIN], int tid) {
#pragma unroll
  for (int k = 0; k < XPX; ++k)
    if (tid + k * THREADS < NG)
      xs[tid + k * THREADS] = make_uint2(xr[k][0] | (static_cast<uint32_t>(xr[k][1]) << 16), xr[k][2]);
}

// Row p (own position (p / TW, p % TW)) of dW1's B operand: x under it at the
// nine taps (one 8-B load each), column n = 3 tap + ci (27), then 1.0
// (column 27: db1 as a product), then zeros.
__device__ __forceinline__ void im2col(unsigned char* col, const uint2* xs, int p) {
  const int r = p / TW, q = p % TW;
  uint32_t v[28];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const uint2 u = xs[(r + tap / 3) * QG + q + tap % 3];
    v[3 * tap] = u.x & 0xffffu;
    v[3 * tap + 1] = u.x >> 16;
    v[3 * tap + 2] = u.y & 0xffffu;
  }
  v[27] = 0x3f80u;
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 14; ++k) w[k] = v[2 * k] | (v[2 * k + 1] << 16);
  w[14] = w[15] = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<uint4*>(col + sw(p, c)) = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
}

// dW2's B fragments of c1 window row R for channel chunk ic, at the three
// horizontal taps kx (window columns kx + position): kx 0 and 1 by one x4
// (matrices 2kx, 2kx + 1: positions 0-7, 8-15), kx 2 by an x2.
__device__ __forceinline__ void dw2_row(uint32_t (&br)[3][2], uint32_t c1w, int R, int ic, int lane) {
  const int j = lane >> 3, k = (lane & 7) + 8 * (j & 1);
  uint32_t t4[4];
  ldsm_t4(t4, c1w + sw(R * QG + k + (j >> 1), ic));
  br[0][0] = t4[0];
  br[0][1] = t4[1];
  br[1][0] = t4[2];
  br[1][1] = t4[3];
  ldsm_t2(br[2][0], br[2][1], c1w + sw(R * QG + k + 2, ic));
}

// dW2 of one tile for channel chunk ic, all o and taps: K = the tile's
// positions, own row s a k16 step. Own row s at tap (ky, kx) reads c1 window
// row s + ky, so the B fragments of a window row serve three k-steps: they
// rotate through b (the loop is unrolled, so the rotation is register
// renaming), and each step loads one new row. Where bias, db2's ones column
// on the k-steps s = ic mod 4.
__device__ __forceinline__ void dw2_tile(float (&acc)[ACC][4], float (&bsum)[2][4], uint32_t gz, uint32_t c1w,
                                         int ic, bool bias, int lane) {
  const int j = lane >> 3, r8 = lane & 7;
  uint32_t b[3][3][2];
  dw2_row(b[0], c1w, 0, ic, lane);
  dw2_row(b[1], c1w, 1, ic, lane);
#pragma unroll
  for (int s = 0; s < TH; ++s) {
    dw2_row(b[(s + 2) % 3], c1w, s + 2, ic, lane);
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldsm_t4(a[mt], gz + sw((s + 1) * QG + 1 + r8 + 8 * (j >> 1), 2 * mt + (j & 1)));
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma(acc[9 * mt + 3 * ky + kx], a[mt], b[(s + ky) % 3][kx][0], b[(s + ky) % 3][kx][1]);
    if (bias && (s & 3) == ic) {
      mma(bsum[0], a[0], ONES, ONES);
      mma(bsum[1], a[1], ONES, ONES);
    }
  }
}

// g1 = conv^T(gz2, W2) on own rows r0 .. r0 + 3 (four m16 tiles), as a
// correlation with the flipped taps (ky', kx'), which read the window at (r +
// ky', l + kx'). For each (kx', channel half h) the three taps' B fragments
// are loaded once, and each A fragment of window rows r0 .. r0 + 5 is loaded
// once and feeds every row it is a tap of. Masked by c1 > 0, rounded to bf16
// into the shared tile gz1s (and to gz1 in device memory when dx is asked).
__device__ __forceinline__ void g1_tile(float (&acc)[ACC][4], uint32_t gzw, const unsigned char* c1s,
                                        const uint4* wds, unsigned char* gz1s, __nv_bfloat16* gz1, Tile tl, int H,
                                        int W, int r0, int lane) {
  const int g = lane >> 2, tg = lane & 3, lrow = lane & 15, csel = lane >> 4;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;  // [4 r + nt]
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 bw[3][2];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int s = 2 * (3 * ky + kx) + h;
        bw[ky][0] = wds[(2 * s) * 32 + lane];
        bw[ky][1] = wds[(2 * s + 1) * 32 + lane];
      }
#pragma unroll
      for (int rr = 0; rr < 6; ++rr) {
        uint32_t a[4];
        ldsm_x4(a, gzw + sw((r0 + rr) * QG + lrow + kx, 2 * h + csel));
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
          if (rr - ky >= 0 && rr - ky < 4) {
            const int r = rr - ky;
            mma(acc[4 * r], a, bw[ky][0].x, bw[ky][0].y);
            mma(acc[4 * r + 1], a, bw[ky][0].z, bw[ky][0].w);
            mma(acc[4 * r + 2], a, bw[ky][1].x, bw[ky][1].y);
            mma(acc[4 * r + 3], a, bw[ky][1].z, bw[ky][1].w);
          }
      }
    }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int l = g + 8 * hh, p = (r0 + r) * TW + l, pc = (r0 + r + 1) * QG + l + 1;  // own; its c1 in the window
      const int y = tl.oy0 + r0 + r, x = tl.ox0 + l;
      uint32_t* dst = gz1 != nullptr && y < H && x < W
                          ? reinterpret_cast<uint32_t*>(gz1 + (((size_t)tl.b * H + y) * W + x) * C) + tg
                          : nullptr;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // c1 is zero outside the image, so gz1 is too
        const uint32_t v = mask2(pack(acc[4 * r + nt][2 * hh], acc[4 * r + nt][2 * hh + 1]),
                                 *reinterpret_cast<const uint32_t*>(c1s + sw(pc, nt) + 4 * tg));
        *reinterpret_cast<uint32_t*>(gz1s + sw(p, nt) + 4 * tg) = v;
        if (dst != nullptr) dst[4 * nt] = v;
      }
    }
}

// dW1 and db1 (column 27 of the im2col) over this warp's two k-steps, own rows
// 2 warp and 2 warp + 1: M = o (two m16 tiles), N = 32 columns (four n8
// tiles), A = gz1s and B = the im2col, both by ldmatrix .trans.
__device__ __forceinline__ void dw1_tile(float (&acc)[2][4][4], uint32_t gz1a, uint32_t cola, int warp, int lane) {
  const int j = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int s = 2 * warp + q;
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldsm_t4(a[mt], gz1a + sw(s * TW + r8 + 8 * (j >> 1), 2 * mt + (j & 1)));
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) ldsm_t4(b[pr], cola + sw(s * TW + r8 + 8 * (j & 1), 2 * pr + (j >> 1)));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        mma(acc[mt][2 * pr], a[mt], b[pr][0], b[pr][1]);
        mma(acc[mt][2 * pr + 1], a[mt], b[pr][2], b[pr][3]);
      }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
c2_pass(const __nv_bfloat16* __restrict__ gz2, const __nv_bfloat16* __restrict__ c1,
        const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wd2, __nv_bfloat16* __restrict__ gz1,
        float* __restrict__ part, int flags, int B, int H, int W) {
  const bool do_w2 = flags & 1, do_g1 = flags & 2, do_w1 = flags & 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned short* xg = reinterpret_cast<const unsigned short*>(x);
  uint2* xs = reinterpret_cast<uint2*>(smem + P2_X);
  const int tiles_x = (W + TW - 1) / TW;
  const long long per_img = (long long)tiles_x * ((H + TH - 1) / TH);
  const long long total = per_img * B;
  if (do_g1)
    for (int i = tid; i < WD_U4; i += THREADS) cp16(base + 16 * i, wd2 + i, true);
  unsigned short xr[XPX][CIN];
  long long t = blockIdx.x;
  if (t < total) {
    const Tile tl = tile_at<TH, TW>(t, per_img, tiles_x);
    p2_issue(base + P2_RING, gz2, c1, tl, H, W, tid);
    if (do_w1) fetch_x(xr, xg, tl, H, W, tid);
  }
  commit();
  float acc[ACC][4] = {}, bsum[2][4] = {}, acc1[2][4][4] = {};
  for (int i = 0; t < total; ++i, t += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(t, per_img, tiles_x);
    const long long tn = t + gridDim.x;
    if (do_w1) store_x(xs, xr, tid);  // the previous tile's im2col, which read xs, was built before the last barrier
    if (tn < total) {  // the next tile into the other stage, read last before the previous barrier
      const Tile nx = tile_at<TH, TW>(tn, per_img, tiles_x);
      p2_issue(base + P2_RING + ((i + 1) & 1) * P2_STAGE, gz2, c1, nx, H, W, tid);
      if (do_w1) fetch_x(xr, xg, nx, H, W, tid);
    }
    commit();
    wait_group<1>();
    __syncthreads();  // this tile's windows, W2 and xs visible to all
    const int so = P2_RING + (i & 1) * P2_STAGE;
    if (do_w1) im2col(smem + P2_COL, xs, tid);
    if (warp < 4) {
      if (do_w2) dw2_tile(acc, bsum, base + so, base + so + NG * 64, warp, true, lane);
    } else if (do_g1) {
      g1_tile(acc, base + so, smem + so + NG * 64, reinterpret_cast<const uint4*>(smem), smem + P2_GZ1, gz1, tl, H,
              W, 4 * (warp - 4), lane);
    }
    __syncthreads();  // gz1s and the im2col complete; this stage free for the next copies
    if (do_w1) dw1_tile(acc1, base + P2_GZ1, base + P2_COL, warp, lane);
  }
  if (part == nullptr) return;
  wait_group<0>();
  __syncthreads();  // the ring is free: dW1's per-warp partials go there
  float* dst = part + (size_t)blockIdx.x * PART2;
  float* red = reinterpret_cast<float*>(smem + P2_RING);  // [8][1024] dW1 | db1, then [4][32] db2
  if (warp < 4) {
    write_w(acc, dst, warp, lane);
    stash_bias(bsum, red + WARPS * 1024 + warp * C, lane);
  }
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp * 1024 + (16 * mt + g + 8 * (e >> 1)) * 32 + 8 * nt + 2 * tg + (e & 1)] = acc1[mt][nt][e];
  __syncthreads();
  for (int e = tid; e < 1024; e += THREADS) {  // the warps' partials in warp order
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * 1024 + e];
    const int o = e >> 5, n = e & 31;
    if (n < 9 * CIN) dst[NW + C + o * (CIN * 9) + (n % CIN) * 9 + n / CIN] = s;
    else if (n == 9 * CIN) dst[NW + C + NW1 + o] = s;
  }
  bias_out(red + WARPS * 1024, dst + NW, tid);
}

}  // namespace bf

// ===================== pass 3: dx = conv^T(gz1, W1) =====================
//
// Both dtypes, on the TF32 path of the float32 kernels (one product in
// bf16, whose values TF32 holds exactly); W1's fragments come in the
// activation dtype (kernels/trunk.py:prepare_bwd_weights) and are widened
// as they are read.

constexpr int P3_GZ1 = WD1_F2 * 8;
constexpr int P3_SMEM = P3_GZ1 + RG * QG * 128;

__device__ __forceinline__ float2 widen(float2 v) { return v; }

__device__ __forceinline__ float2 widen(__nv_bfloat162 v) { return __bfloat1622float2(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dx_kernel(const T* __restrict__ gz1, const void* __restrict__ wd1, T* __restrict__ dx, int B, int H, int W) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  using Pair = typename std::conditional<SPLIT, float2, __nv_bfloat162>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const Pair* wds = reinterpret_cast<const Pair*>(smem);
  unsigned char* gzs = smem + P3_GZ1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3, lrow = lane & 15;
  stage(smem, static_cast<const uint4*>(wd1), WD1_F2 * static_cast<int>(sizeof(Pair)) / 16, nullptr, 0, tid,
        THREADS);

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
        const float2 w = widen(wds[(4 * tap + h) * 32 + lane]);
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
  cudaError_t err;
  if constexpr (std::is_same<T, float>::value) {
    err = persistent_grid(bwd_c3_kernel, THREADS, P1_SMEM, tiles_of(B, Ho, Wo, TH3, TW3), out);
    if (err != cudaSuccess) return err;
    return persistent_grid(bwd_c2_kernel, THREADS, P2_SMEM, tiles_of(B, H, W, TH, TW), out + 1);
  } else {
    err = persistent_grid(bf::c3_pass, THREADS, bf::P1_SMEM, tiles_of(B, Ho, Wo, bf::TH3, bf::TW3), out);
    if (err != cudaSuccess) return err;
    return persistent_grid(bf::c2_pass, THREADS, bf::P2_SMEM, tiles_of(B, H, W, bf::TH, bf::TW), out + 1);
  }
}

// needs: 1 dx, 2 dW1 / db1, 4 dW2 / db2, 8 dW3 / db3. wd: [W1 | W2 | W3] in
// T (kernels/trunk.py:prepare_bwd_weights): W1's dx fragments (2,304
// values), then W2's and W3's dgrad fragments (9,216 values each).
template <typename T>
cudaError_t backward(int needs, const void* g3, const void* x, const void* c1, const void* c2, const void* c3,
                     const void* wd, void* gz2, void* gz1, float* part, int grid3, int grid2, float* dw3,
                     float* dw21, void* dx, int B, int H, int W, cudaStream_t s) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int round = F32 ? 0 : 1;
  const uint4* wd2 = reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(wd) + 2 * WD1_F2 * sizeof(T));
  const uint4* wd3 = wd2 + (F32 ? WD_U4 : bf::WD_U4);
  float* part2 = part + (size_t)grid3 * PART3;
  int want[2] = {0, 0};  // (and the kernels' shared-memory attribute set)
  cudaError_t err = grids<T>(B, H, W, want);
  if (err != cudaSuccess) return err;
  if (grid3 != want[0] || grid2 != want[1]) return cudaErrorInvalidValue;
  const bool lower = needs & 7;  // anything below c3
  const T* g3t = static_cast<const T*>(g3);
  const T* c3t = static_cast<const T*>(c3);
  const T* c2t = static_cast<const T*>(c2);
  T* gz2t = lower ? static_cast<T*>(gz2) : nullptr;
  float* part3 = (needs & 8) ? part : nullptr;
  if (needs & 15) {
    if constexpr (F32)
      bwd_c3_kernel<<<grid3, THREADS, P1_SMEM, s>>>(g3t, c3t, c2t, wd3, gz2t, part3, B, H, W, Ho, Wo);
    else
      bf::c3_pass<<<grid3, THREADS, bf::P1_SMEM, s>>>(g3t, c3t, c2t, wd3, gz2t, part3, B, H, W, Ho, Wo);
    if ((err = cudaGetLastError())) return err;
  }
  if ((needs & 8) && (err = reduce(part, grid3, PART3, dw3, round, s))) return err;
  if (lower) {
    const T* c1t = static_cast<const T*>(c1);
    const T* xt = static_cast<const T*>(x);
    T* gz1t = (needs & 1) ? static_cast<T*>(gz1) : nullptr;
    float* p2 = (needs & 6) ? part2 : nullptr;
    const int flags = ((needs & 4) ? 1 : 0) | ((needs & 3) ? 2 : 0) | ((needs & 2) ? 4 : 0);
    if constexpr (F32)
      bwd_c2_kernel<<<grid2, THREADS, P2_SMEM, s>>>(gz2t, c1t, xt, wd2, gz1t, p2, flags, B, H, W);
    else
      bf::c2_pass<<<grid2, THREADS, bf::P2_SMEM, s>>>(gz2t, c1t, xt, wd2, gz1t, p2, flags, B, H, W);
    if ((err = cudaGetLastError())) return err;
  }
  if ((needs & 6) && (err = reduce(part2, grid2, PART2, dw21, round, s))) return err;
  if (needs & 1) {
    err = launch_persistent(bwd_dx_kernel<T>, THREADS, P3_SMEM, tiles_of(B, H, W, TH, TW), s,
                            static_cast<const T*>(gz1), wd, static_cast<T*>(dx), B, H, W);
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
// the dgrad weight layout in dtype (kernels/trunk.py:prepare_bwd_weights,
// 20,736 values); gz2 [B, H, W, 32] scratch in dtype (needs & 7), gz1 the
// same (needs & 1); part the partials for the grids of dd_trunk_bwd_grids;
// dw3 [9,248] f32: dW3 (OIHW) | db3; dw21 [10,144] f32: dW2 | db2 | dW1 |
// db1 (bf16: each rounded to bf16 once); dx [B, H, W, 3] in dtype. The
// tensors' addresses are multiples of 16 B. Returns a cudaError_t.
extern "C" int dd_trunk_bwd(int dtype, int needs, const void* g3, const void* x, const void* c1, const void* c2,
                            const void* c3, const void* wd, void* gz2, void* gz1, float* part, int grid3,
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
