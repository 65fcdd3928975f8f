// Encoder conv trunk c1 -> c2 -> c3 in one kernel, for sm_90a.
//
// Replaces driving_dirty_tpu/pallas/trunk.py:fused_trunk (the Pallas TPU
// kernel), and through a stage switch the bisection variants of
// scripts/probe_trunk_variants.py. It computes, for NHWC input x [B, H, W, 3]:
//
//   c1 = relu(conv3x3(x,  w1, stride 1, pad 1) + b1)   [B, H,  W,  32]
//   c2 = relu(conv3x3(c1, w2, stride 1, pad 1) + b2)   [B, H,  W,  32]
//   c3 = relu(conv3x3(c2, w3, stride 2, pad 1) + b3)   [B, Ho, Wo, 32]
//
// with Ho = (H + 1) / 2 and Wo = (W + 1) / 2, for any H and W (odd sizes
// included). Only x and c3 touch device memory: c1 and c2 live in shared
// memory, one output tile at a time. c1 and c2 positions outside the image
// are stored as zero, not relu(bias): they are the next conv's zero padding.
//
// Two kernels, one per activation dtype, both implicit GEMMs on the tensor
// cores (mma.sync) over the same skeleton (a persistent grid of c3 tiles,
// weights staged once per CTA, the next tile's input loaded while the
// current one computes):
//
// * float32 (trunk_tf32_kernel): split TF32, "3xTF32" (see the float32
//   section below), which keeps f32 accuracy: one TF32 product alone
//   (about 2^-11 a product) would miss the f32 tolerance.
// * bfloat16 (trunk_tc_kernel): mma.sync.m16n8k16 (bf16 in, f32
//   accumulate); see the bfloat16 section below.
//
// Both take a template parameter STAGES, the first argument of the C entry
// dd_trunk: 3 is the trunk; 0, 1 and 2 stop after the input tile, c1 or
// c2 and write that stage at the c3 positions, (2oy, 2ox), as the stage
// bisection's variants (kernels/trunk.py:trunk_variant):
//   0: x at (2oy, 2ox), channel c holding x[..., c % 3]   (v0)
//   1: c1 at (2oy, 2ox)                                   (v1, v2)
//   2: c2 at (2oy, 2ox)                                   (v3, v4)
// Weights come prepared by kernels/trunk.py:prepare_weights: one buffer of
// the three weights as mma B-operand fragments in the activation dtype
// (the layouts are below); biases one f32 buffer [b1 | b2 | b3], rounded
// to the activation dtype.
//
// Bound on the H100 at the main path's [8, 256, 1836, 3]: 93.1 GFLOP
// against 82.7 MB of compulsory bf16 traffic (165 MB in f32): in bf16
// 94 us on the tensor cores (989 TFLOP/s) against 24.7 us of bytes; in f32
// three TF32 products per product, 279.3 GFLOP, 564 us at 495 TFLOP/s
// (1.39 ms for f32 FMAs on the CUDA cores at 67 TFLOP/s). Both are bound
// by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;    // trunk width, fixed by the architecture
constexpr int CIN = 3;   // input channels

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

constexpr int align128(int v) { return (v + 127) / 128 * 128; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// Copy nw 16-B words from w, then nb from b, into shared memory at smem
// with cp.async; the caller's next __syncthreads makes them visible.
__device__ __forceinline__ void stage(unsigned char* smem, const uint4* w, int nw, const uint4* b,
                                      int nb, int tid, int threads) {
  for (int i = tid; i < nw + nb; i += threads) {
    const uint4* src = i < nw ? w + i : b + (i - nw);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(smem + 16 * i)), "l"(src));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Tile {
  int b, oy0, ox0;
};

// Tile t of the persistent grid's walk over (image, tile row, tile column).
template <int TH, int TW>
__device__ __forceinline__ Tile tile_at(long long t, long long per_img, int tiles_x) {
  const int b = static_cast<int>(t / per_img);
  const int rem = static_cast<int>(t - b * per_img);
  return {b, (rem / tiles_x) * TH, (rem % tiles_x) * TW};
}

// Launch a persistent kernel: one CTA per tile, at most as many as fit on
// the card at once (the CTAs then walk over the tiles).
template <typename... P, typename... A>
cudaError_t launch_persistent(void (*kernel)(P...), int threads, int smem, long long tiles,
                              cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// ===================== float32: split TF32 on the tensor cores =====================
//
// Each conv is an implicit GEMM, out[M = positions][N = 32] = A[M][K] x
// B[K][32], on mma.sync.aligned.m16n8k8 with TF32 operands and f32
// accumulators, K over (tap, input channel) as in the bf16 kernel (c1's
// K = 27 padded with zero weights to 32). Every f32 operand v is split as
//   hi = v rounded to TF32, to nearest with ties away from zero (what
//        cvt.rna.tf32.f32 gives for a finite v), as (bits + 0x1000) & ~0x1fff,
//   lo = v - hi truncated to TF32 (& ~0x1fff: the bits the mma reads),
// and each k-step accumulates a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (three mma,
// the small products first). The dropped a_lo*b_lo (2^-22 of |a*b|) and
// the truncation of lo (2^-21) keep the sums over K <= 288 terms within a
// few 1e-6 of the largest output of an f32 conv (the tolerance is 2e-4).
// The two integer operations cost less than cvt.rna's instruction
// sequence, which made the kernel markedly slower on the H100.
// kernels/trunk.py:tf32_split is the same split in PyTorch, and
// tests/test_torch_port_trunk_tf32.py runs the whole trunk through it.
//
// A operand. c1 and c2 are stored [pixel][32 channels] f32, 128 B a pixel,
// with the eight 16-B chunks (4 channels each) of pixel p XOR-swizzled by
// p & 7 (sw() below). ldmatrix serves 32-bit elements: an .x4 of 8 x 8
// b16 gives lane (g, tg) the f32 at (row g, column tg) of each 8 x 4 block,
// which is the m16n8k8 TF32 A fragment when the four blocks are (rows 0-7,
// k 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7), (rows 8-15, k 4-7). So, as
// in bf16, a 3 x 3 tap is a shift of the row addresses, 8 consecutive
// pixels cover all 32 banks, and c2 is stored even columns first for c3's
// stride 2. Each A fragment is split once and feeds 4 n8 tiles x 3 mma.
// c1's A comes from the input tile, which is stored pre-split as (hi, lo)
// float2 pairs, with scalar loads (27 of the 32 K values are real).
//
// B operand. prepare_weights lays each f32 weight out in m16n8k8 fragment
// order, [k-step of 8][n-pair][lane][4 x f32] (b0, b1 of the pair's two n8
// tiles), one 16-B load per lane per two n8 tiles. The weights stay f32 in
// shared memory and are split as they are loaded, once per k-step for all
// the m16 tiles of a warp: hi/lo pairs would double their 77,824 B, and the
// budget below has no room for that.
//
// Tiling. A CTA of 12 warps owns a TH x TW = 6 x 16 tile of c3 (an 8 x 16
// tile, as in bf16, needs 253,824 B in f32, over the 232,448 B a CTA may
// use). Per tile:
//   input  17 x 37 x 3, split, zero outside the image, loaded into
//          registers while the previous tile computes;
//   c1     15 x 35 = 525 positions = 33 m16 tiles, 2-3 per warp (K 32: 4
//          k-steps, its B fragments split once per tile in registers);
//   c2     13 x 33 = 429 positions = 27 m16 tiles (36 k-steps): warps 0-2
//          take 3, warps 3-11 take 2, so the four SM sub-partitions (warp
//          % 4) get 7, 7, 7 and 6;
//   c3     6 rows of 16 = 6 m16 tiles x 2 halves of N: one (row, half) a
//          warp, written to device memory.
// Shared memory per CTA:
//   weights (f32 B fragments) 4,096 + 36,864 + 36,864 = 77,824 B
//   biases  96 f32                                    =    384 B
//   input   17 x 37 x 3 (hi, lo) f32                  = 15,096 B
//   c1      525 x 128 B                               = 67,200 B
//   c2      429 x 128 B                               = 54,912 B
//   total with 128-B alignment                        = 215,424 B of 227 KB
// The halo recompute makes 12% more c2 MACs than the bound counts. Per
// tile the warps run 11,664 c2 + 2,592 c3 + 1,584 c1 mma (three per
// product) and split every operand they load; c2 takes two thirds of the
// kernel's time (the stage bisection, PERF.md), bound by mma.sync's TF32
// rate and the split's integer and add instructions (wgmma is later work).

namespace tf {

constexpr int TH = 6, TW = 16;                   // c3 tile
constexpr int WARPS = 12, THREADS = 32 * WARPS;
constexpr int R2 = 2 * TH + 1, Q2 = 2 * TW + 1;  // c2 region 13 x 33
constexpr int R1 = 2 * TH + 3, Q1 = 2 * TW + 3;  // c1 region 15 x 35
constexpr int R0 = 2 * TH + 5, Q0 = 2 * TW + 5;  // input     17 x 37
constexpr int N1 = R1 * Q1, N2 = R2 * Q2;        // 525, 429 positions
constexpr int MT1 = (N1 + 15) / 16, MT2 = (N2 + 15) / 16, MT3 = TH;  // 33, 27, 6 m16 tiles
constexpr int W2A = 3, G2A = 3, G2B = 2;         // c2: warps < W2A take G2A m-tiles, the rest G2B
static_assert(TW == 16, "a c3 m16 tile is one row of the c3 tile");
static_assert(W2A * G2A + (WARPS - W2A) * G2B == MT2, "every c2 m-tile on one warp");
static_assert(2 * MT3 == WARPS, "one c3 (row, half of N) per warp");
constexpr int Q2E = (Q2 + 1) / 2;                // even c2 columns, stored first
constexpr int XN = R0 * Q0 * CIN;                // input tile elements
constexpr int XPT = (XN + THREADS - 1) / THREADS;
constexpr int KS1 = 4, KS = 36;                  // k8 steps of c1 and of c2, c3
constexpr int FRAG = 2 * 32;                     // uint4 per k-step: 2 n-pairs x 32 lanes
constexpr int W_U4 = (KS1 + 2 * KS) * FRAG;      // 4,864 uint4 = 77,824 B
constexpr int B_U4 = 3 * C * 4 / 16;             // biases, 24 uint4

constexpr int OFF_B = W_U4 * 16;
constexpr int OFF_X = align128(OFF_B + B_U4 * 16);
constexpr int OFF_C1 = align128(OFF_X + XN * 8);
constexpr int OFF_C2 = align128(OFF_C1 + N1 * 128);
constexpr int SMEM = OFF_C2 + N2 * 128;
static_assert(SMEM <= 232448, "shared memory of one CTA");

// Byte offset of 16-B channel chunk `chunk` (channels 4*chunk .. +3) of
// pixel p in a [pixel][32] f32 buffer, swizzled.
__device__ __forceinline__ int sw(int p, int chunk) {
  return (p << 7) | ((chunk ^ (p & 7)) << 4);
}

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent and 10 mantissa bits

// v = hi + lo to 2^-21 of |v|, both TF32 (the split above).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(v - __uint_as_float(hi)) & TF32_MASK;
}

// The B fragments of one k-step for two n8 tiles (b0, b1 of each), split.
struct BPair {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ BPair split_b(const uint4& w) {
  BPair f;
  split(__uint_as_float(w.x), f.hi[0], f.lo[0]);
  split(__uint_as_float(w.y), f.hi[1], f.lo[1]);
  split(__uint_as_float(w.z), f.hi[2], f.lo[2]);
  split(__uint_as_float(w.w), f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * (n8 tile t of the pair b), in three TF32 products.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const BPair& b, int t) {
  mma(d, al, b.hi[2 * t], b.hi[2 * t + 1]);
  mma(d, ah, b.lo[2 * t], b.lo[2 * t + 1]);
  mma(d, ah, b.hi[2 * t], b.hi[2 * t + 1]);
}

// All four n8 tiles: pair b0 holds n-tiles 0, 1 and pair b1 n-tiles 2, 3.
__device__ __forceinline__ void mma3_n32(float (&d)[4][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const BPair& b0, const BPair& b1) {
  mma3(d[0], ah, al, b0, 0);
  mma3(d[1], ah, al, b0, 1);
  mma3(d[2], ah, al, b1, 0);
  mma3(d[3], ah, al, b1, 1);
}

__device__ __forceinline__ void split_a(const uint32_t (&a)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(__uint_as_float(a[e]), ah[e], al[e]);
}

// Accumulators of NT n8 tiles (of 4) seeded with the bias from column n0:
// thread (g, tg) holds columns n0 + 8j + 2tg, +1 of rows g and g + 8.
template <int NT>
__device__ __forceinline__ void seed(float (&acc)[NT][4], const float* bias, int tg) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float lo = bias[8 * j + 2 * tg], hi = bias[8 * j + 2 * tg + 1];
    acc[j][0] = lo; acc[j][1] = hi; acc[j][2] = lo; acc[j][3] = hi;
  }
}

__device__ __forceinline__ float2 relu2(float a, float b) {
  return make_float2(fmaxf(a, 0.f), fmaxf(b, 0.f));
}

// Rows g + 8hh (hh = 0, 1) of one m16 x n32 accumulator block into pixel
// p of a [pixel][32] buffer: relu, or zero outside the image.
__device__ __forceinline__ void store_rows(unsigned char* dst, int p, const float (&acc)[4][4], int hh,
                                           bool in, int tg) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float2*>(dst + sw(p, 2 * j + (tg >> 1)) + 8 * (tg & 1)) =
        in ? relu2(acc[j][2 * hh], acc[j][2 * hh + 1]) : make_float2(0.f, 0.f);
}

// This thread's share of a tile's input (local (r, q) is global
// (2*oy0 - 3 + r, 2*ox0 - 3 + q)), zero outside the image.
__device__ __forceinline__ void fetch_input(float (&xr)[XPT], const float* x, Tile tl, int H, int W,
                                            int tid) {
  const float* xb = x + (size_t)tl.b * H * W * CIN;
  const int gy0 = 2 * tl.oy0 - 3, gx0 = 2 * tl.ox0 - 3;
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / (Q0 * CIN);
    const int rem = i - r * (Q0 * CIN);
    const int q = rem / CIN;
    const int gy = gy0 + r, gx = gx0 + q;
    xr[j] = (i < XN && inside(gy, gx, H, W)) ? __ldg(xb + ((size_t)gy * W + gx) * CIN + rem - q * CIN) : 0.f;
  }
}

// c1: local (r, q) is global (2*oy0 - 2 + r, 2*ox0 - 2 + q); pixel r*Q1 + q.
__device__ __forceinline__ void conv1(const float2* xs, const uint4* w1f, const float* bias,
                                      unsigned char* c1s, Tile tl, int H, int W, int warp, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  // The input offsets of this thread's two K indices in each k-step:
  // k = 8s + tg + 4e, k = (ky*3 + kx)*3 + ci; -1 for K's zero padding.
  int koff[KS1][2];
#pragma unroll
  for (int s = 0; s < KS1; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 8 * s + tg + 4 * e;
      koff[s][e] = k < 9 * CIN ? ((k / 9) * Q0 + (k / 3) % 3) * CIN + k % 3 : -1;
    }
  BPair bw[KS1][2];
#pragma unroll
  for (int s = 0; s < KS1; ++s) {
    bw[s][0] = split_b(w1f[(2 * s) * 32 + lane]);
    bw[s][1] = split_b(w1f[(2 * s + 1) * 32 + lane]);
  }
  for (int mt = warp; mt < MT1; mt += WARPS) {
    float acc[4][4];
    seed<4>(acc, bias, tg);
    int base[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = min(mt * 16 + g + 8 * hh, N1 - 1);
      base[hh] = ((row / Q1) * Q0 + row % Q1) * CIN;
    }
#pragma unroll
    for (int s = 0; s < KS1; ++s) {
      // a[e]: row g + 8(e & 1), k index e >> 1
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ko = koff[s][e >> 1];
        const float2 v = ko >= 0 ? xs[base[e & 1] + ko] : make_float2(0.f, 0.f);
        ah[e] = __float_as_uint(v.x);
        al[e] = __float_as_uint(v.y);
      }
      mma3_n32(acc, ah, al, bw[s][0], bw[s][1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = mt * 16 + g + 8 * hh;
      if (row >= N1) continue;
      const bool in = inside(2 * tl.oy0 - 2 + row / Q1, 2 * tl.ox0 - 2 + row % Q1, H, W);
      store_rows(c1s, row, acc, hh, in, tg);
    }
  }
}

// c2 on G m16 tiles from mt0: local (r, q) is global (2*oy0 - 1 + r,
// 2*ox0 - 1 + q); stored at pixel r*Q2 + (q even ? q/2 : Q2E + q/2).
template <int G>
__device__ __forceinline__ void conv2(uint32_t c1a, const uint4* w2f, const float* bias,
                                      unsigned char* c2s, Tile tl, int H, int W, int mt0, int lane) {
  const int g = lane >> 2, tg = lane & 3, csel = lane >> 4;
  int pix[G];  // c1 pixel under tap (0, 0) of this lane's ldmatrix row
#pragma unroll
  for (int m = 0; m < G; ++m) {
    const int row = min((mt0 + m) * 16 + (lane & 15), N2 - 1);
    pix[m] = (row / Q2) * Q1 + row % Q2;
  }
  float acc[G][4][4];
#pragma unroll
  for (int m = 0; m < G; ++m) seed<4>(acc[m], bias, tg);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3) * Q1 + tap % 3;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int s = 4 * tap + h;
      const BPair b0 = split_b(w2f[(2 * s) * 32 + lane]), b1 = split_b(w2f[(2 * s + 1) * 32 + lane]);
#pragma unroll
      for (int m = 0; m < G; ++m) {
        uint32_t a[4], ah[4], al[4];
        ldsm_x4(a, c1a + sw(pix[m] + toff, 2 * h + csel));
        split_a(a, ah, al);
        mma3_n32(acc[m], ah, al, b0, b1);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < G; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = (mt0 + m) * 16 + g + 8 * hh;
      if (row >= N2) continue;
      const int r = row / Q2, q = row % Q2;
      const bool in = inside(2 * tl.oy0 - 1 + r, 2 * tl.ox0 - 1 + q, H, W);
      store_rows(c2s, r * Q2 + ((q & 1) ? Q2E + (q >> 1) : (q >> 1)), acc[m], hh, in, tg);
    }
}

// c3: warp w computes c3 row w % TH (an m16 tile, its 16 rows the columns
// ox) for output channels 16 * (w / TH) .. +15.
__device__ __forceinline__ void conv3(uint32_t c2a, const uint4* w3f, const float* bias, float* out,
                                      Tile tl, int Ho, int Wo, int warp, int lane) {
  const int g = lane >> 2, tg = lane & 3, csel = lane >> 4, ox = lane & 15;
  const int oy = warp % MT3, nh = warp / MT3;
  float acc[2][4];
  seed<2>(acc, bias + 16 * nh, tg);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    // c2 column 2*ox + kx: even columns first, odd after them
    const int p = (2 * oy + ky) * Q2 + (kx == 1 ? Q2E + ox : ox + (kx >> 1));
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const BPair b = split_b(w3f[(2 * (4 * tap + h) + nh) * 32 + lane]);
      uint32_t a[4], ah[4], al[4];
      ldsm_x4(a, c2a + sw(p, 2 * h + csel));
      split_a(a, ah, al);
      mma3(acc[0], ah, al, b, 0);
      mma3(acc[1], ah, al, b, 1);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int gy = tl.oy0 + oy, gx = tl.ox0 + g + 8 * hh;
    if (gy >= Ho || gx >= Wo) continue;
    float* dst = out + (((size_t)tl.b * Ho + gy) * Wo + gx) * C + 16 * nh + 2 * tg;
#pragma unroll
    for (int t = 0; t < 2; ++t)
      *reinterpret_cast<float2*>(dst + 8 * t) = relu2(acc[t][2 * hh], acc[t][2 * hh + 1]);
  }
}

// A bisection variant's output: stage STAGES (0 input, 1 c1, 2 c2) at
// (2oy, 2ox) for every c3 position of the tile, 16 B a thread.
template <int STAGES>
__device__ __forceinline__ void store_stage(const float2* xs, const unsigned char* c1s,
                                            const unsigned char* c2s, float* out, Tile tl, int Ho,
                                            int Wo, int tid) {
  for (int i = tid; i < TH * TW * 8; i += THREADS) {
    const int pos = i >> 3, c = i & 7, oy = pos / TW, ox = pos % TW;
    const int gy = tl.oy0 + oy, gx = tl.ox0 + ox;
    if (gy >= Ho || gx >= Wo) continue;
    float4 v;
    if constexpr (STAGES == 0) {
      const float2* p = xs + ((2 * oy + 3) * Q0 + 2 * ox + 3) * CIN;
      float u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 hl = p[(4 * c + k) % CIN];
        u[k] = hl.x + hl.y;
      }
      v = make_float4(u[0], u[1], u[2], u[3]);
    } else if constexpr (STAGES == 1) {
      v = *reinterpret_cast<const float4*>(c1s + sw((2 * oy + 2) * Q1 + 2 * ox + 2, c));
    } else {
      v = *reinterpret_cast<const float4*>(c2s + sw((2 * oy + 1) * Q2 + Q2E + ox, c));
    }
    *reinterpret_cast<float4*>(out + (((size_t)tl.b * Ho + gy) * Wo + gx) * C + 4 * c) = v;
  }
}

// The bisection instantiations (STAGES < 3) return before the later stages,
// which nvcc may report as unreachable (diagnostic 128).
#pragma nv_diag_suppress 128
template <int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
trunk_tf32_kernel(const float* __restrict__ x, const uint4* __restrict__ wfrag,
                  const uint4* __restrict__ bias, float* __restrict__ out,
                  int B, int H, int W, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* w1f = reinterpret_cast<const uint4*>(smem);
  const uint4* w2f = w1f + KS1 * FRAG;
  const uint4* w3f = w2f + KS * FRAG;
  const float* bs = reinterpret_cast<const float*>(smem + OFF_B);
  float2* xs = reinterpret_cast<float2*>(smem + OFF_X);
  unsigned char* c1s = smem + OFF_C1;
  unsigned char* c2s = smem + OFF_C2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  static_assert(OFF_B == 16 * W_U4, "biases right after the weights");
  stage(smem, wfrag, W_U4, bias, B_U4, tid, THREADS);

  const int tiles_x = (Wo + TW - 1) / TW;
  const long long per_img = (long long)tiles_x * ((Ho + TH - 1) / TH);
  const long long total = per_img * B;
  float xr[XPT];
  long long t = blockIdx.x;
  if (t < total) fetch_input(xr, x, tile_at<TH, TW>(t, per_img, tiles_x), H, W, tid);
  for (; t < total; t += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(t, per_img, tiles_x);
#pragma unroll
    for (int j = 0; j < XPT; ++j)
      if (tid + j * THREADS < XN) {
        uint32_t hi, lo;
        split(xr[j], hi, lo);
        xs[tid + j * THREADS] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
      }
    // The next tile's input loads fly while this tile computes.
    if (t + gridDim.x < total) fetch_input(xr, x, tile_at<TH, TW>(t + gridDim.x, per_img, tiles_x), H, W, tid);
    __syncthreads();  // input (and, first time, the weights) in shared memory
    if constexpr (STAGES == 0) {
      store_stage<0>(xs, c1s, c2s, out, tl, Ho, Wo, tid);
      __syncthreads();  // the next tile overwrites xs
      continue;
    }
    conv1(xs, w1f, bs, c1s, tl, H, W, warp, lane);
    __syncthreads();
    if constexpr (STAGES == 1) {
      store_stage<1>(xs, c1s, c2s, out, tl, Ho, Wo, tid);
      continue;
    }
    if (warp < W2A)
      conv2<G2A>(smem_addr(c1s), w2f, bs + C, c2s, tl, H, W, warp * G2A, lane);
    else
      conv2<G2B>(smem_addr(c1s), w2f, bs + C, c2s, tl, H, W, W2A * G2A + (warp - W2A) * G2B, lane);
    __syncthreads();
    if constexpr (STAGES == 2) {
      store_stage<2>(xs, c1s, c2s, out, tl, Ho, Wo, tid);
      continue;
    }
    conv3(smem_addr(c2s), w3f, bs + 2 * C, out, tl, Ho, Wo, warp, lane);
  }
}

template <int STAGES>
cudaError_t launch(const void* x, const void* weights, const void* biases, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long tiles = (long long)((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH) * B;
  return launch_persistent(trunk_tf32_kernel<STAGES>, THREADS, SMEM, tiles, stream,
                           static_cast<const float*>(x), static_cast<const uint4*>(weights),
                           static_cast<const uint4*>(biases), static_cast<float*>(out), B, H, W, Ho, Wo);
}

}  // namespace tf

// ===================== bfloat16: tensor cores =====================
//
// Each conv is an implicit GEMM, out[M = positions][N = 32] = A[M][K] x
// B[K][32], on mma.sync.aligned.m16n8k16 (bf16 A and B, f32 accumulators).
// K runs over (tap, input channel): K = 9 x 32 = 288 for c2 and c3, and
// 9 x 3 = 27 for c1, padded with zero weights to 32. The epilogue adds the
// bias (it seeds the accumulators), applies ReLU, zeroes positions outside
// the image and rounds to bf16 into shared memory (c1, c2) or device
// memory (c3): the same roundings as the bf16 reference.
//
// A operand. c1 and c2 are stored [pixel][32 channels] bf16, 64 B a pixel,
// with the four 16-B channel chunks of pixel p XOR-swizzled by (p >> 1) & 3
// (sw() below). An A fragment (16 positions x 16 channels of one tap) is
// one ldmatrix.x4 whose 32 lanes each give the address of one 16-B row:
// position m's pixel plus the tap's offset, so a 3 x 3 tap is a shift of
// those addresses and no im2col buffer exists. 8 consecutive pixels cover
// all 32 banks under the swizzle. c3 reads c2 at stride 2; c2 is stored
// with its even columns first and its odd columns after them, so those
// reads are consecutive pixels too. c1's A fragments are gathered from the
// 3-channel input tile with scalar loads (27 of the 32 K values are real).
//
// B operand. prepare_weights lays each weight out in mma fragment order,
// [k-step of 16][n-pair][lane][4 x u32]: one 16-B load per lane gives the
// B fragments of two n8 tiles, 512 contiguous bytes a warp. Each CTA
// stages all three (38,912 B) and the biases in shared memory once, with
// cp.async, and keeps them for every tile it computes.
//
// Tiling. A CTA of 12 warps (384 threads) owns a TH x TW = 8 x 16 tile of
// c3 at a time; the grid is persistent (one CTA per SM, as many as the
// tiles need) and walks over (image, tile row, tile column) in order, so
// neighbouring CTAs share their halo rows in L2. Per tile:
//   input  21 x 37 x 3 (zero outside the image), loaded into registers
//          while the previous tile computes, stored to shared memory;
//   c1     19 x 35 = 665 positions = 42 m16 tiles, 21 units of 2 m-tiles
//          on the 12 warps (K = 32: 2 k-steps);
//   c2     17 x 33 = 561 positions = 36 m16 tiles, 3 per warp (18 k-steps);
//   c3     8 rows of 16 = 8 m16 tiles, 2 per warp on warps 0-3, written
//          to device memory.
// Three __syncthreads a tile (input ready, c1 ready, c2 ready). Shared
// memory per CTA:
//   weights (B fragments)   2,048 + 18,432 + 18,432 = 38,912 B
//   biases  96 f32                                  =    384 B
//   input   21 x 37 x 3 bf16                        =  4,662 B
//   c1      665 x 64 B                              = 42,560 B
//   c2      561 x 64 B                              = 35,904 B
//   total with 128-B alignment                      = 122,560 B of 227 KB
// The halo recompute makes 11% more MACs than the bound counts (13% with
// c1's K padding and the partial last m-tiles). Per tile the warps run
// 2,592 c2 + 576 c3 + 336 c1 mma and 648 + 144 ldmatrix.x4: each 512-B A
// fragment feeds only four mma (N = 32), so shared-memory traffic, the
// barriers and mma.sync's instruction rate limit the kernel, not the tensor
// cores' peak (wgmma is later work).

namespace tc {

constexpr int TH = 8, TW = 16;                   // c3 tile
constexpr int WARPS = 12, THREADS = 32 * WARPS;
constexpr int R2 = 2 * TH + 1, Q2 = 2 * TW + 1;  // c2 region 17 x 33
constexpr int R1 = 2 * TH + 3, Q1 = 2 * TW + 3;  // c1 region 19 x 35
constexpr int R0 = 2 * TH + 5, Q0 = 2 * TW + 5;  // input     21 x 37
constexpr int N1 = R1 * Q1, N2 = R2 * Q2;        // 665, 561 positions
constexpr int MT1 = (N1 + 15) / 16, MT2 = (N2 + 15) / 16, MT3 = TH;  // m16 tiles
constexpr int G1 = 2, G2 = MT2 / WARPS, G3 = 2;  // m16 tiles per warp unit
static_assert(TW == 16, "a c3 m16 tile is one row of the c3 tile");
static_assert(MT1 % G1 == 0 && MT2 % WARPS == 0 && MT3 % G3 == 0, "whole units");
static_assert(MT3 / G3 <= WARPS, "one c3 unit per warp");
constexpr int Q2E = (Q2 + 1) / 2;                // even c2 columns, stored first
constexpr int XN = R0 * Q0 * CIN;                // input tile elements
constexpr int XPT = (XN + THREADS - 1) / THREADS;
constexpr int KS1 = 2, KS = 18;                  // k16 steps of c1 and of c2, c3
constexpr int FRAG = 2 * 32;                     // uint4 per k-step: 2 n-pairs x 32 lanes
constexpr int W_U4 = (KS1 + 2 * KS) * FRAG;      // 2,432 uint4 = 38,912 B
constexpr int B_U4 = 3 * C * 4 / 16;             // biases, 24 uint4

constexpr int OFF_B = W_U4 * 16;
constexpr int OFF_X = align128(OFF_B + B_U4 * 16);
constexpr int OFF_C1 = align128(OFF_X + XN * 2);
constexpr int OFF_C2 = align128(OFF_C1 + N1 * 64);
constexpr int SMEM = OFF_C2 + N2 * 64;

// Byte offset of 16-B channel chunk `chunk` (channels 8*chunk .. +7) of
// pixel p in a [pixel][32] bf16 buffer, swizzled.
__device__ __forceinline__ int sw(int p, int chunk) {
  return (p << 6) | ((chunk ^ ((p >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// All four n8 tiles of one k-step: B fragments of n-tiles 0,1 in bl and
// 2,3 in bh.
__device__ __forceinline__ void mma_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                        const uint4& bl, const uint4& bh) {
  mma(d[0], a, bl.x, bl.y);
  mma(d[1], a, bl.z, bl.w);
  mma(d[2], a, bh.x, bh.y);
  mma(d[3], a, bh.z, bh.w);
}

// Accumulators of G m16 tiles seeded with the bias: thread (g, tg) holds
// columns 8j + 2tg, +1 of rows g and g + 8.
template <int G>
__device__ __forceinline__ void seed(float (&acc)[G][4][4], const float* bias, int tg) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = bias[8 * j + 2 * tg], hi = bias[8 * j + 2 * tg + 1];
#pragma unroll
    for (int m = 0; m < G; ++m) {
      acc[m][j][0] = lo; acc[m][j][1] = hi; acc[m][j][2] = lo; acc[m][j][3] = hi;
    }
  }
}

// This thread's share of a tile's input (local (r, q) is global
// (2*oy0 - 3 + r, 2*ox0 - 3 + q)), zero outside the image.
__device__ __forceinline__ void fetch_input(unsigned short (&xr)[XPT], const unsigned short* x,
                                            Tile tl, int H, int W, int tid) {
  const unsigned short* xb = x + (size_t)tl.b * H * W * CIN;
  const int gy0 = 2 * tl.oy0 - 3, gx0 = 2 * tl.ox0 - 3;
#pragma unroll
  for (int j = 0; j < XPT; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / (Q0 * CIN);
    const int rem = i - r * (Q0 * CIN);
    const int q = rem / CIN;
    const int gy = gy0 + r, gx = gx0 + q;
    xr[j] = (i < XN && inside(gy, gx, H, W)) ? __ldg(xb + ((size_t)gy * W + gx) * CIN + rem - q * CIN) : 0;
  }
}

// c1: local (r, q) is global (2*oy0 - 2 + r, 2*ox0 - 2 + q); pixel r*Q1 + q.
__device__ __forceinline__ void conv1(const unsigned short* xs, const uint4* w1f, const float* bias,
                                      unsigned char* c1s, Tile tl, int H, int W, int warp, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  // The 8 K indices this thread's A fragments hold over both k-steps:
  // e -> k = 8*(e >> 1) + 2*tg + (e & 1), k = (ky*3 + kx)*3 + ci.
  int koff[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = 8 * (e >> 1) + 2 * tg + (e & 1);
    koff[e] = k < 9 * CIN ? ((k / 9) * Q0 + (k / 3) % 3) * CIN + k % 3 : -1;
  }
  uint4 bw[KS1][2];
#pragma unroll
  for (int s = 0; s < KS1; ++s) {
    bw[s][0] = w1f[(2 * s) * 32 + lane];
    bw[s][1] = w1f[(2 * s + 1) * 32 + lane];
  }
  auto ld2 = [&](int base, int ka, int kb) -> uint32_t {
    const uint32_t lo = ka >= 0 ? xs[base + ka] : 0u;
    const uint32_t hi = kb >= 0 ? xs[base + kb] : 0u;
    return lo | (hi << 16);
  };
  for (int u = warp; u < MT1 / G1; u += WARPS) {
    float acc[G1][4][4];
    seed<G1>(acc, bias, tg);
    int base[G1][2];
#pragma unroll
    for (int m = 0; m < G1; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = min((u * G1 + m) * 16 + g + 8 * hh, N1 - 1);
        base[m][hh] = ((row / Q1) * Q0 + row % Q1) * CIN;
      }
#pragma unroll
    for (int s = 0; s < KS1; ++s)
#pragma unroll
      for (int m = 0; m < G1; ++m) {
        uint32_t a[4];
        a[0] = ld2(base[m][0], koff[4 * s], koff[4 * s + 1]);
        a[1] = ld2(base[m][1], koff[4 * s], koff[4 * s + 1]);
        a[2] = ld2(base[m][0], koff[4 * s + 2], koff[4 * s + 3]);
        a[3] = ld2(base[m][1], koff[4 * s + 2], koff[4 * s + 3]);
        mma_n32(acc[m], a, bw[s][0], bw[s][1]);
      }
#pragma unroll
    for (int m = 0; m < G1; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = (u * G1 + m) * 16 + g + 8 * hh;
        if (row >= N1) continue;
        const bool in = inside(2 * tl.oy0 - 2 + row / Q1, 2 * tl.ox0 - 2 + row % Q1, H, W);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(c1s + sw(row, j) + 4 * tg) =
              in ? pack_relu(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]) : 0u;
      }
  }
}

// c2: local (r, q) is global (2*oy0 - 1 + r, 2*ox0 - 1 + q); stored at
// pixel r*Q2 + (q even ? q/2 : Q2E + q/2).
__device__ __forceinline__ void conv2(uint32_t c1a, const uint4* w2f, const float* bias,
                                      unsigned char* c2s, Tile tl, int H, int W, int warp, int lane) {
  const int g = lane >> 2, tg = lane & 3, csel = lane >> 4;
  const int mt0 = warp * G2;
  int pix[G2];  // c1 pixel under tap (0, 0) of this lane's ldmatrix row
#pragma unroll
  for (int m = 0; m < G2; ++m) {
    const int row = min((mt0 + m) * 16 + (lane & 15), N2 - 1);
    pix[m] = (row / Q2) * Q1 + row % Q2;
  }
  float acc[G2][4][4];
  seed<G2>(acc, bias, tg);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3) * Q1 + tap % 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * tap + h;
      const uint4 bl = w2f[(2 * s) * 32 + lane], bh = w2f[(2 * s + 1) * 32 + lane];
#pragma unroll
      for (int m = 0; m < G2; ++m) {
        uint32_t a[4];
        ldsm_x4(a, c1a + sw(pix[m] + toff, 2 * h + csel));
        mma_n32(acc[m], a, bl, bh);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < G2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = (mt0 + m) * 16 + g + 8 * hh;
      if (row >= N2) continue;
      const int r = row / Q2, q = row % Q2;
      const bool in = inside(2 * tl.oy0 - 1 + r, 2 * tl.ox0 - 1 + q, H, W);
      const int p = r * Q2 + ((q & 1) ? Q2E + (q >> 1) : (q >> 1));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(c2s + sw(p, j) + 4 * tg) =
            in ? pack_relu(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]) : 0u;
    }
}

// c3: m16 tile oy is row oy of the c3 tile, its 16 rows the columns ox.
__device__ __forceinline__ void conv3(uint32_t c2a, const uint4* w3f, const float* bias,
                                      __nv_bfloat16* out, Tile tl, int Ho, int Wo, int warp, int lane) {
  if (warp >= MT3 / G3) return;
  const int g = lane >> 2, tg = lane & 3, csel = lane >> 4, ox = lane & 15;
  const int oy0 = warp * G3;
  float acc[G3][4][4];
  seed<G3>(acc, bias, tg);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    // c2 column 2*ox + kx: even columns first, odd after them
    const int col = kx == 1 ? Q2E + ox : ox + (kx >> 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * tap + h;
      const uint4 bl = w3f[(2 * s) * 32 + lane], bh = w3f[(2 * s + 1) * 32 + lane];
#pragma unroll
      for (int m = 0; m < G3; ++m) {
        uint32_t a[4];
        ldsm_x4(a, c2a + sw((2 * (oy0 + m) + ky) * Q2 + col, 2 * h + csel));
        mma_n32(acc[m], a, bl, bh);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < G3; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gy = tl.oy0 + oy0 + m, gx = tl.ox0 + g + 8 * hh;
      if (gy >= Ho || gx >= Wo) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + (((size_t)tl.b * Ho + gy) * Wo + gx) * C + 2 * tg);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[4 * j] = pack_relu(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
    }
}

// A bisection variant's output: stage STAGES (0 input, 1 c1, 2 c2) at
// (2oy, 2ox) for every c3 position of the tile, 16 B a thread.
template <int STAGES>
__device__ __forceinline__ void store_stage(const unsigned short* xs, const unsigned char* c1s,
                                            const unsigned char* c2s, __nv_bfloat16* out, Tile tl,
                                            int Ho, int Wo, int tid) {
  for (int i = tid; i < TH * TW * 4; i += THREADS) {
    const int pos = i >> 2, c = i & 3, oy = pos / TW, ox = pos % TW;
    const int gy = tl.oy0 + oy, gx = tl.ox0 + ox;
    if (gy >= Ho || gx >= Wo) continue;
    uint4 v;
    if constexpr (STAGES == 0) {
      const unsigned short* p = xs + ((2 * oy + 3) * Q0 + 2 * ox + 3) * CIN;
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = 8 * c + 2 * k;
        w[k] = p[ch % CIN] | (static_cast<uint32_t>(p[(ch + 1) % CIN]) << 16);
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (STAGES == 1) {
      v = *reinterpret_cast<const uint4*>(c1s + sw((2 * oy + 2) * Q1 + 2 * ox + 2, c));
    } else {
      v = *reinterpret_cast<const uint4*>(c2s + sw((2 * oy + 1) * Q2 + Q2E + ox, c));
    }
    *reinterpret_cast<uint4*>(out + (((size_t)tl.b * Ho + gy) * Wo + gx) * C + 8 * c) = v;
  }
}

template <int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
trunk_tc_kernel(const unsigned short* __restrict__ x, const uint4* __restrict__ wfrag,
                const uint4* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                int B, int H, int W, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* w1f = reinterpret_cast<const uint4*>(smem);
  const uint4* w2f = w1f + KS1 * FRAG;
  const uint4* w3f = w2f + KS * FRAG;
  const float* bs = reinterpret_cast<const float*>(smem + OFF_B);
  unsigned short* xs = reinterpret_cast<unsigned short*>(smem + OFF_X);
  unsigned char* c1s = smem + OFF_C1;
  unsigned char* c2s = smem + OFF_C2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Weights and biases, once per CTA (the biases follow the weights).
  static_assert(OFF_B == 16 * W_U4, "biases right after the weights");
  stage(smem, wfrag, W_U4, bias, B_U4, tid, THREADS);

  const int tiles_x = (Wo + TW - 1) / TW;
  const long long per_img = (long long)tiles_x * ((Ho + TH - 1) / TH);
  const long long total = per_img * B;
  unsigned short xr[XPT];
  long long t = blockIdx.x;
  if (t < total) fetch_input(xr, x, tile_at<TH, TW>(t, per_img, tiles_x), H, W, tid);
  for (; t < total; t += gridDim.x) {
    const Tile tl = tile_at<TH, TW>(t, per_img, tiles_x);
#pragma unroll
    for (int j = 0; j < XPT; ++j)
      if (tid + j * THREADS < XN) xs[tid + j * THREADS] = xr[j];
    // The next tile's input loads fly while this tile computes.
    if (t + gridDim.x < total) fetch_input(xr, x, tile_at<TH, TW>(t + gridDim.x, per_img, tiles_x), H, W, tid);
    __syncthreads();  // input (and, first time, the weights) in shared memory
    if constexpr (STAGES == 0) {
      store_stage<0>(xs, c1s, c2s, out, tl, Ho, Wo, tid);
      __syncthreads();  // the next tile overwrites xs
      continue;
    }
    conv1(xs, w1f, bs, c1s, tl, H, W, warp, lane);
    __syncthreads();
    if constexpr (STAGES == 1) {
      store_stage<1>(xs, c1s, c2s, out, tl, Ho, Wo, tid);
      continue;
    }
    conv2(smem_addr(c1s), w2f, bs + C, c2s, tl, H, W, warp, lane);
    __syncthreads();
    if constexpr (STAGES == 2) {
      store_stage<2>(xs, c1s, c2s, out, tl, Ho, Wo, tid);
      continue;
    }
    conv3(smem_addr(c2s), w3f, bs + 2 * C, out, tl, Ho, Wo, warp, lane);
  }
}

template <int STAGES>
cudaError_t launch(const void* x, const void* weights, const void* biases, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long tiles = (long long)((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH) * B;
  return launch_persistent(trunk_tc_kernel<STAGES>, THREADS, SMEM, tiles, stream,
                           static_cast<const unsigned short*>(x), static_cast<const uint4*>(weights),
                           static_cast<const uint4*>(biases), static_cast<__nv_bfloat16*>(out), B, H, W,
                           Ho, Wo);
}

}  // namespace tc

template <int STAGES>
cudaError_t dispatch(int dtype, const void* x, const void* weights, const void* biases, void* out,
                     int B, int H, int W, cudaStream_t s) {
  if (dtype == 0) return tf::launch<STAGES>(x, weights, biases, out, B, H, W, s);
  if (dtype == 1) return tc::launch<STAGES>(x, weights, biases, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The C entry for ctypes. stages 3 is the trunk (kernels/trunk.py:trunk);
// 0 (input), 1 (c1) and 2 (c2) are the stage bisection, written at
// (2oy, 2ox). dtype 0 = float32 (split TF32), 1 = bfloat16, both on the
// tensor cores, for x and out; weights and biases as prepare_weights lays
// them out for that dtype. Returns a cudaError_t.
extern "C" int dd_trunk(int stages, int dtype, const void* x, const void* weights,
                        const void* biases, void* out, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 0: return (int)dispatch<0>(dtype, x, weights, biases, out, B, H, W, s);
    case 1: return (int)dispatch<1>(dtype, x, weights, biases, out, B, H, W, s);
    case 2: return (int)dispatch<2>(dtype, x, weights, biases, out, B, H, W, s);
    case 3: return (int)dispatch<3>(dtype, x, weights, biases, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
