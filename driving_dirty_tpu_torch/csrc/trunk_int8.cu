// B1-int8: the encoder conv trunk c1 -> c2 -> c3 in static-scale int8, in
// one kernel, for sm_90a.
//
// Replaces the XLA int8 convs of driving_dirty_tpu/ops/quant.py:
// encoder_convs_int8 with static scales (the JAX package's precision 8; it
// has no Pallas kernel). For NHWC bf16 x [B, H, W, 3] and static activation
// scales s1, s2, s3 it computes, as kernels/trunk_int8.py:trunk_int8_plain
// (ops/quant.py) does, one operation at a time:
//
//   q0 = clamp(rn(f32(x) * s1), -127, 127)                          int8
//   a1 = bf16(relu(f32(acc1) * comb1 + b1)), acc1 = conv(q0, w1q)   acc int32
//   q1 = clamp(rn(f32(a1) * s2), -127, 127)                         int8
//   a2 = bf16(relu(f32(acc2) * comb2 + b2)), acc2 = conv(q1, w2q)
//   q2 = clamp(rn(f32(a2) * s3), -127, 127)
//   c3 = bf16(relu(f32(acc3) * comb3 + b3)), acc3 = conv(q2, w3q, stride 2)
//
// with 3x3 convs, padding 1, c3 [B, Ho, Wo, 32], Ho = (H + 1) / 2, Wo = (W +
// 1) / 2, any H and W. rn is round to nearest even (__float2int_rn, as
// torch.round); comb_l[o] = f32(1/s_l) * w_inv_l[o] and the per-channel int8
// weights come prepared from the wrapper (the plain version's own values).
// Every float step is an _rn intrinsic, so nvcc contracts nothing into an
// fma, and the int32 sums are exact: the kernel equals the plain version
// bit for bit. Only x and c3 touch device memory: q1 and q2 live in shared
// memory as int8, one tile at a time; positions outside the image are
// stored as 0 (the next conv's zero padding).
//
// Products: each conv is an implicit GEMM, out[M = positions][N = 32] =
// A[M][K] x B[K][32], on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
// One 3 x 3 tap of c2 or c3 has 32 int8 input channels: exactly one k-step
// (K = 9 x 32 = 288, nine k-steps). c1's 27 products pad with zero weights
// to one k-step.
//
// A operand. q1 and q2 are stored [pixel][32 channels] int8, 32 B a pixel,
// its two 16-B chunks XOR-swizzled by (p >> 2) & 1 (sw() below), so that 8
// consecutive pixels cover all 32 banks. An m16n8k32 s8 A fragment is the
// same bytes as an m16n8k16 bf16 one (16 rows x 32 B; lane (g, tg) holds
// bytes 4tg..4tg+3 of rows g and g + 8, then of bytes 16 + 4tg..), so, as in
// the bf16 B1 (csrc/trunk.cu), one ldmatrix.x4 of the 16 row addresses
// (position m's pixel plus the tap's offset) loads it, and q2 is stored
// with its even columns first for c3's stride 2. c1's A fragments are
// gathered from the int8 input tile with byte loads.
//
// B operand. kernels/trunk_int8.py:int8_fragments lays each weight out in
// fragment order, [k-step][n-pair][lane][16 B] (b0, b1 of the pair's two n8
// tiles); each CTA stages all three (19,456 B) and the epilogue constants
// (768 B) in shared memory once, with cp.async.
//
// Tiling: that of the bf16 B1. A CTA of 12 warps owns an 8 x 16 tile of c3
// at a time, in a persistent grid over (image, tile row, tile column).
// Per tile:
//   input  21 x 37 x 3 bf16, loaded into registers while the previous tile
//          computes, quantized by s1 as it is stored to shared memory;
//   c1     19 x 35 = 665 positions = 42 m16 tiles, 21 units of 2 (1 k-step);
//   c2     17 x 33 = 561 positions = 36 m16 tiles, 3 per warp (9 k-steps);
//   c3     8 rows of 16 = 8 m16 tiles, 2 per warp on warps 0-3.
// Shared memory per CTA:
//   weights (B fragments)  1,024 + 9,216 + 9,216 = 19,456 B
//   epilogue [comb | bias] 192 f32               =    768 B
//   input  21 x 37 x 3 int8                      =  2,331 B
//   q1     665 x 32 B                            = 21,280 B
//   q2     561 x 32 B                            = 17,952 B
//   total with 128-B alignment                   = 61,952 B
// Per tile the warps run 1,296 c2 + 288 c3 + 168 c1 mma and an epilogue of
// about ten instructions for each of 43,808 values (q1, q2, c3).
//
// Bound on the H100 at the main path's [8, 256, 1836, 3]: 46.6 G products,
// 93.1 GOP, 47 us at 1,979 TOPS int8 dense, against 82.7 MB of bf16 input
// and output (24.7 us at 3.35 TB/s): bound by operations. mma.sync reaches
// a fraction of the dense rate, and the epilogue's instructions are of the
// same order as the products (wgmma and a leaner epilogue are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;    // trunk width, fixed by the architecture
constexpr int CIN = 3;   // input channels
constexpr int QMAX = 127;

constexpr int TH = 8, TW = 16;                   // c3 tile
constexpr int WARPS = 12, THREADS = 32 * WARPS;
constexpr int R2 = 2 * TH + 1, Q2 = 2 * TW + 1;  // q2 region 17 x 33
constexpr int R1 = 2 * TH + 3, Q1 = 2 * TW + 3;  // q1 region 19 x 35
constexpr int R0 = 2 * TH + 5, Q0 = 2 * TW + 5;  // input     21 x 37
constexpr int N1 = R1 * Q1, N2 = R2 * Q2;        // 665, 561 positions
constexpr int MT1 = (N1 + 15) / 16, MT2 = (N2 + 15) / 16, MT3 = TH;  // m16 tiles
constexpr int G1 = 2, G2 = MT2 / WARPS, G3 = 2;  // m16 tiles per warp unit
static_assert(TW == 16, "a c3 m16 tile is one row of the c3 tile");
static_assert(MT1 % G1 == 0 && MT2 % WARPS == 0 && MT3 % G3 == 0, "whole units");
static_assert(MT3 / G3 <= WARPS, "one c3 unit per warp");
constexpr int Q2E = (Q2 + 1) / 2;                // even q2 columns, stored first
constexpr int XN = R0 * Q0 * CIN;                // input tile elements
constexpr int XPT = (XN + THREADS - 1) / THREADS;
constexpr int KS1 = 1, KS = 9;                   // k32 steps of c1 and of c2, c3
constexpr int FRAG = 2 * 32;                     // uint4 per k-step: 2 n-pairs x 32 lanes
constexpr int W_U4 = (KS1 + 2 * KS) * FRAG;      // 1,216 uint4 = 19,456 B
constexpr int E_U4 = 6 * C * 4 / 16;             // epilogue constants, 48 uint4

constexpr int align128(int v) { return (v + 127) / 128 * 128; }

constexpr int OFF_E = W_U4 * 16;
constexpr int OFF_X = align128(OFF_E + E_U4 * 16);
constexpr int OFF_C1 = align128(OFF_X + XN);
constexpr int OFF_C2 = align128(OFF_C1 + N1 * 32);
constexpr int SMEM = OFF_C2 + N2 * 32;
static_assert(SMEM <= 232448, "shared memory of one CTA");

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// Byte offset of 16-B channel chunk `chunk` (channels 16*chunk .. +15) of
// pixel p in a [pixel][32] int8 buffer, swizzled.
__device__ __forceinline__ int sw(int p, int chunk) {
  return (p << 5) | ((chunk ^ ((p >> 2) & 1)) << 4);
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// All four n8 tiles of one k-step: B fragments of n-tiles 0,1 in bl and
// 2,3 in bh.
__device__ __forceinline__ void mma_n32(int (&d)[4][4], const uint32_t (&a)[4], const uint4& bl,
                                        const uint4& bh) {
  mma(d[0], a, bl.x, bl.y);
  mma(d[1], a, bl.z, bl.w);
  mma(d[2], a, bh.x, bh.y);
  mma(d[3], a, bh.z, bh.w);
}

template <int G>
__device__ __forceinline__ void zero(int (&acc)[G][4][4]) {
#pragma unroll
  for (int m = 0; m < G; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;
}

// clamp(rn(v * s), -127, 127): ops/quant.py:quantize on an f32 value.
__device__ __forceinline__ int quant(float v, float s) {
  return max(-QMAX, min(QMAX, __float2int_rn(__fmul_rn(v, s))));
}

// relu(f32(acc) * comb + bias), rounded to bf16: the layer's output.
__device__ __forceinline__ __nv_bfloat16 dequant(int acc, float comb, float bias) {
  return __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), comb), bias), 0.f));
}

// Two adjacent channels (n, n + 1) of a c1 or c2 accumulator -> their next
// layer's int8 inputs, packed in the low 16 bits (channel n in the low byte).
__device__ __forceinline__ uint32_t requant2(int a0, int a1, const float* comb, const float* bias, int n,
                                             float s) {
  const int q0 = quant(__bfloat162float(dequant(a0, comb[n], bias[n])), s);
  const int q1 = quant(__bfloat162float(dequant(a1, comb[n + 1], bias[n + 1])), s);
  return (static_cast<uint32_t>(q0) & 0xffu) | ((static_cast<uint32_t>(q1) & 0xffu) << 8);
}

// Copy nw 16-B words from w, then ne from e, into shared memory at smem
// with cp.async; the caller's next __syncthreads makes them visible.
__device__ __forceinline__ void stage(unsigned char* smem, const uint4* w, int nw, const uint4* e,
                                      int ne, int tid) {
  for (int i = tid; i < nw + ne; i += THREADS) {
    const uint4* src = i < nw ? w + i : e + (i - nw);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(smem + 16 * i)), "l"(src));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Tile {
  int b, oy0, ox0;
};

// Tile t of the persistent grid's walk over (image, tile row, tile column).
__device__ __forceinline__ Tile tile_at(long long t, long long per_img, int tiles_x) {
  const int b = static_cast<int>(t / per_img);
  const int rem = static_cast<int>(t - b * per_img);
  return {b, (rem / tiles_x) * TH, (rem % tiles_x) * TW};
}

// This thread's share of a tile's bf16 input (local (r, q) is global
// (2*oy0 - 3 + r, 2*ox0 - 3 + q)), zero outside the image.
__device__ __forceinline__ void fetch_input(unsigned short (&xr)[XPT], const unsigned short* x, Tile tl,
                                            int H, int W, int tid) {
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
// Stores q1 = its output requantized by s2.
__device__ __forceinline__ void conv1(const signed char* xs, const uint4* w1f, const float* comb,
                                      const float* bias, float s2, unsigned char* c1s, Tile tl, int H,
                                      int W, int warp, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  // The 8 K indices this thread's A fragments hold: i -> k = 16*(i >> 2) +
  // 4*tg + (i & 3), k = (ky*3 + kx)*3 + ci; -1 for K's zero padding.
  int koff[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = 16 * (i >> 2) + 4 * tg + (i & 3);
    koff[i] = k < 9 * CIN ? ((k / 9) * Q0 + (k / 3) % 3) * CIN + k % 3 : -1;
  }
  const uint4 bl = w1f[lane], bh = w1f[32 + lane];
  // 4 consecutive K values (half h of the k-step) of the position at `base`
  auto ld4 = [&](int base, int h) -> uint32_t {
    uint32_t v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ko = koff[4 * h + e];
      if (ko >= 0) v |= (static_cast<uint32_t>(static_cast<unsigned char>(xs[base + ko]))) << (8 * e);
    }
    return v;
  };
  for (int u = warp; u < MT1 / G1; u += WARPS) {
    int acc[G1][4][4];
    zero<G1>(acc);
    int base[G1][2];
#pragma unroll
    for (int m = 0; m < G1; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = min((u * G1 + m) * 16 + g + 8 * hh, N1 - 1);
        base[m][hh] = ((row / Q1) * Q0 + row % Q1) * CIN;
      }
#pragma unroll
    for (int m = 0; m < G1; ++m) {
      uint32_t a[4];
      a[0] = ld4(base[m][0], 0);
      a[1] = ld4(base[m][1], 0);
      a[2] = ld4(base[m][0], 1);
      a[3] = ld4(base[m][1], 1);
      mma_n32(acc[m], a, bl, bh);
    }
#pragma unroll
    for (int m = 0; m < G1; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = (u * G1 + m) * 16 + g + 8 * hh;
        if (row >= N1) continue;
        const bool in = inside(2 * tl.oy0 - 2 + row / Q1, 2 * tl.ox0 - 2 + row % Q1, H, W);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 8 * j + 2 * tg;
          *reinterpret_cast<unsigned short*>(c1s + sw(row, j >> 1) + 8 * (j & 1) + 2 * tg) =
              in ? static_cast<unsigned short>(requant2(acc[m][j][2 * hh], acc[m][j][2 * hh + 1], comb,
                                                        bias, n, s2))
                 : 0;
        }
      }
  }
}

// c2: local (r, q) is global (2*oy0 - 1 + r, 2*ox0 - 1 + q); stored at
// pixel r*Q2 + (q even ? q/2 : Q2E + q/2), requantized by s3.
__device__ __forceinline__ void conv2(uint32_t c1a, const uint4* w2f, const float* comb, const float* bias,
                                      float s3, unsigned char* c2s, Tile tl, int H, int W, int warp,
                                      int lane) {
  const int g = lane >> 2, tg = lane & 3, csel = lane >> 4;
  const int mt0 = warp * G2;
  int pix[G2];  // q1 pixel under tap (0, 0) of this lane's ldmatrix row
#pragma unroll
  for (int m = 0; m < G2; ++m) {
    const int row = min((mt0 + m) * 16 + (lane & 15), N2 - 1);
    pix[m] = (row / Q2) * Q1 + row % Q2;
  }
  int acc[G2][4][4];
  zero<G2>(acc);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int toff = (tap / 3) * Q1 + tap % 3;
    const uint4 bl = w2f[(2 * tap) * 32 + lane], bh = w2f[(2 * tap + 1) * 32 + lane];
#pragma unroll
    for (int m = 0; m < G2; ++m) {
      uint32_t a[4];
      ldsm_x4(a, c1a + sw(pix[m] + toff, csel));
      mma_n32(acc[m], a, bl, bh);
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
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * j + 2 * tg;
        *reinterpret_cast<unsigned short*>(c2s + sw(p, j >> 1) + 8 * (j & 1) + 2 * tg) =
            in ? static_cast<unsigned short>(requant2(acc[m][j][2 * hh], acc[m][j][2 * hh + 1], comb, bias,
                                                      n, s3))
               : 0;
      }
    }
}

// c3: m16 tile oy is row oy of the c3 tile, its 16 rows the columns ox.
__device__ __forceinline__ void conv3(uint32_t c2a, const uint4* w3f, const float* comb, const float* bias,
                                      __nv_bfloat16* out, Tile tl, int Ho, int Wo, int warp, int lane) {
  if (warp >= MT3 / G3) return;
  const int g = lane >> 2, tg = lane & 3, csel = lane >> 4, ox = lane & 15;
  const int oy0 = warp * G3;
  int acc[G3][4][4];
  zero<G3>(acc);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    // q2 column 2*ox + kx: even columns first, odd after them
    const int col = kx == 1 ? Q2E + ox : ox + (kx >> 1);
    const uint4 bl = w3f[(2 * tap) * 32 + lane], bh = w3f[(2 * tap + 1) * 32 + lane];
#pragma unroll
    for (int m = 0; m < G3; ++m) {
      uint32_t a[4];
      ldsm_x4(a, c2a + sw((2 * (oy0 + m) + ky) * Q2 + col, csel));
      mma_n32(acc[m], a, bl, bh);
    }
  }
#pragma unroll
  for (int m = 0; m < G3; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gy = tl.oy0 + oy0 + m, gx = tl.ox0 + g + 8 * hh;
      if (gy >= Ho || gx >= Wo) continue;
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(out + (((size_t)tl.b * Ho + gy) * Wo + gx) * C + 2 * tg);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 8 * j + 2 * tg;
        __nv_bfloat162 v;
        v.x = dequant(acc[m][j][2 * hh], comb[n], bias[n]);
        v.y = dequant(acc[m][j][2 * hh + 1], comb[n + 1], bias[n + 1]);
        dst[4 * j] = v;
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
trunk_int8_kernel(const unsigned short* __restrict__ x, const uint4* __restrict__ wfrag,
                  const uint4* __restrict__ epilogue, __nv_bfloat16* __restrict__ out, int B, int H,
                  int W, int Ho, int Wo, float s1, float s2, float s3) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* w1f = reinterpret_cast<const uint4*>(smem);
  const uint4* w2f = w1f + KS1 * FRAG;
  const uint4* w3f = w2f + KS * FRAG;
  const float* comb = reinterpret_cast<const float*>(smem + OFF_E);  // [comb1 | comb2 | comb3]
  const float* bias = comb + 3 * C;                                   // [b1 | b2 | b3]
  signed char* xs = reinterpret_cast<signed char*>(smem + OFF_X);
  unsigned char* c1s = smem + OFF_C1;
  unsigned char* c2s = smem + OFF_C2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Weights and epilogue constants, once per CTA (the constants follow the
  // weights).
  static_assert(OFF_E == 16 * W_U4, "epilogue constants right after the weights");
  stage(smem, wfrag, W_U4, epilogue, E_U4, tid);

  const int tiles_x = (Wo + TW - 1) / TW;
  const long long per_img = (long long)tiles_x * ((Ho + TH - 1) / TH);
  const long long total = per_img * B;
  unsigned short xr[XPT];
  long long t = blockIdx.x;
  if (t < total) fetch_input(xr, x, tile_at(t, per_img, tiles_x), H, W, tid);
  for (; t < total; t += gridDim.x) {
    const Tile tl = tile_at(t, per_img, tiles_x);
#pragma unroll
    for (int j = 0; j < XPT; ++j)
      if (tid + j * THREADS < XN)
        xs[tid + j * THREADS] = static_cast<signed char>(quant(__uint_as_float(static_cast<uint32_t>(xr[j]) << 16), s1));
    // The next tile's input loads fly while this tile computes.
    if (t + gridDim.x < total) fetch_input(xr, x, tile_at(t + gridDim.x, per_img, tiles_x), H, W, tid);
    __syncthreads();  // input (and, first time, the weights) in shared memory
    conv1(xs, w1f, comb, bias, s2, c1s, tl, H, W, warp, lane);
    __syncthreads();
    conv2(smem_addr(c1s), w2f, comb + C, bias + C, s3, c2s, tl, H, W, warp, lane);
    __syncthreads();
    conv3(smem_addr(c2s), w3f, comb + 2 * C, bias + 2 * C, out, tl, Ho, Wo, warp, lane);
  }
}

}  // namespace

// The C entry for ctypes (kernels/trunk_int8.py): x and out bfloat16 NHWC,
// weights as int8_fragments lays them out, epilogue f32 [comb1 | comb2 |
// comb3 | b1 | b2 | b3], s1 s2 s3 the static scales. Launches a persistent
// grid (one CTA per tile, at most as many as fit on the card at once) on
// `stream`. Returns a cudaError_t.
extern "C" int dd_trunk_int8(const void* x, const void* weights, const void* epilogue, void* out, int B,
                             int H, int W, float s1, float s2, float s3, void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long tiles = (long long)((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH) * B;
  cudaError_t err = cudaFuncSetAttribute(trunk_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trunk_int8_kernel, THREADS, SMEM)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  trunk_int8_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<const uint4*>(weights),
      static_cast<const uint4*>(epilogue), static_cast<__nv_bfloat16*>(out), B, H, W, Ho, Wo, s1, s2, s3);
  return (int)cudaGetLastError();
}
