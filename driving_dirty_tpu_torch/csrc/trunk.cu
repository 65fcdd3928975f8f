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
// Two kernels, one per activation dtype:
//
// * float32 (trunk_f32_kernel): f32 FMAs on the CUDA cores, as the f32
//   reference needs (TF32 would miss its 2e-4 tolerance). One CTA of 256
//   threads per 4 x 16 tile of c3; see the f32 section below.
// * bfloat16 (trunk_tc_kernel): each conv is an implicit GEMM on the
//   tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulate); see the
//   tensor-core section below.
//
// Both take a template parameter STAGES, the first argument of the C entry
// dd_trunk: 3 is the trunk; 0, 1 and 2 stop after the input tile, c1 or
// c2 and write that stage at the c3 positions, (2oy, 2ox), as the stage
// bisection's variants (kernels/trunk.py:trunk_variant):
//   0: x at (2oy, 2ox), channel c holding x[..., c % 3]   (v0)
//   1: c1 at (2oy, 2ox)                                   (v1, v2)
//   2: c2 at (2oy, 2ox)                                   (v3, v4)
// Weights come prepared by kernels/trunk.py:prepare_weights: for f32 one
// buffer of the three HWIO f32 weights ([3][3][Cin][32] each, output
// channel fastest), for bf16 one buffer of the three weights as B-operand
// fragments (below); biases one f32 buffer [b1 | b2 | b3], rounded to the
// activation dtype.
//
// Bound on the H100 at the main path's [8, 256, 1836, 3]: 93.1 GFLOP
// against 82.7 MB of compulsory bf16 traffic (165 MB in f32): in bf16
// 94 us on the tensor cores (989 TFLOP/s) against 24.7 us of bytes; in f32
// 1.39 ms on the CUDA cores (67 TFLOP/s). Both are bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;    // trunk width, fixed by the architecture
constexpr int CIN = 3;   // input channels
constexpr int W1N = 9 * CIN * C, W2N = 9 * C * C;  // f32 HWIO weight sizes

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

// ===================== float32: CUDA cores =====================
//
// One CTA of 256 threads owns a TH x TW = 4 x 16 tile of c3 for one image.
// It loads the input tile with its 5-pixel total halo (zero outside the
// image), computes c1 over (2TH+3) x (2TW+3) = 11 x 35 positions and c2
// over (2TH+1) x (2TW+1) = 9 x 33, both into shared memory, then computes
// the tile of c3 and writes it NHWC. Weights are read through the
// read-only cache as float4; every lane of a warp reads the same weight
// address, so the reads are broadcasts.
//
// Work split inside the CTA (register blocking keeps FMAs per shared-memory
// load high):
//   c1: one thread per position, all 32 output channels (385 positions).
//   c2: one thread per (3-row strip, column, half of the output channels):
//       3 x 16 accumulators; for each (ci, kx) it loads 5 activations and
//       reuses them over the three ky taps: 144 FMAs per 17 loads.
//       3 strips x 33 columns x 2 halves = 198 of the 256 threads.
//   c3: one thread per (output position, group of 8 channels) = 256 items.
//
// Shared memory per CTA (above 48 KB it needs the attribute set in
// launch_f32()):
//   input  13 x 37 x 3 f32           =  5,772 B
//   c1     32 x 11 x 35 f32          = 49,280 B
//   c2     32 x  9 x 33 f32          = 38,016 B
//   total                             = 93,068 B
// so two CTAs fit on one SM (the register budget of
// __launch_bounds__(256, 2) allows the same). The halo costs about 15% more
// FLOPs than the bound counts (c1 and c2 are recomputed on tile borders).

namespace f32 {

constexpr int TH = 4;         // c3 rows per CTA
constexpr int TW = 16;        // c3 columns per CTA
constexpr int THREADS = 256;

constexpr int R2 = 2 * TH + 1, Q2 = 2 * TW + 1;  // c2 region  9 x 33
constexpr int R1 = 2 * TH + 3, Q1 = 2 * TW + 3;  // c1 region 11 x 35
constexpr int R0 = 2 * TH + 5, Q0 = 2 * TW + 5;  // input     13 x 37

constexpr int STRIP = 3;                 // c2 rows per thread
constexpr int NSTRIP = R2 / STRIP;       // 3
constexpr int HALF = C / 2;              // c2 output channels per thread
constexpr int C2_ITEMS = NSTRIP * Q2 * 2;
constexpr int C3_GROUP = 8;              // c3 output channels per thread
static_assert(R2 % STRIP == 0, "c2 rows must split into whole strips");
static_assert(C2_ITEMS <= THREADS, "one c2 item per thread");
static_assert(TH * TW * (C / C3_GROUP) == THREADS, "one c3 item per thread");

constexpr size_t SMEM = (R0 * Q0 * CIN + C * R1 * Q1 + C * R2 * Q2) * sizeof(float);

// Store 8 consecutive output channels (32 B; the address is 32-B aligned).
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The bisection instantiations (STAGES < 3) return before the later stages'
// loops, which nvcc reports as unreachable (diagnostic 128).
#pragma nv_diag_suppress 128
template <int STAGES>
__global__ void __launch_bounds__(THREADS, 2)
trunk_f32_kernel(const float* __restrict__ x,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ out, int H, int W, int Ho, int Wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [R0][Q0][CIN]
  float* c1s = xs + R0 * Q0 * CIN;              // [C][R1][Q1]
  float* c2s = c1s + C * R1 * Q1;               // [C][R2][Q2]

  const int tid = threadIdx.x;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const float* xb = x + (size_t)blockIdx.z * H * W * CIN;

  // ---- input tile: local (r, q) is global (2*oy0 - 3 + r, 2*ox0 - 3 + q) ----
  {
    const int gy0 = 2 * oy0 - 3, gx0 = 2 * ox0 - 3;
    for (int i = tid; i < R0 * Q0 * CIN; i += THREADS) {
      const int r = i / (Q0 * CIN);
      const int rem = i - r * (Q0 * CIN);
      const int q = rem / CIN;
      const int gy = gy0 + r, gx = gx0 + q;
      float v = 0.f;
      if (inside(gy, gx, H, W)) v = xb[((size_t)gy * W + gx) * CIN + (rem - q * CIN)];
      xs[i] = v;
    }
  }
  __syncthreads();

  // The c3 item of this thread: output position and group of 8 channels.
  const int px = tid % (TH * TW);
  const int cg = (tid / (TH * TW)) * C3_GROUP;
  const int oy = px / TW, ox = px % TW;
  const int gy = oy0 + oy, gx = ox0 + ox;
  float* dst = out + (((size_t)blockIdx.z * Ho + gy) * Wo + gx) * C + cg;

  // STAGES < 3, a bisection variant: that stage at (2oy, 2ox) is the output.
  if constexpr (STAGES == 0) {
    if (gy < Ho && gx < Wo) {
      float v[C3_GROUP];
      const float* p = xs + ((2 * oy + 3) * Q0 + 2 * ox + 3) * CIN;
#pragma unroll
      for (int j = 0; j < C3_GROUP; ++j) v[j] = p[(cg + j) % CIN];
      store8(dst, v);
    }
    return;
  }

  // ---- c1: local (r, q) is global (2*oy0 - 2 + r, 2*ox0 - 2 + q) ----
  for (int p = tid; p < R1 * Q1; p += THREADS) {
    const int r = p / Q1, q = p - r * Q1;
    float acc[C];
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = __ldg(b1 + co);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci) {
          const float a = xs[((r + ky) * Q0 + q + kx) * CIN + ci];
          const float4* wp = reinterpret_cast<const float4*>(w1 + ((ky * 3 + kx) * CIN + ci) * C);
#pragma unroll
          for (int j = 0; j < C / 4; ++j) {
            const float4 w = __ldg(wp + j);
            acc[4 * j + 0] = fmaf(a, w.x, acc[4 * j + 0]);
            acc[4 * j + 1] = fmaf(a, w.y, acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(a, w.z, acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(a, w.w, acc[4 * j + 3]);
          }
        }
    const bool in = inside(2 * oy0 - 2 + r, 2 * ox0 - 2 + q, H, W);
#pragma unroll
    for (int co = 0; co < C; ++co) c1s[(co * R1 + r) * Q1 + q] = in ? fmaxf(acc[co], 0.f) : 0.f;
  }
  __syncthreads();

  if constexpr (STAGES == 1) {
    if (gy < Ho && gx < Wo) {
      float v[C3_GROUP];
#pragma unroll
      for (int j = 0; j < C3_GROUP; ++j) v[j] = c1s[((cg + j) * R1 + 2 * oy + 2) * Q1 + 2 * ox + 2];
      store8(dst, v);
    }
    return;
  }

  // ---- c2: local (r, q) is global (2*oy0 - 1 + r, 2*ox0 - 1 + q) ----
  if (tid < C2_ITEMS) {
    const int q = tid % Q2;
    const int t = tid / Q2;
    const int r0 = (t % NSTRIP) * STRIP;
    const int cob = (t / NSTRIP) * HALF;
    float acc[STRIP][HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float b = __ldg(b2 + cob + j);
#pragma unroll
      for (int rr = 0; rr < STRIP; ++rr) acc[rr][j] = b;
    }
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      const float* src = c1s + (ci * R1 + r0) * Q1 + q;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float a[STRIP + 2];
#pragma unroll
        for (int k = 0; k < STRIP + 2; ++k) a[k] = src[k * Q1 + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const float4* wp =
              reinterpret_cast<const float4*>(w2 + ((ky * 3 + kx) * C + ci) * C + cob);
#pragma unroll
          for (int j = 0; j < HALF / 4; ++j) {
            const float4 w = __ldg(wp + j);
#pragma unroll
            for (int rr = 0; rr < STRIP; ++rr) {
              const float v = a[rr + ky];
              acc[rr][4 * j + 0] = fmaf(v, w.x, acc[rr][4 * j + 0]);
              acc[rr][4 * j + 1] = fmaf(v, w.y, acc[rr][4 * j + 1]);
              acc[rr][4 * j + 2] = fmaf(v, w.z, acc[rr][4 * j + 2]);
              acc[rr][4 * j + 3] = fmaf(v, w.w, acc[rr][4 * j + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < STRIP; ++rr) {
      const int r = r0 + rr;
      const bool in = inside(2 * oy0 - 1 + r, 2 * ox0 - 1 + q, H, W);
#pragma unroll
      for (int j = 0; j < HALF; ++j)
        c2s[((cob + j) * R2 + r) * Q2 + q] = in ? fmaxf(acc[rr][j], 0.f) : 0.f;
    }
  }
  __syncthreads();

  if constexpr (STAGES == 2) {
    if (gy < Ho && gx < Wo) {
      float v[C3_GROUP];
#pragma unroll
      for (int j = 0; j < C3_GROUP; ++j) v[j] = c2s[((cg + j) * R2 + 2 * oy + 1) * Q2 + 2 * ox + 1];
      store8(dst, v);
    }
    return;
  }

  // ---- c3: local (oy, ox) is global (oy0 + oy, ox0 + ox), stride 2 over c2 ----
  {
    float acc[C3_GROUP];
#pragma unroll
    for (int j = 0; j < C3_GROUP; ++j) acc[j] = __ldg(b3 + cg + j);
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      const float* src = c2s + (ci * R2 + 2 * oy) * Q2 + 2 * ox;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float a = src[ky * Q2 + kx];
          const float4* wp =
              reinterpret_cast<const float4*>(w3 + ((ky * 3 + kx) * C + ci) * C + cg);
          const float4 wa = __ldg(wp), wb = __ldg(wp + 1);
          acc[0] = fmaf(a, wa.x, acc[0]);
          acc[1] = fmaf(a, wa.y, acc[1]);
          acc[2] = fmaf(a, wa.z, acc[2]);
          acc[3] = fmaf(a, wa.w, acc[3]);
          acc[4] = fmaf(a, wb.x, acc[4]);
          acc[5] = fmaf(a, wb.y, acc[5]);
          acc[6] = fmaf(a, wb.z, acc[6]);
          acc[7] = fmaf(a, wb.w, acc[7]);
        }
    }
    if (gy < Ho && gx < Wo) {
#pragma unroll
      for (int j = 0; j < C3_GROUP; ++j) acc[j] = fmaxf(acc[j], 0.f);
      store8(dst, acc);
    }
  }
}

template <int STAGES>
cudaError_t launch(const void* x, const void* weights, const void* biases, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      trunk_f32_kernel<STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const float* w = static_cast<const float*>(weights);
  const float* b = static_cast<const float*>(biases);
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  trunk_f32_kernel<STAGES><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(x), w, b, w + W1N, b + C, w + W1N + W2N, b + 2 * C,
      static_cast<float*>(out), H, W, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace f32

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

constexpr int align128(int v) { return (v + 127) / 128 * 128; }
constexpr int OFF_B = W_U4 * 16;
constexpr int OFF_X = align128(OFF_B + B_U4 * 16);
constexpr int OFF_C1 = align128(OFF_X + XN * 2);
constexpr int OFF_C2 = align128(OFF_C1 + N1 * 64);
constexpr int SMEM = OFF_C2 + N2 * 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-B channel chunk `chunk` (channels 8*chunk .. +7) of
// pixel p in a [pixel][32] bf16 buffer, swizzled.
__device__ __forceinline__ int sw(int p, int chunk) {
  return (p << 6) | ((chunk ^ ((p >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t pack_relu(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(lo, 0.f), fmaxf(hi, 0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
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

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_at(long long t, long long per_img, int tiles_x) {
  const int b = static_cast<int>(t / per_img);
  const int rem = static_cast<int>(t - b * per_img);
  return {b, (rem / tiles_x) * TH, (rem % tiles_x) * TW};
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
  for (int i = tid; i < W_U4 + B_U4; i += THREADS) {
    const uint4* src = i < W_U4 ? wfrag + i : bias + (i - W_U4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(smem + 16 * i)), "l"(src));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

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
      if (tid + j * THREADS < XN) xs[tid + j * THREADS] = xr[j];
    // The next tile's input loads fly while this tile computes.
    if (t + gridDim.x < total) fetch_input(xr, x, tile_at(t + gridDim.x, per_img, tiles_x), H, W, tid);
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
  auto kernel = trunk_tc_kernel<STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, SMEM)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long tiles = (long long)((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH) * B;
  const int grid = static_cast<int>(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const uint4*>(weights),
      static_cast<const uint4*>(biases), static_cast<__nv_bfloat16*>(out), B, H, W, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace tc

template <int STAGES>
cudaError_t dispatch(int dtype, const void* x, const void* weights, const void* biases, void* out,
                     int B, int H, int W, cudaStream_t s) {
  if (dtype == 0) return f32::launch<STAGES>(x, weights, biases, out, B, H, W, s);
  if (dtype == 1) return tc::launch<STAGES>(x, weights, biases, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// The C entry for ctypes. stages 3 is the trunk (kernels/trunk.py:trunk);
// 0 (input), 1 (c1) and 2 (c2) are the stage bisection, written at
// (2oy, 2ox). dtype 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores),
// for x and out; weights and biases as prepare_weights lays them out for
// that dtype. Returns a cudaError_t.
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
