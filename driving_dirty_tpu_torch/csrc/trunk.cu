// Encoder conv trunk c1 -> c2 -> c3 in one kernel, for sm_90a.
//
// Replaces driving_dirty_tpu/pallas/trunk.py:fused_trunk (the Pallas TPU
// kernel). It computes, for NHWC input x [B, H, W, 3]:
//
//   c1 = relu(conv3x3(x,  w1, stride 1, pad 1) + b1)   [B, H,  W,  32]
//   c2 = relu(conv3x3(c1, w2, stride 1, pad 1) + b2)   [B, H,  W,  32]
//   c3 = relu(conv3x3(c2, w3, stride 2, pad 1) + b3)   [B, Ho, Wo, 32]
//
// with Ho = (H + 1) / 2 and Wo = (W + 1) / 2, for any H and W (odd sizes
// included). Only x and c3 touch device memory: c1 and c2 live in shared
// memory, one output tile at a time.
//
// Design. One CTA of 256 threads owns a TH x TW = 4 x 16 tile of c3 for one
// image. It loads the input tile with its 5-pixel total halo (zero outside
// the image), computes c1 over (2TH+3) x (2TW+3) = 11 x 35 positions and c2
// over (2TH+1) x (2TW+1) = 9 x 33, both into shared memory, then computes the
// tile of c3 and writes it NHWC. c1 and c2 positions outside the image are
// stored as zero, not relu(bias): they are the next conv's zero padding.
// Accumulation is f32 on the CUDA cores; with bf16 activations c1 and c2 are
// rounded to bf16 when stored, as the bf16 reference rounds them. Weights are
// f32 HWIO ([3][3][Cin][32], output channel fastest) read through the
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
// Shared memory (stated per CTA; above 48 KB it needs the attribute set in
// launch()):
//   input  13 x 37 x 3 f32                   =  5,772 B
//   c1     32 x 11 x 35 activations           = 49,280 B f32 | 24,640 B bf16
//   c2     32 x  9 x 33 activations           = 38,016 B f32 | 19,008 B bf16
//   total                                      = 93,068 B f32 | 49,420 B bf16
// so two CTAs fit on one SM in f32 (the register budget of
// __launch_bounds__(256, 2) allows the same).
//
// Bound on the H100 (main path, one 256 x 1836 panorama): 11.64 GFLOP against
// 20.7 MB of compulsory f32 traffic, so the kernel is bound by operations:
// 174 us per scene at the 67 TFLOP/s f32 CUDA-core peak. The halo costs
// about 15% more FLOPs than that bound counts (c1 and c2 are recomputed on
// tile borders). Tensor cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 32;         // trunk width, fixed by the architecture
constexpr int CIN = 3;        // input channels
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

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Store 8 consecutive output channels (32 B in f32, 16 B in bf16; the
// address is aligned to that size because C * sizeof(T) is).
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 u;
  __nv_bfloat162 p;
  p = __floats2bfloat162_rn(v[0], v[1]); u.x = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[2], v[3]); u.y = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[4], v[5]); u.z = *reinterpret_cast<uint32_t*>(&p);
  p = __floats2bfloat162_rn(v[6], v[7]); u.w = *reinterpret_cast<uint32_t*>(&p);
  *reinterpret_cast<uint4*>(dst) = u;
}

template <typename T>
constexpr size_t smem_bytes() {
  return R0 * Q0 * CIN * sizeof(float) + C * R1 * Q1 * sizeof(T) + C * R2 * Q2 * sizeof(T);
}

__device__ __forceinline__ bool inside(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
trunk_kernel(const T* __restrict__ x,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const float* __restrict__ w2, const float* __restrict__ b2,
             const float* __restrict__ w3, const float* __restrict__ b3,
             T* __restrict__ out, int H, int W, int Ho, int Wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                       // [R0][Q0][CIN]
  T* c1s = reinterpret_cast<T*>(smem + R0 * Q0 * CIN * sizeof(float));  // [C][R1][Q1]
  T* c2s = c1s + C * R1 * Q1;                                        // [C][R2][Q2]

  const int tid = threadIdx.x;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const T* xb = x + (size_t)blockIdx.z * H * W * CIN;

  // ---- input tile: local (r, q) is global (2*oy0 - 3 + r, 2*ox0 - 3 + q) ----
  {
    const int gy0 = 2 * oy0 - 3, gx0 = 2 * ox0 - 3;
    for (int i = tid; i < R0 * Q0 * CIN; i += THREADS) {
      const int r = i / (Q0 * CIN);
      const int rem = i - r * (Q0 * CIN);
      const int q = rem / CIN;
      const int gy = gy0 + r, gx = gx0 + q;
      float v = 0.f;
      if (inside(gy, gx, H, W)) v = to_f(xb[((size_t)gy * W + gx) * CIN + (rem - q * CIN)]);
      xs[i] = v;
    }
  }
  __syncthreads();

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
    for (int co = 0; co < C; ++co)
      c1s[(co * R1 + r) * Q1 + q] = from_f<T>(in ? fmaxf(acc[co], 0.f) : 0.f);
  }
  __syncthreads();

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
      const T* src = c1s + (ci * R1 + r0) * Q1 + q;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float a[STRIP + 2];
#pragma unroll
        for (int k = 0; k < STRIP + 2; ++k) a[k] = to_f(src[k * Q1 + kx]);
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
        c2s[((cob + j) * R2 + r) * Q2 + q] = from_f<T>(in ? fmaxf(acc[rr][j], 0.f) : 0.f);
    }
  }
  __syncthreads();

  // ---- c3: local (oy, ox) is global (oy0 + oy, ox0 + ox), stride 2 over c2 ----
  {
    const int px = tid % (TH * TW);
    const int cg = (tid / (TH * TW)) * C3_GROUP;
    const int oy = px / TW, ox = px % TW;
    float acc[C3_GROUP];
#pragma unroll
    for (int j = 0; j < C3_GROUP; ++j) acc[j] = __ldg(b3 + cg + j);
#pragma unroll 2
    for (int ci = 0; ci < C; ++ci) {
      const T* src = c2s + (ci * R2 + 2 * oy) * Q2 + 2 * ox;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float a = to_f(src[ky * Q2 + kx]);
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
    const int gy = oy0 + oy, gx = ox0 + ox;
    if (gy < Ho && gx < Wo) {
#pragma unroll
      for (int j = 0; j < C3_GROUP; ++j) acc[j] = fmaxf(acc[j], 0.f);
      store8(out + (((size_t)blockIdx.z * Ho + gy) * Wo + gx) * C + cg, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, const void* w3, const void* b3, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      trunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid((Wo + TW - 1) / TW, (Ho + TH - 1) / TH, B);
  trunk_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3), static_cast<T*>(out),
      H, W, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. dtype 0 = float32, 1 = bfloat16 (x and out); weights
// and biases are always float32, weights HWIO. Returns a cudaError_t.
extern "C" int dd_trunk_forward(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* w3,
                                const void* b3, void* out, int B, int H, int W,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w1, b1, w2, b2, w3, b3, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
