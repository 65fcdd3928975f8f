// What the trunk's forward (trunk.cu, B1) and its backward (trunk_bwd.cu,
// B1-bwd) share: the persistent grid's launch and walk over tiles, shared-
// memory addressing, and the split-TF32 mma.sync primitives of the f32
// kernels (the split is described in trunk.cu's float32 section).
#pragma once

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

// The grid of a persistent kernel: one CTA per tile, at most as many as fit
// on the card at once (the CTAs then walk over the tiles).
template <typename... P>
cudaError_t persistent_grid(void (*kernel)(P...), int threads, int smem, long long tiles, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = static_cast<int>(tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm);
  return cudaSuccess;
}

// Launch a persistent kernel on persistent_grid's grid.
template <typename... P, typename... A>
cudaError_t launch_persistent(void (*kernel)(P...), int threads, int smem, long long tiles,
                              cudaStream_t stream, A... args) {
  int grid = 0;
  const cudaError_t err = persistent_grid(kernel, threads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

namespace tf32 {

// Byte offset of 16-B channel chunk `chunk` (channels 4*chunk .. +3) of
// pixel p in a [pixel][32] f32 buffer, swizzled.
__device__ __forceinline__ int sw(int p, int chunk) {
  return (p << 7) | ((chunk ^ (p & 7)) << 4);
}

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent and 10 mantissa bits

// v = hi + lo to 2^-21 of |v|, both TF32 (trunk.cu's float32 section).
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

}  // namespace tf32

}  // namespace
