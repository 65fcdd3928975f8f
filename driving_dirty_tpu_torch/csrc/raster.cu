// Box rasterizer (kernel B2) for sm_90a: [B, N, 2, 4] meter boxes plus a
// [B, N] valid mask -> [B, size, size] {0,1} float32 occupancy maps.
//
// Replaces driving_dirty_tpu/pallas/raster.py:boxes_to_binary_map_pallas
// (the Pallas TPU kernel, pallas_call at :76). Semantics are those of the
// plain version, driving_dirty_tpu_torch/ops/maps.py:boxes_to_binary_map,
// at any size: corners reordered into the ring fl, fr, br, bl, scaled
// px = m * scale + offset (scale = size * 10 / 800, offset = size / 2, both
// float32), a pixel (col, pre-flip row) inside when all four signed edge
// tests are >= 0 with the sign of the ring's doubled area, rows flipped,
// degenerate (|2 * area| <= 1e-6) and invalid boxes adding nothing.
//
// Bit-exact to the plain version. Every product, sum and difference is
// written with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// a*b - c*d into an fma: that would change the rounding of the edge test,
// and where an edge passes through a pixel centre (corners on 0.1 m
// multiples at 800 px) the rounding decides whether the pixel counts. The
// doubled area is summed left to right over the four edge terms, as the
// plain version sums it. The pre-flip row is an integer-valued float, so
// the flip is done in the index.
//
// What bounds it on the H100: the output, B * size^2 * 4 bytes written once
// (20.5 MB for B = 8 at 800, 6.1 us at 3.35 TB/s), against about 30 f32
// operations per pixel of each box's bounding rectangle (a few million
// pixel-boxes for a scene of 60 cars): bytes bind at realistic box counts.
//
// Design. A 2-D grid of (tile of TILE_ROWS output rows, batch item); 256
// threads per block. The block runs the per-box prologue itself, one box
// per thread (reorder, scale, edges, area, sign, degeneracy), and keeps in
// shared memory only the valid, non-degenerate boxes whose row range,
// widened by CULL_MARGIN pixels, meets the tile. Each thread then owns
// pixels p = tid, tid + 256, ... of the tile in row-major order, so
// neighbouring threads store neighbouring columns (coalesced), and tests
// its pixels against the staged boxes, stopping at the first box that
// covers the pixel; a pixel outside a box's bounding rectangle widened by
// CULL_MARGIN skips that box's edge tests. Both culls are conservative: an
// edge test rounds to a small fraction of a pixel, so no pixel outside the
// widened rectangle passes all four (tests/test_torch_port_raster.py checks
// this on the plain version). Boxes are staged CHUNK at a time; a later
// chunk ORs into what the same thread stored for an earlier one. Nothing of
// the TPU tiling (80-row tiles, SMEM scalars, size % 80 == 0) is carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 8;       // output rows per block
constexpr int CHUNK = THREADS;     // boxes staged per pass, one per thread
constexpr float CULL_MARGIN = 2.f;  // pixels added to each side of a box's bounding rectangle

__device__ __forceinline__ bool edge_ok(float ax, float ay, float ex, float ey, float sg,
                                        float xx, float yy) {
  const float cross = __fsub_rn(__fmul_rn(ex, __fsub_rn(yy, ay)), __fmul_rn(ey, __fsub_rn(xx, ax)));
  return __fmul_rn(sg, cross) >= 0.f;
}

__global__ void __launch_bounds__(THREADS)
raster_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
              float* __restrict__ out, int N, int size, float scale, float offset) {
  __shared__ float4 s_ax[CHUNK], s_ay[CHUNK], s_ex[CHUNK], s_ey[CHUNK];
  __shared__ float4 s_bb[CHUNK];  // bounding rectangle widened by CULL_MARGIN
  __shared__ float s_sg[CHUNK];
  __shared__ int s_count;

  const int item = blockIdx.y;
  const int r0 = blockIdx.x * TILE_ROWS;  // first output row of the tile
  const int rows = min(TILE_ROWS, size - r0);
  const float y_hi = (float)(size - 1 - r0);     // pre-flip row of output row r0
  const float y_lo = (float)(size - r0 - rows);  // pre-flip row of the tile's last row
  const int npix = rows * size;
  float* tile = out + ((size_t)item * size + r0) * size;
  const float* item_boxes = boxes + (size_t)item * N * 8;
  const uint8_t* item_valid = valid + (size_t)item * N;
  const int nchunks = N > 0 ? (N + CHUNK - 1) / CHUNK : 1;

  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();

    // ---- prologue: one box per thread ----
    const int j = chunk * CHUNK + threadIdx.x;
    if (j < N && item_valid[j]) {
      const float* bx = item_boxes + (size_t)j * 8;  // [2][4]: x row, y row; fl, fr, bl, br
      const int ring[4] = {0, 1, 3, 2};              // -> fl, fr, br, bl
      float px[4], py[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        px[c] = __fadd_rn(__fmul_rn(bx[ring[c]], scale), offset);
        py[c] = __fadd_rn(__fmul_rn(bx[4 + ring[c]], scale), offset);
      }
      float ex[4], ey[4], area2 = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (e + 1) & 3;
        ex[e] = __fsub_rn(px[n], px[e]);
        ey[e] = __fsub_rn(py[n], py[e]);
        const float term = __fsub_rn(__fmul_rn(px[e], py[n]), __fmul_rn(px[n], py[e]));
        area2 = e == 0 ? term : __fadd_rn(area2, term);
      }
      const float ymin = fminf(fminf(py[0], py[1]), fminf(py[2], py[3]));
      const float ymax = fmaxf(fmaxf(py[0], py[1]), fmaxf(py[2], py[3]));
      const bool meets = ymax + CULL_MARGIN >= y_lo && ymin - CULL_MARGIN <= y_hi;
      if (fabsf(area2) > 1e-6f && meets) {
        const int k = atomicAdd(&s_count, 1);
        s_ax[k] = make_float4(px[0], px[1], px[2], px[3]);
        s_ay[k] = make_float4(py[0], py[1], py[2], py[3]);
        s_ex[k] = make_float4(ex[0], ex[1], ex[2], ex[3]);
        s_ey[k] = make_float4(ey[0], ey[1], ey[2], ey[3]);
        s_sg[k] = area2 >= 0.f ? 1.f : -1.f;
        const float xmin = fminf(fminf(px[0], px[1]), fminf(px[2], px[3]));
        const float xmax = fmaxf(fmaxf(px[0], px[1]), fmaxf(px[2], px[3]));
        s_bb[k] = make_float4(xmin - CULL_MARGIN, xmax + CULL_MARGIN, ymin - CULL_MARGIN,
                              ymax + CULL_MARGIN);
      }
    }
    __syncthreads();

    // ---- pixels: consecutive threads own consecutive columns ----
    const int count = s_count;
    int r = threadIdx.x / size, c = threadIdx.x - r * size;  // pixel p = r * size + c
    for (int p = threadIdx.x; p < npix; p += THREADS) {
      const float xx = (float)c;
      const float yy = y_hi - (float)r;  // exact: integer-valued, below 2^24
      float v = chunk == 0 ? 0.f : tile[p];
      for (int k = 0; k < count && v == 0.f; ++k) {
        const float4 bb = s_bb[k];
        if (xx < bb.x || xx > bb.y || yy < bb.z || yy > bb.w) continue;
        const float4 ax = s_ax[k], ay = s_ay[k], ex = s_ex[k], ey = s_ey[k];
        const float sg = s_sg[k];
        if (edge_ok(ax.x, ay.x, ex.x, ey.x, sg, xx, yy) &&
            edge_ok(ax.y, ay.y, ex.y, ey.y, sg, xx, yy) &&
            edge_ok(ax.z, ay.z, ex.z, ey.z, sg, xx, yy) &&
            edge_ok(ax.w, ay.w, ex.w, ey.w, sg, xx, yy))
          v = 1.f;
      }
      tile[p] = v;
      for (c += THREADS; c >= size; c -= size) ++r;
    }
    __syncthreads();  // the next chunk overwrites the staged boxes
  }
}

}  // namespace

// C entry for ctypes: boxes float32 [B, N, 2, 4], valid uint8/bool [B, N],
// out float32 [B, size, size], all contiguous on the device. Returns a
// cudaError_t.
extern "C" int dd_raster_forward(const void* boxes, const void* valid, void* out, int B, int N,
                                 int size, float scale, float offset, void* stream) {
  if (B < 1 || B > 65535 || N < 0 || size < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((size + TILE_ROWS - 1) / TILE_ROWS, B);
  raster_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), N, size, scale, offset);
  return (int)cudaGetLastError();
}
