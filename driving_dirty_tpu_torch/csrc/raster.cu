// Box rasterizer (kernel B2) for sm_90a: [B, N, 2, 4] meter boxes plus a
// [B, N] valid mask -> [B, size, size] {0,1} float32 occupancy maps.
//
// Replaces driving_dirty_tpu/pallas/raster.py:boxes_to_binary_map_pallas
// (the Pallas TPU kernel, pallas_call at :76). Semantics are those of the
// plain version, driving_dirty_tpu_torch/ops/maps.py:boxes_to_binary_map,
// at any size: corners reordered into the ring fl, fr, br, bl, scaled
// px = m * scale + offset (scale = size * 10 / 800, offset = size / 2, both
// float32), a pixel (col, pre-flip row) inside when all four signed edge
// tests sg * (ex * (yy - ay) - ey * (xx - ax)) are >= 0, sg the sign of the
// ring's doubled area, rows flipped, degenerate (|2 * area| <= 1e-6) and
// invalid boxes adding nothing.
//
// Bit-exact to the plain version. Every product, sum and difference is
// written with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract
// a*b - c*d into an fma: that would change the rounding of the edge test,
// and where an edge passes through a pixel centre (corners on 0.1 m
// multiples at 800 px) the rounding decides whether the pixel counts. The
// doubled area is summed left to right over the four edge terms, as the
// plain version sums it. sg is folded into the edges (sex = sg * ex,
// sey = sg * ey): negation is exact and commutes with rounding, so the test
// (sex * (yy - ay)) - sey * (xx - ax) >= 0 gives the same bits.
//
// What bounds it on the H100: the output, B * size^2 * 4 bytes written once
// (20.5 MB for B = 8 at 800, 6.1 us at 3.35 TB/s). The design keeps every
// other cost off the per-pixel path.
//
// The fact the design rests on: for a fixed row yy, an edge test is
// monotone in the column xx. t1 = sex * (yy - ay) does not depend on xx,
// and every correctly rounded subtraction and multiplication is monotone,
// so (xx - ax), then sey * (xx - ax), then t1 - that, move one way as xx
// grows. Each edge therefore admits a half-line of columns (all or none
// where sey == 0), and a box admits one interval of columns per row. The
// interval is found with the same rounded predicate as the plain version:
// an estimate (the real-valued crossing ax + t1 / sey, clamped to the
// range) decides only where the search starts; a gallop and a bisection on
// the exact predicate decide every pixel. Monotonicity needs every
// intermediate finite: it holds when all |px|, |py| <= 2^60 (products stay
// below 2^123). A valid, non-degenerate box beyond that (or non-finite) is
// "irregular" and gets the plain per-pixel edge tests in the fill instead.
//
// Design, two kernels on the caller's stream:
// 1. raster_records_kernel, one block per item: the per-box prologue once
//    per (item, box) (ring, scale, edges, doubled area, sign, degeneracy),
//    compacted into a record array: regular boxes from the front, irregular
//    ones from the back, and their two counts.
// 2. raster_spans_kernel, one block per tile of 16 output rows x 1024
//    columns of an item. It stages the item's records in shared memory,
//    then
//    a. culls the boxes that cannot cover any of its rows, exactly: every
//       edge's column threshold is monotone in the row too, so over the
//       block's rows an edge admits no more than the hull of what it admits
//       at the first and the last row. Eight lanes a box bound the four
//       edges' ranges at those two rows, each with one exact edge test
//       beside the estimated crossing (edge_range with exact == false);
//       when the largest lower bound exceeds the smallest upper bound the
//       box covers none of the rows;
//    b. finds each (row, surviving box) span, consecutive threads on
//       consecutive rows of one box, and ORs it into a per-row bitmask in
//       shared memory;
//    c. writes the tile: each thread owns 4 consecutive columns and stores
//       them as one 16-B float4 (a scalar-store instantiation serves sizes
//       whose rows are not 16-B aligned).
//    Stores stay coalesced, the output goes out once, and the work per
//    pixel does not grow with the number of boxes. Nothing of the TPU
//    tiling (80-row tiles, SMEM scalars, size % 80 == 0) is carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;            // output rows per span block
constexpr int TILE_W = 1024;        // columns per span block
constexpr int WORDS = TILE_W / 32;  // bitmask words per row of a tile
constexpr int CHUNK = 256;          // box records staged per pass
constexpr float REGULAR = 1152921504606846976.f;  // 2^60

// One valid, non-degenerate box: ring corners and sign-folded edges, in
// ring order fl, fr, br, bl (edge e runs from corner e to corner e + 1).
struct Rec {
  float4 ax, ay, sex, sey;
};

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The edge test at column x of a row whose t1 = sex * (yy - ay) is given.
__device__ __forceinline__ bool edge_ok(float t1, float sey, float ax, int x) {
  return __fsub_rn(t1, __fmul_rn(sey, __fsub_rn(__int2float_rn(x), ax))) >= 0.f;
}

// The last x in [lo, hi] such that q holds on all of [lo, x], lo - 1 if q
// fails at lo; q(x) = edge_ok(x) != neg holds on a prefix of the columns
// (monotone). Starts at the estimate, gallops, then bisects.
__device__ int last_of_prefix(float t1, float sey, float ax, float est, int lo, int hi, bool neg) {
  const int c = (int)fminf(fmaxf(est, (float)lo), (float)hi);  // NaN -> lo
  int a, b;  // q(a) holds, q(b) does not
  if (edge_ok(t1, sey, ax, c) != neg) {
    a = c;
    for (int step = 1;; step <<= 1) {
      if (a >= hi) return hi;
      const int n = min(a + step, hi);
      if (edge_ok(t1, sey, ax, n) != neg) {
        a = n;
      } else {
        b = n;
        break;
      }
    }
  } else {
    b = c;
    for (int step = 1;; step <<= 1) {
      if (b <= lo) return lo - 1;
      const int n = max(b - step, lo);
      if (edge_ok(t1, sey, ax, n) != neg) {
        a = n;
        break;
      }
      b = n;
    }
  }
  while (b - a > 1) {
    const int m = (a + b) >> 1;
    if (edge_ok(t1, sey, ax, m) != neg) a = m; else b = m;
  }
  return a;
}

// The columns [elo, ehi] of [lo, hi] that edge e of a regular box admits in
// row yy, empty as elo > ehi: a prefix (sey > 0), a suffix (sey < 0), or
// all or nothing (sey == 0: t1 - (+-0) is the same test at every column).
// With exact == false, for the cull, bounds that hold every admitted column
// instead: one exact test two columns past the estimated crossing; a
// failing column bounds a prefix from above or a suffix from below, and a
// passing one leaves [lo, hi].
__device__ void edge_range(const Rec& r, int e, float yy, int lo, int hi, bool exact, int& elo,
                           int& ehi) {
  const float ax = get(r.ax, e), sey = get(r.sey, e);
  const float t1 = __fmul_rn(get(r.sex, e), __fsub_rn(yy, get(r.ay, e)));
  elo = lo;
  ehi = hi;
  if (sey == 0.f) {
    if (!(t1 >= 0.f)) elo = hi + 1, ehi = lo - 1;
    return;
  }
  const float est = ax + __fdividef(t1, sey);  // where the test flips, roughly
  if (exact) {
    if (sey > 0.f) ehi = last_of_prefix(t1, sey, ax, est, lo, hi, false);
    else elo = last_of_prefix(t1, sey, ax, est, lo, hi, true) + 1;
    return;
  }
  const float past = sey > 0.f ? est + 2.f : est - 2.f;
  const int x = (int)fminf(fmaxf(past, (float)lo), (float)hi);  // NaN -> lo
  if (!edge_ok(t1, sey, ax, x)) {
    if (sey > 0.f) ehi = x - 1;
    else elo = x + 1;
  }
}

// The columns [lo, hi] of [c0, c1] that a regular box covers in row yy
// (each edge searched inside what the earlier ones left); false when there
// are none.
__device__ bool span(const Rec& r, float yy, int c0, int c1, int& lo, int& hi) {
  lo = c0;
  hi = c1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int elo, ehi;
    edge_range(r, e, yy, lo, hi, true, elo, ehi);
    lo = max(lo, elo);
    hi = min(hi, ehi);
    if (lo > hi) return false;
  }
  return true;
}

__device__ __forceinline__ void set_bits(uint32_t* row, int a, int b) {
  const int wa = a >> 5, wb = b >> 5;
  const uint32_t ma = ~0u << (a & 31), mb = ~0u >> (31 - (b & 31));
  if (wa == wb) {
    atomicOr(&row[wa], ma & mb);
    return;
  }
  atomicOr(&row[wa], ma);
  for (int w = wa + 1; w < wb; ++w) atomicOr(&row[w], ~0u);
  atomicOr(&row[wb], mb);
}

// The plain per-pixel edge tests of the irregular boxes for the ncols
// columns from col whose bit in nib is not set yet.
__device__ uint32_t irregular(const Rec* recs, int n, float yy, int col, int ncols, uint32_t nib) {
  for (int c = 0; c < ncols; ++c) {
    for (int k = 0; k < n && !((nib >> c) & 1u); ++k) {
      const Rec r = recs[k];
      bool in = true;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float t1 = __fmul_rn(get(r.sex, e), __fsub_rn(yy, get(r.ay, e)));
        in = in && edge_ok(t1, get(r.sey, e), get(r.ax, e), col + c);
      }
      if (in) nib |= 1u << c;
    }
  }
  return nib;
}

__global__ void __launch_bounds__(THREADS)
raster_records_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                      Rec* __restrict__ recs, int* __restrict__ counts, int N, float scale,
                      float offset) {
  __shared__ int s_warp[2][THREADS / 32];
  __shared__ int s_base[2];
  const int item = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* item_boxes = boxes + (size_t)item * N * 8;
  const uint8_t* item_valid = valid + (size_t)item * N;
  Rec* item_recs = recs + (size_t)item * N;
  if (threadIdx.x == 0) s_base[0] = s_base[1] = 0;

  for (int j0 = 0; j0 < N; j0 += THREADS) {
    const int j = j0 + threadIdx.x;
    bool reg = false, irr = false;
    Rec r;
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
      bool regular = true;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = (e + 1) & 3;
        ex[e] = __fsub_rn(px[n], px[e]);
        ey[e] = __fsub_rn(py[n], py[e]);
        const float term = __fsub_rn(__fmul_rn(px[e], py[n]), __fmul_rn(px[n], py[e]));
        area2 = e == 0 ? term : __fadd_rn(area2, term);
        regular = regular && fabsf(px[e]) <= REGULAR && fabsf(py[e]) <= REGULAR;
      }
      if (fabsf(area2) > 1e-6f) {
        const float sg = area2 >= 0.f ? 1.f : -1.f;
        r.ax = make_float4(px[0], px[1], px[2], px[3]);
        r.ay = make_float4(py[0], py[1], py[2], py[3]);
        r.sex = make_float4(sg * ex[0], sg * ex[1], sg * ex[2], sg * ex[3]);
        r.sey = make_float4(sg * ey[0], sg * ey[1], sg * ey[2], sg * ey[3]);
        reg = regular;
        irr = !regular;
      }
    }
    const unsigned below = (1u << lane) - 1u;
    const unsigned breg = __ballot_sync(~0u, reg), birr = __ballot_sync(~0u, irr);
    if (lane == 0) {
      s_warp[0][warp] = __popc(breg);
      s_warp[1][warp] = __popc(birr);
    }
    __syncthreads();
    int at_reg = s_base[0] + __popc(breg & below), at_irr = s_base[1] + __popc(birr & below);
    for (int w = 0; w < warp; ++w) {
      at_reg += s_warp[0][w];
      at_irr += s_warp[1][w];
    }
    if (reg) item_recs[at_reg] = r;
    if (irr) item_recs[N - 1 - at_irr] = r;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < THREADS / 32; ++w) {
        s_base[0] += s_warp[0][w];
        s_base[1] += s_warp[1][w];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    counts[2 * item] = s_base[0];
    counts[2 * item + 1] = s_base[1];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
raster_spans_kernel(const Rec* __restrict__ recs, const int* __restrict__ counts,
                    float* __restrict__ out, int N, int size) {
  __shared__ Rec s_rec[CHUNK];
  __shared__ int s_active[CHUNK];  // staged boxes that may cover a row of the tile
  __shared__ int s_nactive;
  __shared__ uint32_t s_bits[ROWS][WORDS];
  const int item = blockIdx.z;
  const int r0 = blockIdx.x * ROWS;    // first output row of the tile
  const int c0 = blockIdx.y * TILE_W;  // first column of the tile
  const int rows = min(ROWS, size - r0);
  const int width = min(TILE_W, size - c0);
  const int c1 = c0 + width - 1;
  const float y_first = (float)(size - 1 - r0);              // pre-flip rows of the tile's
  const float y_last = (float)(size - 1 - (r0 + rows - 1));  // first and last output row
  const Rec* item_recs = recs + (size_t)item * N;
  const int n_reg = counts[2 * item], n_irr = counts[2 * item + 1];
  for (int i = threadIdx.x; i < ROWS * WORDS; i += THREADS) (&s_bits[0][0])[i] = 0u;

  for (int k0 = 0; k0 < n_reg; k0 += CHUNK) {
    const int cnt = min(CHUNK, n_reg - k0);
    __syncthreads();  // the bits are zeroed, the previous chunk's spans are done
    for (int k = threadIdx.x; k < cnt; k += THREADS) s_rec[k] = item_recs[k0 + k];
    if (threadIdx.x == 0) s_nactive = 0;
    __syncthreads();

    // ---- cull: lanes 8k .. 8k+7 hold box k's edges (e = lane / 2 % 4) at
    // the tile's first and last row (lane % 2); whole warps, so the
    // shuffles see every lane ----
    for (int base = 0; base < 8 * cnt; base += THREADS) {
      const int l = base + threadIdx.x;
      const bool on = l < 8 * cnt;  // the same for the 8 lanes of a box
      int lo = c0, hi = c1;
      if (on) {
        edge_range(s_rec[l >> 3], (l >> 1) & 3, (l & 1) ? y_last : y_first, c0, c1, false, lo, hi);
      }
      lo = min(lo, __shfl_xor_sync(~0u, lo, 1));  // the edge over the tile's rows
      hi = max(hi, __shfl_xor_sync(~0u, hi, 1));
      lo = max(lo, __shfl_xor_sync(~0u, lo, 2));  // all four edges
      hi = min(hi, __shfl_xor_sync(~0u, hi, 2));
      lo = max(lo, __shfl_xor_sync(~0u, lo, 4));
      hi = min(hi, __shfl_xor_sync(~0u, hi, 4));
      if (on && (l & 7) == 0 && lo <= hi) s_active[atomicAdd(&s_nactive, 1)] = l >> 3;
    }
    __syncthreads();

    // ---- spans: one (row, box) pair per thread, consecutive threads on
    // consecutive rows of a box, ORed into the row's bits ----
    const int na = s_nactive;
    for (int p = threadIdx.x; p < rows * na; p += THREADS) {
      const int j = p / rows, r = p - j * rows;
      const float yy = (float)(size - 1 - (r0 + r));  // pre-flip row: exact below 2^24
      int lo, hi;
      if (span(s_rec[s_active[j]], yy, c0, c1, lo, hi)) set_bits(s_bits[r], lo - c0, hi - c0);
    }
  }
  __syncthreads();

  // ---- fill: 4 consecutive columns per thread, one store each ----
  const int groups = (width + 3) >> 2;
  for (int q = threadIdx.x; q < rows * groups; q += THREADS) {
    const int r = q / groups, g = q - r * groups;
    const int row = r0 + r, col = c0 + 4 * g;
    uint32_t nib = (s_bits[r][g >> 3] >> ((g & 7) * 4)) & 0xFu;
    if (n_irr) {
      nib = irregular(item_recs + N - n_irr, n_irr, (float)(size - 1 - row), col,
                      min(4, size - col), nib);
    }
    float* dst = out + ((size_t)item * size + row) * size + col;
    const float4 v = make_float4((float)(nib & 1u), (float)((nib >> 1) & 1u),
                                 (float)((nib >> 2) & 1u), (float)((nib >> 3) & 1u));
    if (VEC) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const int n = min(4, size - col);
      dst[0] = v.x;
      if (n > 1) dst[1] = v.y;
      if (n > 2) dst[2] = v.z;
      if (n > 3) dst[3] = v.w;
    }
  }
}

}  // namespace

// C entry for ctypes: boxes float32 [B, N, 2, 4], valid uint8/bool [B, N],
// records scratch of B * N * 64 bytes, counts scratch int32 [B, 2], out
// float32 [B, size, size] (16-B aligned), all contiguous on the device.
// Launches both kernels on `stream`; returns a cudaError_t.
extern "C" int dd_raster_forward(const void* boxes, const void* valid, void* records, void* counts,
                                 void* out, int B, int N, int size, float scale, float offset,
                                 void* stream) {
  if (B < 1 || B > 65535 || N < 0 || size < 1 || size >= (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  raster_records_kernel<<<B, THREADS, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<Rec*>(records), static_cast<int*>(counts), N, scale, offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((size + ROWS - 1) / ROWS, (size + TILE_W - 1) / TILE_W, B);
  if (size % 4 == 0) {
    raster_spans_kernel<true><<<grid, THREADS, 0, s>>>(
        static_cast<const Rec*>(records), static_cast<const int*>(counts),
        static_cast<float*>(out), N, size);
  } else {
    raster_spans_kernel<false><<<grid, THREADS, 0, s>>>(
        static_cast<const Rec*>(records), static_cast<const int*>(counts),
        static_cast<float*>(out), N, size);
  }
  return (int)cudaGetLastError();
}
