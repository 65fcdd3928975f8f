// Native convex-polygon IoU kernel for the box threat-score metric: the
// port's copy of driving_dirty_tpu/metrics/native/iou.cpp, byte for byte in
// its code.
//
// Replaces the C library the reference leans on (Shapely/GEOS polygon
// intersection, the reference's src/utils/helper.py:79-83) and the Python
// double loop around it (helper.py:54-57) with a single C++ pass over the
// AABB-prefiltered pair matrix. Exposed via ctypes (a plain C interface);
// built on demand with g++ by driving_dirty_tpu_torch/metrics/_native.py.
//
// Algorithm: Andrew monotone-chain convex hull of each 4-corner box, then
// Sutherland–Hodgman convex clipping, shoelace areas — exactly the math in
// driving_dirty_tpu_torch/metrics/polygon.py, which doubles as the test oracle.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct P {
  double x, y;
};

inline double cross(const P& o, const P& a, const P& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// monotone chain; pts modified in place; returns hull size (CCW)
int convex_hull(P* pts, int n, P* hull) {
  std::sort(pts, pts + n, [](const P& a, const P& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  // dedup
  int m = 0;
  for (int i = 0; i < n; i++) {
    if (m == 0 || pts[i].x != pts[m - 1].x || pts[i].y != pts[m - 1].y) pts[m++] = pts[i];
  }
  n = m;
  if (n <= 2) {
    std::memcpy(hull, pts, n * sizeof(P));
    return n;
  }
  int k = 0;
  for (int i = 0; i < n; i++) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
    hull[k++] = pts[i];
  }
  int lower = k + 1;
  for (int i = n - 2; i >= 0; i--) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) k--;
    hull[k++] = pts[i];
  }
  return k - 1;
}

double polygon_area(const P* poly, int n) {
  if (n < 3) return 0.0;
  double s = 0.0;
  for (int i = 0; i < n; i++) {
    int j = (i + 1) % n;
    s += poly[i].x * poly[j].y - poly[j].x * poly[i].y;
  }
  return std::fabs(s) * 0.5;
}

// Sutherland–Hodgman clip of convex CCW subject by convex CCW clip polygon.
int clip_convex(const P* subject, int ns, const P* clip, int nc, P* out) {
  P buf_a[32], buf_b[32];
  std::memcpy(buf_a, subject, ns * sizeof(P));
  P* in = buf_a;
  P* ou = buf_b;
  int n_in = ns;
  for (int e = 0; e < nc; e++) {
    const P& a = clip[e];
    const P& b = clip[(e + 1) % nc];
    double ex = b.x - a.x, ey = b.y - a.y;
    int n_out = 0;
    if (n_in == 0) return 0;
    P prev = in[n_in - 1];
    bool prev_in = ex * (prev.y - a.y) - ey * (prev.x - a.x) >= 0;
    for (int i = 0; i < n_in; i++) {
      P cur = in[i];
      bool cur_in = ex * (cur.y - a.y) - ey * (cur.x - a.x) >= 0;
      if (cur_in != prev_in) {
        double dx = cur.x - prev.x, dy = cur.y - prev.y;
        double denom = ex * dy - ey * dx;
        if (std::fabs(denom) > 1e-12) {
          double t = (ex * (a.y - prev.y) - ey * (a.x - prev.x)) / denom;
          if (n_out < 31) ou[n_out++] = {prev.x + t * dx, prev.y + t * dy};
        }
      }
      if (cur_in && n_out < 31) ou[n_out++] = cur;
      prev = cur;
      prev_in = cur_in;
    }
    std::swap(in, ou);
    n_in = n_out;
  }
  std::memcpy(out, in, n_in * sizeof(P));
  return n_in;
}

// box: [2][4] row 0 = xs, row 1 = ys
double box_iou(const double* b1, const double* b2) {
  P p1[4], p2[4], h1[8], h2[8], inter[32];
  for (int i = 0; i < 4; i++) {
    p1[i] = {b1[i], b1[4 + i]};
    p2[i] = {b2[i], b2[4 + i]};
  }
  int n1 = convex_hull(p1, 4, h1);
  int n2 = convex_hull(p2, 4, h2);
  if (n1 < 3 || n2 < 3) return 0.0;
  double a1 = polygon_area(h1, n1);
  double a2 = polygon_area(h2, n2);
  int ni = clip_convex(h1, n1, h2, n2, inter);
  double ai = polygon_area(inter, ni);
  double u = a1 + a2 - ai;
  return u > 0 ? ai / u : 0.0;
}

}  // namespace

extern "C" {

// boxes1: [n1, 2, 4], boxes2: [n2, 2, 4] (float64, C-contiguous)
// cond:   [n1, n2] uint8 prefilter; out: [n1, n2] float64
void masked_pair_iou(const double* boxes1, const double* boxes2,
                     const uint8_t* cond, double* out,
                     int64_t n1, int64_t n2) {
  for (int64_t i = 0; i < n1; i++) {
    for (int64_t j = 0; j < n2; j++) {
      out[i * n2 + j] =
          cond[i * n2 + j] ? box_iou(boxes1 + i * 8, boxes2 + j * 8) : 0.0;
    }
  }
}

// Rasterize n [2,4] meter boxes into an HxW {0,1} map — native fallback for
// hosts without an accelerator (parity with ops/maps.py semantics: corners
// fl,fr,br,bl ring, px = m*10+400, row flip).
void rasterize_boxes(const double* boxes, const uint8_t* valid, int64_t n,
                     uint8_t* out, int64_t size) {
  std::memset(out, 0, size * size);
  static const int order[4] = {0, 1, 3, 2};
  for (int64_t b = 0; b < n; b++) {
    if (valid && !valid[b]) continue;
    const double* bx = boxes + b * 8;
    double px[4], py[4];
    for (int i = 0; i < 4; i++) {
      px[i] = bx[order[i]] * 10.0 + 400.0;
      py[i] = bx[4 + order[i]] * 10.0 + 400.0;
    }
    double area2 = 0;
    for (int i = 0; i < 4; i++) {
      int j = (i + 1) % 4;
      area2 += px[i] * py[j] - px[j] * py[i];
    }
    if (std::fabs(area2) < 1e-6) continue;
    double sign = area2 >= 0 ? 1.0 : -1.0;
    double xmin = *std::min_element(px, px + 4), xmax = *std::max_element(px, px + 4);
    double ymin = *std::min_element(py, py + 4), ymax = *std::max_element(py, py + 4);
    int64_t r0 = std::max<int64_t>(0, (int64_t)std::floor(ymin));
    int64_t r1 = std::min<int64_t>(size - 1, (int64_t)std::ceil(ymax));
    int64_t c0 = std::max<int64_t>(0, (int64_t)std::floor(xmin));
    int64_t c1 = std::min<int64_t>(size - 1, (int64_t)std::ceil(xmax));
    for (int64_t r = r0; r <= r1; r++) {
      for (int64_t c = c0; c <= c1; c++) {
        bool inside = true;
        for (int i = 0; i < 4 && inside; i++) {
          int j = (i + 1) % 4;
          double crossv = (px[j] - px[i]) * ((double)r - py[i]) -
                          (py[j] - py[i]) * ((double)c - px[i]);
          inside = sign * crossv >= 0.0;
        }
        if (inside) out[(size - 1 - r) * size + c] = 1;
      }
    }
  }
}
}
