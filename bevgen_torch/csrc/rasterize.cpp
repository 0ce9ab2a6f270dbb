// Native BEV rasterization core (host C++, no CUDA).
//
// The port's copy of the JAX package's `native/rasterize.cpp`, the same
// code: the hot loop of BEV raster drawing (bevgen_torch/data/rasterize.py,
// reference argoverse_preprocess.py) and the scene editor's
// re-rasterization on a machine without cv2: polygon fills and polyline
// draws over 256x256 uint8 rasters. Self-contained C++ (no OpenCV
// dependency) exposed over a C ABI for ctypes (bevgen_torch/native.py).
//
// Semantics: even-odd scanline polygon fill with half-open pixel-center
// sampling and Bresenham polylines — matching cv2.fillPoly /
// cv2.polylines on simple polygons to within boundary-pixel rounding
// (held to cv2 and to the JAX package's core in
// tests/test_torch_rasterize.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Draw one Bresenham segment, bounded by the raster size.
//
// Callers pass city-scale geometry converted to ego pixels without
// window culling, so endpoints can be tens of thousands of pixels
// off-raster; unbounded stepping would make this "fast path" slower
// than cv2 (which clips lines to the image first). Two bounds:
//  - exact O(1) reject when the segment's bbox misses the raster
//    (Bresenham pixels never leave the endpoint bbox);
//  - Liang-Barsky clip to a margin-expanded rect for segments that
//    reach far outside it. Rounding the clipped endpoint perturbs the
//    drawn line by <= 0.5 px (the same class of deviation cv2's integer
//    clipLine introduces); the margin keeps the perturbation off the
//    visible window's entry point.
void bresenham(int64_t x0, int64_t y0, int64_t x1, int64_t y1,
               uint8_t* out, int32_t h, int32_t w, uint8_t value) {
  if (std::max(x0, x1) < 0 || std::min(x0, x1) >= w ||
      std::max(y0, y1) < 0 || std::min(y0, y1) >= h)
    return;  // exact: no pixel of this segment can land in the raster
  const int64_t margin = 256;
  const double lo_x = -(double)margin, hi_x = (double)w - 1 + margin;
  const double lo_y = -(double)margin, hi_y = (double)h - 1 + margin;
  if (x0 < lo_x || x0 > hi_x || y0 < lo_y || y0 > hi_y ||
      x1 < lo_x || x1 > hi_x || y1 < lo_y || y1 > hi_y) {
    // Liang-Barsky parameter clip of p(t) = p0 + t*(p1-p0), t in [0,1]
    double t0 = 0.0, t1 = 1.0;
    const double dx = (double)(x1 - x0), dy = (double)(y1 - y0);
    const double p[4] = {-dx, dx, -dy, dy};
    const double q[4] = {(double)x0 - lo_x, hi_x - (double)x0,
                         (double)y0 - lo_y, hi_y - (double)y0};
    for (int i = 0; i < 4; ++i) {
      if (p[i] == 0.0) {
        if (q[i] < 0.0) return;  // parallel and outside
      } else {
        const double r = q[i] / p[i];
        if (p[i] < 0.0) { if (r > t1) return; if (r > t0) t0 = r; }
        else            { if (r < t0) return; if (r < t1) t1 = r; }
      }
    }
    const int64_t nx0 = (int64_t)std::llround((double)x0 + t0 * dx);
    const int64_t ny0 = (int64_t)std::llround((double)y0 + t0 * dy);
    const int64_t nx1 = (int64_t)std::llround((double)x0 + t1 * dx);
    const int64_t ny1 = (int64_t)std::llround((double)y0 + t1 * dy);
    x0 = nx0; y0 = ny0; x1 = nx1; y1 = ny1;
  }
  int64_t dx = std::llabs(x1 - x0), dy = -std::llabs(y1 - y0);
  int64_t sx = x0 < x1 ? 1 : -1, sy = y0 < y1 ? 1 : -1, err = dx + dy;
  while (true) {
    if (x0 >= 0 && x0 < w && y0 >= 0 && y0 < h) out[y0 * w + x0] = value;
    if (x0 == x1 && y0 == y1) break;
    int64_t e2 = 2 * err;
    if (e2 >= dy) { err += dy; x0 += sx; }
    if (e2 <= dx) { err += dx; y0 += sy; }
  }
}

}  // namespace

extern "C" {

// points: flat (x, y) int32 pairs; lens[i] = #points of polygon i.
// out: h*w uint8 raster (row-major), filled pixels set to `value`.
void fill_polygons(const int32_t* points, const int32_t* lens,
                   int32_t n_polys, uint8_t* out, int32_t h, int32_t w,
                   uint8_t value) {
  const int32_t* p = points;
  std::vector<double> xs;
  for (int32_t pi = 0; pi < n_polys; ++pi) {
    const int32_t n = lens[pi];
    if (n < 3) { p += 2 * n; continue; }
    // bounding box; exact whole-polygon reject when it misses the raster
    int32_t ymin = p[1], ymax = p[1], xmin = p[0], xmax = p[0];
    for (int32_t i = 0; i < n; ++i) {
      xmin = std::min(xmin, p[2 * i]);
      xmax = std::max(xmax, p[2 * i]);
      ymin = std::min(ymin, p[2 * i + 1]);
      ymax = std::max(ymax, p[2 * i + 1]);
    }
    if (xmax < 0 || xmin >= w || ymax < 0 || ymin >= h) {
      p += 2 * n;
      continue;
    }
    ymin = std::max(ymin, (int32_t)0);
    ymax = std::min(ymax, h - 1);
    for (int32_t y = ymin; y <= ymax; ++y) {
      const double yc = (double)y;  // sample at integer rows (cv2-like)
      xs.clear();
      for (int32_t i = 0; i < n; ++i) {
        const double x0 = p[2 * i], y0 = p[2 * i + 1];
        const int32_t j = (i + 1) % n;
        const double x1 = p[2 * j], y1 = p[2 * j + 1];
        if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
          xs.push_back(x0 + (yc - y0) / (y1 - y0) * (x1 - x0));
        }
      }
      std::sort(xs.begin(), xs.end());
      for (size_t k = 0; k + 1 < xs.size(); k += 2) {
        int32_t xa = (int32_t)std::max(0.0, std::ceil(xs[k] - 0.5));
        int32_t xb = (int32_t)std::min((double)w - 1,
                                       std::floor(xs[k + 1] + 0.5));
        for (int32_t x = xa; x <= xb; ++x) out[y * w + x] = value;
      }
    }
    // boundary: rasterize edges too (cv2.fillPoly includes outlines)
    for (int32_t i = 0; i < n; ++i) {
      const int32_t j = (i + 1) % n;
      bresenham(p[2 * i], p[2 * i + 1], p[2 * j], p[2 * j + 1],
                out, h, w, value);
    }
    p += 2 * n;
  }
}

// Bresenham polylines (open), 1px.
void draw_polylines(const int32_t* points, const int32_t* lens,
                    int32_t n_lines, uint8_t* out, int32_t h, int32_t w,
                    uint8_t value) {
  const int32_t* p = points;
  for (int32_t li = 0; li < n_lines; ++li) {
    const int32_t n = lens[li];
    for (int32_t i = 0; i + 1 < n; ++i) {
      bresenham(p[2 * i], p[2 * i + 1], p[2 * i + 2], p[2 * i + 3],
                out, h, w, value);
    }
    p += 2 * n;
  }
}

}  // extern "C"
