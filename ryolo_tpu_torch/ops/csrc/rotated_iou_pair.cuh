// The IoU of one pair of rotated rectangles, shared by the pairwise kernel
// (rotated_iou.cu) and the NMS mask kernel (rotated_nms.cu), so that both give
// the same bits for the same pair.
//
// Boxes are (cx, cy, w, h, angle_deg); box1 is the clipped ring, box2 the
// clipping rectangle. Contract kept from the TPU kernel
// ryolo_tpu/ops/pallas_iou.py::_iou_tile_kernel (with _clip_ring_unrolled) and
// from the plain PyTorch version in ryolo_tpu_torch/ops/rotated_iou.py:
//   * each pair is re-centred on box2 before any corner is formed (the NMS
//     shifts centres by class * 4096, up to ~61k px: without the re-centring
//     f32 cancellation corrupts every high-class IoU);
//   * box1's corners form an 8-slot duplicate-fill ring; four Sutherland-Hodgman
//     clips against box2's edges use unit inward normals (sign rule of
//     pallas_iou.py:122-123) and count a vertex within 1e-4 px as inside;
//   * a vertex equal to its predecessor is not emitted, emitted points are
//     compacted in order, the ring is filled up with the last one (zeros if
//     none);
//   * the shoelace formula gives the area; zero-size boxes give 0, and
//     union <= 0 gives 0.
// Everything that depends on one box only is split off into RowTerms (box1)
// and ColTerms (box2), computed once per box and staged by the kernels. The
// library is built with --fmad=false, so products and sums round as the plain
// version rounds them.
#pragma once

#include <cuda_runtime.h>

namespace riou {

constexpr int kV = 8;  // ring slots
constexpr float kEpsInside = 1e-4f;
constexpr float kDeg2Rad = 0.017453292519943295f;

// Corner k of a box is (sx(k) * w/2, sy(k) * h/2) before rotation; k is a
// compile-time constant after unrolling, so these fold away.
__device__ __forceinline__ float sx(int k) { return (k == 0 || k == 3) ? 1.f : -1.f; }
__device__ __forceinline__ float sy(int k) { return k < 2 ? 1.f : -1.f; }

// Box1's terms: centre, the four rotated half-extents, area.
struct RowTerms {
  float cx, cy, a, b, e, f, area;
};

// Box2's terms: centre, area, and per edge a point p0 and the inward unit
// normal, in box2-centred coordinates.
struct ColTerms {
  float cx, cy, area;
  float p0x[4], p0y[4], nx[4], ny[4];
};

__device__ __forceinline__ RowTerms row_terms(const float* p) {
  const float w = p[2], h = p[3];
  float s, c;
  sincosf(p[4] * kDeg2Rad, &s, &c);
  RowTerms t;
  t.cx = p[0];
  t.cy = p[1];
  t.a = c * (w * 0.5f);
  t.b = s * (h * 0.5f);
  t.e = s * (w * 0.5f);
  t.f = c * (h * 0.5f);
  t.area = w * h;
  return t;
}

__device__ __forceinline__ ColTerms col_terms(const float* p) {
  const float w = p[2], h = p[3];
  float s, c;
  sincosf(p[4] * kDeg2Rad, &s, &c);
  const float a = c * (w * 0.5f), bb = s * (h * 0.5f);
  const float e = s * (w * 0.5f), f = c * (h * 0.5f);
  float qx[4], qy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    qx[k] = sx(k) * a - sy(k) * bb;
    qy[k] = sx(k) * e + sy(k) * f;
  }
  ColTerms t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p0x = qx[k], p0y = qy[k];
    const float ex = qx[(k + 1) % 4] - p0x, ey = qy[(k + 1) % 4] - p0y;
    const float inv_len = 1.f / sqrtf(fmaxf(ex * ex + ey * ey, 1e-12f));
    const float nx = -ey * inv_len, ny = ex * inv_len;
    const float sgn = (-p0x * nx - p0y * ny) < 0.f ? -1.f : 1.f;
    t.p0x[k] = p0x;
    t.p0y[k] = p0y;
    t.nx[k] = nx * sgn;
    t.ny[k] = ny * sgn;
  }
  t.cx = p[0];
  t.cy = p[1];
  t.area = w * h;
  return t;
}

// Write point (x, y) to ring slot n (dropped when n >= 8).
__device__ __forceinline__ void place(float (&ox)[kV], float (&oy)[kV], int n,
                                      float x, float y) {
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    if (n == v) {
      ox[v] = x;
      oy[v] = y;
    }
  }
}

// One half-plane clip of the duplicate-fill ring (rx, ry), in place.
// (p0x, p0y): a point of the line; (nx, ny): its inward unit normal.
__device__ __forceinline__ void clip(float (&rx)[kV], float (&ry)[kV], float p0x,
                                     float p0y, float nx, float ny) {
  float d[kV];
  bool in[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    d[i] = (rx[i] - p0x) * nx + (ry[i] - p0y) * ny;
    in[i] = d[i] >= -kEpsInside;
  }
  float ox[kV], oy[kV];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    ox[v] = 0.f;
    oy[v] = 0.f;
  }
  int n = 0;
  float lx = 0.f, ly = 0.f;  // last emitted point (zeros if none)
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int j = (i + 1) % kV;
    const int h = (i + kV - 1) % kV;
    const bool dup = rx[i] == rx[h] && ry[i] == ry[h];
    if (in[i] && !dup) {
      place(ox, oy, n, rx[i], ry[i]);
      lx = rx[i];
      ly = ry[i];
      ++n;
    }
    if (in[i] != in[j]) {
      const float denom = d[i] - d[j];
      const float t = d[i] / (denom == 0.f ? 1.f : denom);
      const float x = rx[i] + t * (rx[j] - rx[i]);
      const float y = ry[i] + t * (ry[j] - ry[i]);
      place(ox, oy, n, x, y);
      lx = x;
      ly = y;
      ++n;
    }
  }
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    rx[v] = v < n ? ox[v] : lx;
    ry[v] = v < n ? oy[v] : ly;
  }
}

// IoU(box1, box2) from the two boxes' terms.
__device__ __forceinline__ float pair_iou(const RowTerms& r, const ColTerms& c) {
  const float rel_x = r.cx - c.cx;
  const float rel_y = r.cy - c.cy;
  float rx[kV], ry[kV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rx[k] = (rel_x + sx(k) * r.a) - sy(k) * r.b;
    ry[k] = (rel_y + sx(k) * r.e) + sy(k) * r.f;
  }
#pragma unroll
  for (int k = 4; k < kV; ++k) {
    rx[k] = rx[3];
    ry[k] = ry[3];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    clip(rx, ry, c.p0x[k], c.p0y[k], c.nx[k], c.ny[k]);
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int j = (i + 1) % kV;
    acc += rx[i] * ry[j] - ry[i] * rx[j];
  }
  const float inter = 0.5f * fabsf(acc);
  const float uni = (r.area + c.area) - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

}  // namespace riou
