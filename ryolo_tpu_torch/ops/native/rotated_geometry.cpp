// Host rotated-box geometry for the eval matcher: exact pairwise skew-IoU
// and the per-image match of detections to ground truth, on the CPU.
//
// A copy of ryolo_tpu/ops/native/rotated_geometry.cpp with the same
// arithmetic, so the port's TP flags equal the JAX package's on the same
// host.  Its nms_rotated is left out: the port's NMS runs on the device
// (ops/rotated_nms.py).  Box convention matches detectron2: (cx, cy, w, h,
// angle_degrees), w along local x before rotation.
//
// Algorithm: Sutherland–Hodgman clipping of rectangle A by the four
// half-planes of rectangle B, with early exits and double precision.
//
// Exposed via a minimal C ABI for ctypes (ops/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

constexpr double kPi = 3.14159265358979323846;

void rect_corners(const float* box, Pt out[4]) {
  const double cx = box[0], cy = box[1];
  const double hw = box[2] * 0.5, hh = box[3] * 0.5;
  const double t = box[4] * kPi / 180.0;
  const double c = std::cos(t), s = std::sin(t);
  const double dx[4] = {hw, -hw, -hw, hw};
  const double dy[4] = {hh, hh, -hh, -hh};
  for (int i = 0; i < 4; ++i) {
    out[i].x = cx + c * dx[i] - s * dy[i];
    out[i].y = cy + s * dx[i] + c * dy[i];
  }
}

double polygon_area(const Pt* poly, int n) {
  if (n < 3) return 0.0;
  double acc = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& a = poly[i];
    const Pt& b = poly[(i + 1) % n];
    acc += a.x * b.y - a.y * b.x;
  }
  return std::abs(acc) * 0.5;
}

// Clip `poly` (n vertices) against the half-plane through p0 with inward
// normal nrm; writes result into `out`, returns new count (<= n + 1).
int clip_halfplane(const Pt* poly, int n, Pt p0, Pt nrm, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = poly[i];
    const Pt& nxt = poly[(i + 1) % n];
    const double dc = (cur.x - p0.x) * nrm.x + (cur.y - p0.y) * nrm.y;
    const double dn = (nxt.x - p0.x) * nrm.x + (nxt.y - p0.y) * nrm.y;
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      const double t = dc / (dc - dn);
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

double intersection_area(const float* b1, const float* b2) {
  Pt poly[16], tmp[16], clip[4];
  rect_corners(b1, poly);
  rect_corners(b2, clip);
  const Pt center2 = {b2[0], b2[1]};
  int n = 4;
  for (int e = 0; e < 4 && n > 0; ++e) {
    const Pt& p0 = clip[e];
    const Pt& p1 = clip[(e + 1) % 4];
    Pt nrm = {-(p1.y - p0.y), p1.x - p0.x};
    const double ref =
        (center2.x - p0.x) * nrm.x + (center2.y - p0.y) * nrm.y;
    if (ref < 0) {
      nrm.x = -nrm.x;
      nrm.y = -nrm.y;
    }
    n = clip_halfplane(poly, n, p0, nrm, tmp);
    std::memcpy(poly, tmp, sizeof(Pt) * n);
  }
  return polygon_area(poly, n);
}

double iou_single(const float* b1, const float* b2) {
  const double a1 = double(b1[2]) * b1[3];
  const double a2 = double(b2[2]) * b2[3];
  // cheap reject: circumscribed-circle distance test
  const double dx = double(b1[0]) - b2[0], dy = double(b1[1]) - b2[1];
  const double r1 = std::hypot(double(b1[2]), double(b1[3])) * 0.5;
  const double r2 = std::hypot(double(b2[2]), double(b2[3])) * 0.5;
  if (dx * dx + dy * dy > (r1 + r2) * (r1 + r2)) return 0.0;
  const double inter = intersection_area(b1, b2);
  const double uni = a1 + a2 - inter;
  return uni > 0 ? inter / uni : 0.0;
}

}  // namespace

extern "C" {

// boxes1: (n, 5) float32, boxes2: (m, 5) float32, out: (n, m) float32
void pairwise_rotated_iou(const float* boxes1, int64_t n, const float* boxes2,
                          int64_t m, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* b1 = boxes1 + i * 5;
    for (int64_t j = 0; j < m; ++j) {
      out[i * m + j] = float(iou_single(b1, boxes2 + j * 5));
    }
  }
}

// Per-image eval matcher (the reference protocol of test.py:121-145):
// predictions in confidence-descending order each claim their argmax
// same-class target iff IoU > iouv[0] and the target is unclaimed; the
// TP flag at threshold j is (IoU > iouv[j]).
//
// Bit-identical to the per-class numpy matcher of eval/metrics.py
// (match_image_detections_plain): IoU values round through float32 before
// the threshold compares (the numpy path stores the pairwise matrix as
// f32), argmax keeps the FIRST max (strict >), and first-claim-per-target
// equals the unique-first-index formulation.
//
// pred_geom: (n, 5) degree boxes in confidence order; pred_cls: (n,);
// tar_geom: (m, 5); tar_cls: (m,); iouv: (k,) float64 ascending;
// tp_out: (n, k) uint8 (written 0/1).
void match_rotated(const float* pred_geom, const float* pred_cls, int64_t n,
                   const float* tar_geom, const float* tar_cls, int64_t m,
                   const double* iouv, int64_t k, uint8_t* tp_out) {
  std::memset(tp_out, 0, size_t(n) * k);
  if (n == 0 || m == 0) return;
  std::vector<char> claimed(m, 0);
  for (int64_t i = 0; i < n; ++i) {
    const float* pb = pred_geom + i * 5;
    const float pc = pred_cls[i];
    float best = -1.0f;
    int64_t best_j = -1;
    for (int64_t j = 0; j < m; ++j) {
      if (tar_cls[j] != pc) continue;
      const float iou = float(iou_single(pb, tar_geom + j * 5));
      if (iou > best) {  // strict: first max wins, like np.argmax
        best = iou;
        best_j = j;
      }
    }
    if (best_j < 0 || !(double(best) > iouv[0]) || claimed[best_j]) continue;
    claimed[best_j] = 1;
    for (int64_t t = 0; t < k; ++t) {
      tp_out[i * k + t] = double(best) > iouv[t] ? 1 : 0;
    }
  }
}

}  // extern "C"
