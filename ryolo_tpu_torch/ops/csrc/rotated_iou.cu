// Pairwise IoU of rotated rectangles, batched: (B, N, 5) x (B, M, 5) -> (B, N, M).
//
// Replaces the TPU kernel ryolo_tpu/ops/pallas_iou.py::_iou_tile_kernel (with
// _clip_ring_unrolled), reached through pairwise_rotated_iou_pallas. Boxes are
// (cx, cy, w, h, angle_deg). Contract kept from it, and from the plain PyTorch
// version in ryolo_tpu_torch/ops/rotated_iou.py:
//   * each pair is re-centred on box2 before any corner is formed (the NMS
//     shifts centres by class * 4096, up to ~61k px: without the re-centring
//     f32 cancellation corrupts every high-class IoU);
//   * box1's corners form an 8-slot duplicate-fill ring; four Sutherland-Hodgman
//     clips against box2's edges use unit inward normals (sign rule of
//     pallas_iou.py:122-123) and count a vertex within 1e-4 px as inside;
//   * a vertex equal to its predecessor is not emitted, emitted points are
//     compacted in order, the ring is filled up with the last one;
//   * the shoelace formula gives the area; zero-size boxes give 0, and
//     union <= 0 gives 0.
//
// What bounds it: FP32 ALU work. A pair needs at least 214 FP32 operations
// (four clips of an 8-vertex ring, 8 more per edge crossing) plus as many
// compares and selects, and moves 4 bytes of output; inputs are 20 bytes per
// box and each box is shared by a whole row or column of pairs, so bytes are
// negligible.
// What the design does about it:
//   * one pair per thread; a 32 x 8 block stages its 32 column boxes and 8 row
//     boxes in shared memory once, with everything that depends on one box
//     only (sin/cos, corner offsets, box2's edge points and inward normals,
//     areas), so a pair pays only for its own arithmetic;
//   * the rings live in registers: every loop is unrolled over compile-time
//     indices and the compaction writes slot v under a runtime compare
//     (n == v), so no per-thread array is indexed dynamically (no local
//     memory; see the -Xptxas -v report kept beside the library);
//   * the TPU kernel's one-hot compaction (a TPU has no per-lane control flow)
//     is not carried over: a predicated select per ring slot replaces it.
// Built with --fmad=false so that products and sums round as the plain version
// rounds them.

#include <cuda_runtime.h>

namespace {

constexpr int kV = 8;           // ring slots
constexpr int kTN = 32;         // column boxes (box2) per block: threadIdx.x
constexpr int kTM = 8;          // row boxes (box1) per block: threadIdx.y
constexpr float kEpsInside = 1e-4f;
constexpr float kDeg2Rad = 0.017453292519943295f;
// Corner k of a box is (sx(k) * w/2, sy(k) * h/2) before rotation; k is a
// compile-time constant after unrolling, so these fold away.
__device__ __forceinline__ float sx(int k) { return (k == 0 || k == 3) ? 1.f : -1.f; }
__device__ __forceinline__ float sy(int k) { return k < 2 ? 1.f : -1.f; }

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

__global__ void __launch_bounds__(kTN * kTM)
rotated_iou_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
                   float* __restrict__ out, int n_rows, int n_cols) {
  // Per-box terms. Row box (box1): centre, the four rotated half-extents,
  // area. Column box (box2): centre, area, and per edge a point p0 and the
  // inward unit normal, in box2-centred coordinates.
  __shared__ float r_cx[kTM], r_cy[kTM], r_a[kTM], r_b[kTM], r_e[kTM], r_f[kTM],
      r_area[kTM];
  __shared__ float c_cx[kTN], c_cy[kTN], c_area[kTN];
  __shared__ float c_p0x[4][kTN], c_p0y[4][kTN], c_nx[4][kTN], c_ny[4][kTN];

  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kTN;
  const int row0 = blockIdx.y * kTM;
  const float* b1 = boxes1 + static_cast<size_t>(b) * n_rows * 5;
  const float* b2 = boxes2 + static_cast<size_t>(b) * n_cols * 5;
  const int tx = threadIdx.x, ty = threadIdx.y;

  if (ty == 0 && col0 + tx < n_cols) {
    const float* p = b2 + static_cast<size_t>(col0 + tx) * 5;
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
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float p0x = qx[k], p0y = qy[k];
      const float ex = qx[(k + 1) % 4] - p0x, ey = qy[(k + 1) % 4] - p0y;
      const float inv_len = 1.f / sqrtf(fmaxf(ex * ex + ey * ey, 1e-12f));
      const float nx = -ey * inv_len, ny = ex * inv_len;
      const float sgn = (-p0x * nx - p0y * ny) < 0.f ? -1.f : 1.f;
      c_p0x[k][tx] = p0x;
      c_p0y[k][tx] = p0y;
      c_nx[k][tx] = nx * sgn;
      c_ny[k][tx] = ny * sgn;
    }
    c_cx[tx] = p[0];
    c_cy[tx] = p[1];
    c_area[tx] = w * h;
  }
  if (ty == 1 && tx < kTM && row0 + tx < n_rows) {
    const float* p = b1 + static_cast<size_t>(row0 + tx) * 5;
    const float w = p[2], h = p[3];
    float s, c;
    sincosf(p[4] * kDeg2Rad, &s, &c);
    r_cx[tx] = p[0];
    r_cy[tx] = p[1];
    r_a[tx] = c * (w * 0.5f);
    r_b[tx] = s * (h * 0.5f);
    r_e[tx] = s * (w * 0.5f);
    r_f[tx] = c * (h * 0.5f);
    r_area[tx] = w * h;
  }
  __syncthreads();

  const int row = row0 + ty, col = col0 + tx;
  if (row >= n_rows || col >= n_cols) return;

  const float rel_x = r_cx[ty] - c_cx[tx];
  const float rel_y = r_cy[ty] - c_cy[tx];
  float rx[kV], ry[kV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rx[k] = (rel_x + sx(k) * r_a[ty]) - sy(k) * r_b[ty];
    ry[k] = (rel_y + sx(k) * r_e[ty]) + sy(k) * r_f[ty];
  }
#pragma unroll
  for (int k = 4; k < kV; ++k) {
    rx[k] = rx[3];
    ry[k] = ry[3];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    clip(rx, ry, c_p0x[k][tx], c_p0y[k][tx], c_nx[k][tx], c_ny[k][tx]);
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int j = (i + 1) % kV;
    acc += rx[i] * ry[j] - ry[i] * rx[j];
  }
  const float inter = 0.5f * fabsf(acc);
  const float uni = (r_area[ty] + c_area[tx]) - inter;
  out[(static_cast<size_t>(b) * n_rows + row) * n_cols + col] =
      uni > 0.f ? inter / uni : 0.f;
}

}  // namespace

// Launch on `stream` (a cudaStream_t). Returns cudaGetLastError() as an int.
extern "C" int rotated_iou_launch(const float* boxes1, const float* boxes2, float* out,
                                  int batch, int n_rows, int n_cols, void* stream) {
  const dim3 block(kTN, kTM);
  const dim3 grid((n_cols + kTN - 1) / kTN, (n_rows + kTM - 1) / kTM, batch);
  rotated_iou_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes1, boxes2, out, n_rows, n_cols);
  return static_cast<int>(cudaGetLastError());
}
