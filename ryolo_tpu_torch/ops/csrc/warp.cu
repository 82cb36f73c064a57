// Affine bilinear warp of mosaic canvases down to training images, batched:
// (B, 3, C, C) uint8 planar x-major canvases + (B, 2, 3) inverse affines
// -> (B, 3, s, s) float32 NCHW images holding integers in [0, 255].
//
// Replaces the TPU kernel ryolo_tpu/ops/pallas_warp.py::warp_canvas_planar
// (_warp_kernel / _warp_tile_body). Contract kept from it, and from the plain
// PyTorch version ryolo_tpu_torch/ops/warp.py::warp_canvas_plain (itself the
// port of device_augment._warp_block):
//   * output pixel (row oy, col ox) maps to cx = (m0*ox + m1*oy) + m2 and
//     cy = (m3*ox + m4*oy) + m5; x0 = floor(cx), fx = cx - x0, same for y;
//   * canvas[b, c, X, Y] holds canvas cell (X-1, Y-1) (Y contiguous); the
//     taps are (bx, by), (bx+1, by), (bx, by+1), (bx+1, by+1) with
//     bx = x0 + 1, by = y0 + 1, and a tap past index C-1 reads PAD 114;
//   * a pixel with x0 or y0 outside [-1, C-2] is PAD; the blend
//     c00*((1-fx)(1-fy)) + c01*(fx(1-fy)) + c10*((1-fx)fy) + c11*(fx*fy) is
//     summed left to right and rounded half to even (rintf);
//   * an inactive spec (active[b] == 0) is PAD-filled without reading its
//     canvas.
// Every product and sum is an explicit __fmul_rn / __fadd_rn (and the build
// passes --fmad=false), so nothing is contracted into an FMA: the kernel
// rounds exactly as the plain version does, and the two agree bit for bit.
//
// What the TPU kernel did and this one does not: a TPU cannot gather, so it
// staged a 96-cell canvas window per 32x32 tile by DMA and selected taps with
// one-hot MXU matmuls (x1024 packing of both y taps), which bounded the
// affine's derivative (MAX_ROW_NORM ~3.03). Here every thread loads its own
// taps: no window, no span bound, any affine.
//
// What bounds it: bytes. A pixel needs ~40 FP32 operations and moves 12 B of
// float32 output plus the canvas cells its taps read, so at 3.35 TB/s against
// 67 TFLOP/s the writes and tap reads set the floor.
// What the design does about it (first version, kept simple): one thread per
// output pixel computes the coordinates and weights once and serves all three
// channels; a 32 x 8 block puts neighbouring threads on neighbouring output
// columns, so the float32 stores coalesce and the taps of a block fall in a
// small canvas window that L1/L2 serve. A pixel whose taps lie off the canvas
// is decided before any index is formed, so no out-of-range float reaches an
// integer cast (the TPU kernel clamps before its cast for the same reason).
// Not done yet: staging canvas windows in shared memory, wider loads.

#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;  // output columns per block: threadIdx.x
constexpr int kBY = 8;   // output rows per block: threadIdx.y
constexpr float kPad = 114.f;

__global__ void warp_kernel(const unsigned char* __restrict__ canvas,
                            const float* __restrict__ minv,
                            const int* __restrict__ active,
                            float* __restrict__ out, int C, int s) {
  const int ox = blockIdx.x * kBX + threadIdx.x;
  const int oy = blockIdx.y * kBY + threadIdx.y;
  const int b = blockIdx.z;
  if (ox >= s || oy >= s) return;
  const size_t plane = (size_t)s * s;
  float* o = out + (size_t)b * 3 * plane + (size_t)oy * s + ox;
  if (active[b] == 0) {
    o[0] = kPad;
    o[plane] = kPad;
    o[2 * plane] = kPad;
    return;
  }
  const float* m = minv + 6 * b;
  const float fox = (float)ox, foy = (float)oy;
  const float cx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], fox), __fmul_rn(m[1], foy)), m[2]);
  const float cy = __fadd_rn(__fadd_rn(__fmul_rn(m[3], fox), __fmul_rn(m[4], foy)), m[5]);
  const float x0 = floorf(cx), y0 = floorf(cy);
  const float edge = (float)(C - 2);
  // NaN coordinates fail every compare and are PAD, as in the plain version
  if (!(x0 >= -1.f && x0 <= edge && y0 >= -1.f && y0 <= edge)) {
    o[0] = kPad;
    o[plane] = kPad;
    o[2 * plane] = kPad;
    return;
  }
  const float fx = __fsub_rn(cx, x0), fy = __fsub_rn(cy, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
  const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
  const int bx = (int)x0 + 1, by = (int)y0 + 1;  // in [0, C-1] here
  const bool xin = bx + 1 <= C - 1, yin = by + 1 <= C - 1;
  const size_t r0 = (size_t)bx * C + by;
  const size_t cc = (size_t)C * C;
  const unsigned char* p = canvas + (size_t)b * 3 * cc;
#pragma unroll
  for (int c = 0; c < 3; ++c, p += cc) {
    const float c00 = p[r0];
    const float c01 = xin ? (float)p[r0 + C] : kPad;
    const float c10 = yin ? (float)p[r0 + 1] : kPad;
    const float c11 = (xin && yin) ? (float)p[r0 + C + 1] : kPad;
    float v = __fmul_rn(c00, w00);
    v = __fadd_rn(v, __fmul_rn(c01, w01));
    v = __fadd_rn(v, __fmul_rn(c10, w10));
    v = __fadd_rn(v, __fmul_rn(c11, w11));
    o[c * plane] = rintf(v);
  }
}

}  // namespace

extern "C" int warp_launch(const unsigned char* canvas, const float* minv,
                           const int* active, float* out, int B, int C, int s,
                           cudaStream_t stream) {
  if (B <= 0 || s <= 0) return 0;
  dim3 block(kBX, kBY);
  dim3 grid((s + kBX - 1) / kBX, (s + kBY - 1) / kBY, B);
  warp_kernel<<<grid, block, 0, stream>>>(canvas, minv, active, out, C, s);
  return (int)cudaGetLastError();
}
