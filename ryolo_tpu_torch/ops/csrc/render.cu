// The tap renderer of device-side augmentation, one launch per batch:
// packed tile words + a slot table -> (n_out, 3, s, s) float32 NCHW images
// in [0, 1], with mosaic paste, HSV jitter, affine bilinear warp, mixup,
// flips and /255 done per output pixel.
//
// Replaces the TPU kernel ryolo_tpu/ops/pallas_warp.py:261 warp_canvas_planar
// (body _warp_kernel :107) and absorbs the canvas stages that fed it: the
// paste (ryolo_tpu/data/device_augment.py:298 _paste_canvas), the HSV pass
// through the owner byte (:365 _hsv_canvas), and the mixup/flip tail (:648
// _mix_flip_tail). A TPU cannot gather, so the JAX package materialised a
// (3, 2s+2, 2s+2) canvas per spec and warped it with one-hot matmuls; the
// H100 gathers, so this kernel computes what the JAX package's readable
// "taps" renderer (_render_one :175) computes, straight from the tiles.
// Contract (the plain version, ryolo_tpu_torch/ops/render.py
// render_taps_plain, says the same):
//   * render pixel (row ry, col rx) of spec b: cx = (m0*rx + m1*ry) + m2,
//     cy = (m3*rx + m4*ry) + m5, x0 = floor(cx), fx = cx - x0 (same for y);
//     taps (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1);
//   * a tap's owner is the highest slot whose float region [r0, r2) x
//     [r1, r3) holds it; an unowned tap is PAD 114; an owned tap reads the
//     word tiles[row, clip(qx - offx, 0, s-1), clip(qy - offy, 0, s-1)]
//     (R | G<<8 | B<<16) and applies the slot's HSV gains unless all are 1;
//   * the blend c00*((1-fx)(1-fy)) + c01*(fx(1-fy)) + c10*((1-fx)fy) +
//     c11*(fx*fy) is summed left to right and rounded half to even (rintf);
//   * output pixel (oy, ox) of image b is render pixel (ry, rx) with
//     rx = s-1-ox under flip_lr and ry = s-1-oy under flip_ud; with a
//     partner j, floor(base*r + partner*(1-r)); then times float32 1/255.
// Every product, sum and division is an explicit __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn in the plain version's association (the build also
// passes --fmad=false), so the kernel equals the plain version bit for bit.
//
// What bounds it: bytes, by the count (12 B of float32 output per pixel
// against one 4-byte word per distinct source pixel read); in practice the
// ~40 FP32 operations of each non-identity tap's HSV round trip (3
// divisions among them), 4 taps a pixel, are of the same order, so issue
// and the gathers' latency set the pace. What the design does about it:
//   * one packed 4-byte load per tap serves all three channels (the canvas
//     warp.cu issues 12 byte loads from three planes); no canvas, no HSV
//     intermediates in device memory, partners never written out;
//   * a block renders a 32 x 8 tile of one output image; its spec (affine,
//     slots, gains, flips, mix) and its partner's are staged in shared
//     memory once, by warp 0;
//   * slot culling: the affine is monotone in each output coordinate, so
//     the block tile's four corners bound every tap it can reach; warp 0
//     keeps only the slots whose region meets that window (a ballot, one
//     bit per slot) and each tap's owner search walks those bits from the
//     highest down, usually 1-2 of the 9;
//   * warp footprint: a warp covers 8 columns x 4 rows, so its taps fall in
//     few 32-byte sectors of the x-major tile rows (a 32-column row would
//     stride one word per sector), and each store is 4 full sectors;
//   * a base pixel with a mixup partner gathers the partner's 4 taps in the
//     same thread.
// A tap coordinate that is NaN, infinite or far off the canvas is in no
// region, so it never reaches the float -> int cast; an owned one is
// clipped to [0, s-1] before it. Not done: HSV lookup tables per slot, and
// staging tile windows in shared memory (cp.async/TMA); L1 serves the
// neighbouring taps.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxT = 16;    // slots per spec: one 16-bit half of a ballot
constexpr int kTileX = 32;   // output columns per block
constexpr int kTileY = 8;    // output rows per block
constexpr int kThreads = 256;
constexpr float kPad = 114.f;

// float32 reciprocals of 30 and 255, np.float32(1) / np.float32(c): the plain
// version multiplies by them as XLA compiles a division by a constant
__device__ __forceinline__ float rcp30() { return __int_as_float(0x3d088889); }
__device__ __forceinline__ float rcp255() { return __int_as_float(0x3b808081); }

struct Slot {
  float r0, r1, r2, r3;  // region [r0, r2) x [r1, r3) in canvas cells
  float offx, offy;      // canvas -> source translation
  float gh, gs, gv;      // HSV gains
  int row;               // tile row
  int ident;             // all three gains are 1: no HSV round trip
};

struct Spec {
  float m[6];     // output -> canvas affine
  unsigned keep;  // slots whose region meets the block's tap window
  Slot slot[kMaxT];
};

// torch.remainder / jnp.remainder by 180: the sign of the divisor
__device__ __forceinline__ float mod180(float a) {
  float m = fmodf(a, 180.f);
  if (m != 0.f && m < 0.f) m = __fadd_rn(m, 180.f);
  return m;
}

// ryolo_tpu_torch/ops/hsv.py _hsv_jitter_planar, expression by expression
__device__ __forceinline__ void hsv_jitter(float& r, float& g, float& b,
                                           float gh, float gs, float gv) {
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float d = __fsub_rn(mx, mn);
  const float safe = d > 0.f ? d : 1.f;
  float h;
  if (mx == r) {
    h = __fdiv_rn(__fsub_rn(g, b), safe);
  } else if (mx == g) {
    h = __fadd_rn(2.f, __fdiv_rn(__fsub_rn(b, r), safe));
  } else {
    h = __fadd_rn(4.f, __fdiv_rn(__fsub_rn(r, g), safe));
  }
  h = d > 0.f ? __fmul_rn(h, 30.f) : 0.f;
  if (h < 0.f) h = __fadd_rn(h, 180.f);
  h = rintf(h);
  if (h >= 180.f) h = 0.f;
  float s = mx > 0.f ? rintf(__fdiv_rn(__fmul_rn(255.f, d), mx)) : 0.f;
  float v = mx;
  // the jitter: hue wraps at 180, saturation and value clip at 255
  h = mod180(floorf(__fmul_rn(h, gh)));
  s = fminf(fmaxf(floorf(__fmul_rn(s, gs)), 0.f), 255.f);
  v = fminf(fmaxf(floorf(__fmul_rn(v, gv)), 0.f), 255.f);
  // back to RGB (cv2's 8-bit convention)
  const float h6 = __fmul_rn(h, rcp30());
  const float fi = floorf(h6);
  const float f = __fsub_rn(h6, fi);
  const float sf = __fmul_rn(s, rcp255());
  const float p = __fmul_rn(v, __fsub_rn(1.f, sf));
  const float q = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(sf, f)));
  const float t =
      __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(sf, __fsub_rn(1.f, f))));
  float ro, go, bo;
  switch ((int)fi % 6) {  // h in [0, 180): sector 0..5
    case 0: ro = v; go = t; bo = p; break;
    case 1: ro = q; go = v; bo = p; break;
    case 2: ro = p; go = v; bo = t; break;
    case 3: ro = p; go = q; bo = v; break;
    case 4: ro = t; go = p; bo = v; break;
    default: ro = v; go = p; bo = q; break;
  }
  r = rintf(ro);
  g = rintf(go);
  b = rintf(bo);
}

// One tap: owner search over the kept slots, highest first, then the word
__device__ __forceinline__ void tap(const int* __restrict__ tiles,
                                    const Spec& sp, float qx, float qy, int s,
                                    float c[3]) {
  unsigned m = sp.keep;
  while (m) {
    const int k = 31 - __clz(m);
    const Slot& sl = sp.slot[k];
    if (qx >= sl.r0 && qx < sl.r2 && qy >= sl.r1 && qy < sl.r3) {
      const float edge = (float)(s - 1);
      const int sx = (int)fminf(fmaxf(__fsub_rn(qx, sl.offx), 0.f), edge);
      const int sy = (int)fminf(fmaxf(__fsub_rn(qy, sl.offy), 0.f), edge);
      const int w = __ldg(tiles + ((size_t)sl.row * s + sx) * s + sy);
      c[0] = (float)(w & 0xFF);
      c[1] = (float)((w >> 8) & 0xFF);
      c[2] = (float)((w >> 16) & 0xFF);
      if (!sl.ident) hsv_jitter(c[0], c[1], c[2], sl.gh, sl.gs, sl.gv);
      return;
    }
    m ^= 1u << k;
  }
  c[0] = c[1] = c[2] = kPad;
}

// Render pixel (ry, rx) of one spec: 4 taps, blend, rint
__device__ __forceinline__ void render_px(const int* __restrict__ tiles,
                                          const Spec& sp, float rx, float ry,
                                          int s, float out[3]) {
  const float cx = __fadd_rn(__fadd_rn(__fmul_rn(sp.m[0], rx),
                                       __fmul_rn(sp.m[1], ry)), sp.m[2]);
  const float cy = __fadd_rn(__fadd_rn(__fmul_rn(sp.m[3], rx),
                                       __fmul_rn(sp.m[4], ry)), sp.m[5]);
  const float x0 = floorf(cx), y0 = floorf(cy);
  const float fx = __fsub_rn(cx, x0), fy = __fsub_rn(cy, y0);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gx, gy), w01 = __fmul_rn(fx, gy);
  const float w10 = __fmul_rn(gx, fy), w11 = __fmul_rn(fx, fy);
  float c00[3], c01[3], c10[3], c11[3];
  tap(tiles, sp, x0, y0, s, c00);
  tap(tiles, sp, x1, y0, s, c01);
  tap(tiles, sp, x0, y1, s, c10);
  tap(tiles, sp, x1, y1, s, c11);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = __fmul_rn(c00[c], w00);
    v = __fadd_rn(v, __fmul_rn(c01[c], w01));
    v = __fadd_rn(v, __fmul_rn(c10[c], w10));
    v = __fadd_rn(v, __fmul_rn(c11[c], w11));
    out[c] = rintf(v);
  }
}

// Lane p*16 + k of warp 0 stages slot k of spec p (0 the base, 1 the partner)
// and decides whether it can own a tap of the block: the render rectangle
// [rx0, rx1] x [ry0, ry1] maps to coordinates bounded by its four corners
// (each rounded product and sum is monotone in its operand), so every tap
// lies in [floor(min), floor(max) + 1] on each axis.
__device__ __forceinline__ bool stage_slot(const int* __restrict__ rec, int k,
                                           int rx0, int rx1, int ry0, int ry1,
                                           Spec& sp) {
  const int* w = rec + 6 + 10 * k;
  Slot sl;
  sl.r0 = __int_as_float(w[0]);
  sl.r1 = __int_as_float(w[1]);
  sl.r2 = __int_as_float(w[2]);
  sl.r3 = __int_as_float(w[3]);
  sl.offx = __int_as_float(w[4]);
  sl.offy = __int_as_float(w[5]);
  sl.gh = __int_as_float(w[6]);
  sl.gs = __int_as_float(w[7]);
  sl.gv = __int_as_float(w[8]);
  sl.row = w[9];
  sl.ident = sl.gh == 1.f && sl.gs == 1.f && sl.gv == 1.f;
  sp.slot[k] = sl;
  float m[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) m[j] = __int_as_float(rec[j]);
  float xlo = 0.f, xhi = 0.f, ylo = 0.f, yhi = 0.f;
  bool nan = false;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const float rx = (float)(corner & 1 ? rx1 : rx0);
    const float ry = (float)(corner & 2 ? ry1 : ry0);
    const float cx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], rx),
                                         __fmul_rn(m[1], ry)), m[2]);
    const float cy = __fadd_rn(__fadd_rn(__fmul_rn(m[3], rx),
                                         __fmul_rn(m[4], ry)), m[5]);
    nan |= isnan(cx) || isnan(cy);
    xlo = corner ? fminf(xlo, cx) : cx;
    xhi = corner ? fmaxf(xhi, cx) : cx;
    ylo = corner ? fminf(ylo, cy) : cy;
    yhi = corner ? fmaxf(yhi, cy) : cy;
  }
  if (!(sl.r2 > sl.r0 && sl.r3 > sl.r1)) return false;  // owns nothing
  if (nan) return true;  // no bound: keep the slot
  const float qx_lo = floorf(xlo), qx_hi = __fadd_rn(floorf(xhi), 1.f);
  const float qy_lo = floorf(ylo), qy_hi = __fadd_rn(floorf(yhi), 1.f);
  return !(qx_hi < sl.r0 || qx_lo >= sl.r2 || qy_hi < sl.r1 ||
           qy_lo >= sl.r3);
}

__global__ void __launch_bounds__(kThreads)
render_kernel(const int* __restrict__ tiles, const int* __restrict__ table,
              float* __restrict__ out, int T, int s) {
  __shared__ Spec spec[2];
  const int b = blockIdx.z;
  const int W = 10 + 10 * T;
  const int* rec = table + (size_t)b * W;
  const int flip_lr = rec[W - 4], flip_ud = rec[W - 3], mix = rec[W - 2];
  const float mix_r = __int_as_float(rec[W - 1]);
  // the block's output tile, and its render rectangle under the flips
  const int ox0 = blockIdx.x * kTileX, oy0 = blockIdx.y * kTileY;
  const int ox1 = min(ox0 + kTileX, s) - 1, oy1 = min(oy0 + kTileY, s) - 1;
  const int rx0 = flip_lr ? s - 1 - ox1 : ox0;
  const int rx1 = flip_lr ? s - 1 - ox0 : ox1;
  const int ry0 = flip_ud ? s - 1 - oy1 : oy0;
  const int ry1 = flip_ud ? s - 1 - oy0 : oy1;
  if (threadIdx.x < 32) {
    const int p = threadIdx.x >> 4, k = threadIdx.x & 15;
    const int sb = p ? mix : b;
    bool keep = false;
    if (k < 6 && sb >= 0) {
      spec[p].m[k] = __int_as_float(table[(size_t)sb * W + k]);
    }
    if (k < T && sb >= 0) {
      keep = stage_slot(table + (size_t)sb * W, k, rx0, rx1, ry0, ry1,
                        spec[p]);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    if (threadIdx.x == 0) {
      spec[0].keep = bits & 0xffffu;
      spec[1].keep = bits >> 16;
    }
  }
  __syncthreads();

  // warp w covers columns (w & 3) * 8 .. +8 and rows (w >> 2) * 4 .. +4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ox = ox0 + (warp & 3) * 8 + (lane & 7);
  const int oy = oy0 + (warp >> 2) * 4 + (lane >> 3);
  if (ox >= s || oy >= s) return;
  const float rx = (float)(flip_lr ? s - 1 - ox : ox);
  const float ry = (float)(flip_ud ? s - 1 - oy : oy);
  float v[3];
  render_px(tiles, spec[0], rx, ry, s, v);
  if (mix >= 0) {
    float pv[3];
    render_px(tiles, spec[1], rx, ry, s, pv);
    const float r1 = __fsub_rn(1.f, mix_r);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = floorf(__fadd_rn(__fmul_rn(v[c], mix_r), __fmul_rn(pv[c], r1)));
    }
  }
  const size_t plane = (size_t)s * s;
  float* o = out + (size_t)b * 3 * plane + (size_t)oy * s + ox;
  o[0] = __fmul_rn(v[0], rcp255());
  o[plane] = __fmul_rn(v[1], rcp255());
  o[2 * plane] = __fmul_rn(v[2], rcp255());
}

}  // namespace

static_assert(sizeof(Spec) * 2 <= 48 * 1024, "static shared memory");

extern "C" int render_launch(const int* tiles, const int* table, float* out,
                             int n_out, int T, int s, cudaStream_t stream) {
  if (n_out <= 0 || s <= 0) return 0;
  if (T < 0 || T > kMaxT) return (int)cudaErrorInvalidValue;
  dim3 grid((s + kTileX - 1) / kTileX, (s + kTileY - 1) / kTileY, n_out);
  render_kernel<<<grid, kThreads, 0, stream>>>(tiles, table, out, T, s);
  return (int)cudaGetLastError();
}
