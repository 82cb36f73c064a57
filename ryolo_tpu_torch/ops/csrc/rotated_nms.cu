// Greedy rotated NMS over score-sorted, batched candidates, in two kernels:
// nms_mask builds the suppression bitmask, nms_scan walks it in score order.
//
// Replaces, on the detect path, the TPU kernel
// ryolo_tpu/ops/pallas_iou.py::_iou_tile_kernel as ryolo_tpu/ops/rotated_nms.py
// calls it per 64-candidate chunk (:127-182), and that function's chunk loop
// and within-chunk fixpoint (:152-212, an XLA while_loop). The function, for
// candidates e < r of one image, with ch(x) = x / 64 (the JAX chunk):
//   * e suppresses r when IoU > thr, with _iou_block's box roles: across
//     chunks (ch(e) < ch(r)) IoU(box1 = r, box2 = e), the candidate against
//     the kept buffer (:140); within a chunk IoU(box1 = e, box2 = r), the
//     self block's iou_self[e, r] (:146-150). The IoU is not symmetric at the
//     ulp level, so each orientation is computed where JAX computes it;
//   * keep[r] when r is valid, no kept e < r suppresses it, and fewer than
//     max_keep rows before r are kept;
//   * only rows below n_rows[b] = min(K, 64 * ceil(#valid / 64)) are decided
//     (the JAX loop's chunk count, :194-204); later rows are not kept.
//
// Mask layout, rows as the suppressed: mask[b][r][c] (K x ceil(K/64) 64-bit
// words per image) has bit j set when candidate 64c + j suppresses r. Only
// the words c <= ch(r) of rows r < n_rows[b] are written, by the tiles on or
// below the diagonal, and those are the only words the scan reads, so the
// mask needs no memset. In the diagonal word only bits j < r mod 64 are set.
//
// nms_mask: one block per 64 x 64 tile (row chunk R, column chunk C <= R),
// 256 threads, four per row, sixteen columns each; the four partial words
// are joined with two shuffles. The block stages, for its 64 rows, the box1
// terms and the circumscribed radius, and for its 64 columns the box2 terms,
// the radius and whether the box is large enough for the far reject; on the
// diagonal the rows and columns are the same boxes, so the same staging
// serves the same-chunk orientation (box1 = column, box2 = row). The count
// n_rows is read on the device; blocks past it exit at once.
// What bounds it: FP32 ALU work, 214+ operations for each pair that is
// clipped; the far reject takes most pairs of different classes (centres
// 4096 px apart per class) for about 12 operations.
//
// The far reject, and why it is exact. A pair whose circumscribed circles lie
// apart by more than margin = 1 px + 1e-3 * (|dx| + |dy|), with box2's sides
// both at least 1e-3 px, gets IoU 0 without clipping. The full computation
// gives exactly 0 there too:
//   * every ring point is, up to rounding, in box1 (corners, and points on
//     segments between ring points) and, once emitted by clip k, within
//     1e-4 px of half-planes 0..k of box2 (box2's sides give its edges unit
//     normals: lengths far above the 1e-12 clamp). A point emitted by all
//     four clips would lie in box1 and within 1e-4 * sqrt(2) px of box2, so
//     the two boxes would be closer than ~1.5e-4 px plus rounding. Rounding
//     at the re-centred scale is a few ulp of |dx| + |dy| + the extents
//     (~1e-6 of them), far below the margin, while the circles' gap bounds
//     the boxes' distance from below. So some clip emits no point;
//   * that clip leaves the ring at (0, 0), box2's centre, in all 8 slots.
//     Each later clip keeps it there: the centre's signed distance is
//     sgn * S, where S is the very value whose sign chose sgn, so it is
//     >= 0 and the point is inside; every slot equals its predecessor, so
//     none is emitted as a vertex, there is no crossing, and the fill point
//     is (0, 0) again;
//   * the shoelace of that ring is 0, so the IoU is 0 (0 / union, or 0 when
//     union <= 0). The bit is then 0 > thr, the same as the full
//     computation's for every thr. NaN coordinates fail the reject's
//     comparison and take the full computation.
//
// nms_scan: one block of 1024 threads per image walks the chunks in order,
// keeping a kept bitset (one word per chunk) in shared memory. Per chunk, 32
// warps test two rows each against the kept words of the earlier chunks
// (lanes split the words, one vote per row); then one thread runs the
// within-chunk greedy over the 64 diagonal words with the max_keep cap. It
// stops at max_keep or at n_rows[b], and writes keep (B, K) as bytes.
// What bounds it: the words it reads (64-bit, (R + 1) per row of chunk R) and
// the chain of chunks, each waiting for the one before.
//
// Built with --fmad=false (see rotated_iou_pair.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "rotated_iou_pair.cuh"

namespace {

constexpr int kC = 64;                 // chunk: rows and columns of a tile
constexpr int kQ = 4;                  // mask threads per row
constexpr int kScanThreads = 1024;
constexpr float kFarMarginPx = 1.f;    // the far reject; chip_smoke.py
constexpr float kFarMarginRel = 1e-3f; // repeats these three for its
constexpr float kMinSide = 1e-3f;      // bound and probes

__device__ __forceinline__ float radius(const float* p) {
  return 0.5f * sqrtf(p[2] * p[2] + p[3] * p[3]);
}

// Circumscribed circles (centres (x1, y1), (x2, y2)) apart by more than the
// margin.
__device__ __forceinline__ bool far_apart(float x1, float y1, float r1, float x2,
                                          float y2, float r2) {
  const float dx = x1 - x2, dy = y1 - y2;
  const float reach =
      (r1 + r2) + (kFarMarginPx + kFarMarginRel * (fabsf(dx) + fabsf(dy)));
  return dx * dx + dy * dy > reach * reach;
}

__global__ void __launch_bounds__(kC * kQ)
nms_mask_kernel(const float* __restrict__ boxes, const int* __restrict__ n_rows,
                uint64_t* __restrict__ mask, int k, int nw, float thr) {
  // blockIdx.x numbers the tiles on or below the diagonal row chunk by row
  // chunk: tile t is (R, C) with t = R (R + 1) / 2 + C, C <= R
  const int t = blockIdx.x;
  int R = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((R + 1) * (R + 2) / 2 <= t) ++R;
  while (R * (R + 1) / 2 > t) --R;
  const int C = t - R * (R + 1) / 2;
  const int b = blockIdx.y;
  const int lim = n_rows[b];
  if (R * kC >= lim) return;

  __shared__ riou::RowTerms rt[kC];  // box1 terms of the row chunk
  __shared__ riou::ColTerms ct[kC];  // box2 terms of the column chunk
  __shared__ float r_rad[kC], c_rad[kC];
  __shared__ bool c_big[kC];

  const float* bb = boxes + static_cast<size_t>(b) * k * 5;
  const int tid = threadIdx.x;
  if (tid < kC) {
    const int r = R * kC + tid;
    if (r < k) {
      const float* p = bb + static_cast<size_t>(r) * 5;
      rt[tid] = riou::row_terms(p);
      r_rad[tid] = radius(p);
    }
  } else if (tid < 2 * kC) {
    const int x = tid - kC, e = C * kC + x;
    if (e < k) {
      const float* p = bb + static_cast<size_t>(e) * 5;
      ct[x] = riou::col_terms(p);
      c_rad[x] = radius(p);
      c_big[x] = fabsf(p[2]) >= kMinSide && fabsf(p[3]) >= kMinSide;
    }
  }
  __syncthreads();

  const int i = tid / kQ, q = tid % kQ;  // row i of the tile, column quarter q
  const int r = R * kC + i;
  const bool diag = C == R;
  unsigned long long word = 0;
  if (r < lim) {
    const int j_end = diag ? min((q + 1) * (kC / kQ), i) : (q + 1) * (kC / kQ);
    for (int j = q * (kC / kQ); j < j_end; ++j) {
      // across chunks IoU(box1 = row r, box2 = column e); within the chunk
      // IoU(box1 = column e, box2 = row r), the same tile staged both ways
      const int i1 = diag ? j : i;
      const int i2 = diag ? i : j;
      const bool far = c_big[i2] && far_apart(rt[i1].cx, rt[i1].cy, r_rad[i1],
                                              ct[i2].cx, ct[i2].cy, c_rad[i2]);
      const float iou = far ? 0.f : riou::pair_iou(rt[i1], ct[i2]);
      if (iou > thr) word |= 1ull << j;
    }
  }
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  if (q == 0 && r < lim) {
    mask[(static_cast<size_t>(b) * k + r) * nw + C] = word;
  }
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint64_t* __restrict__ mask, const uint8_t* __restrict__ valid,
                const int* __restrict__ n_rows, uint8_t* __restrict__ keep, int k,
                int nw, int max_keep) {
  extern __shared__ uint64_t kept[];  // bit j of word c: row 64c + j kept
  __shared__ bool base[kC];           // valid, decided, not hit by an earlier chunk
  __shared__ uint64_t diag_word[kC];
  __shared__ int count_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lim = n_rows[b];
  const uint64_t* mb = mask + static_cast<size_t>(b) * k * nw;
  const uint8_t* vb = valid + static_cast<size_t>(b) * k;
  for (int c = tid; c < nw; c += kScanThreads) kept[c] = 0;
  if (tid == 0) count_s = 0;
  __syncthreads();

  int count = 0;  // rows kept so far, the same in every thread
  for (int R = 0; R * kC < lim && count < max_keep; ++R) {
    for (int i = warp; i < kC; i += kScanThreads / 32) {
      const int r = R * kC + i;
      const bool live = r < lim;
      const uint64_t* row = mb + static_cast<size_t>(r) * nw;
      const uint64_t dw = live && lane == 0 ? row[R] : 0;
      const bool v = live && lane == 0 && vb[r] != 0;
      bool hit = false;
      if (live) {
        for (int c = lane; c < R; c += 32) hit |= (row[c] & kept[c]) != 0;
      }
      hit = __any_sync(0xffffffffu, hit);
      if (lane == 0) {
        base[i] = v && !hit;
        diag_word[i] = dw;
      }
    }
    __syncthreads();
    if (tid == 0) {
      uint64_t w = 0;
      int n = count;
      for (int i = 0; i < kC && n < max_keep; ++i) {
        if (base[i] && (diag_word[i] & w) == 0) {
          w |= 1ull << i;
          ++n;
        }
      }
      kept[R] = w;
      count_s = n;
    }
    __syncthreads();
    count = count_s;
  }
  for (int r = tid; r < k; r += kScanThreads) {
    keep[static_cast<size_t>(b) * k + r] =
        static_cast<uint8_t>((kept[r / kC] >> (r % kC)) & 1ull);
  }
}

}  // namespace

// mask: (batch, k, ceil(k / 64)) 64-bit words; boxes (batch, k, 5) float32;
// n_rows (batch,) int32. Launch on `stream` (a cudaStream_t). Returns
// cudaGetLastError() as an int.
extern "C" int nms_mask_launch(const float* boxes, const int* n_rows, void* mask,
                               int batch, int k, float thr, void* stream) {
  const int nw = (k + kC - 1) / kC;
  const dim3 grid(nw * (nw + 1) / 2, batch);
  nms_mask_kernel<<<grid, kC * kQ, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes, n_rows, static_cast<uint64_t*>(mask), k, nw, thr);
  return static_cast<int>(cudaGetLastError());
}

// keep, valid: (batch, k) bytes (torch.bool). Needs ceil(k / 64) * 8 bytes of
// dynamic shared memory per block on top of under 1 KiB of static, within
// the default 48 KiB: k <= 385024 (ops/cuda_nms.py MAX_K).
extern "C" int nms_scan_launch(const void* mask, const uint8_t* valid,
                               const int* n_rows, uint8_t* keep, int batch, int k,
                               int max_keep, void* stream) {
  const int nw = (k + kC - 1) / kC;
  nms_scan_kernel<<<batch, kScanThreads, nw * sizeof(uint64_t),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(mask), valid, n_rows, keep, k, nw, max_keep);
  return static_cast<int>(cudaGetLastError());
}
