// Pairwise IoU of rotated rectangles, batched: (B, N, 5) x (B, M, 5) -> (B, N, M).
//
// The counterpart of ryolo_tpu/ops/pallas_iou.py::pairwise_rotated_iou_pallas
// (tile body _iou_tile_kernel, with _clip_ring_unrolled) as a public entry
// point. The detect path does not launch it: its NMS runs the same per-pair
// arithmetic inside nms_mask (rotated_nms.cu). Row boxes are box1, column
// boxes box2; the per-pair arithmetic and its contract are in
// rotated_iou_pair.cuh, shared by both kernels.
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

#include <cuda_runtime.h>

#include "rotated_iou_pair.cuh"

namespace {

constexpr int kTN = 32;  // column boxes (box2) per block: threadIdx.x
constexpr int kTM = 8;   // row boxes (box1) per block: threadIdx.y

__global__ void __launch_bounds__(kTN * kTM)
rotated_iou_kernel(const float* __restrict__ boxes1, const float* __restrict__ boxes2,
                   float* __restrict__ out, int n_rows, int n_cols) {
  __shared__ riou::RowTerms rows[kTM];
  __shared__ riou::ColTerms cols[kTN];

  const int b = blockIdx.z;
  const int col0 = blockIdx.x * kTN;
  const int row0 = blockIdx.y * kTM;
  const float* b1 = boxes1 + static_cast<size_t>(b) * n_rows * 5;
  const float* b2 = boxes2 + static_cast<size_t>(b) * n_cols * 5;
  const int tx = threadIdx.x, ty = threadIdx.y;

  if (ty == 0 && col0 + tx < n_cols) {
    cols[tx] = riou::col_terms(b2 + static_cast<size_t>(col0 + tx) * 5);
  }
  if (ty == 1 && tx < kTM && row0 + tx < n_rows) {
    rows[tx] = riou::row_terms(b1 + static_cast<size_t>(row0 + tx) * 5);
  }
  __syncthreads();

  const int row = row0 + ty, col = col0 + tx;
  if (row >= n_rows || col >= n_cols) return;
  out[(static_cast<size_t>(b) * n_rows + row) * n_cols + col] =
      riou::pair_iou(rows[ty], cols[tx]);
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
