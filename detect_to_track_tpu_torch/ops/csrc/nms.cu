// Greedy NMS keep-mask for Hopper (sm_90a): boxes (B, k, 4) float32 ijhw
// sorted by descending score and valid (B, k) -> keep (B, k), in two
// launches on one stream.
//
// Replaces detect_to_track_tpu/ops/nms.py::nms_mask, an XLA while_loop (the
// fixed point of keep <- valid & ~any_{j<i}(keep[j] & overlaps[j, i])), not a
// Pallas kernel. Its plain version is ops/nms.py::nms_mask_ref. Greedy NMS:
// slot i is kept iff it is valid and no kept slot j < i overlaps it by IoU >
// iou_thresh; invalid slots neither keep nor suppress. Exact, with no cap on
// the length of a suppression chain.
//
// 1. nms_mask_kernel: bit t of mask[b, i, w] (u64) is set iff j = 64 w + t
//    > i and IoU(box i, box j) > iou_thresh. One block of 64 threads per
//    (column word w, row block of 64, frame b): the 64 column boxes are
//    staged in shared memory, each thread computes its row's word. Words
//    left of the diagonal block (every j < i) are written as 0.
// 2. nms_sweep_kernel: one block per frame walks the slots in index order
//    with a `removed` bitset of ceil(k / 64) words in shared memory: slot i
//    is kept iff valid and its bit is clear, and a kept slot ORs row i of
//    the mask into `removed`, one word per thread (only words >= i / 64:
//    the row has no bit below i). keep = valid & ~removed at the end.
//
// Bitwise equal to the plain version: the IoU is computed with the same
// float32 operations in the same order as boxes.compute_ious and
// ijhw_to_ijij (corners ij -/+ hw / 2; max / min; clamp(hi - lo, 0); inter
// = dh * dw; union = (h_a * w_a + h_b * w_b) - inter; IoU 0 where union <=
// 0; NaN propagates through max, min and clamp as torch's do), each one
// correctly rounded by an _rn intrinsic: the build allows FMA contraction,
// which would round h_a * w_a + h_b * w_b differently. The threshold is
// compared in float32, as torch compares a float32 tensor with a Python
// float.
//
// What bounds it: at the working point (8 frames x 3072 slots) the IoUs
// are about 0.6 GFLOP, microseconds at the card's float32 rate, and the
// inputs and the keep-mask are 0.4 MB. The mask (B k^2 / 8 bytes, 9.4 MB)
// stays in L2. The sweep is a chain of k dependent steps and bound by
// latency: a slot that is invalid or already removed costs one
// shared-memory read, a kept slot two barriers and one L2 read per thread.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWordBits = 64;
// dynamic shared memory one block may use on Hopper
constexpr size_t kMaxSmemBytes = 232448;

// threads of a sweep block: one per bitset word, in whole warps, at most 1024
int sweep_threads(int nw) { return nw < 1024 ? (nw + 31) / 32 * 32 : 1024; }

// torch.maximum / torch.minimum / clamp(min=0): NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || a > b) ? a : b; }
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || a < b) ? a : b; }
__device__ __forceinline__ float clamp0_nan(float x) { return (x != x || x > 0.0f) ? x : 0.0f; }

struct Corners {
  float i0, j0, i1, j1, area;
};

// ijhw_to_ijij and box_areas of one box
__device__ __forceinline__ Corners corners(const float* box) {
  const float hh = __fdiv_rn(box[2], 2.0f);
  const float hw = __fdiv_rn(box[3], 2.0f);
  return {__fsub_rn(box[0], hh), __fsub_rn(box[1], hw), __fadd_rn(box[0], hh), __fadd_rn(box[1], hw),
          __fmul_rn(box[2], box[3])};
}

// compute_ious(a, b) > thresh, in compute_ious's operations and order
__device__ __forceinline__ bool iou_above(const Corners& a, const Corners& b, float thresh) {
  const float dh = clamp0_nan(__fsub_rn(min_nan(a.i1, b.i1), max_nan(a.i0, b.i0)));
  const float dw = clamp0_nan(__fsub_rn(min_nan(a.j1, b.j1), max_nan(a.j0, b.j0)));
  const float inter = __fmul_rn(dh, dw);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thresh;
}

__global__ void __launch_bounds__(kWordBits)
nms_mask_kernel(const float* __restrict__ boxes, unsigned long long* __restrict__ mask, int k, int nw,
                float thresh) {
  __shared__ Corners cols[kWordBits];
  const int w = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int i = rb * kWordBits + t;
  const float* fb = boxes + static_cast<size_t>(b) * k * 4;
  const size_t out = (static_cast<size_t>(b) * k + i) * nw + w;
  if (w < rb) {  // every column j < i
    if (i < k) mask[out] = 0ull;
    return;
  }
  const int j = w * kWordBits + t;
  if (j < k) cols[t] = corners(fb + static_cast<size_t>(j) * 4);
  __syncthreads();
  if (i >= k) return;
  const Corners a = corners(fb + static_cast<size_t>(i) * 4);
  const int n = min(kWordBits, k - w * kWordBits);
  unsigned long long bits = 0ull;
  for (int c = 0; c < n; ++c) {
    if (w * kWordBits + c > i && iou_above(a, cols[c], thresh)) bits |= 1ull << c;
  }
  mask[out] = bits;
}

__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ keep, int k, int nw) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const uint8_t* vb = valid + static_cast<size_t>(b) * k;
  const unsigned long long* mb = mask + static_cast<size_t>(b) * k * nw;
  for (int w = tid; w < nw; w += nth) removed[w] = 0ull;
  __syncthreads();
  for (int i = 0; i < k; ++i) {
    // every thread reads the same values here, and `removed` is written
    // only between the two barriers of a kept slot, so the branches are
    // uniform across the block
    if (!vb[i] || ((removed[i / kWordBits] >> (i % kWordBits)) & 1ull)) continue;
    __syncthreads();  // every thread has read removed[i / 64]
    const unsigned long long* r = mb + static_cast<size_t>(i) * nw;
    for (int w = i / kWordBits + tid; w < nw; w += nth) removed[w] |= r[w];
    __syncthreads();
  }
  // bit i is final once slot i - 1 is swept: later rows set no bit below them
  for (int i = tid; i < k; i += nth)
    keep[static_cast<size_t>(b) * k + i] = vb[i] && !((removed[i / kWordBits] >> (i % kWordBits)) & 1ull);
}

}  // namespace

extern "C" {

// shared memory of the sweep's `removed` bitset for k slots (the kernel's
// only limit on k: k up to about 1.8 million)
size_t d2t_nms_sweep_smem_bytes(int k) { return sizeof(unsigned long long) * ((k + kWordBits - 1) / kWordBits); }

// boxes: (b, k, 4) float32 ijhw, score-descending; valid: (b, k) bool as
// bytes; mask: (b, k, ceil(k / 64)) u64 scratch; keep: (b, k) bool as bytes,
// every element written. Two launches on `stream`. Returns cudaGetLastError()
// (0 on success) after each, or cudaErrorInvalidValue for shapes the kernels
// do not take.
int d2t_nms_mask(const void* boxes, const void* valid, void* mask, void* keep, int b, int k, float iou_thresh,
                 void* stream) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  const size_t smem = d2t_nms_sweep_smem_bytes(k);
  if (b < 1 || k < 1 || b > 65535 || nw > 65535 || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(nw, nw, b), kWordBits, 0, s>>>(static_cast<const float*>(boxes),
                                                         static_cast<unsigned long long*>(mask), k, nw, iou_thresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<b, sweep_threads(nw), smem, s>>>(static_cast<const unsigned long long*>(mask),
                                            static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, nw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
