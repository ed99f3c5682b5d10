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
// 2. nms_sweep_kernel: one block per frame resolves the slots 64 at a time,
//    one mask word w after the other, with a `dead` bitset of ceil(k / 64)
//    words in shared memory (bit set: invalid, past k, suppressed, or, once
//    its word is resolved, not kept), one barrier a word. In step w:
//    - thread 0 walks the 64 bits of word w in order, from live = ~dead[w]:
//      a bit t still set is kept, and its diagonal word mask[64 w + t][w]
//      clears the slots of word w it suppresses (only bits above t), so the
//      bits left are kept_w, the greedy result inside the word; dead[w] =
//      ~kept_w. The walk is unrolled and branch-free on the two 32-bit
//      halves (a step of the low half costs a bit test and an AND, the
//      high half's updates ride beside it), and its shared-memory loads do
//      not depend on it. Alongside each kept slot it ORs the slot's
//      super-diagonal word mask[64 w + t][w + 1] into a register: the carry
//      that word w + 1's walk starts from, so no block-wide update stands
//      between two walks;
//    - the block's last 128 threads load word w + 1's 64 diagonal and 64
//      super-diagonal words into the other half of a double buffer (they do
//      not depend on any result);
//    - the threads from the second warp on OR the rows of word w - 1's kept
//      slots into the words past w (mask[64 (w - 1) + t][v] for v > w), 4
//      threads a word, each taking 16 bits of kept_{w - 1} and issuing its
//      up to 16 loads at once (predicated, at fixed offsets), then a
//      shared-memory atomicOr: this runs under the walk of word w, and word
//      v > w is complete by the walk of v.
//    keep = ~dead at the end.
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
// stays in L2. The sweep is a chain of dependent steps and bound by
// latency: per 64-slot word, thread 0's walk (64 dependent steps of a few
// register operations) and one barrier; the next words' loads and the later
// words' updates (one L2 round trip) run under the walk.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// threads of a sweep block at most; the CPU build of the tests sets it small
// so that a thread owns several words
#ifndef D2T_NMS_MAX_THREADS
#define D2T_NMS_MAX_THREADS 1024
#endif

namespace {

constexpr int kWordBits = 64;
constexpr int kMaxThreads = D2T_NMS_MAX_THREADS;
static_assert(kMaxThreads >= 2, "the sweep needs a thread besides the walking one");
// shared memory one block may use on Hopper, and the sweep's static part
// (the diagonal and super-diagonal words' double buffers)
constexpr size_t kMaxSmemBytes = 232448;
constexpr size_t kSweepStaticBytes = 4 * kWordBits * sizeof(unsigned long long);
// sweep threads that OR one word's update, each taking kSplitBits of the
// kept slots (so its loads issue at once)
constexpr int kSplit = 4;
constexpr int kSplitBits = kWordBits / kSplit;

// threads of a sweep block: the walking warp, kSplit per bitset word for
// the updates and 128 that load the next word's diagonal and super-diagonal
// words, in whole warps, at most kMaxThreads
int sweep_threads(int nw) {
  const int n = (32 + kSplit * nw + 2 * kWordBits + 31) / 32 * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

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
  extern __shared__ unsigned long long dead[];
  // word w's diagonal words mask[64 w + t][w] and super-diagonal words
  // mask[64 w + t][w + 1] in half w & 1
  __shared__ unsigned long long diag[2][kWordBits], sup[2][kWordBits];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nth = blockDim.x;
  const uint8_t* vb = valid + static_cast<size_t>(b) * k;
  const unsigned long long* mb = mask + static_cast<size_t>(b) * k * nw;
  // the updating threads: from the second warp on (thread 0 walks alone in
  // its warp), or every thread but 0 in a block of one warp or less
  const int h0 = nth > 32 ? 32 : 1;
  // word w's diagonal and super-diagonal words, loaded from the block's last
  // thread down (thread 0 only in a block of fewer than 129 threads)
  auto load_words = [&](int w) {
    const int n = min(kWordBits, k - w * kWordBits);
    const int m = w + 1 < nw ? 2 * n : n;
    for (int u = nth - 1 - tid; u < m; u += nth) {
      const int t = u < n ? u : u - n;
      const unsigned long long x = mb[(static_cast<size_t>(w) * kWordBits + t) * nw + w + (u < n ? 0 : 1)];
      (u < n ? diag : sup)[w & 1][t] = x;
    }
  };
  // the slots past k are dead; the invalid ones are set below, reading the
  // valid bytes in order across the block
  for (int w = tid; w < nw; w += nth)
    dead[w] = w == nw - 1 && k % kWordBits ? ~0ull << (k % kWordBits) : 0ull;
  load_words(0);
  __syncthreads();
  for (int i = tid; i < k; i += nth)
    if (!vb[i]) atomicOr(&dead[i / kWordBits], 1ull << (i % kWordBits));
  __syncthreads();
  unsigned long long carry = 0ull;  // thread 0: word w - 1's kept rows at word w
  for (int w = 0; w < nw; ++w) {
    if (tid == 0) {
      // the greedy rule inside word w: in index order, a slot still live
      // is kept and clears the slots its diagonal word suppresses (bits
      // above it); the live bits left are the kept ones
      const unsigned long long* d = diag[w & 1];
      const unsigned long long* s = sup[w & 1];
      const unsigned long long live = ~(dead[w] | carry);
      unsigned lo = static_cast<unsigned>(live), hi = static_cast<unsigned>(live >> 32);
      unsigned long long next = 0ull;
#pragma unroll
      for (int t = 0; t < kWordBits; ++t) {
        const unsigned long long x = d[t], y = s[t];
        const unsigned half = t < 32 ? lo : hi;
        const unsigned m = static_cast<unsigned>(static_cast<int>(half << (31 - t % 32)) >> 31);  // bit t, all ones
        const unsigned long long m64 = static_cast<unsigned long long>(m) << 32 | m;
        if (t < 32) lo &= ~(static_cast<unsigned>(x) & m);
        hi &= ~(static_cast<unsigned>(x >> 32) & m);
        next |= y & m64;
      }
      dead[w] = ~(static_cast<unsigned long long>(hi) << 32 | lo);
      carry = next;
    }
    if (w + 1 < nw) load_words(w + 1);
    if (w > 0 && tid >= h0) {
      // word w - 1's kept rows into the words past w (word w had them as
      // the carry), kSplit threads a word
      const unsigned long long kept = ~dead[w - 1];
      const unsigned long long* rows = mb + static_cast<size_t>(w - 1) * kWordBits * nw;
      for (int u = tid - h0; u < kSplit * nw; u += nth - h0) {
        const int v = u % nw, q = u / nw;
        if (v <= w) continue;
        const unsigned bits = static_cast<unsigned>(kept >> (q * kSplitBits));
        const unsigned long long* row = rows + static_cast<size_t>(q * kSplitBits) * nw + v;
        unsigned long long r[kSplitBits], acc = 0ull;
#pragma unroll
        for (int i = 0; i < kSplitBits; ++i)  // independent predicated row loads, then their OR
          r[i] = (bits >> i) & 1u ? row[static_cast<size_t>(i) * nw] : 0ull;
#pragma unroll
        for (int i = 0; i < kSplitBits; ++i) acc |= r[i];
        if (acc) atomicOr(&dead[v], acc);
      }
    }
    // dead[w] and word w + 1's loads are in place, and word w + 1 has every
    // kept row of the words before w
    __syncthreads();
  }
  for (int i = tid; i < k; i += nth)
    keep[static_cast<size_t>(b) * k + i] = !((dead[i / kWordBits] >> (i % kWordBits)) & 1ull);
}

}  // namespace

extern "C" {

// shared memory of the sweep for k slots: the `dead` bitset and the
// diagonal and super-diagonal words' double buffers (the kernel's only
// limit on k: k up to about 1.8 million)
size_t d2t_nms_sweep_smem_bytes(int k) {
  return sizeof(unsigned long long) * ((k + kWordBits - 1) / kWordBits) + kSweepStaticBytes;
}

// boxes: (b, k, 4) float32 ijhw, score-descending; valid: (b, k) bool as
// bytes; mask: (b, k, ceil(k / 64)) u64 scratch; keep: (b, k) bool as bytes,
// every element written. Two launches on `stream`. Returns cudaGetLastError()
// (0 on success) after each, or cudaErrorInvalidValue for shapes the kernels
// do not take.
int d2t_nms_mask(const void* boxes, const void* valid, void* mask, void* keep, int b, int k, float iou_thresh,
                 void* stream) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  if (b < 1 || k < 1 || b > 65535 || nw > 65535 || d2t_nms_sweep_smem_bytes(k) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = d2t_nms_sweep_smem_bytes(k) - kSweepStaticBytes;  // the dynamic part
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
