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
//    > i, j < k and IoU(box i, box j) > iou_thresh, for the words at or
//    above the diagonal (w >= i / 64) only: the sweep reads no other word,
//    and none is written. One warp per task: a row group (kRows / 2 row
//    blocks of 64), a column word w at or right of the group's first row
//    block, and a frame; kIouWarps tasks a block, on a grid of the
//    triangle's tasks alone (iou_grid). Each warp stages its word's 64
//    column boxes in shared memory, and each lane holds kRows row boxes in
//    registers (rows 32 r + lane of the group), so one staged column serves
//    kRows IoUs. The columns run in chunks of kChunk, unrolled, so every bit
//    position is a constant. Once a word, the diagonal word keeps only its
//    bits j > i and the last word its bits j < k.
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
// Bitwise equal to the plain version: the IoU's terms are computed with the
// same float32 operations in the same order as boxes.compute_ious and
// ijhw_to_ijij (corners ij -/+ hw / 2; max / min; clamp(hi - lo, 0); inter
// = dh * dw; union = (h_a * w_a + h_b * w_b) - inter; IoU 0 where union <=
// 0), each one correctly rounded by an _rn intrinsic: the build allows FMA
// contraction, which would round h_a * w_a + h_b * w_b differently. The
// threshold is compared in float32, as torch compares a float32 tensor with
// a Python float. Two rewrites keep every bit with fewer instructions:
// - NaN. torch's max, min and clamp propagate NaN; fmaxf and fminf drop
//   it. A box with a NaN corner has IoU 0 with every box in compute_ious
//   (the NaN reaches inter, so union is NaN and union > 0 is false).
//   Staging gives such a box a NaN area, so its union is NaN here too,
//   whatever fmaxf and fminf make of its corners. Between boxes without a
//   NaN corner, fmaxf and fminf equal torch's ops up to the sign of a zero,
//   which the subtraction, the clamp and the compares lose. A NaN that
//   torch makes inside the clamp (inf - inf: both corners +inf, or both
//   -inf) gives IoU 0 there; here dh is 0, so inter is 0 or NaN and the
//   IoU is 0 too. The bit is (0 > t) in both forms.
// - The division. For t a float in [2^-125, FLT_MAX], RN(inter / uni) > t
//   iff the quotient is above m = t + h, the midpoint between t and the
//   next float up (h, half t's ulp, is a power of 2: product_half_ulp). The
//   quotient of two floats never equals m (m needs 25 significant bits).
//   For a finite uni > 0 that is x - h uni > 0, with x = inter - t uni.
//   d = fma(-t, uni, inter) rounds x once, e = fma(-h, uni, d) rounds d - h
//   uni once, and rounding is monotone. Where |e| >= FLT_MIN, the sign of e
//   is the sign of x - h uni: where h uni is a float, d and x lie on the
//   same side of it; where it is below FLT_MIN, d lies more than a
//   subnormal step from it, which x cannot cross; where it is past
//   FLT_MAX, it is above both. So the bit is uni > 0 && e > 0. A union
//   that is NaN, infinite or not positive gives 0 here, as the division
//   does. A row whose word has any |e| < FLT_MIN (a quotient within about
//   2^-49 of m, relative, or a tiny union) takes the division for that
//   word. A threshold outside [2^-125, FLT_MAX] (negative, 0, tiny, inf,
//   NaN) takes the division for every pair (nms_mask_kernel<false>).
//
// What bounds it: at the working point (8 frames x 3072 slots) the IoU
// launch computes the 37.7 M IoUs above the diagonal, about 0.5 GFLOP and
// 8 us at the card's float32 rate; the instructions it issues for them
// bound it (the geometry, two FMAs, two compares and a bit an IoU). The
// inputs and the keep-mask are 0.4 MB; the words it writes (4.8 MB of the
// B k^2 / 8 byte mask) stay in L2. The sweep is a chain of dependent steps
// and bound by latency: per 64-slot word, thread 0's walk (64 dependent
// steps of a few register operations) and one barrier; the next words'
// loads and the later words' updates (one L2 round trip) run under the
// walk.

#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

// threads of a sweep block at most; the CPU build of the tests sets it small
// so that a thread owns several words
#ifndef D2T_NMS_MAX_THREADS
#define D2T_NMS_MAX_THREADS 1024
#endif
// rows a lane of the IoU launch holds (even: a warp's rows fill whole
// 64-row blocks) and warps, each one task, a block; the CPU tests build 4
// rows a lane and one warp a block besides
#ifndef D2T_NMS_IOU_ROWS
#define D2T_NMS_IOU_ROWS 2
#endif
#ifndef D2T_NMS_IOU_WARPS
#define D2T_NMS_IOU_WARPS 4
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
constexpr int kWarp = 32;
constexpr int kRows = D2T_NMS_IOU_ROWS;
static_assert(kRows >= 2 && kRows % 2 == 0, "a warp's rows fill whole 64-row blocks");
constexpr int kGroupBlocks = kRows / 2;  // 64-row blocks of a row group
constexpr int kIouWarps = D2T_NMS_IOU_WARPS;
constexpr int kIouThreads = kIouWarps * kWarp;
constexpr int kChunk = 32;  // columns unrolled a step

// threads of a sweep block: the walking warp, kSplit per bitset word for
// the updates and 128 that load the next word's diagonal and super-diagonal
// words, in whole warps, at most kMaxThreads
int sweep_threads(int nw) {
  const int n = (32 + kSplit * nw + 2 * kWordBits + 31) / 32 * 32;
  return n < kMaxThreads ? n : kMaxThreads;
}

// IoU tasks of a frame before row group g: group g' takes the column words
// g' kGroupBlocks to nw - 1
__host__ __device__ inline long long tasks_before(long long g, int nw) {
  return g * nw - kGroupBlocks * g * (g - 1) / 2;
}

long long iou_tasks(int nw) { return tasks_before((nw + kGroupBlocks - 1) / kGroupBlocks, nw); }

// task -> its row group g and column word w: the tasks run group by group,
// group g's over the words g kGroupBlocks to nw - 1. tasks_before(g) is
// (nw + kGroupBlocks / 2) g - kGroupBlocks g^2 / 2: its root, then exact
// steps
__host__ __device__ inline void task_tile(int task, int nw, int& g, int& w) {
  const int groups = (nw + kGroupBlocks - 1) / kGroupBlocks;
  const float s = nw + 0.5f * kGroupBlocks;
  g = static_cast<int>((s - sqrtf(fmaxf(s * s - 2.0f * kGroupBlocks * task, 0.0f))) / kGroupBlocks);
  g = g < 0 ? 0 : g < groups ? g : groups - 1;
  while (g > 0 && tasks_before(g, nw) > task) --g;
  while (tasks_before(g + 1, nw) <= task) ++g;
  w = g * kGroupBlocks + static_cast<int>(task - tasks_before(g, nw));
}

// the IoU launch's grid: kIouWarps tasks a block along x, the frames along
// y (kIouThreads threads a block)
dim3 iou_grid(int b, int nw) {
  return dim3(static_cast<unsigned>((iou_tasks(nw) + kIouWarps - 1) / kIouWarps), static_cast<unsigned>(b));
}

// h, half the ulp of t, where the product test is exact (t in [2^-125,
// FLT_MAX]: h is a float, at least 2^-149); 0 elsewhere, where the division
// decides every pair
float product_half_ulp(float t) {
  if (!(t >= 0x1p-125f && t <= FLT_MAX)) return 0.0f;
  int e;
  std::frexp(t, &e);  // t in [2^(e - 1), 2^e): ulp 2^(e - 24)
  return std::ldexp(1.0f, e - 25);
}

struct alignas(16) Corners {
  float i0, j0, i1, j1;
};

struct Box {
  Corners c;
  float area;
};

// ijhw_to_ijij and box_areas of one box; a NaN area where a corner is NaN
__device__ __forceinline__ Box load_box(const float* box) {
  const float hh = __fdiv_rn(box[2], 2.0f);
  const float hw = __fdiv_rn(box[3], 2.0f);
  Box x{{__fsub_rn(box[0], hh), __fsub_rn(box[1], hw), __fadd_rn(box[0], hh), __fadd_rn(box[1], hw)},
        __fmul_rn(box[2], box[3])};
  if (x.c.i0 != x.c.i0 || x.c.j0 != x.c.j0 || x.c.i1 != x.c.i1 || x.c.j1 != x.c.j1) x.area = nanf("");
  return x;
}

// compute_ious(a, b)'s intersection and union, in its operations and
// order, with fmaxf / fminf (see above)
__device__ __forceinline__ void overlap(const Box& a, const Corners& b, float b_area, float& inter, float& uni) {
  const float dh = fmaxf(__fsub_rn(fminf(a.c.i1, b.i1), fmaxf(a.c.i0, b.i0)), 0.0f);
  const float dw = fmaxf(__fsub_rn(fminf(a.c.j1, b.j1), fmaxf(a.c.j0, b.j0)), 0.0f);
  inter = __fmul_rn(dh, dw);
  uni = __fsub_rn(__fadd_rn(a.area, b_area), inter);
}

__device__ __forceinline__ bool above_by_division(float inter, float uni, float thresh) {
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > thresh;
}

// row a's word against the 64 staged columns, by the division
__device__ unsigned long long word_by_division(const Box& a, const Corners* cols, const float* areas, float thresh) {
  unsigned long long bits = 0ull;
  for (int c = 0; c < kWordBits; ++c) {
    float inter, uni;
    overlap(a, cols[c], areas[c], inter, uni);
    if (above_by_division(inter, uni, thresh)) bits |= 1ull << c;
  }
  return bits;
}

// kProduct: the product test (half_ulp = product_half_ulp(thresh) > 0);
// else the division for every pair
template <bool kProduct>
__global__ void __launch_bounds__(kIouThreads)
nms_mask_kernel(const float* __restrict__ boxes, unsigned long long* __restrict__ mask, int k, int nw, int tasks,
                float thresh, float half_ulp) {
  __shared__ Corners cols[kIouWarps][kWordBits];
  __shared__ float areas[kIouWarps][kWordBits];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.y;
  const int task = blockIdx.x * kIouWarps + warp;
  const bool live = task < tasks;  // a spare warp of the last block only meets the barrier
  int g = 0, w = 0;  // the task's row group and column word
  if (live) task_tile(task, nw, g, w);
  const float* fb = boxes + static_cast<size_t>(b) * k * 4;
  const Box none{{0.0f, 0.0f, 0.0f, 0.0f}, nanf("")};  // past k: IoU 0 with every box
  if (live) {
    for (int u = lane; u < kWordBits; u += kWarp) {
      const int j = w * kWordBits + u;
      const Box x = j < k ? load_box(fb + static_cast<size_t>(j) * 4) : none;
      cols[warp][u] = x.c;
      areas[warp][u] = x.area;
    }
  }
  __syncthreads();
  if (!live) return;
  const Corners* cw = cols[warp];
  const float* aw = areas[warp];
  const int i0 = g * kGroupBlocks * kWordBits + lane;  // row r is i0 + 32 r
  Box a[kRows];
  unsigned long long bits[kRows];
  float closest[kRows];  // the least |e| of each row's word (product test)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kWarp;
    a[r] = i < k ? load_box(fb + static_cast<size_t>(i) * 4) : none;
    bits[r] = 0ull;
    closest[r] = FLT_MAX;
  }
#pragma unroll 1
  for (int c0 = 0; c0 < kWordBits; c0 += kChunk) {
    unsigned chunk[kRows] = {};
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const Corners p = cw[c0 + c];
      const float pa = aw[c0 + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float inter, uni;
        overlap(a[r], p, pa, inter, uni);
        bool bit;
        if constexpr (kProduct) {
          const float e = __fmaf_rn(-half_ulp, uni, __fmaf_rn(-thresh, uni, inter));
          closest[r] = fminf(closest[r], fabsf(e));
          bit = uni > 0.0f && e > 0.0f;
        } else {
          bit = above_by_division(inter, uni, thresh);
        }
        if (bit) chunk[r] |= 1u << c;  // one predicated instruction; a shifted bool compiles to three
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) bits[r] |= static_cast<unsigned long long>(chunk[r]) << c0;
  }
  const unsigned long long in_k = w == nw - 1 && k % kWordBits ? ~(~0ull << (k % kWordBits)) : ~0ull;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + r * kWarp;
    const int rb = g * kGroupBlocks + r / 2;  // the row's 64-row block
    if (i >= k || rb > w) continue;  // past k, or a word below the diagonal
    unsigned long long x = bits[r];
    if (kProduct && closest[r] < FLT_MIN) x = word_by_division(a[r], cw, aw, thresh);
    if (rb == w) {  // the diagonal word: the columns j > i alone
      const int t = i % kWordBits;
      x &= t == kWordBits - 1 ? 0ull : ~0ull << (t + 1);
    }
    mask[(static_cast<size_t>(b) * k + i) * nw + w] = x & in_k;
  }
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

// The IoU launch alone on `stream` (the first of d2t_nms_mask's two; a
// test hook besides): boxes (b, k, 4) float32 ijhw; mask (b, k, ceil(k /
// 64)) u64, its words at or above the diagonal (w >= i / 64) written, no
// other. Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for shapes it does not take.
int d2t_nms_iou_bits(const void* boxes, void* mask, int b, int k, float iou_thresh, void* stream) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  if (b < 1 || k < 1 || b > 65535 || iou_tasks(nw) > INT_MAX - kIouWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tasks = static_cast<int>(iou_tasks(nw));
  const float h = product_half_ulp(iou_thresh);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  unsigned long long* m = static_cast<unsigned long long*>(mask);
  if (h > 0.0f)
    nms_mask_kernel<true><<<iou_grid(b, nw), kIouThreads, 0, s>>>(bx, m, k, nw, tasks, iou_thresh, h);
  else
    nms_mask_kernel<false><<<iou_grid(b, nw), kIouThreads, 0, s>>>(bx, m, k, nw, tasks, iou_thresh, h);
  return static_cast<int>(cudaGetLastError());
}

// boxes: (b, k, 4) float32 ijhw, score-descending; valid: (b, k) bool as
// bytes; mask: (b, k, ceil(k / 64)) u64 scratch; keep: (b, k) bool as bytes,
// every element written. Two launches on `stream`. Returns cudaGetLastError()
// (0 on success) after each, or cudaErrorInvalidValue for shapes the kernels
// do not take.
int d2t_nms_mask(const void* boxes, const void* valid, void* mask, void* keep, int b, int k, float iou_thresh,
                 void* stream) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  if (b < 1 || k < 1 || b > 65535 || d2t_nms_sweep_smem_bytes(k) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = d2t_nms_sweep_smem_bytes(k) - kSweepStaticBytes;  // the dynamic part
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = static_cast<cudaError_t>(d2t_nms_iou_bits(boxes, mask, b, k, iou_thresh, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_sweep_kernel<<<b, sweep_threads(nw), smem, s>>>(static_cast<const unsigned long long*>(mask),
                                            static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, nw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
