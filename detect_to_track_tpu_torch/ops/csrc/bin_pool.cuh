// Average pooling over a roi's k x k bins on f32 NHWC maps, for Hopper
// (sm_90a): the device code that PSROIPool (psroi.cu) and ROIPool
// (roipool.cu) share.
//
// The bin bounds i0, i1, j0, j1 of each roi come in as int32 `bounds` (B, R,
// 4, k): rows i0, i1, j0, j1, computed by the caller with
// torch_ref._bin_bounds, the plain version's own code, so the geometry is
// bitwise the plain version's (nvcc would contract the bound arithmetic into
// FMAs here and move an edge that sits within an ulp of a pixel boundary). A
// bin holds the pixels 0 <= h < H with i0 <= h < i1 (and likewise w), as the
// plain version's masks do; n = (i1 - i0) (j1 - j0) in int32 (torch's
// wrap-around), and a bin with n <= 0 pools to 0 (the empty-bin quirk).
//
// Bin-major maps: with T values a bin (PSROIPool's targets, or the tracker's
// O projected outputs), channel (i k + j) T + t holds value t of bin (i, j),
// so a bin's T values at a pixel are T contiguous floats. A value takes one
// lane of a group of L lanes, L the smallest power of two >= T up to 32, so
// a warp has P = 32 / L groups: PSROIPool's class head's T = 31 one (a
// coalesced 124-byte load of a bin's targets at a pixel), its box head's and
// the tracker's T = 4 eight.
//
// Shared here: the forwards' pixel sums (pixel_run_sum, kFwdBatch loads in
// flight before their adds, in order) and ROIPool's slots (plan_slots); the
// backward of bin-major maps, PSROIPool's and the tracker's fused head's:
//
//   dfg[b, h, w, (i k + j) T + t] = sum over the rois r whose bin (i, j)
//   holds (h, w) of g[b, r, t, i, j] / n,
//
// every element written; g is read through its strides (the fused head
// hands in its (B, R, O) cotangent with the (i, j) strides 0). Rois get no
// gradient (the bounds are integers). Two launches:
// - psroi_bwd_prologue_kernel, a block per roi: g' = g / n bin-major (B, R,
//   k, k, T), 0 for an empty bin, so each term is the plain version's g / n
//   and a hit reads T contiguous floats with no division; and the roi's
//   masks of the row bins i that hold each map row and of the column bins j
//   that hold each map column (roi_bin_masks);
// - psroi_bwd_kernel: pixel-major, no atomics, no barrier between its
//   accumulator's zeroing and its store. One block per (frame, row, tile of
//   kBlockPixels pixels), each warp P pixels, each pixel an accumulator S
//   of C floats in shared memory. The warp's lanes read 32 rois' row mask
//   and column masks at a time; a ballot lists the rois whose bins hold one
//   of its pixels. Each lane then walks its pixel's hits in order (rois
//   ascending, then i, then j; next_hit), issuing kHitBatch hits' g' loads
//   before it adds them into S[(i k + j) T + t]. A lane owns its pixel's
//   target entries, so no two lanes write one entry, and every entry sums
//   its rois in ascending order: bitwise the same on a repeat. S is dfg's
//   own layout, so the block's pixels leave as one straight copy of S
//   (16-byte stores; S sits in shared memory at dfg's 16-byte phase).
//
// The launchers are nvcc's alone (#ifdef __CUDACC__); the kernels and the
// size rules also build for CPU threads (tests/torch_port_cuda_on_cpu.py).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kFwdThreads = 256;          // 8 bin warps a forward block (one roi)
constexpr int kFwdBatch = 8;              // pixel loads a forward lane issues together
constexpr int kPrologueThreads = 256;     // the backward prologue's block (one roi)
constexpr int kBlockPixels = 8;           // pixels of a backward block (at least one warp)
constexpr int kHitBatch = 4;              // hits whose loads a lane issues together
constexpr int kMaxGrid = 65535;           // grid y and z
constexpr size_t kMaxSmemBytes = 232448;  // a Hopper block's shared memory

// lanes of a pixel or bin: the smallest power of two >= t, at most a warp
__host__ __device__ inline int lanes_per_pixel(int t) {
  int lanes = 1;
  while (lanes < t && lanes < kWarp) lanes *= 2;
  return lanes;
}

// (i1 - i0) (j1 - j0) as torch computes it on int32 tensors (wrapping)
__device__ __forceinline__ int bin_numel(int i0, int i1, int j0, int j1) {
  return static_cast<int>((static_cast<unsigned>(i1) - static_cast<unsigned>(i0)) *
                          (static_cast<unsigned>(j1) - static_cast<unsigned>(j0)));
}

// lane groups of a warp at T targets (P): pixels (the backward) or bins
// (the forward) it takes at a time
__host__ __device__ inline int warp_groups(int t) { return kWarp / lanes_per_pixel(t); }

// the sum of one channel over `count` pixels of a bin's clipped rectangle
// (columns w_lo to w_lo + bw, rows from h_lo), from its pixel `start` in
// row-major order, `frame` the channel's pixel (0, 0): kFwdBatch loads in
// flight before their adds, in order
__device__ __forceinline__ float pixel_run_sum(const float* frame, int h_lo, int w_lo, int bw, int start, int count,
                                               long long sh, long long sw) {
  float sum = 0.0f;
  if (count <= 0) return sum;
  int dh = start / bw, dw = start - dh * bw;
  const long long wrap = sh - bw * sw;  // from past a row's end to the next row's start
  const float* px = frame + ((h_lo + dh) * sh + (w_lo + dw) * sw);
  for (int left = count; left > 0; left -= kFwdBatch) {
    float v[kFwdBatch];
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u) {
      v[u] = u < left ? __ldg(px) : 0.0f;
      px += sw;
      if (++dw == bw) {
        dw = 0;
        px += wrap;
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u)
      if (u < left) sum += v[u];
  }
  return sum;
}

// a bin's map pixels: rows h_lo to h_lo + bh, columns w_lo to w_lo + bw (bh
// or bw <= 0: none)
struct BinRect {
  int h_lo, w_lo, bh, bw;
  __device__ int pixels() const { return bh > 0 && bw > 0 ? bh * bw : 0; }
};

__device__ __forceinline__ BinRect bin_rect(int i0, int i1, int j0, int j1, int h_n, int w_n) {
  const int h_lo = i0 > 0 ? i0 : 0, h_hi = i1 < h_n ? i1 : h_n;
  const int w_lo = j0 > 0 ? j0 : 0, w_hi = j1 < w_n ? j1 : w_n;
  return BinRect{h_lo, w_lo, h_hi - h_lo, w_hi - w_lo};
}

// bin (i, j) of a roi whose bounds bd (rows i0, i1, j0, j1) are staged
__device__ __forceinline__ BinRect bin_rect(const int* bd, int k, int bin, int h_n, int w_n) {
  const int i = bin / k, j = bin - i * k;
  return bin_rect(bd[i], bd[k + i], bd[2 * k + j], bd[3 * k + j], h_n, w_n);
}

// the sum of one channel over the bin [i0, i1) x [j0, j1)'s map pixels
// (pixel_run_sum); 0 for a bin that holds no pixel
__device__ __forceinline__ float bin_sum(const float* frame, int i0, int i1, int j0, int j1, int h_n, int w_n,
                                         long long sh, long long sw) {
  const BinRect rc = bin_rect(i0, i1, j0, j1, h_n, w_n);
  return pixel_run_sum(frame, rc.h_lo, rc.w_lo, rc.bw, 0, rc.pixels(), sh, sw);
}

// Slots, the ROIPool forwards' split of a roi's work: each bin's pixels in
// row-major order are cut into runs of at most per = ceil(N / groups)
// pixels, N the pixels of all the roi's bins, so each of a block's `groups`
// lane groups sums about N / groups pixels, however the bins' sizes differ
// (a detection larger than the frame puts the whole map into its bin (0,
// 0) under ROIPool's corner clamp). At most groups + k^2 slots. One warp
// (all its lanes call this) plans from the staged bounds bd, lanes over
// the bins, N by a shuffle sum and the slots' offsets by a shuffle scan:
// bin b's slots are [first[b], first[b + 1]), first[k^2 + 1] = per.
__device__ inline void plan_slots(const int* bd, int k, int h_n, int w_n, int groups, int* first) {
  const int kk = k * k, lane = threadIdx.x % kWarp;
  long long total = 0;
  for (int bin = lane; bin < kk; bin += kWarp) total += bin_rect(bd, k, bin, h_n, w_n).pixels();
  for (int off = kWarp / 2; off > 0; off /= 2) total += __shfl_xor_sync(0xffffffffu, total, off);
  const int per = total > groups ? static_cast<int>((total + groups - 1) / groups) : 1;
  int carry = 0;
  for (int base = 0; base < kk; base += kWarp) {
    const int bin = base + lane;
    const int slots = bin < kk ? (bin_rect(bd, k, bin, h_n, w_n).pixels() + per - 1) / per : 0;
    int upto = slots;  // the slots of the warp's bins up to this lane's, inclusive
    for (int off = 1; off < kWarp; off *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, upto, off);
      if (lane >= off) upto += v;
    }
    if (bin < kk) first[bin] = carry + upto - slots;
    carry += __shfl_sync(0xffffffffu, upto, kWarp - 1);
  }
  if (lane == 0) {
    first[kk] = carry;
    first[kk + 1] = per;
  }
}

// each slot's bin, owner[s] = b for s in [first[b], first[b + 1]), by the
// block's `threads` threads after plan_slots
__device__ __forceinline__ void slot_owners(const int* first, int kk, int threads, int* owner) {
  for (int bin = threadIdx.x; bin < kk; bin += threads)
    for (int s = first[bin]; s < first[bin + 1]; ++s) owner[s] = bin;
}

// a slot's pixel run: its bin's rectangle, its first pixel and its count
__device__ __forceinline__ void slot_run(const int* bd, const int* first, const int* owner, int slot, int k, int h_n,
                                         int w_n, int& bin, BinRect& rc, int& start, int& count) {
  bin = owner[slot];
  rc = bin_rect(bd, k, bin, h_n, w_n);
  start = (slot - first[bin]) * first[k * k + 1];
  const int left = rc.pixels() - start;
  count = left < first[k * k + 1] ? left : first[k * k + 1];
}

// roi (b, r)'s masks of the bins that hold each map row and column, its
// bounds bd (rows i0, i1, j0, j1) in shared memory: rows[(b H + h) R + r] =
// the bins i with i0 <= h < i1, cols[(b W + w) R + r] = the bins j with j0
// <= w < j1 (k bits each); the block's `threads` threads take a row or
// column each
__device__ __forceinline__ void roi_bin_masks(const int* bd, unsigned* __restrict__ rows,
                                              unsigned* __restrict__ cols, long long b, long long r, int r_n, int k,
                                              int h_n, int w_n, int threads) {
  for (int x = threadIdx.x; x < h_n + w_n; x += threads) {
    const bool is_row = x < h_n;
    const int v = is_row ? x : x - h_n, lo = is_row ? 0 : 2 * k;  // the pixel row or column, its bounds' rows
    unsigned m = 0;
    for (int q = 0; q < k; ++q) m |= static_cast<unsigned>(bd[lo + q] <= v && v < bd[lo + k + q]) << q;
    if (is_row)
      rows[(b * h_n + v) * r_n + r] = m;
    else
      cols[(b * w_n + v) * r_n + r] = m;
  }
}

// grid (B R); block kPrologueThreads; dynamic shared memory 4 k ints. For
// roi (b, r): gs[b, r, i, j, t] = g[b, r, t, i, j] / n, 0 where n <= 0 (gs
// contiguous), and the roi's bin masks (roi_bin_masks)
__global__ void __launch_bounds__(kPrologueThreads)
psroi_bwd_prologue_kernel(const float* __restrict__ g, long long gsb, long long gsr, long long gst, long long gsi,
                          long long gsj, const int* __restrict__ bounds, float* __restrict__ gs,
                          unsigned* __restrict__ rows, unsigned* __restrict__ cols, int r_n, int t_n, int k,
                          int h_n, int w_n) {
  extern __shared__ int bd[];  // the roi's rows i0, i1, j0, j1
  const long long br = blockIdx.x;
  const long long b = br / r_n, r = br - b * r_n;
  const int kk = k * k;
  for (int x = threadIdx.x; x < 4 * k; x += kPrologueThreads) bd[x] = __ldg(bounds + br * 4 * k + x);
  __syncthreads();
  const float* gr = g + b * gsb + r * gsr;
  float* o = gs + br * kk * t_n;
  for (int x = threadIdx.x; x < kk * t_n; x += kPrologueThreads) {
    const int m = x / t_n, t = x - m * t_n, i = m / k, j = m - i * k;
    const int n = bin_numel(bd[i], bd[k + i], bd[2 * k + j], bd[3 * k + j]);
    o[x] = n > 0 ? __ldg(gr + t * gst + i * gsi + j * gsj) / static_cast<float>(n) : 0.0f;
  }
  roi_bin_masks(bd, rows, cols, b, r, r_n, k, h_n, w_n, kPrologueThreads);
}

// a lane's walk over its pixel's hits in a group of 32 rois, in order: rois
// ascending, then row bins i, then column bins j
struct HitWalk {
  unsigned rois;  // rois of the group not taken yet
  unsigned bj;    // the current roi's column bins holding the pixel
  unsigned ai;    // its row bins left
  unsigned aj;    // the column bins left in row bin i
  int roi, i;
};

// the walk's next hit (roi in the group, bin i k + j); false past the last
__device__ __forceinline__ bool next_hit(HitWalk& it, const unsigned* scan_i, const unsigned* scan_jp, int k,
                                         int& roi, int& bin) {
  while (it.aj == 0) {
    if (it.ai != 0) {
      it.i = __ffs(it.ai) - 1;
      it.ai &= it.ai - 1;
      it.aj = it.bj;
    } else if (it.rois != 0) {
      it.roi = __ffs(it.rois) - 1;
      it.rois &= it.rois - 1;
      it.bj = scan_jp[it.roi];
      it.ai = it.bj != 0 ? scan_i[it.roi] : 0u;
    } else {
      return false;
    }
  }
  const int j = __ffs(it.aj) - 1;
  it.aj &= it.aj - 1;
  roi = it.roi;
  bin = it.i * k + j;
  return true;
}

// floats of the backward's accumulators for px pixels of c channels: 3 more
// for the shift that puts S at dfg's 16-byte phase, rounded up to 16 bytes
__host__ __device__ inline size_t acc_floats(int px, int c) { return (static_cast<size_t>(px) * c + 3 + 3) / 4 * 4; }

// shared memory of a backward block of `warps` warps at T targets, k: the
// accumulators and the warps' scans
inline size_t bwd_smem_bytes(int warps, int t, int k) {
  const int p = warp_groups(t);
  return sizeof(float) * acc_floats(warps * p, t * k * k) + sizeof(unsigned) * static_cast<size_t>(warps) * kWarp * (1 + p);
}

// warps of a backward block: kBlockPixels pixels (at least one warp), fewer
// warps while the block's shared memory does not fit; 0 when not one fits
inline int bwd_warps(int t, int k) {
  const int want = kBlockPixels / warp_groups(t);
  for (int warps = want > 0 ? want : 1; warps >= 1; --warps)
    if (bwd_smem_bytes(warps, t, k) <= kMaxSmemBytes) return warps;
  return 0;
}

// grid (tiles of warps * P pixels along w, H, B); block warps * 32 threads;
// dynamic shared memory bwd_smem_bytes(warps, T, k). gs, rows, cols: the
// prologue's; dfg contiguous (B, H, W, T k^2). kK > 0 fixes k at compile
// time (the walk's bins), 0 takes it from k_arg.
template <int kK>
__global__ void __launch_bounds__(kBlockPixels * kWarp)
psroi_bwd_kernel(const float* __restrict__ gs, const unsigned* __restrict__ rows, const unsigned* __restrict__ cols,
                 float* __restrict__ dfg, int r_n, int t_n, int k_arg, int h_n, int w_n) {
  const int k = kK > 0 ? kK : k_arg;
  const int kk = k * k, c_n = kk * t_n;
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int lanes = lanes_per_pixel(t_n), slots = kWarp / lanes;
  const int px_block = warps * slots;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  unsigned* scan_i = reinterpret_cast<unsigned*>(smem + acc_floats(px_block, c_n)) + warp * kWarp * (1 + slots);
  unsigned* scan_j = scan_i + kWarp;  // the warp's scan: each lane's roi's row bins holding the row, and (slots x
                                      // 32) its column bins holding each pixel
  const int tl = lane % lanes, slot = lane / lanes;
  const int b = blockIdx.z, h = blockIdx.y;
  const int w0 = blockIdx.x * px_block;
  // the block's pixels are one run of dfg from `base`; acc[x] shares dfg[base + x]'s 16-byte phase
  const long long base = ((static_cast<long long>(b) * h_n + h) * w_n + w0) * c_n;
  float* acc = smem + static_cast<int>(base & 3);
  const int np = w_n - w0 < px_block ? w_n - w0 : px_block;
  for (int x = threadIdx.x; x < px_block * c_n; x += blockDim.x) acc[x] = 0.0f;
  __syncthreads();
  const int pw = warp * slots + slot;  // this lane's pixel in the block
  float* s = acc + pw * c_n;
  // ---- S[(i k + j) T + t] = sum over the rois, in order, of g' ----
  if (warp * slots < np) {  // warp-uniform
    const unsigned* row_bins = rows + (static_cast<long long>(b) * h_n + h) * r_n;
    const unsigned* col_bins = cols + (static_cast<long long>(b) * w_n + w0 + warp * slots) * r_n;
    // lanes over 32 rois at a time read the bins that hold the row and each
    // of the warp's pixels; then each lane walks its own pixel's hits
    for (int rb = 0; rb < r_n; rb += kWarp) {
      const int r = rb + lane;
      const unsigned mi = r < r_n ? __ldg(row_bins + r) : 0u;
      unsigned any = 0;
      for (int p = 0; p < slots; ++p) {
        const unsigned mj = mi != 0 && warp * slots + p < np ? __ldg(col_bins + p * r_n + r) : 0u;
        scan_j[p * kWarp + lane] = mj;
        any |= mj;
      }
      scan_i[lane] = mi;
      const unsigned hits = __ballot_sync(0xffffffffu, any != 0);
      __syncwarp();
      if (pw < np) {
        const float* gr = gs + (static_cast<long long>(b) * r_n + rb) * c_n;
        for (int t = tl; t < t_n; t += lanes) {
          HitWalk it{hits, 0u, 0u, 0u, 0, 0};
          for (bool more = true; more;) {
            int roi[kHitBatch], bin[kHitBatch];
            bool ok[kHitBatch];
            float v[kHitBatch];
#pragma unroll
            for (int q = 0; q < kHitBatch; ++q) {
              roi[q] = bin[q] = 0;
              ok[q] = next_hit(it, scan_i, scan_j + slot * kWarp, k, roi[q], bin[q]);
            }
#pragma unroll
            for (int q = 0; q < kHitBatch; ++q)
              v[q] = ok[q] ? __ldg(gr + (static_cast<long long>(roi[q]) * kk + bin[q]) * t_n + t) : 0.0f;
#pragma unroll
            for (int q = 0; q < kHitBatch; ++q)
              if (ok[q]) s[bin[q] * t_n + t] += v[q];
            more = ok[kHitBatch - 1];
          }
        }
      }
      __syncwarp();  // every lane has read the scan before the next group's
    }
  }
  __syncthreads();
  // ---- the block's np C floats of S, straight into dfg ----
  float* dst = dfg + base;
  const int n_el = np * c_n;
  const int lead = (4 - static_cast<int>(base & 3)) & 3;  // floats before dfg's first 16-byte boundary
  const int head = lead < n_el ? lead : n_el;
  const int body = (n_el - head) / 4;
  for (int x = threadIdx.x; x < head; x += blockDim.x) dst[x] = acc[x];
  float4* dst4 = reinterpret_cast<float4*>(dst + head);
  const float4* acc4 = reinterpret_cast<const float4*>(acc + head);
  for (int x = threadIdx.x; x < body; x += blockDim.x) dst4[x] = acc4[x];
  for (int x = head + 4 * body + threadIdx.x; x < n_el; x += blockDim.x) dst[x] = acc[x];
}

using BwdKernel = void (*)(const float*, const unsigned*, const unsigned*, float*, int, int, int, int, int);

// the backward's instance for k: the R-FCN's and the tracker's k 7
// unrolled, any other k generic
inline BwdKernel bwd_kernel(int k) { return k == 7 ? psroi_bwd_kernel<7> : psroi_bwd_kernel<0>; }

#ifdef __CUDACC__

// allow a kernel its dynamic shared memory (past 48 KB)
inline cudaError_t smem_configure(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// the backward: the prologue, then the pixel-major kernel; see d2t_psroi_bwd
inline int launch_bin_bwd(const void* g, long long gsb, long long gsr, long long gst, long long gsi, long long gsj,
                          const void* bounds, void* gs, void* masks, void* dfg, int b, int r, int t, int k, int h,
                          int w, void* stream) {
  if (b < 1 || r < 1 || t < 1 || k < 1 || k > 32 || h < 1 || w < 1 || b > kMaxGrid || h > kMaxGrid ||
      static_cast<long long>(b) * r > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = bwd_warps(t, k);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem_bytes(warps, t, k);
  const BwdKernel kernel = bwd_kernel(k);
  cudaError_t err = smem_configure(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* rows = static_cast<unsigned*>(masks);
  unsigned* cols = rows + static_cast<long long>(b) * h * r;
  psroi_bwd_prologue_kernel<<<static_cast<unsigned>(static_cast<long long>(b) * r), kPrologueThreads,
                              sizeof(int) * 4 * k, st>>>(static_cast<const float*>(g), gsb, gsr, gst, gsi, gsj,
                                                         static_cast<const int*>(bounds), static_cast<float*>(gs), rows,
                                                         cols, r, t, k, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int px = warps * warp_groups(t);
  const dim3 grid((w + px - 1) / px, h, b);
  kernel<<<grid, warps * kWarp, smem, st>>>(static_cast<const float*>(gs), rows, cols, static_cast<float*>(dfg), r, t,
                                            k, h, w);
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace
