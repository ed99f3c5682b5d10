// PSROIPool (position-sensitive average ROI pooling) for Hopper (sm_90a):
// the forward and a deterministic backward, f32 maps of any strides.
//
// Replaces detect_to_track_tpu/ops/pooling.py:154 `_ps_roi_pool_einsum`, an
// XLA program of mask matmuls (a channel gather, then two batched matmuls;
// its backward more matmuls and the gather's scatter), not a Pallas kernel.
// Its plain version is ops/pooling.py's einsum form. With T targets, a k x k
// grid and ch(t, i, j) = (t + 1) (i k + j) (the reference's quirk) or t k^2 +
// i k + j (the paper's layout):
//
//   out[b, r, t, i, j] = sum_{h in [i0, i1), w in [j0, j1)} fm[b, h, w, ch] / n
//
// with n = (i1 - i0) (j1 - j0) in int32 (torch's wrap-around), and 0 where n
// <= 0 (the empty-bin quirk). The bin bounds i0, i1, j0, j1 of each roi come
// in as int32 `bounds` (B, R, 4, k): rows i0, i1, j0, j1, computed by the
// caller with torch_ref._bin_bounds, the plain version's own code, so the
// geometry is bitwise the plain version's (nvcc would contract the
// bound arithmetic into FMAs here and move an edge that sits within an ulp
// of a pixel boundary). A bin holds the pixels 0 <= h < H with i0 <= h < i1
// (and likewise w), as the plain version's masks do.
//
// 1. psroi_fwd_kernel: one warp per bin (b, r, i, j), lanes over t (t =
//    lane, lane + 32, ...). A lane sums its channel's window row by row (the
//    W sums, then the H sum, as the einsum contracts W then H) and divides
//    once. No shared memory, no barrier, no warp intrinsic.
// 2. psroi_bwd_kernel: dfm[b, h, w, c] = sum over (r, t, i, j) with ch(t, i,
//    j) = c and (h, w) in bin (r, i, j) of g[b, r, t, i, j] / n, every
//    element written (0 for a channel no (t, i, j) reaches). Rois get no
//    gradient (the bounds are integers). Pixel-major and deterministic, with
//    no atomic: one block per (frame, row, tile of pixels), one warp per
//    pixel, in two phases, as the plain backward runs (the einsums' adjoint
//    into the gathered maps fg[h, w, t, i, j], then the gather's scatter):
//    - phase 1: the warp's pixel gathers fg = sum_r g[b, r, t, i, j] / n over
//      the rois whose bin (i, j) holds it, in a shared accumulator S[t, i, j]
//      (C floats). The block stages the frame's bounds kRoiChunk rois at a
//      time, with each roi's mask of the row bins i that hold the block's
//      row h. The warp's lanes take 32 rois at a time and find the column
//      bins j that hold the pixel (posting their masks in shared memory); a
//      ballot lists the rois with a bin (i, j) holding it, and the warp
//      takes them in ascending order, lane t adding g / n into S[t, i, j]
//      for each such bin. A lane owns its targets' entries, so no two lanes
//      write one entry: no atomic, and every entry sums its rois in
//      ascending order.
//    - phase 2: the block writes its pixels' C channels, dfm[c] = the sum of
//      S over the (t, i, j) with ch = c, in ascending flat (t, i, j) order,
//      from the inverse map (inv_ptr, inv_idx: a CSR of the channel map,
//      made by the caller, staged in shared memory), threads over the
//      channels: one contiguous run of C floats a pixel in NHWC. Under the
//      quirk channel 0 takes all T targets of bin (0, 0), a serial sum of T
//      terms.
//    Bitwise the same on a repeat: every sum has a fixed order.
//
// The layout: the R-FCN's maps are contiguous NHWC. Its convolutions run
// channels-last (the backbone hands them permuted NHWC tensors, and cuDNN
// keeps that format), so conv(t).permute(0, 2, 3, 1) has unit stride along
// the channels. Both kernels take any strides of fm and dfm (NCHW storage
// is tested, not used by the model); the op allocates dfm contiguous NHWC.
//
// What bounds it on this card: the bytes. At the working point (8 frames,
// 38 x 75, 256 rois, k 7; the class head's 1519 channels and the box head's
// 196) the forward reads the map elements its bins hold (~53 MB of the
// class head's 139, under the quirk) and writes ~13 MB; the backward reads
// g (~13 MB) and writes dfm (~139 MB): with the box head's share, about
// 0.07 ms at 3.35 TB/s for both heads, forward and backward.
// The adds (one a pixel of a bin and target) are far below the float32
// rate. What the design does about it: neither kernel copies fm or builds
// an intermediate the size of the maps (the einsum form's gathered maps and
// W-contracted product, ~0.6 GB at the class head, are gone), both read and
// write the maps in place, and the backward writes dfm once, a pixel's
// channels in one run. Both stay well above the bound:
// - the forward moves sectors, not floats. In NHWC a lane's loads lie C
//   floats apart, and a warp's lanes read channels m apart (the quirk's
//   (t + 1) m, m = i k + j) or k^2 apart (the paper's t k^2 + m): for m >=
//   8, and always under the paper's map, a warp load of the class head
//   touches 31 sectors of 32 bytes for 31 floats. Lanes over neighbouring
//   channels would not fill
//   those sectors: the channels beside a bin's targets belong to other bins
//   (i, j) of the roi, which hold other pixels, so no warp of this roi reads
//   the rest of a sector at this pixel. The grid runs frame by frame, and a
//   frame's maps (17 MB of the class head) fit in L2 (50 MB), so most of
//   those sectors can come from L2 rather than HBM. Reading along w
//   (one sector for a lane's row of a bin) needs NCHW storage, and making it
//   costs a copy of the maps (2 x 139 MB moved, at least 0.08 ms at 3.35
//   TB/s) or NCHW convolutions.
// - the backward is bound by latency: its per-pixel scan of the rois and
//   each hit's dependent g load and division, with C floats a pixel in
//   shared memory limiting the class head to 2 blocks an SM.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kFwdThreads = 256;             // 8 bins a forward block
constexpr int kMaxBwdWarps = 8;              // pixels a backward round
constexpr int kBwdRounds = 2;                // rounds of a backward block
constexpr int kRoiChunk = 128;                // rois the backward stages at a time
constexpr int kMaxGrid = 65535;              // grid y and z
constexpr size_t kMaxSmemBytes = 232448;     // a Hopper block's shared memory

// the channel of target t in bin (i, j)
__device__ __forceinline__ int channel_of(int t, int i, int j, int k, int paper) {
  return paper ? (t * k + i) * k + j : (t + 1) * (i * k + j);
}

// (i1 - i0) (j1 - j0) as torch computes it on int32 tensors (wrapping)
__device__ __forceinline__ int bin_numel(int i0, int i1, int j0, int j1) {
  return static_cast<int>((static_cast<unsigned>(i1) - static_cast<unsigned>(i0)) *
                          (static_cast<unsigned>(j1) - static_cast<unsigned>(j0)));
}

__global__ void __launch_bounds__(kFwdThreads)
psroi_fwd_kernel(const float* __restrict__ fm, const int* __restrict__ bounds, float* __restrict__ out,
                 long long n_bins, int r_n, int t_n, int k, int h_n, int w_n, long long sb, long long sh,
                 long long sw, long long sc, int paper) {
  const long long bin = static_cast<long long>(blockIdx.x) * (kFwdThreads / kWarp) + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (bin >= n_bins) return;
  const int kk = k * k;
  const int j = static_cast<int>(bin % k);
  const int i = static_cast<int>(bin / k % k);
  const long long br = bin / kk;  // b * R + r
  const long long b = br / r_n;
  const int* bd = bounds + br * 4 * k;
  const int i0 = bd[i], i1 = bd[k + i], j0 = bd[2 * k + j], j1 = bd[3 * k + j];
  const int n = bin_numel(i0, i1, j0, j1);
  const int h_lo = i0 > 0 ? i0 : 0, h_hi = i1 < h_n ? i1 : h_n;
  const int w_lo = j0 > 0 ? j0 : 0, w_hi = j1 < w_n ? j1 : w_n;
  const float* frame = fm + b * sb;
  float* o = out + br * t_n * kk + i * k + j;
  for (int t = lane; t < t_n; t += kWarp) {
    const float* plane = frame + channel_of(t, i, j, k, paper) * sc;
    float sum = 0.0f;
    for (int h = h_lo; h < h_hi; ++h) {
      const float* row = plane + h * sh;
      float rs = 0.0f;
      for (int w = w_lo; w < w_hi; ++w) rs += __ldg(row + w * sw);
      sum += rs;
    }
    o[static_cast<long long>(t) * kk] = n > 0 ? sum / static_cast<float>(n) : 0.0f;
  }
}

// shared memory of a backward block of `warps` pixel warps: their
// accumulators, the staged bounds and row masks of a roi chunk, the warps'
// scans, and the channel map's inverse
size_t bwd_smem_bytes(int warps, int c, int k, int r) {
  const int rc = r < kRoiChunk ? r : kRoiChunk;
  return sizeof(float) * static_cast<size_t>(warps) * c + sizeof(int) * static_cast<size_t>(rc + 1) * 4 * k +
         sizeof(unsigned) * (static_cast<size_t>(rc) + 2 * kWarp * warps) + sizeof(int) * (2 * static_cast<size_t>(c) + 1);
}

// pixel warps of a backward block: as many as fit, up to kMaxBwdWarps; 0
// when not one fits
int bwd_warps(int c, int k, int r) {
  for (int warps = kMaxBwdWarps; warps >= 1; --warps)
    if (bwd_smem_bytes(warps, c, k, r) <= kMaxSmemBytes) return warps;
  return 0;
}

// grid (tiles of warps * kBwdRounds pixels along w, H, B); block warps * 32
// threads; dynamic shared memory bwd_smem_bytes(warps, C, k, R). kK > 0
// fixes k at compile time (the loops over a roi's bins unroll), 0 takes it
// from k_arg.
template <int kK>
__global__ void __launch_bounds__(kMaxBwdWarps * kWarp)
psroi_bwd_kernel(const float* __restrict__ g, long long gsb, long long gsr, long long gst, long long gsi,
                 long long gsj, const int* __restrict__ bounds, const int* __restrict__ inv_ptr,
                 const int* __restrict__ inv_idx, float* __restrict__ dfm, long long sb, long long sh, long long sw,
                 long long sc, int r_n, int t_n, int k_arg, int w_n, int c_n) {
  const int k = kK > 0 ? kK : k_arg;
  extern __shared__ float smem[];
  const int warps = blockDim.x / kWarp;
  const int rc_max = r_n < kRoiChunk ? r_n : kRoiChunk;
  const int ld = rc_max + 1;  // a bound row's stride: lanes over rois hit distinct banks
  float* acc = smem;                                             // warps x C: S[t, i, j] of each pixel
  int* sbd = reinterpret_cast<int*>(acc + warps * c_n);          // 4 k rows of ld: sbd[q * ld + r]
  unsigned* imask = reinterpret_cast<unsigned*>(sbd + 4 * k * ld);  // rc_max row masks
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  unsigned* scan_i = imask + rc_max + warp * kWarp;  // the warp's scan: each lane's roi's
  unsigned* scan_j = scan_i + warps * kWarp;         // bins i and j holding the pixel
  int* s_ptr = reinterpret_cast<int*>(imask + rc_max + 2 * warps * kWarp);  // the inverse map, C + 1
  int* s_idx = s_ptr + c_n + 1;                                              // and C entries
  for (int x = threadIdx.x; x <= c_n; x += blockDim.x) {
    s_ptr[x] = __ldg(inv_ptr + x);
    if (x < c_n) s_idx[x] = __ldg(inv_idx + x);
  }  // read after the first chunk's barriers
  const int kk = k * k;
  const int w_begin = blockIdx.x * warps * kBwdRounds;
  const int w_end = w_begin + warps * kBwdRounds < w_n ? w_begin + warps * kBwdRounds : w_n;
  for (int w0 = w_begin; w0 < w_end; w0 += warps) {
    const int w = w0 + warp;  // this warp's pixel; past w_end the warp idles in phase 1
    float* s = acc + warp * c_n;
    for (int x = lane; x < c_n; x += kWarp) s[x] = 0.0f;
    // ---- phase 1: S[t, i, j] = sum over the rois, in order, of g / n ----
    for (int r0 = 0; r0 < r_n; r0 += kRoiChunk) {
      const int rc = r_n - r0 < kRoiChunk ? r_n - r0 : kRoiChunk;
      __syncthreads();  // the previous chunk's readers are done
      // a roi's 4 k bounds are k int4s: one 16-byte load each (the chunk
      // starts at a multiple of 16 bytes), transposed into sbd
      const int4* src = reinterpret_cast<const int4*>(bounds + (static_cast<long long>(b) * r_n + r0) * 4 * k);
      for (int x = threadIdx.x; x < rc * k; x += blockDim.x) {
        const int4 v = __ldg(src + x);
        const int r = x / k, q = 4 * (x - r * k);
        sbd[q * ld + r] = v.x;
        sbd[(q + 1) * ld + r] = v.y;
        sbd[(q + 2) * ld + r] = v.z;
        sbd[(q + 3) * ld + r] = v.w;
      }
      __syncthreads();
      for (int r = threadIdx.x; r < rc; r += blockDim.x) {
        unsigned m = 0;
#pragma unroll
        for (int i = 0; i < k; ++i) m |= static_cast<unsigned>(sbd[i * ld + r] <= h && h < sbd[(k + i) * ld + r]) << i;
        imask[r] = m;
      }
      __syncthreads();
      if (w < w_end) {  // warp-uniform
        // lanes over 32 rois at a time find the bins (i, j) that hold the
        // pixel; then the warp takes those rois in order, lanes over t
        for (int rb = 0; rb < rc; rb += kWarp) {
          const int r = rb + lane;
          unsigned mi = 0, mj = 0;
          if (r < rc) {
            mi = imask[r];
            if (mi != 0)
#pragma unroll
              for (int j = 0; j < k; ++j)
                mj |= static_cast<unsigned>(sbd[(2 * k + j) * ld + r] <= w && w < sbd[(3 * k + j) * ld + r]) << j;
          }
          scan_i[lane] = mi;
          scan_j[lane] = mj;
          __syncwarp();
          for (unsigned hits = __ballot_sync(0xffffffffu, mi != 0 && mj != 0); hits != 0; hits &= hits - 1) {
            const int src_lane = __ffs(hits) - 1;
            const unsigned bi = scan_i[src_lane], bj = scan_j[src_lane];
            const int rr = rb + src_lane;
            const float* gr = g + b * gsb + (r0 + rr) * gsr;
            for (unsigned ai = bi; ai != 0; ai &= ai - 1) {
              const int i = __ffs(ai) - 1;
              const int i0 = sbd[i * ld + rr], i1 = sbd[(k + i) * ld + rr];
              for (unsigned aj = bj; aj != 0; aj &= aj - 1) {
                const int j = __ffs(aj) - 1;
                const int n = bin_numel(i0, i1, sbd[(2 * k + j) * ld + rr], sbd[(3 * k + j) * ld + rr]);
                if (n <= 0) continue;  // the plain version's g / n is 0 there
                const float nf = static_cast<float>(n);
                const float* gp = gr + i * gsi + j * gsj;
                float* sp = s + i * k + j;
                for (int t = lane; t < t_n; t += kWarp) sp[t * kk] += __ldg(gp + t * gst) / nf;
              }
            }
          }
          __syncwarp();  // every lane has read the scan before the next group's
        }
      }
    }
    __syncthreads();
    // ---- phase 2: dfm[b, h, w0 + p, c] = sum of S over ch^-1(c) ----
    const int np = w_end - w0 < warps ? w_end - w0 : warps;
    float* row = dfm + static_cast<long long>(b) * sb + static_cast<long long>(h) * sh;
    for (int p = 0; p < np; ++p) {
      const float* sp = acc + p * c_n;
      float* px = row + static_cast<long long>(w0 + p) * sw;
#pragma unroll 4
      for (int c = threadIdx.x; c < c_n; c += blockDim.x) {
        float v = 0.0f;
        for (int q = s_ptr[c], q_end = s_ptr[c + 1]; q < q_end; ++q) v += sp[s_idx[q]];
        px[static_cast<long long>(c) * sc] = v;
      }
    }
    __syncthreads();  // phase 2's readers are done before the next round zeroes S
  }
}

using BwdKernel = void (*)(const float*, long long, long long, long long, long long, long long, const int*,
                          const int*, const int*, float*, long long, long long, long long, long long, int, int, int,
                          int, int);

// the backward's instance for k: the R-FCN's k 7 unrolled, any other k generic
BwdKernel bwd_kernel(int k) { return k == 7 ? psroi_bwd_kernel<7> : psroi_bwd_kernel<0>; }

}  // namespace

extern "C" {

// shared memory of the backward at C channels, k, R rois (0 when no block
// of one warp fits in a Hopper block's shared memory)
size_t d2t_psroi_bwd_smem_bytes(int c, int k, int r) {
  const int warps = bwd_warps(c, k, r);
  return warps ? bwd_smem_bytes(warps, c, k, r) : 0;
}

// allow the backward instance its dynamic shared memory (past 48 KB)
static cudaError_t bwd_configure(BwdKernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// backward blocks resident on an SM at C channels, k, R rois (-1 on error)
int d2t_psroi_bwd_blocks_per_sm(int c, int k, int r) {
  const int warps = bwd_warps(c, k, r);
  if (warps == 0 || k < 1 || k > 32) return -1;
  const size_t smem = bwd_smem_bytes(warps, c, k, r);
  int blocks = -1;
  if (bwd_configure(bwd_kernel(k), smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bwd_kernel(k), warps * kWarp, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// fm: (B, H, W, C) float32 at element strides (sb, sh, sw, sc), C = T k^2;
// bounds: (B, R, 4, k) int32, contiguous; out: (B, R, T, k, k) float32,
// contiguous, every element written. One launch on `stream`. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes the
// kernel does not take.
int d2t_psroi_fwd(const void* fm, const void* bounds, void* out, int b, int r, int t, int k, int h, int w,
                  long long sb, long long sh, long long sw, long long sc, int paper, void* stream) {
  if (b < 1 || r < 1 || t < 1 || k < 1 || k > 32 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_bins = static_cast<long long>(b) * r * k * k;
  const long long blocks = (n_bins + kFwdThreads / kWarp - 1) / (kFwdThreads / kWarp);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  psroi_fwd_kernel<<<static_cast<unsigned>(blocks), kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fm), static_cast<const int*>(bounds), static_cast<float*>(out), n_bins, r, t, k, h,
      w, sb, sh, sw, sc, paper);
  return static_cast<int>(cudaGetLastError());
}

// g: (B, R, T, k, k) float32 at element strides (gsb, gsr, gst, gsi, gsj);
// bounds: (B, R, 4, k) int32, contiguous; inv_ptr (C + 1), inv_idx (T k^2):
// int32, the channel map's inverse (the flat (t, i, j) of channel c are
// inv_idx[inv_ptr[c] .. inv_ptr[c + 1]), ascending); dfm: (B, H, W, C)
// float32 at element strides (sb, sh, sw, sc), every element written. One
// launch on `stream`. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes the kernel does not take.
int d2t_psroi_bwd(const void* g, long long gsb, long long gsr, long long gst, long long gsi, long long gsj,
                  const void* bounds, const void* inv_ptr, const void* inv_idx, void* dfm, int b, int r, int t,
                  int k, int h, int w, int c, long long sb, long long sh, long long sw, long long sc, void* stream) {
  if (b < 1 || r < 1 || t < 1 || k < 1 || k > 32 || h < 1 || w < 1 || c < 1 || b > kMaxGrid || h > kMaxGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = bwd_warps(c, k, r);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem_bytes(warps, c, k, r);
  const BwdKernel kernel = bwd_kernel(k);
  const cudaError_t err = bwd_configure(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int px = warps * kBwdRounds;
  const dim3 grid((w + px - 1) / px, h, b);
  kernel<<<grid, warps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), gsb, gsr, gst, gsi, gsj, static_cast<const int*>(bounds),
      static_cast<const int*>(inv_ptr), static_cast<const int*>(inv_idx), static_cast<float*>(dfm), sb, sh, sw, sc,
      r, t, k, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
