// ROIPool (average ROI pooling, the reference's roipool_cuda.cu) for Hopper
// (sm_90a): the tracker's fused pool-fc head and the materialized pooling,
// each a forward and a deterministic backward on f32 maps.
//
// Replaces detect_to_track_tpu/ops/pooling.py:118 `roi_pool_linear` and
// :95 `roi_pool` (`_roi_pool_einsum`), XLA programs of mask matmuls (two
// batched matmuls a call; their backwards more matmuls), not Pallas kernels.
// Their plain versions are ops/pooling.py's einsum forms. ROIPool's geometry
// clamps the roi's top-left corner to [0, 1] (the caller's bounds do it);
// the rest (the bounds, n, empty bins) is bin_pool.cuh's.
//
// 1. The fused head: the tracker's pyramid, projected by the fc weight
//    before pooling, is g (B, H, W, k, k, O), and
//
//      out[b, r, o] = sum_{i, j} (1 / n) sum_{(h, w) in bin (i, j)} g[b, h, w, i, j, o]
//
//    g is bin-major with T = O (channel (i k + j) O + o), the layout
//    PSROIPool's kernels read. roipool_linear_fwd_kernel: a block per roi;
//    the roi's pixels are split into slots (bin_pool.cuh plan_slots), runs
//    of at most ceil(N / 64) of a bin's pixels, N those of all its bins, so
//    each of the block's 64 lane groups (4 lanes, one a value) sums about N
//    / 64 pixels however the bins' sizes differ: under ROIPool's corner
//    clamp a detection larger than the frame puts the whole map into its
//    bin (0, 0), which a lane group a bin summed alone (that first design
//    took 0.213 ms on an H100 for a 4-pair call's detections). The
//    slots' sums are staged; each bin's average sums its slots in order, and
//    the k^2 averages are summed in a fixed order (a warp a value, a lane a
//    bin or two, then a shuffle tree), in the kernel. The backward
//
//      dg[b, h, w, i, j, o] = sum_r [i0 <= h < i1] [j0 <= w < j1] dout[b, r, o] / n
//
//    is PSROIPool's (the prologue, then the pixel-major psroi_bwd_kernel<7>)
//    with the cotangent's (i, j) strides 0: no atomics, every element of dg
//    written, bitwise the same on a repeat.
// 2. The materialized pooling: out[b, r, i, j, c] = (1 / n) sum_{(h, w) in
//    bin (i, j)} fm[b, h, w, c], every bin reading the same C channels
//    (the tracker's oracle head: C = 2 512 + 3 289 = 1891).
//    - roipool_fwd_kernel: a block per (roi, 32 channels), lanes over the
//      channels (one coalesced 128-byte load of a pixel on NHWC maps), the
//      block's 8 warps over the roi's slots as above; each lane sums its
//      channel over a slot's pixels with kFwdBatch loads in flight, then
//      the warps store the bins' averages as 128-byte runs of the outputs
//      (B, R, k, k, C). The channels are split over blocks: a roi's (k, k,
//      C) outputs (370 KB at C 1891) do not fit a block's shared memory.
//    - the backward dfm[b, h, w, c] = sum over the rois r and bins (i, j)
//      that hold (h, w) of dout[b, r, i, j, c] / n: roipool_bwd_prologue_kernel
//      (each bin's n, each roi's row and column bin masks), then
//      roipool_bwd_kernel, pixel-major: a warp per (pixel, 128 channels),
//      4 a lane; lanes over 32 rois read the masks, a ballot lists the rois
//      that hold the pixel, and the warp walks their hits in order (rois
//      ascending, then i, then j; next_hit), kHitBatch hits' loads in flight,
//      each term divided by n as the plain version's is. A lane owns its
//      channels' sums: no atomics, bitwise the same on a repeat, every
//      element of dfm written once.
//
// What bounds it on this card: the bytes. The fused head at a 4-pair call (R
// 128, k 7, O 4, 38 x 75) reads at most g's 8.9 MB and writes 2 KB; its
// backward reads the 8 KB cotangent and writes dg's 8.9 MB. The materialized
// pooling at C 1891 writes 190 MB (4 pairs) and reads the map elements its
// bins hold, of the map's 86 MB; its backward reads the 190 MB cotangent
// and writes the map's gradient. The adds (one a pixel of a bin and output)
// are far below the float32 rate. What the design does about it: each
// output and gradient element is written once; the materialized kernels'
// lanes read consecutive channels; the fused backward's hits read four
// contiguous floats of g / n. What is left is latency: the slots' chains
// of pixel loads and the bin sums (forwards), the hit walks (backwards). On
// an H100 the fused forward runs at about 12x its bound, the materialized
// kernels at 13-27x theirs.

#include "bin_pool.cuh"

namespace {

constexpr int kRoiFwdWarps = 8;  // slot warps of a materialized forward block (one roi, 32 channels)
constexpr int kRoiBwdWarps = 8;  // pixels of a materialized backward block, a warp each
constexpr int kRoiBwdVec = 4;    // channels of a backward lane: a warp takes 128 of its pixel's

// shared memory of a slotted forward block: (groups + k^2) x width floats
// (each slot's sums), then 4 k (the bounds), k^2 + 2 (each bin's first
// slot, the slot size) and groups + k^2 (each slot's bin) ints
__host__ __device__ inline size_t slotted_smem_bytes(int groups, int width, int k) {
  const size_t slots = static_cast<size_t>(groups) + k * k;
  return sizeof(float) * slots * width + sizeof(int) * (4 * k + k * k + 2 + slots);
}

// stage roi br's bounds and plan its slots for `groups` lane groups (all the
// block's threads call it); returns the bounds, and first and owner through
// the pointers
__device__ __forceinline__ int* slotted_setup(float* smem, const int* __restrict__ bounds, long long br, int groups,
                                              int width, int k, int h_n, int w_n, int*& first, int*& owner) {
  const int kk = k * k;
  int* bd = reinterpret_cast<int*>(smem + (groups + kk) * width);  // rows i0, i1, j0, j1
  first = bd + 4 * k;
  owner = first + kk + 2;
  for (int x = threadIdx.x; x < 4 * k; x += blockDim.x) bd[x] = __ldg(bounds + br * 4 * k + x);
  __syncthreads();
  if (threadIdx.x < kWarp) plan_slots(bd, k, h_n, w_n, groups, first);
  __syncthreads();
  slot_owners(first, kk, blockDim.x, owner);
  __syncthreads();
  return bd;
}

// bin `bin`'s average at value column `col` of the slots' sums: its slots
// summed in order, divided by n; 0 where n <= 0
__device__ __forceinline__ float slotted_average(const float* part, const int* bd, const int* first, int bin, int k,
                                                 int width, int col) {
  const int i = bin / k, j = bin - i * k;
  const int n = bin_numel(bd[i], bd[k + i], bd[2 * k + j], bd[3 * k + j]);
  float sum = 0.0f;
  for (int q = first[bin]; q < first[bin + 1]; ++q) sum += part[q * width + col];
  return n > 0 ? sum / static_cast<float>(n) : 0.0f;
}

// grid (B R); block kFwdThreads; dynamic shared memory
// slotted_smem_bytes(kFwdThreads / L, T, k). g: (B, H, W, k^2 T) bin-major
// at element strides (sb, sh, sw, sc); out: (B, R, T), contiguous
__global__ void __launch_bounds__(kFwdThreads)
roipool_linear_fwd_kernel(const float* __restrict__ g, const int* __restrict__ bounds, float* __restrict__ out,
                          int r_n, int t_n, int k, int h_n, int w_n, long long sb, long long sh, long long sw,
                          long long sc) {
  extern __shared__ float smem[];  // each slot's T sums, then the bounds and the slots' plan
  const long long br = blockIdx.x;  // b * R + r
  const int kk = k * k, lanes = lanes_per_pixel(t_n), groups = kFwdThreads / lanes;
  int *first, *owner;
  const int* bd = slotted_setup(smem, bounds, br, groups, t_n, k, h_n, w_n, first, owner);
  const int tl = threadIdx.x % lanes, group = threadIdx.x / lanes;
  const float* frame = g + br / r_n * sb;
  // a lane group takes a slot at a time, its lanes the values
  for (int slot = group; slot < first[kk]; slot += groups) {
    int bin, start, count;
    BinRect rc;
    slot_run(bd, first, owner, slot, k, h_n, w_n, bin, rc, start, count);
    for (int t = tl; t < t_n; t += lanes)
      smem[slot * t_n + t] = pixel_run_sum(frame + (static_cast<long long>(bin) * t_n + t) * sc, rc.h_lo, rc.w_lo,
                                           rc.bw, start, count, sh, sw);
  }
  __syncthreads();
  // each value's k^2 bin averages, summed in a fixed order: a warp a value,
  // its lanes over the bins, then a shuffle tree
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  for (int t = warp; t < t_n; t += kFwdThreads / kWarp) {
    float s = 0.0f;
    for (int bin = lane; bin < kk; bin += kWarp) s += slotted_average(smem, bd, first, bin, k, t_n, t);
    for (int off = kWarp / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[br * t_n + t] = s;
  }
}

// grid (B R, ceil(C / 32)); block kRoiFwdWarps warps; dynamic shared memory
// slotted_smem_bytes(kRoiFwdWarps, 32, k). fm: (B, H, W, C) at element
// strides (sb, sh, sw, sc); out: (B, R, k, k, C), contiguous
__global__ void __launch_bounds__(kRoiFwdWarps * kWarp)
roipool_fwd_kernel(const float* __restrict__ fm, const int* __restrict__ bounds, float* __restrict__ out, int r_n,
                   int c_n, int k, int h_n, int w_n, long long sb, long long sh, long long sw, long long sc) {
  extern __shared__ float smem[];  // each slot's 32 channels' sums, then the bounds and the slots' plan
  const long long br = blockIdx.x;  // b * R + r
  const int kk = k * k;
  int *first, *owner;
  const int* bd = slotted_setup(smem, bounds, br, kRoiFwdWarps, kWarp, k, h_n, w_n, first, owner);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int c = blockIdx.y * kWarp + lane;
  const bool live = c < c_n;
  const float* frame = fm + br / r_n * sb + (live ? c : 0) * sc;
  // a warp takes a slot at a time, its lanes 32 channels
  for (int slot = warp; slot < first[kk]; slot += kRoiFwdWarps) {
    int bin, start, count;
    BinRect rc;
    slot_run(bd, first, owner, slot, k, h_n, w_n, bin, rc, start, count);
    smem[slot * kWarp + lane] = live ? pixel_run_sum(frame, rc.h_lo, rc.w_lo, rc.bw, start, count, sh, sw) : 0.0f;
  }
  __syncthreads();
  if (!live) return;
  float* o = out + br * kk * c_n + c;
  for (int bin = warp; bin < kk; bin += kRoiFwdWarps)
    o[static_cast<long long>(bin) * c_n] = slotted_average(smem, bd, first, bin, k, kWarp, lane);
}

// grid (B R); block kPrologueThreads; dynamic shared memory 4 k ints. For
// roi (b, r): nb[b, r, i, j] = n (int32), and the roi's bin masks
// (roi_bin_masks)
__global__ void __launch_bounds__(kPrologueThreads)
roipool_bwd_prologue_kernel(const int* __restrict__ bounds, int* __restrict__ nb, unsigned* __restrict__ rows,
                            unsigned* __restrict__ cols, int r_n, int k, int h_n, int w_n) {
  extern __shared__ int bd[];  // the roi's rows i0, i1, j0, j1
  const long long br = blockIdx.x;
  const long long b = br / r_n, r = br - b * r_n;
  const int kk = k * k;
  for (int x = threadIdx.x; x < 4 * k; x += kPrologueThreads) bd[x] = __ldg(bounds + br * 4 * k + x);
  __syncthreads();
  for (int x = threadIdx.x; x < kk; x += kPrologueThreads) {
    const int i = x / k, j = x - i * k;
    nb[br * kk + x] = bin_numel(bd[i], bd[k + i], bd[2 * k + j], bd[3 * k + j]);
  }
  roi_bin_masks(bd, rows, cols, b, r, r_n, k, h_n, w_n, kPrologueThreads);
}

// grid (ceil(W / kRoiBwdWarps), H, B x chunks of 128 channels); block
// kRoiBwdWarps warps. dout: (B, R, k, k, C) at element strides (sdb, sdr,
// sdi, sdj, sdc); nb, rows, cols: the prologue's; dfm: (B, H, W, C)
// contiguous
__global__ void __launch_bounds__(kRoiBwdWarps * kWarp)
roipool_bwd_kernel(const float* __restrict__ dout, long long sdb, long long sdr, long long sdi, long long sdj,
                   long long sdc, const int* __restrict__ nb, const unsigned* __restrict__ rows,
                   const unsigned* __restrict__ cols, float* __restrict__ dfm, int r_n, int c_n, int k, int h_n,
                   int w_n, int chunks) {
  __shared__ unsigned scan[kRoiBwdWarps * 2 * kWarp];  // a warp's: 32 rois' row bins, then their column bins
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.z / chunks, chunk = blockIdx.z - b * chunks;
  const int h = blockIdx.y, w = blockIdx.x * kRoiBwdWarps + warp;
  if (w >= w_n) return;  // warp-uniform; no block barrier below
  const int kk = k * k;
  unsigned* scan_i = scan + warp * 2 * kWarp;
  unsigned* scan_j = scan_i + kWarp;
  const int c0 = chunk * kWarp * kRoiBwdVec + lane;  // the lane's channels: c0 + 32 u
  const float* db = dout + b * sdb + c0 * sdc;
  const int* nbb = nb + static_cast<long long>(b) * r_n * kk;
  const unsigned* row_bins = rows + (static_cast<long long>(b) * h_n + h) * r_n;
  const unsigned* col_bins = cols + (static_cast<long long>(b) * w_n + w) * r_n;
  float acc[kRoiBwdVec];
#pragma unroll
  for (int u = 0; u < kRoiBwdVec; ++u) acc[u] = 0.0f;
  for (int rb = 0; rb < r_n; rb += kWarp) {
    const int r = rb + lane;
    const unsigned mi = r < r_n ? __ldg(row_bins + r) : 0u;
    const unsigned mj = mi != 0 ? __ldg(col_bins + r) : 0u;
    scan_i[lane] = mi;
    scan_j[lane] = mj;
    const unsigned hits = __ballot_sync(0xffffffffu, mj != 0);
    __syncwarp();
    HitWalk it{hits, 0u, 0u, 0u, 0, 0};
    for (bool more = hits != 0; more;) {
      int roi[kHitBatch], bin[kHitBatch], n[kHitBatch];
      bool ok[kHitBatch];
      float v[kHitBatch][kRoiBwdVec];
#pragma unroll
      for (int q = 0; q < kHitBatch; ++q) {
        roi[q] = bin[q] = 0;
        ok[q] = next_hit(it, scan_i, scan_j, k, roi[q], bin[q]);
      }
#pragma unroll
      for (int q = 0; q < kHitBatch; ++q) {
        const int i = bin[q] / k, j = bin[q] - i * k;
        const float* p = db + (rb + roi[q]) * sdr + i * sdi + j * sdj;
        n[q] = ok[q] ? __ldg(nbb + static_cast<long long>(rb + roi[q]) * kk + bin[q]) : 0;
#pragma unroll
        for (int u = 0; u < kRoiBwdVec; ++u)
          v[q][u] = ok[q] && c0 + u * kWarp < c_n ? __ldg(p + u * kWarp * sdc) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kHitBatch; ++q)
        if (n[q] > 0) {
#pragma unroll
          for (int u = 0; u < kRoiBwdVec; ++u) acc[u] += v[q][u] / static_cast<float>(n[q]);
        }
      more = ok[kHitBatch - 1];
    }
    __syncwarp();  // every lane has read the scan before the next group's
  }
  float* dst = dfm + ((static_cast<long long>(b) * h_n + h) * w_n + w) * c_n;
#pragma unroll
  for (int u = 0; u < kRoiBwdVec; ++u)
    if (c0 + u * kWarp < c_n) dst[c0 + u * kWarp] = acc[u];
}

}  // namespace

extern "C" {

// g: (B, H, W, k, k, O) float32 at element strides (sb, sh, sw) and so of
// the flattened (k, k, O) axes (channel (i k + j) O + o); bounds: (B, R, 4,
// k) int32, contiguous (ROIPool's, corner clamped); out: (B, R, O)
// float32, contiguous. One launch on `stream`. Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for shapes the kernel does not
// take (the slots' sums past a block's shared memory).
int d2t_roipool_linear_fwd(const void* g, const void* bounds, void* out, int b, int r, int o, int k, int h, int w,
                           long long sb, long long sh, long long sw, long long so, void* stream) {
  if (b < 1 || r < 1 || o < 1 || k < 1 || k > 32 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * r;
  const size_t smem = slotted_smem_bytes(kFwdThreads / lanes_per_pixel(o), o, k);
  if (blocks > 0x7fffffffLL || smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = smem_configure(reinterpret_cast<const void*>(roipool_linear_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  roipool_linear_fwd_kernel<<<static_cast<unsigned>(blocks), kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(bounds), static_cast<float*>(out), r, o, k, h, w, sb, sh,
      sw, so);
  return static_cast<int>(cudaGetLastError());
}

// dout: (B, R, O) float32 at element strides (sdb, sdr, sdo); bounds as the
// forward's; gs: (B, R, k, k, O) float32 scratch (dout / n); masks: B (H +
// W) R uint32 scratch; dg: (B, H, W, k, k, O) float32, contiguous and
// 16-byte aligned, every element written. Two launches on `stream` (the
// prologue, then the pixel-major kernel: d2t_psroi_bwd's, with the
// cotangent's (i, j) strides 0).
int d2t_roipool_linear_bwd(const void* dout, long long sdb, long long sdr, long long sdo, const void* bounds,
                           void* gs, void* masks, void* dg, int b, int r, int o, int k, int h, int w, void* stream) {
  return launch_bin_bwd(dout, sdb, sdr, sdo, 0, 0, bounds, gs, masks, dg, b, r, o, k, h, w, stream);
}

// fm: (B, H, W, C) float32 at element strides (sb, sh, sw, sc); bounds:
// (B, R, 4, k) int32, contiguous; out: (B, R, k, k, C) float32,
// contiguous, every element written. One launch on `stream`. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// the kernel does not take.
int d2t_roipool_fwd(const void* fm, const void* bounds, void* out, int b, int r, int c, int k, int h, int w,
                    long long sb, long long sh, long long sw, long long sc, void* stream) {
  if (b < 1 || r < 1 || c < 1 || k < 1 || k > 32 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * r, chunks = (c + kWarp - 1) / kWarp;
  const size_t smem = slotted_smem_bytes(kRoiFwdWarps, kWarp, k);
  if (blocks > 0x7fffffffLL || chunks > kMaxGrid || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = smem_configure(reinterpret_cast<const void*>(roipool_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  roipool_fwd_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks)), kRoiFwdWarps * kWarp, smem,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(fm),
                                                            static_cast<const int*>(bounds), static_cast<float*>(out),
                                                            r, c, k, h, w, sb, sh, sw, sc);
  return static_cast<int>(cudaGetLastError());
}

// dout: (B, R, k, k, C) float32 at element strides (sdb, sdr, sdi, sdj,
// sdc); bounds: (B, R, 4, k) int32, contiguous; nb: B R k^2 int32 scratch
// (each bin's n); masks: B (H + W) R uint32 scratch (each roi's bins
// holding each row, then each column); dfm: (B, H, W, C) float32,
// contiguous, every element written. Two launches on `stream` (the
// prologue, then the pixel-major kernel). Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for shapes the kernel does not take.
int d2t_roipool_bwd(const void* dout, long long sdb, long long sdr, long long sdi, long long sdj, long long sdc,
                    const void* bounds, void* nb, void* masks, void* dfm, int b, int r, int c, int k, int h, int w,
                    void* stream) {
  const long long chunks = (c + kWarp * kRoiBwdVec - 1) / (kWarp * kRoiBwdVec);
  if (b < 1 || r < 1 || c < 1 || k < 1 || k > 32 || h < 1 || w < 1 || h > kMaxGrid || b * chunks > kMaxGrid ||
      static_cast<long long>(b) * r > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* rows = static_cast<unsigned*>(masks);
  unsigned* cols = rows + static_cast<long long>(b) * h * r;
  roipool_bwd_prologue_kernel<<<static_cast<unsigned>(static_cast<long long>(b) * r), kPrologueThreads,
                                sizeof(int) * 4 * k, st>>>(static_cast<const int*>(bounds), static_cast<int*>(nb),
                                                           rows, cols, r, k, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kRoiBwdWarps - 1) / kRoiBwdWarps, h, static_cast<unsigned>(b * chunks));
  roipool_bwd_kernel<<<grid, kRoiBwdWarps * kWarp, 0, st>>>(static_cast<const float*>(dout), sdb, sdr, sdi, sdj, sdc,
                                                           static_cast<const int*>(nb), rows, cols,
                                                           static_cast<float*>(dfm), r, c, k, h, w,
                                                           static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
