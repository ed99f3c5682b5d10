// PSROIPool (position-sensitive average ROI pooling) for Hopper (sm_90a):
// the forward and a deterministic backward on bin-major f32 score maps.
//
// Replaces detect_to_track_tpu/ops/pooling.py:154 `_ps_roi_pool_einsum`, an
// XLA program of mask matmuls (a channel gather, then two batched matmuls;
// its backward more matmuls and the gather's scatter), not a Pallas kernel.
// Its plain version is ops/pooling.py's einsum form. With T targets and a k x
// k grid, the maps fg are bin-major: channel (i k + j) T + t holds target t
// of bin (i, j), so a bin's T targets at a pixel are T contiguous floats.
// The R-FCN's 1x1 convolutions write them so (their weight rows gathered by
// the channel map, the reference's quirk ch(t, i, j) = (t + 1) (i k + j) or
// the paper's t k^2 + i k + j; ops/pooling.py BinMajorRows): the channel
// map lives there, in neither kernel.
//
//   out[b, r, t, i, j] = sum_{h in [i0, i1), w in [j0, j1)} fg[b, h, w, (i k + j) T + t] / n
//
// The geometry, the layouts and the backward are bin_pool.cuh's, shared
// with ROIPool (roipool.cu, whose fused head's backward is this one):
//
// 1. psroi_fwd_kernel: one block per roi (b, r), blocks in frame order, the
//    roi's bounds staged in shared memory. Each lane group takes a bin of
//    the roi in turn, the warp P bins at a time, and each lane sums its
//    target over the bin's pixels (bin_sum: row-major order, kFwdBatch
//    loads in flight before their adds, in order), then divides once
//    (bitwise the same on a repeat). The roi's T k^2 outputs are staged in
//    shared memory and leave as one contiguous (T, k, k) run.
// 2. the backward: psroi_bwd_prologue_kernel, then psroi_bwd_kernel<kK>,
//    pixel-major, no atomics (bin_pool.cuh).
//
// What bounds it on this card: the bytes. At the working point (8 frames, 38
// x 75, 256 rois, k 7; the class head's 1519 channels and the box head's
// 196) the forward reads the map elements its bins hold (~53 MB of the class
// head's 139 under the quirk, counted in the reference layout) and writes
// ~13 MB; the backward reads g (~13 MB) and writes dfg (~139 MB). The adds
// (one a pixel of a bin and target) are far below the float32 rate. What the
// design does about it: a bin's targets are contiguous, so a warp load moves
// the sectors it needs (4-5 for the class head's 31 floats, where reference-
// layout maps took 31); each output and each dfg element is written once, in
// contiguous runs; the backward's shared memory holds S alone (the class
// head: 4 blocks an SM), and its roi scan reads two precomputed masks a roi
// instead of staging bounds. What is left is latency: each lane's chain of
// pixel loads (forward) and of hits (backward), and the backward's fixed
// cost, about half of the class head's time with no hit at all.

#include "bin_pool.cuh"

namespace {

// grid (B R); block kFwdThreads; dynamic shared memory T k^2 floats and 4 k
// ints
__global__ void __launch_bounds__(kFwdThreads)
psroi_fwd_kernel(const float* __restrict__ fg, const int* __restrict__ bounds, float* __restrict__ out, int r_n,
                 int t_n, int k, int h_n, int w_n, long long sb, long long sh, long long sw, long long sc) {
  extern __shared__ float smem[];  // the roi's outputs, (T, k, k), then its bounds
  const long long br = blockIdx.x;  // b * R + r
  const long long b = br / r_n;
  const int kk = k * k;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int lanes = lanes_per_pixel(t_n), groups = kWarp / lanes;
  const int tl = lane % lanes, group = lane / lanes;
  int* bd = reinterpret_cast<int*>(smem + t_n * kk);  // rows i0, i1, j0, j1
  for (int x = threadIdx.x; x < 4 * k; x += kFwdThreads) bd[x] = __ldg(bounds + br * 4 * k + x);
  __syncthreads();
  const float* frame = fg + b * sb;
  // a warp takes P bins at a time, a lane group each
  for (int bin = warp * groups + group; bin < kk; bin += kFwdThreads / kWarp * groups) {
    const int i = bin / k, j = bin - i * k;
    const int i0 = bd[i], i1 = bd[k + i], j0 = bd[2 * k + j], j1 = bd[3 * k + j];
    const int n = bin_numel(i0, i1, j0, j1);
    for (int t = tl; t < t_n; t += lanes) {
      const float sum = bin_sum(frame + (static_cast<long long>(bin) * t_n + t) * sc, i0, i1, j0, j1, h_n, w_n, sh, sw);
      smem[t * kk + bin] = n > 0 ? sum / static_cast<float>(n) : 0.0f;
    }
  }
  __syncthreads();
  float* o = out + br * t_n * kk;
  for (int x = threadIdx.x; x < t_n * kk; x += kFwdThreads) o[x] = smem[x];
}

}  // namespace

extern "C" {

// shared memory of the backward at T targets and k (0 when no block of one
// warp fits in a Hopper block's shared memory)
size_t d2t_psroi_bwd_smem_bytes(int t, int k) {
  const int warps = bwd_warps(t, k);
  return warps ? bwd_smem_bytes(warps, t, k) : 0;
}

// backward blocks resident on an SM at T targets and k (-1 on error)
int d2t_psroi_bwd_blocks_per_sm(int t, int k) {
  const int warps = bwd_warps(t, k);
  if (warps == 0 || k < 1 || k > 32) return -1;
  const size_t smem = bwd_smem_bytes(warps, t, k);
  int blocks = -1;
  const BwdKernel kernel = bwd_kernel(k);
  if (smem_configure(reinterpret_cast<const void*>(kernel), smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * kWarp, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// fg: (B, H, W, T k^2) bin-major float32 at element strides (sb, sh, sw,
// sc); bounds: (B, R, 4, k) int32, contiguous; out: (B, R, T, k, k)
// float32, contiguous, every element written. One launch on `stream`.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// shapes the kernel does not take (T k^2 past a block's shared memory).
int d2t_psroi_fwd(const void* fg, const void* bounds, void* out, int b, int r, int t, int k, int h, int w,
                  long long sb, long long sh, long long sw, long long sc, void* stream) {
  if (b < 1 || r < 1 || t < 1 || k < 1 || k > 32 || h < 1 || w < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * r;
  const size_t smem = sizeof(float) * static_cast<size_t>(t) * k * k + sizeof(int) * 4 * k;
  if (blocks > 0x7fffffffLL || smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = smem_configure(reinterpret_cast<const void*>(psroi_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  psroi_fwd_kernel<<<static_cast<unsigned>(blocks), kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fg), static_cast<const int*>(bounds), static_cast<float*>(out), r, t, k, h, w, sb, sh,
      sw, sc);
  return static_cast<int>(cudaGetLastError());
}

// g: (B, R, T, k, k) float32 at element strides (gsb, gsr, gst, gsi, gsj);
// bounds: (B, R, 4, k) int32, contiguous; gs: (B, R, k, k, T) float32
// scratch (g / n bin-major); masks: B (H + W) R uint32 scratch (each roi's
// bins holding each row, then each column); dfg: (B, H, W, T k^2)
// float32, contiguous and 16-byte aligned, every element written. Two
// launches on `stream` (the prologue, then the pixel-major kernel).
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// shapes the kernel does not take.
int d2t_psroi_bwd(const void* g, long long gsb, long long gsr, long long gst, long long gsi, long long gsj,
                  const void* bounds, void* gs, void* masks, void* dfg, int b, int r, int t, int k, int h, int w,
                  void* stream) {
  return launch_bin_bwd(g, gsb, gsr, gst, gsi, gsj, bounds, gs, masks, dfg, b, r, t, k, h, w, stream);
}

}  // extern "C"
