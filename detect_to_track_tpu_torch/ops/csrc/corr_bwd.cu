// Pointwise correlation backward for Hopper (sm_90a), CUDA cores, f32 sums.
//
// Replaces the TPU kernels of detect_to_track_tpu/ops/correlation.py:
//   - _bwd_fm0_kernel (K2) by corr_bwd_fm0:
//       dFM0[b, i, j, c] = sum_{di, dj} m * g[b, di*k+dj, i, j]
//                                      * FM1[b, i+di-d, j+dj-d, c]
//   - _bwd_fm1_single_tile_kernel (K3, H <= 40 there) and _bwd_fm1_kernel
//     (K4, halo'd row tiles for H > 40) by corr_bwd_fm1, for any H:
//       dFM1[b, y, x, c] = sum_{di, dj} m * g[b, di*k+dj, i, j] * FM0[b, i, j, c]
//     with the source pixel (i, j) = (y-di+d, x-dj+d) inside the map.
// k = 2d+1, di and dj run over [0, 2d) (the +d plane row and column carry no
// gradient), and m is the forward's window mask (correlation_window_masks)
// of the source pixel: the displaced pixel lies in the map and, for
// stride > 1, on the stride phase counted from max(0, p - d). The TPU split
// between K3 and K4 is a VMEM tiling choice; here one kernel takes any H.
//
// Gather form, no atomics: each output element owns its whole sum, so the
// result is the same bits from run to run.
//
// What bounds it: per call at 4 pairs, 38x75, d 8, bf16, the function reads
// g (13.2 MB f32) and one map, and writes one gradient: 59.8 MB at C = 1024,
// 106.6 MB at C = 2048, so 17.9 / 31.8 us at 3.35 TB/s; 6.0 / 12.1 GFLOP is
// 6 / 12 us on bf16 tensor cores. Bytes bound it; on the CUDA cores the
// arithmetic (90 / 180 us at 67 TFLOP/s f32) would.
//
// Design (simple first; a later change makes it fast):
// - one block of 4 warps per (b, output row, 32 output columns, 64
//   channels); a lane owns 2 channels (c and c + 32) of 8 adjacent output
//   columns, so 16 f32 sums sit in registers, and each warp owns 8 columns;
// - per row displacement di (skipped, block-uniformly, when the source row
//   is outside the map or off the stride phase) the block stages in shared
//   memory, as f32: the map row's window of 32 + 8*ceil(2d/8) - 1 columns
//   x 64 channels, and the 2d x 32 gradient values already masked and laid
//   out by OUTPUT column (for dFM1 the source column x - dj + d differs per
//   dj, so the diagonal is gathered once while staging);
// - per chunk of 8 column displacements a lane reads a sliding window of
//   15 map values per channel and 2 x 16 bytes of gradient (a broadcast: the
//   warp shares its columns) for 128 FMAs;
// - lanes run along channels, so map loads and gradient stores are
//   contiguous and the map window reads hit 32 different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 4;
constexpr int JB = 8;              // output columns per warp (and per lane)
constexpr int TJ = WARPS * JB;     // output columns per block
constexpr int CT = 2;              // channels per lane
constexpr int CCH = 32 * CT;       // channels per block
constexpr int DJ = 8;              // column displacements per unrolled chunk
constexpr int THREADS = 32 * WARPS;

struct Geometry {
  int nch;     // chunks of DJ column displacements
  int window;  // staged map columns
  size_t smem_bytes;
};

Geometry make_geometry(int d) {
  Geometry g;
  g.nch = (2 * d + DJ - 1) / DJ;
  g.window = TJ + DJ * g.nch - 1;
  g.smem_bytes =
      (static_cast<size_t>(g.window) * CCH + static_cast<size_t>(DJ) * g.nch * TJ) *
      sizeof(float);
  return g;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// correlation_window_masks: the source position p + r - d lies in the map,
// r < 2d, and it is on the stride phase counted from max(0, p - d).
__device__ __forceinline__ bool window_ok(int p, int r, int d, int stride,
                                          int size) {
  const int src = p + r - d;
  if (r >= 2 * d || src < 0 || src >= size) return false;
  return (src - max(0, p - d)) % stride == 0;
}

// kFm1 = false: dFM0 from FM1 (K2). kFm1 = true: dFM1 from FM0 (K3/K4).
template <typename T, bool kFm1>
__global__ void __launch_bounds__(THREADS)
    corr_bwd_kernel(const float* __restrict__ g, const T* __restrict__ fm,
                    T* __restrict__ out, int H, int W, int C, int d,
                    int stride, int nch, int window) {
  extern __shared__ float smem[];
  float* ms = smem;                 // [window][CCH] map row window
  float* gs = smem + window * CCH;  // [DJ*nch][TJ] masked gradient

  const int x0 = blockIdx.x * TJ;
  const int y = blockIdx.y;
  const int cblocks = (C + CCH - 1) / CCH;
  const int b = blockIdx.z / cblocks;
  const int c0 = (blockIdx.z % cblocks) * CCH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int two_d = 2 * d;
  const int k = two_d + 1;
  const int ndj = DJ * nch;

  const size_t plane = static_cast<size_t>(H) * W;
  const float* g_b = g + static_cast<size_t>(b) * k * k * plane;
  const T* fm_b = fm + static_cast<size_t>(b) * plane * C;
  // first staged map column: dFM0 reads FM1 at x + dj - d, dFM1 reads FM0 at
  // the source column x - dj + d
  const int wx0 = kFm1 ? x0 + d - (ndj - 1) : x0 - d;

  float acc[JB][CT];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) acc[jj][ch] = 0.f;

  for (int di = 0; di < two_d; ++di) {
    // the pixel row whose g and mask apply, and the map row read
    const int src_i = kFm1 ? y - di + d : y;
    const int map_row = kFm1 ? src_i : y + di - d;
    if (src_i < 0 || src_i >= H || !window_ok(src_i, di, d, stride, H))
      continue;  // uniform over the block
    __syncthreads();  // the previous displacement's reads are done
    const T* row = fm_b + static_cast<size_t>(map_row) * W * C;
    for (int e = tid; e < window * CCH; e += THREADS) {
      const int col = wx0 + e / CCH;
      const int c = c0 + e % CCH;
      ms[e] = (col >= 0 && col < W && c < C)
                  ? to_float(row[static_cast<size_t>(col) * C + c])
                  : 0.f;
    }
    const float* g_row = g_b + static_cast<size_t>(di) * k * plane +
                         static_cast<size_t>(src_i) * W;
    for (int e = tid; e < ndj * TJ; e += THREADS) {
      const int dj = e / TJ;
      const int x = x0 + e % TJ;
      const int src_j = kFm1 ? x - dj + d : x;
      float v = 0.f;
      if (x < W && src_j >= 0 && src_j < W && window_ok(src_j, dj, d, stride, W))
        v = g_row[static_cast<size_t>(dj) * plane + src_j];
      gs[e] = v;
    }
    __syncthreads();

    for (int djc = 0; djc < nch; ++djc) {
      // window index of (column jj, displacement djc*DJ + yy) is vbase + t
      // with t = jj + yy (dFM0) or jj - yy + DJ - 1 (dFM1)
      const int vbase = kFm1 ? warp * JB + ndj - DJ - djc * DJ
                             : warp * JB + djc * DJ;
      float v[JB + DJ - 1][CT];
#pragma unroll
      for (int t = 0; t < JB + DJ - 1; ++t)
#pragma unroll
        for (int ch = 0; ch < CT; ++ch)
          v[t][ch] = ms[(vbase + t) * CCH + ch * 32 + lane];
#pragma unroll
      for (int yy = 0; yy < DJ; ++yy) {
        const float4* grow =
            reinterpret_cast<const float4*>(gs + (djc * DJ + yy) * TJ + warp * JB);
        const float4 ga = grow[0];
        const float4 gb = grow[1];
        const float gv[JB] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) {
          const int t = kFm1 ? jj - yy + DJ - 1 : jj + yy;
#pragma unroll
          for (int ch = 0; ch < CT; ++ch)
            acc[jj][ch] = fmaf(gv[jj], v[t][ch], acc[jj][ch]);
        }
      }
    }
  }

  T* out_row = out + (static_cast<size_t>(b) * H + y) * W * C;
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) {
    const int x = x0 + warp * JB + jj;
    if (x >= W) continue;
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) {
      const int c = c0 + ch * 32 + lane;
      if (c < C) out_row[static_cast<size_t>(x) * C + c] = from_float<T>(acc[jj][ch]);
    }
  }
}

template <typename T, bool kFm1>
int launch(const void* g, const void* fm, void* out, int B, int H, int W,
           int C, int d, int stride, cudaStream_t stream) {
  const Geometry geo = make_geometry(d);
  cudaError_t err = cudaFuncSetAttribute(
      corr_bwd_kernel<T, kFm1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(geo.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TJ - 1) / TJ, H, B * ((C + CCH - 1) / CCH));
  corr_bwd_kernel<T, kFm1><<<grid, THREADS, geo.smem_bytes, stream>>>(
      static_cast<const float*>(g), static_cast<const T*>(fm),
      static_cast<T*>(out), H, W, C, d, stride, geo.nch, geo.window);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFm1>
int dispatch(const void* g, const void* fm, void* out, int B, int H, int W,
             int C, int d_max, int stride, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || d_max <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * ((C + CCH - 1) / CCH) > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, kFm1>(g, fm, out, B, H, W, C, d_max, stride, s);
  return launch<float, kFm1>(g, fm, out, B, H, W, C, d_max, stride, s);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs at this d_max; the wrapper checks
// it against the card's limit before launching.
size_t d2t_corr_bwd_smem_bytes(int d_max) {
  return make_geometry(d_max).smem_bytes;
}

// g: (B, (2d+1)^2, H, W) float32 contiguous. fm1, out: (B, H, W, C)
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); out gets
// dFM0, every element written. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int d2t_corr_bwd_fm0(const void* g, const void* fm1, void* out, int B, int H,
                     int W, int C, int d_max, int stride, int is_bf16,
                     void* stream) {
  return dispatch<false>(g, fm1, out, B, H, W, C, d_max, stride, is_bf16, stream);
}

// As d2t_corr_bwd_fm0, from fm0 to dFM1.
int d2t_corr_bwd_fm1(const void* g, const void* fm0, void* out, int B, int H,
                     int W, int C, int d_max, int stride, int is_bf16,
                     void* stream) {
  return dispatch<true>(g, fm0, out, B, H, W, C, d_max, stride, is_bf16, stream);
}

}  // extern "C"
