// Pointwise correlation forward for Hopper (sm_90a), CUDA cores, f32 sums.
//
// Replaces the TPU kernel detect_to_track_tpu/ops/correlation.py::_fwd_kernel
// (K1). Semantics are those of ops/torch_ref.py::pointwise_correlation_ref:
//
//   out[b, di*k + dj, i, j] = sum_c fm0[b, i, j, c] * fm1[b, i+di-d, j+dj-d, c]
//
// with k = 2d+1, zero outside the map, and the window masks of
// correlation_window_masks (the di = 2d row and dj = 2d column stay zero;
// stride > 1 keeps the displacements on the phase counted from
// max(0, i - d)). Every one of the k*k planes is written, zeros included.
//
// What bounds it: per pair at the tracker's working point (38x75, C = 512 /
// 1024 / 2048, d = 8) the function reads 41 MB and writes 9.9 MB, about
// 15 us at 3.35 TB/s, and does 5.2 GFLOP. On the CUDA cores (67 TFLOP/s
// f32) the arithmetic is the bound, about 78 us per pair; on the tensor
// cores it would be the bytes.
//
// Design (simple first; tensor cores, TMA and pipelining come later):
// - one block per (b, output row i, tile of TJ = 32 output columns);
// - per chunk of CC channels the block stages the fm0 tile (TJ x CC) and
//   the fm1 window (2d rows x (TJ + 2d) columns x CC) in shared memory as
//   f32, channel-major, so bf16 and f32 inputs share one inner loop;
// - each thread owns one displacement row di, JB = 8 adjacent output
//   columns and DJ = 8 adjacent column displacements: 64 f32 sums in
//   registers. Per channel it reads 8 fm0 values and a sliding window of
//   15 fm1 values for 64 FMAs, so the shared-memory traffic per FMA is a
//   third of a one-output-per-thread kernel;
// - a warp is 8 displacement rows x 4 column blocks. The row pitch is odd,
//   so the 32 lanes read 32 different banks; fm0 reads are broadcasts;
// - the finished tile goes through shared memory once more so that every
//   plane row is written to device memory as contiguous 128-byte runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int JB = 8;        // output columns per thread
constexpr int DJ = 8;        // column displacements per thread
constexpr int ROWS_PER_WARP = 8;
constexpr int JBLOCKS = 4;   // column blocks per warp
constexpr int TJ = JB * JBLOCKS;  // output columns per block
constexpr int CC = 16;       // channels staged per chunk
constexpr int F0_PITCH = TJ + 1;
constexpr int STAGE_PITCH = TJ + 1;

struct Geometry {
  int row_warps;  // warps over displacement rows
  int dj_warps;   // warps over column-displacement chunks
  int window;     // staged fm1 columns
  int pitch;      // shared-memory row pitch of the fm1 window (odd)
  int plane;      // shared-memory floats per staged fm1 channel (odd)
  int threads;
  size_t smem_bytes;
};

Geometry make_geometry(int d) {
  Geometry g;
  const int two_d = 2 * d;
  const int k = two_d + 1;
  g.row_warps = (two_d + ROWS_PER_WARP - 1) / ROWS_PER_WARP;
  g.dj_warps = (two_d + DJ - 1) / DJ;
  g.window = TJ + DJ * g.dj_warps - 1;
  g.pitch = g.window | 1;
  g.plane = (two_d * g.pitch) | 1;
  g.threads = 32 * g.row_warps * g.dj_warps;
  const size_t chunk = static_cast<size_t>(CC) * g.plane + CC * F0_PITCH;
  const size_t stage = static_cast<size_t>(k) * k * STAGE_PITCH;
  g.smem_bytes = (chunk > stage ? chunk : stage) * sizeof(float);
  return g;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// correlation_window_masks: the source position p + r - d lies in the map,
// r < 2d, and it is on the stride phase counted from max(0, p - d).
__device__ __forceinline__ bool window_ok(int p, int r, int d, int stride,
                                          int size) {
  const int src = p + r - d;
  if (r >= 2 * d || src < 0 || src >= size) return false;
  return (src - max(0, p - d)) % stride == 0;
}

template <typename T>
__global__ void corr_fwd_kernel(const T* __restrict__ fm0,
                                const T* __restrict__ fm1,
                                float* __restrict__ out, int H, int W, int C,
                                int d, int stride, Geometry g) {
  extern __shared__ float smem[];
  float* f1s = smem;                        // [CC][2d rows][pitch]
  float* f0s = smem + CC * g.plane;         // [CC][F0_PITCH]

  const int j0 = blockIdx.x * TJ;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int two_d = 2 * d;
  const int k = two_d + 1;

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = (warp % g.row_warps) * ROWS_PER_WARP + (lane & 7);
  const int jb = lane >> 3;
  const int djc = warp / g.row_warps;

  // staging: each thread owns one channel of the chunk and walks positions
  const int cc_ld = tid % CC;
  const int pos0 = tid / CC;
  const int pos_step = g.threads / CC;

  const size_t row_elems = static_cast<size_t>(W) * C;
  const T* fm0_row = fm0 + (static_cast<size_t>(b) * H + i) * row_elems;
  const T* fm1_map = fm1 + static_cast<size_t>(b) * H * row_elems;

  float acc[JB][DJ];
#pragma unroll
  for (int jj = 0; jj < JB; ++jj)
#pragma unroll
    for (int y = 0; y < DJ; ++y) acc[jj][y] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int c = c0 + cc_ld;
    const bool c_in = c < C;
    __syncthreads();  // the previous chunk's reads are done
    for (int rr = 0; rr < two_d; ++rr) {
      const int gi = i - d + rr;
      const bool row_in = c_in && gi >= 0 && gi < H;
      const T* src_row =
          row_in ? fm1_map + static_cast<size_t>(gi) * row_elems : fm1_map;
      float* dst = f1s + cc_ld * g.plane + rr * g.pitch;
      for (int q = pos0; q < g.window; q += pos_step) {
        const int gj = j0 - d + q;
        dst[q] = (row_in && gj >= 0 && gj < W)
                     ? to_float(src_row[static_cast<size_t>(gj) * C + c])
                     : 0.f;
      }
    }
    for (int jj = pos0; jj < TJ; jj += pos_step) {
      const int gj = j0 + jj;
      f0s[cc_ld * F0_PITCH + jj] =
          (c_in && gj < W) ? to_float(fm0_row[static_cast<size_t>(gj) * C + c])
                           : 0.f;
    }
    __syncthreads();

    if (r < two_d) {
      const float* a_base = f0s + jb * JB;
      const float* v_base = f1s + r * g.pitch + jb * JB + djc * DJ;
#pragma unroll 2
      for (int cc = 0; cc < CC; ++cc) {
        float a[JB];
#pragma unroll
        for (int jj = 0; jj < JB; ++jj) a[jj] = a_base[cc * F0_PITCH + jj];
        const float* v = v_base + cc * g.plane;
#pragma unroll
        for (int x = 0; x < JB + DJ - 1; ++x) {
          const float vx = v[x];
#pragma unroll
          for (int jj = 0; jj < JB; ++jj) {
            const int y = x - jj;
            if (y >= 0 && y < DJ) acc[jj][y] = fmaf(a[jj], vx, acc[jj][y]);
          }
        }
      }
    }
  }

  // stage the (k*k, TJ) output tile, then write whole plane rows
  __syncthreads();
  float* stage = smem;
  if (r < two_d) {
    const bool row_ok = window_ok(i, r, d, stride, H);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int jl = jb * JB + jj;
#pragma unroll
      for (int y = 0; y < DJ; ++y) {
        const int dj = djc * DJ + y;
        if (dj < two_d) {
          const bool ok = row_ok && window_ok(j0 + jl, dj, d, stride, W);
          stage[(r * k + dj) * STAGE_PITCH + jl] = ok ? acc[jj][y] : 0.f;
        }
      }
    }
  }
  // the di = 2d row and the dj = 2d column of planes are always zero
  for (int e = tid; e < (2 * k - 1) * TJ; e += g.threads) {
    const int z = e / TJ;
    const int jl = e % TJ;
    const int p = z < k ? two_d * k + z : (z - k) * k + two_d;
    stage[p * STAGE_PITCH + jl] = 0.f;
  }
  __syncthreads();

  const int k2 = k * k;
  float* out_b = out + static_cast<size_t>(b) * k2 * H * W;
  for (int e = tid; e < k2 * TJ; e += g.threads) {
    const int p = e / TJ;
    const int jl = e % TJ;
    const int j = j0 + jl;
    if (j < W)
      out_b[(static_cast<size_t>(p) * H + i) * W + j] =
          stage[p * STAGE_PITCH + jl];
  }
}

template <typename T>
int launch(const void* fm0, const void* fm1, void* out, int B, int H, int W,
           int C, int d, int stride, cudaStream_t stream) {
  const Geometry g = make_geometry(d);
  cudaError_t err = cudaFuncSetAttribute(
      corr_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TJ - 1) / TJ, H, B);
  corr_fwd_kernel<T><<<grid, g.threads, g.smem_bytes, stream>>>(
      static_cast<const T*>(fm0), static_cast<const T*>(fm1),
      static_cast<float*>(out), H, W, C, d, stride, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs at this d_max; the wrapper checks
// it against the card's limit before launching.
size_t d2t_corr_fwd_smem_bytes(int d_max) {
  return make_geometry(d_max).smem_bytes;
}

// fm0, fm1: (B, H, W, C) contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1). out: (B, (2d+1)^2, H, W) float32, every element written.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int d2t_corr_fwd(const void* fm0, const void* fm1, void* out, int B, int H,
                 int W, int C, int d_max, int stride, int is_bf16,
                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || d_max <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(fm0, fm1, out, B, H, W, C, d_max, stride, s);
  return launch<float>(fm0, fm1, out, B, H, W, C, d_max, stride, s);
}

}  // extern "C"
