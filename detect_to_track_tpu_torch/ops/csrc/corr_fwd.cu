// Pointwise correlation forward for Hopper (sm_90a): bf16 on the tensor
// cores, f32 on the CUDA cores, f32 sums in both.
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
// 1024 / 2048, d = 8) the function reads 41 MB and writes 9.9 MB in bf16,
// about 15 us at 3.35 TB/s, and does 5.2 GFLOP: 5 us on the bf16 tensor
// cores (989 TFLOP/s), 78 us on the CUDA cores (67 TFLOP/s f32). So bf16 is
// bound by bytes only on the tensor cores.
//
// bf16: corr_fwd_mma_kernel, banded products on the tensor cores. Fix the
// output row i, a row displacement di (source row i + di - d) and 16 output
// columns j0..j0+15. Then P = A * B^T with A = fm0[b, i, j0:j0+16, :]
// (16 x C) and B = fm1[b, i+di-d, j0-d : j0-d+8*NT, :] (8*NT x C),
// NT = ceil((15 + 2d) / 8), and out[di*k + dj, i, j0 + m] = P[m, m + dj]:
// the band of the accumulator tile (half of it at d = 8).
// - mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands from shared
//   memory by ldmatrix. Both maps keep C contiguous per pixel, so A is the
//   row-major operand and B already the .col one: no transpose. wgmma needs
//   64-row tiles, which would waste most of a 16-wide band, and a warpgroup
//   per tile; mma.sync keeps one warp per pair of row displacements.
// - one block per (b, output row i, MT = 32 output columns), d warps; warp w
//   owns row displacements 2w and 2w + 1 and both m16 tiles, so the staged
//   fm0 tile is shared by all 2d displacements and each fm1 window row by
//   both m16 tiles;
// - past d = 19 that block no longer fits (the ring slot of 2d window rows
//   passes the 227 KB a block may use at d = 20, NT passes 7 at d = 21, the
//   output stage at d = 22). Then a third grid axis splits the work into
//   tiles of 16 row displacements x 16 column displacements, each the
//   working point's block (NT = 4, 8 warps): a block stages only its
//   group's window rows, shifted by its band's first column displacement,
//   and writes only its group's and band's planes. Any d_max runs so;
// - channel chunks of CK = 32 stream through a ring of up to 3 slots in
//   shared memory with 16-byte cp.async copies (zero-filled off the map and
//   past C), so the next chunks load while the current one multiplies. Each
//   thread's copies have the same map offsets in every chunk, so they are
//   computed once per block: staging is a pointer add and a copy. Row
//   displacements off the map or off the stride phase are neither staged nor
//   multiplied. The wrapper pads C to a multiple of 8 (whole 16-byte units);
// - a staged pixel is CK + 8 bf16 (80 bytes, five 16-byte units), so the
//   8 rows of an ldmatrix phase fall on 8 different bank groups;
// - the epilogue extracts the band from the accumulator fragments, applies
//   the window masks, and writes each plane row as contiguous runs through
//   shared memory.
//
// f32: corr_fwd_kernel<float> on the CUDA cores, as first written. Its gate
// (1e-5 of the largest magnitude) rules out bf16 tensor cores, and TF32
// would need a three-pass split to hold it. The wrapper picks the kernel by
// dtype. One block per (b, output row i, TJ = 32 output columns); per chunk
// of CC channels the block stages the fm0 tile and the fm1 window as f32;
// each thread owns one displacement row, 8 output columns and 8 column
// displacements (64 f32 sums), reading a sliding window of 15 fm1 values.
// Past d = 16 it splits into tiles of 16 x 16 displacements as the bf16
// kernel does: one block for all displacements takes 32 ceil(d / 4)^2
// threads, and past 512 of them (d 17-20: 800) its 122 registers a thread
// no longer fit the SM's register file.
//
// Both kernels index a tile of displacements: rows [r0, r0 + nr) and
// columns [dj0, dj0 + ndj) of the 2d x 2d live ones. A block stages and
// writes the planes of its tile, plus the always-zero planes next to it:
// the dj = 2d plane of each of its rows when its band is the last, and the
// di = 2d row of planes when its group and band are the last. Without a
// split the tile is the whole 2d x 2d and the planes come out in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr size_t kMaxSmemBytes = 232448;  // dynamic shared memory per block

constexpr int JB = 8;        // output columns per thread
constexpr int DJ = 8;        // column displacements per thread
constexpr int ROWS_PER_WARP = 8;
constexpr int JBLOCKS = 4;   // column blocks per warp
constexpr int TJ = JB * JBLOCKS;  // output columns per block
constexpr int CC = 16;       // channels staged per chunk
constexpr int F0_PITCH = TJ + 1;
constexpr int STAGE_PITCH = TJ + 1;
constexpr int kTile = 16;  // row and column displacements of a split block

// The displacement tile of the block at grid z index z (z = (b * groups +
// group) * bands + band) and the planes it writes.
struct Tile {
  int b, r0, nr, dj0, ndj;
  int per;     // staged planes per row: ndj, + 1 for the dj = 2d plane
  int planes;  // nr * per, + k for the di = 2d row of planes
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// kTiled = false: the whole 2d x 2d block (z = b), compile-time constants
// but for d, so the untiled kernels carry no tile arithmetic
template <bool kTiled>
__device__ __forceinline__ Tile block_tile(int z, int d, int rows, int ndj_max) {
  const int two_d = 2 * d;
  if (!kTiled) return Tile{z, 0, two_d, 0, two_d, two_d + 1, (two_d + 1) * (two_d + 1)};
  const int groups = ceil_div(two_d, rows);
  const int bands = ceil_div(two_d, ndj_max);
  Tile t;
  const int band = z % bands;
  const int group = (z / bands) % groups;
  t.b = z / (bands * groups);
  t.r0 = group * rows;
  t.nr = min(rows, two_d - t.r0);
  t.dj0 = band * ndj_max;
  t.ndj = min(ndj_max, two_d - t.dj0);
  const bool last_band = band == bands - 1;
  t.per = t.ndj + (last_band ? 1 : 0);
  t.planes = t.nr * t.per + (last_band && group == groups - 1 ? two_d + 1 : 0);
  return t;
}

// the output plane of the block's staged plane lp (untiled: lp itself)
template <bool kTiled>
__device__ __forceinline__ int tile_plane(const Tile& t, int lp, int d) {
  if (!kTiled) return lp;
  const int k = 2 * d + 1;
  if (lp < t.nr * t.per) return (t.r0 + lp / t.per) * k + t.dj0 + lp % t.per;
  return 2 * d * k + lp - t.nr * t.per;
}

struct Geometry {
  int rows;       // row displacements per block (all 2d, or kTile)
  int ndj;        // column displacements per block (all 2d, or kTile)
  int tiles;      // blocks per (b, i, column tile): groups x bands
  int row_warps;  // warps over displacement rows
  int dj_warps;   // warps over column-displacement chunks
  int window;     // staged fm1 columns
  int pitch;      // shared-memory row pitch of the fm1 window (odd)
  int plane;      // shared-memory floats per staged fm1 channel (odd)
  int threads;
  size_t smem_bytes;
};

Geometry make_geometry_tile(int d, int rows, int ndj) {
  Geometry g;
  const int two_d = 2 * d;
  g.rows = rows;
  g.ndj = ndj;
  g.tiles = ceil_div(two_d, rows) * ceil_div(two_d, ndj);
  g.row_warps = ceil_div(rows, ROWS_PER_WARP);
  g.dj_warps = ceil_div(ndj, DJ);
  g.window = TJ + DJ * g.dj_warps - 1;
  g.pitch = g.window | 1;
  g.plane = (rows * g.pitch) | 1;
  g.threads = 32 * g.row_warps * g.dj_warps;
  const size_t chunk = static_cast<size_t>(CC) * g.plane + CC * F0_PITCH;
  const size_t planes = static_cast<size_t>(rows) * (ndj + 1) + two_d + 1;
  const size_t stage = planes * STAGE_PITCH;
  g.smem_bytes = (chunk > stage ? chunk : stage) * sizeof(float);
  return g;
}

constexpr int kMaxF32Threads = 512;

// one block for all (2d)^2 displacements while it fits (d <= 16), else
// tiles of kTile x kTile
Geometry make_geometry(int d) {
  const Geometry g = make_geometry_tile(d, 2 * d, 2 * d);
  if (g.threads <= kMaxF32Threads && g.smem_bytes <= kMaxSmemBytes) return g;
  return make_geometry_tile(d, kTile, kTile);
}

// correlation_window_masks: the source position p + r - d lies in the map,
// r < 2d, and it is on the stride phase counted from max(0, p - d).
__device__ __forceinline__ bool window_ok(int p, int r, int d, int stride,
                                          int size) {
  const int src = p + r - d;
  if (r >= 2 * d || src < 0 || src >= size) return false;
  return (src - max(0, p - d)) % stride == 0;
}

template <typename T, bool kTiled>
__global__ void __launch_bounds__(kMaxF32Threads) corr_fwd_kernel(const T* __restrict__ fm0,
                                const T* __restrict__ fm1,
                                float* __restrict__ out, int H, int W, int C,
                                int d, int stride, Geometry g) {
  extern __shared__ float smem[];
  float* f1s = smem;                        // [CC][2d rows][pitch]
  float* f0s = smem + CC * g.plane;         // [CC][F0_PITCH]

  const int j0 = blockIdx.x * TJ;
  const int i = blockIdx.y;
  const Tile tile = block_tile<kTiled>(blockIdx.z, d, g.rows, g.ndj);
  const int b = tile.b;
  const int tid = threadIdx.x;

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = (warp % g.row_warps) * ROWS_PER_WARP + (lane & 7);  // tile row
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
    for (int rr = 0; rr < tile.nr; ++rr) {
      const int gi = i - d + tile.r0 + rr;
      const bool row_in = c_in && gi >= 0 && gi < H;
      const T* src_row =
          row_in ? fm1_map + static_cast<size_t>(gi) * row_elems : fm1_map;
      float* dst = f1s + cc_ld * g.plane + rr * g.pitch;
      for (int q = pos0; q < g.window; q += pos_step) {
        const int gj = j0 - d + tile.dj0 + q;
        dst[q] = (row_in && gj >= 0 && gj < W)
                     ? src_row[static_cast<size_t>(gj) * C + c]
                     : 0.f;
      }
    }
    for (int jj = pos0; jj < TJ; jj += pos_step) {
      const int gj = j0 + jj;
      f0s[cc_ld * F0_PITCH + jj] =
          (c_in && gj < W) ? fm0_row[static_cast<size_t>(gj) * C + c] : 0.f;
    }
    __syncthreads();

    if (r < tile.nr) {
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

  // stage the tile's (planes, TJ) outputs, then write whole plane rows
  __syncthreads();
  float* stage = smem;
  if (r < tile.nr) {
    const bool row_ok = window_ok(i, tile.r0 + r, d, stride, H);
#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int jl = jb * JB + jj;
#pragma unroll
      for (int y = 0; y < DJ; ++y) {
        const int dl = djc * DJ + y;
        if (dl < tile.ndj) {
          const bool ok = row_ok && window_ok(j0 + jl, tile.dj0 + dl, d, stride, W);
          stage[(r * tile.per + dl) * STAGE_PITCH + jl] = ok ? acc[jj][y] : 0.f;
        }
      }
    }
  }
  // the dj = 2d plane of each row and the di = 2d row of planes are zero
  const int col_zeros = tile.nr * (tile.per - tile.ndj);
  const int nzero = tile.planes - tile.nr * tile.ndj;
  for (int e = tid; e < nzero * TJ; e += g.threads) {
    const int z = e / TJ;
    const int jl = e % TJ;
    const int lp = z < col_zeros ? z * tile.per + tile.ndj : tile.nr * tile.per + z - col_zeros;
    stage[lp * STAGE_PITCH + jl] = 0.f;
  }
  __syncthreads();

  const int k = 2 * d + 1;
  float* out_b = out + static_cast<size_t>(b) * k * k * H * W;
  for (int e = tid; e < tile.planes * TJ; e += g.threads) {
    const int lp = e / TJ;
    const int jl = e % TJ;
    const int j = j0 + jl;
    const int p = tile_plane<kTiled>(tile, lp, d);
    if (j < W)
      out_b[(static_cast<size_t>(p) * H + i) * W + j] = stage[lp * STAGE_PITCH + jl];
  }
}

int launch_f32(const void* fm0, const void* fm1, void* out, int B, int H,
               int W, int C, int d, int stride, cudaStream_t stream) {
  const Geometry g = make_geometry(d);
  auto kernel = g.tiles > 1 ? corr_fwd_kernel<float, true> : corr_fwd_kernel<float, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TJ - 1) / TJ, H, B * g.tiles);
  kernel<<<grid, g.threads, g.smem_bytes, stream>>>(
      static_cast<const float*>(fm0), static_cast<const float*>(fm1),
      static_cast<float*>(out), H, W, C, d, stride, g);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: banded products on the tensor cores ----

constexpr int MT = 32;             // output columns per block: two m16 tiles
constexpr int CK = 32;             // channels per staged chunk: two k16 steps
constexpr int PITCH = CK + 8;      // bf16 per staged pixel (80 bytes)
constexpr int SEGS = CK / 8;       // 16-byte segments per staged pixel
constexpr int OUT_PITCH = MT + 1;  // f32 per staged output plane row
constexpr int MAX_STAGES = 3;
constexpr int MAX_NT = 7;          // the widest template below

struct MmaGeometry {
  int rows;        // row displacements per block (all 2d, or kTile)
  int ndj;         // column displacements per block (all 2d, or kTile)
  int tiles;       // blocks per (b, i, column tile): groups x bands
  int nt;          // n8 tiles per m16 tile: ceil((15 + ndj) / 8)
  int window;      // staged fm1 columns per row: 16 + 8 * nt
  int threads;     // 16 * rows: one warp per two row displacements
  int stages;      // ring slots
  int slot_elems;  // bf16 per slot: the fm1 window rows, then the fm0 tile
  size_t smem_bytes;
};

MmaGeometry make_mma_geometry_tile(int d, int rows, int ndj) {
  MmaGeometry g;
  g.rows = rows;
  g.ndj = ndj;
  g.tiles = ceil_div(2 * d, rows) * ceil_div(2 * d, ndj);
  g.nt = ceil_div(15 + ndj, 8);
  g.window = 16 + 8 * g.nt;
  g.threads = 16 * rows;
  g.slot_elems = (rows * g.window + MT) * PITCH;
  const size_t slot = static_cast<size_t>(g.slot_elems) * 2;
  const size_t planes = static_cast<size_t>(rows) * (ndj + 1) + 2 * d + 1;
  const size_t stage = planes * OUT_PITCH * sizeof(float);
  g.stages = MAX_STAGES;
  while (g.stages > 1 && g.stages * slot > kMaxSmemBytes) --g.stages;
  g.smem_bytes = g.stages * slot > stage ? g.stages * slot : stage;
  return g;
}

// one block for all (2d)^2 displacements while it fits (d <= 19, NT <= 7),
// else tiles of kTile x kTile: the d = 8 block (NT = 4) at an offset
MmaGeometry make_mma_geometry(int d) {
  const MmaGeometry g = make_mma_geometry_tile(d, 2 * d, 2 * d);
  if (g.nt <= MAX_NT && g.smem_bytes <= kMaxSmemBytes) return g;
  return make_mma_geometry_tile(d, kTile, kTile);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared (a shared-space address), asynchronously;
// valid = false writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a * b for one m16n8k16 tile: bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT n8 tiles per m16 tile; rows <= 8 (NT - 2) row displacements (2d, or
// kTile at NT = 4), so at most 128 (NT - 2) threads. kTiled: a 16 x 16 tile
// of the displacements (NT = 4 only).
template <int NT, bool kTiled>
__global__ void __launch_bounds__(128 * (NT - 2))
    corr_fwd_mma_kernel(const __nv_bfloat16* __restrict__ fm0,
                        const __nv_bfloat16* __restrict__ fm1,
                        float* __restrict__ out, int H, int W, int C, int d,
                        int stride, MmaGeometry g) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_mma);

  const int j0 = blockIdx.x * MT;
  const int i = blockIdx.y;
  const Tile tile = block_tile<kTiled>(blockIdx.z, d, g.rows, g.ndj);
  const int b = tile.b;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int window = g.window;
  const int stages = g.stages;
  const int f0_off = tile.nr * window * PITCH;  // the fm0 tile within a slot

  // Staging: a slot holds pixels p in [0, f1pix + MT): the tile's fm1
  // window rows (p = rr * window + q: row displacement r0 + rr, columns from
  // j0 - d + dj0), then the fm0 tile. Thread tid stages the 16-byte channel
  // unit `seg` of pixels pix0 + n * pstride; their offsets in the maps
  // (16-byte units; kZero: off the map, zero-filled; kSkip: a row that is
  // never multiplied, or no pixel) are the same for every chunk.
  constexpr int NPIX = 2 * NT + 8;  // >= (f1pix + MT) / pstride for rows >= 2
  constexpr int kZero = -1;
  constexpr int kSkip = -2;
  const int seg = tid % SEGS;
  const int pix0 = tid / SEGS;
  const int pstride = g.threads / SEGS;
  const int f1pix = tile.nr * window;
  const int c16 = C / 8;
  int off[NPIX];
#pragma unroll
  for (int n = 0; n < NPIX; ++n) {
    const int p = pix0 + n * pstride;
    int o = kSkip;
    if (p < f1pix) {
      const int rr = tile.r0 + p / window;
      const int gj = j0 - d + tile.dj0 + p % window;
      if (window_ok(i, rr, d, stride, H))
        o = (gj >= 0 && gj < W) ? ((i - d + rr) * W + gj) * c16 : kZero;
    } else if (p < f1pix + MT) {
      const int j = j0 + p - f1pix;
      o = j < W ? (i * W + j) * c16 : kZero;
    }
    off[n] = o;
  }
  const size_t map_elems = static_cast<size_t>(H) * W * C;
  const uint4* fm0_u4 = reinterpret_cast<const uint4*>(fm0 + b * map_elems);
  const uint4* fm1_u4 = reinterpret_cast<const uint4*>(fm1 + b * map_elems);

  // channels [chunk * CK, +CK) into ring slot `slot`
  auto load = [&](int chunk, int slot) {
    const int cu = chunk * (CK / 8) + seg;
    const bool c_in = cu < c16;
    const uint32_t s_base = smem_u32(ring + slot * g.slot_elems) + seg * 16;
#pragma unroll
    for (int n = 0; n < NPIX; ++n) {
      if (off[n] == kSkip) continue;
      const int p = pix0 + n * pstride;
      const uint4* base = p < f1pix ? fm1_u4 : fm0_u4;
      const bool valid = c_in && off[n] >= 0;
      cp_async16(s_base + p * (PITCH * 2), valid ? base + off[n] + cu : base, valid);
    }
  };

  // warp w owns the tile's row displacements 2w and 2w + 1 (past the last
  // group's rows they are >= 2d, which window_ok rejects)
  bool live[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) live[q] = window_ok(i, tile.r0 + 2 * warp + q, d, stride, H);

  float acc[2][2][NT][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][s][t][e] = 0.f;

  const int nchunks = (C + CK - 1) / CK;
  for (int st = 0; st < stages - 1; ++st) {
    if (st < nchunks) load(st, st);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    if (stages == 1) {
      __syncthreads();  // the previous chunk's reads are done
      load(ch, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else if (stages == 2) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<MAX_STAGES - 2>();
    }
    __syncthreads();  // chunk ch landed; slot (ch - 1) % stages is free
    if (stages > 1) {
      const int next = ch + stages - 1;
      if (next < nchunks) load(next, next % stages);
      cp_async_commit();
    }
    if (!(live[0] || live[1])) continue;
    const __nv_bfloat16* s1 = ring + (ch % stages) * g.slot_elems;
    const __nv_bfloat16* s0 = s1 + f0_off;
#pragma unroll
    for (int ks = 0; ks < CK / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        ldmatrix_x4(a[s], s0 + (16 * s + (lane & 15)) * PITCH + ks * 16 +
                              (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!live[q]) continue;
        // window column n of row 2w + q: lanes 0-7 / 16-23 give the rows of
        // the k 0-7 halves of two n8 tiles, lanes 8-15 / 24-31 the k 8-15
        const __nv_bfloat16* rowp = s1 + (2 * warp + q) * window * PITCH +
                                    ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bf[NT + 2][2];
#pragma unroll
        for (int p = 0; p + 1 < NT + 2; p += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, rowp + (8 * p + (lane & 7) + (lane >> 4) * 8) * PITCH);
          bf[p][0] = r[0];
          bf[p][1] = r[1];
          bf[p + 1][0] = r[2];
          bf[p + 1][1] = r[3];
        }
        if ((NT + 2) & 1) {
          uint32_t r[2];
          ldmatrix_x2(r, rowp + (8 * (NT + 1) + (lane & 7)) * PITCH);
          bf[NT + 1][0] = r[0];
          bf[NT + 1][1] = r[1];
        }
        // m16 tile s multiplies window columns [16 s, 16 s + 8 NT)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int t = 0; t < NT; ++t)
            mma_bf16(acc[q][s][t], a[s], bf[2 * s + t][0], bf[2 * s + t][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the band: accumulator (m, n) of tile s is output column 16 s + m at
  // dj = dj0 + n - m; stage the tile's (planes, MT) outputs, then write
  // whole plane rows
  float* stage = reinterpret_cast<float*>(smem_mma);
  const int grp = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int rr = 2 * warp + q;
    if (kTiled && rr >= tile.nr) continue;  // rows past the last group's
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = grp + (e >> 1) * 8;
          const int dl = 8 * t + 2 * tig + (e & 1) - m;
          if (dl < 0 || dl >= tile.ndj) continue;
          const int jl = 16 * s + m;
          const bool ok = live[q] && window_ok(j0 + jl, tile.dj0 + dl, d, stride, W);
          stage[(rr * tile.per + dl) * OUT_PITCH + jl] = ok ? acc[q][s][t][e] : 0.f;
        }
  }
  if constexpr (!kTiled) {
    // the whole 2d x 2d block writes its planes in order with the epilogue
    // the kernel had before the split, so the working point (d = 8) keeps
    // its code and its time; the tile epilogue below serves the split
    const int two_d = 2 * d;
    const int k = two_d + 1;
    for (int e = tid; e < (2 * k - 1) * MT; e += g.threads) {
      const int z = e / MT;
      const int jl = e % MT;
      const int p = z < k ? two_d * k + z : (z - k) * k + two_d;
      stage[p * OUT_PITCH + jl] = 0.f;
    }
    __syncthreads();
    const int k2 = k * k;
    float* out_b = out + static_cast<size_t>(b) * k2 * H * W;
    for (int e = tid; e < k2 * MT; e += g.threads) {
      const int p = e / MT;
      const int jl = e % MT;
      const int j = j0 + jl;
      if (j < W) out_b[(static_cast<size_t>(p) * H + i) * W + j] = stage[p * OUT_PITCH + jl];
    }
    return;
  }
  // the dj = 2d plane of each row and the di = 2d row of planes are zero
  const int col_zeros = tile.nr * (tile.per - tile.ndj);
  const int nzero = tile.planes - tile.nr * tile.ndj;
  for (int e = tid; e < nzero * MT; e += g.threads) {
    const int z = e / MT;
    const int jl = e % MT;
    const int lp = z < col_zeros ? z * tile.per + tile.ndj : tile.nr * tile.per + z - col_zeros;
    stage[lp * OUT_PITCH + jl] = 0.f;
  }
  __syncthreads();

  const int k = 2 * d + 1;
  float* out_b = out + static_cast<size_t>(b) * k * k * H * W;
  for (int e = tid; e < tile.planes * MT; e += g.threads) {
    const int lp = e / MT;
    const int jl = e % MT;
    const int j = j0 + jl;
    const int p = tile_plane<kTiled>(tile, lp, d);
    if (j < W)
      out_b[(static_cast<size_t>(p) * H + i) * W + j] = stage[lp * OUT_PITCH + jl];
  }
}

template <int NT, bool kTiled = false>
int launch_mma_nt(const void* fm0, const void* fm1, void* out, int B, int H,
                  int W, int C, int d, int stride, const MmaGeometry& g,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      corr_fwd_mma_kernel<NT, kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + MT - 1) / MT, H, B * g.tiles);
  corr_fwd_mma_kernel<NT, kTiled><<<grid, g.threads, g.smem_bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(fm0),
      static_cast<const __nv_bfloat16*>(fm1), static_cast<float*>(out), H, W,
      C, d, stride, g);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* fm0, const void* fm1, void* out, int B, int H,
               int W, int C, int d, int stride, cudaStream_t stream) {
  const MmaGeometry g = make_mma_geometry(d);
  if (g.tiles > 1) return launch_mma_nt<4, true>(fm0, fm1, out, B, H, W, C, d, stride, g, stream);
  switch (g.nt) {  // d 1-4, 5-8, 9-12, 13-16, 17-19
    case 3: return launch_mma_nt<3>(fm0, fm1, out, B, H, W, C, d, stride, g, stream);
    case 4: return launch_mma_nt<4>(fm0, fm1, out, B, H, W, C, d, stride, g, stream);
    case 5: return launch_mma_nt<5>(fm0, fm1, out, B, H, W, C, d, stride, g, stream);
    case 6: return launch_mma_nt<6>(fm0, fm1, out, B, H, W, C, d, stride, g, stream);
    case 7: return launch_mma_nt<7>(fm0, fm1, out, B, H, W, C, d, stride, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs at this d_max for this dtype; the
// wrapper checks it against the card's limit before launching.
size_t d2t_corr_fwd_smem_bytes(int d_max, int is_bf16) {
  return is_bf16 ? make_mma_geometry(d_max).smem_bytes
                 : make_geometry(d_max).smem_bytes;
}

// fm0, fm1: (B, H, W, C) contiguous, float32 (is_bf16 = 0: CUDA cores) or
// bfloat16 (is_bf16 = 1: tensor cores; C % 8 == 0 and 16-byte aligned, as
// the wrapper pads them). out: (B, (2d+1)^2, H, W) float32,
// every element written. Launches on `stream` and returns cudaGetLastError()
// (0 on success).
int d2t_corr_fwd(const void* fm0, const void* fm1, void* out, int B, int H,
                 int W, int C, int d_max, int stride, int is_bf16,
                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || d_max <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = is_bf16 ? make_mma_geometry(d_max).tiles : make_geometry(d_max).tiles;
  if (static_cast<long long>(B) * tiles > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    // whole, aligned 16-byte channel units, and map offsets in those units
    // that fit an int
    if (C % 8 != 0 || reinterpret_cast<uintptr_t>(fm0) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(fm1) % 16 != 0 ||
        static_cast<long long>(H) * W * (C / 8) >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(fm0, fm1, out, B, H, W, C, d_max, stride, s);
  }
  return launch_f32(fm0, fm1, out, B, H, W, C, d_max, stride, s);
}

}  // extern "C"
