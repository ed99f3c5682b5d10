// Pointwise correlation backward for Hopper (sm_90a), f32 sums.
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
// Which kernel runs: bf16 maps run both gradients on the tensor cores,
// corr_bwd_mma_kernel<KS, kFm1>; f32 maps run corr_bwd_kernel<kFm1> on the
// CUDA cores. The f32 gate (1e-5 of the largest magnitude) rules out bf16
// tensor cores, and TF32 would need a three-pass split to hold it.
//
// corr_bwd_mma_kernel, banded products (the form of the TPU kernels, which
// build a banded gradient per row displacement and do one matmul). Fix the
// output row y, a live row displacement di and 16 output columns
// x0..x0+15. Both gradients are then a product of a 16 x K banded gradient
// G with a window of K map columns (channels contiguous), over K = 16 *
// ceil((15 + 2d) / 16) columns:
// - dFM0 (K2): out[b, y, x0 + m, c] += sum_n G[m, n] * FM1[b, r, x0 - d + n, c]
//   with the map row r = y + di - d, live when the output row's window mask
//   holds (r on the map and on the stride phase), and G[m, n] = mask *
//   g[b, di*k + (n - m), y, x0 + m] for 0 <= n - m < 2d, else 0: the output
//   pixel's own g values, plane dj into band column m + dj.
// - dFM1 (K3/K4): out[b, y, x0 + m, c] += sum_j G[m, j] * FM0[b, s, x0 - d
//   + 1 + j, c] with the source row s = y - di + d, live when s is on the
//   map and the source row's mask holds, and G[m, j] = mask * g[b, di*k +
//   (m - j + 2d - 1), s, x0 - d + 1 + j] for 0 <= m - j + 2d - 1 < 2d: the
//   diagonal of the source pixels' g values, plane dj into band column
//   m - dj + 2d - 1.
// Block-uniform liveness skips a displacement for the whole block. The two
// instantiations differ only in the map row, the window origin, the
// liveness test and the band gather (offsets computed once per block).
// - mma.sync.m16n8k16 (bf16 in, f32 accumulate). The window is K-major with
//   the channels (N) contiguous, so B comes from shared memory by
//   ldmatrix.trans. G is built per di from g: cp.async copies the 2d band
//   values of each row (4 bytes each, zero-filled where masked) as f32 into
//   a band buffer whose other entries stay zero, and the A fragments are
//   rounded to bf16 as they are read, as the TPU kernels round their banded
//   gradient (ext_t = bf16). wgmma needs 64-row tiles, four times the
//   16-wide band, so mma.sync keeps the tile at the band's width.
// - one block of 4 warps per (b, y, 32 output columns, 128 channels); warp
//   w owns 32 channels of both m16 tiles (32 f32 sums per lane). Both m16
//   tiles share one staged window of 16 + K columns.
// - per di, the map window (16-byte cp.async, zero-filled off the map and
//   past C; the wrapper pads C to a multiple of 8) and the band stream
//   through a 3-slot ring in shared memory, so the next displacements load
//   while the current one multiplies. Each thread's copy offsets are
//   computed once per block: only the map row changes with di. A staged
//   pixel is 136 bf16 (272 bytes, 17 16-byte units): the 8 rows of an
//   ldmatrix phase fall on 8 bank groups. KS = K / 16 is a template
//   parameter (2-4), so bf16 takes d_max <= 24.
// - the sums leave through shared memory as 16-byte stores per 8 channels.
// What bounds it on the card: the window is staged once per (output row,
// live di), so each map byte is read from L2 about 2d times (0.75 / 1.50 GB
// at C = 1024 / 2048 at the working point); the L2 -> shared-memory rate,
// not the 60-107 MB of device memory, sets its time.
//
// corr_bwd_kernel (f32, CUDA cores):
// - one block of 4 warps per (b, output row, 32 output columns, 64
//   channels); a lane owns 2 channels (c and c + 32) of 8 adjacent output
//   columns, so 16 f32 sums sit in registers, and each warp owns 8 columns;
// - per row displacement di (skipped, block-uniformly, when the source row
//   is outside the map or off the stride phase) the block stages in shared
//   memory: the map row's window of 32 + 8*ceil(2d/8) - 1 columns x 64
//   channels, and the 2d x 32 gradient values already masked and laid out
//   by OUTPUT column (for dFM1 the source column x - dj + d differs per dj,
//   so the diagonal is gathered once while staging);
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

// correlation_window_masks: the source position p + r - d lies in the map,
// r < 2d, and it is on the stride phase counted from max(0, p - d).
__device__ __forceinline__ bool window_ok(int p, int r, int d, int stride,
                                          int size) {
  const int src = p + r - d;
  if (r >= 2 * d || src < 0 || src >= size) return false;
  return (src - max(0, p - d)) % stride == 0;
}

// kFm1 = false: dFM0 from FM1 (K2). kFm1 = true: dFM1 from FM0 (K3/K4).
template <bool kFm1>
__global__ void __launch_bounds__(THREADS)
    corr_bwd_kernel(const float* __restrict__ g, const float* __restrict__ fm,
                    float* __restrict__ out, int H, int W, int C, int d,
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
  const float* fm_b = fm + static_cast<size_t>(b) * plane * C;
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
    const float* row = fm_b + static_cast<size_t>(map_row) * W * C;
    for (int e = tid; e < window * CCH; e += THREADS) {
      const int col = wx0 + e / CCH;
      const int c = c0 + e % CCH;
      ms[e] = (col >= 0 && col < W && c < C) ? row[static_cast<size_t>(col) * C + c] : 0.f;
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

  float* out_row = out + (static_cast<size_t>(b) * H + y) * W * C;
#pragma unroll
  for (int jj = 0; jj < JB; ++jj) {
    const int x = x0 + warp * JB + jj;
    if (x >= W) continue;
#pragma unroll
    for (int ch = 0; ch < CT; ++ch) {
      const int c = c0 + ch * 32 + lane;
      if (c < C) out_row[static_cast<size_t>(x) * C + c] = acc[jj][ch];
    }
  }
}

template <bool kFm1>
int launch(const void* g, const void* fm, void* out, int B, int H, int W,
           int C, int d, int stride, cudaStream_t stream) {
  const Geometry geo = make_geometry(d);
  cudaError_t err = cudaFuncSetAttribute(
      corr_bwd_kernel<kFm1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(geo.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TJ - 1) / TJ, H, B * ((C + CCH - 1) / CCH));
  corr_bwd_kernel<kFm1><<<grid, THREADS, geo.smem_bytes, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(fm),
      static_cast<float*>(out), H, W, C, d, stride, geo.nch, geo.window);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: banded products on the tensor cores ----

constexpr int FX = 32;              // output columns per block: two m16 tiles
constexpr int FCB = 128;            // channels per block: 4 warps x 32
constexpr int FTHREADS = 128;
constexpr int FPITCH = FCB + 8;     // bf16 per staged pixel (272 bytes)
constexpr int FSEGS = FCB / 8;      // 16-byte segments per staged pixel
constexpr int FSTAGES = 3;          // ring slots
constexpr int MAX_KS = 4;           // k16 steps per m16 tile: d_max <= 24
constexpr int kMaxSmemBytes = 232448;  // shared memory one SM gives blocks

// k16 steps per m16 tile: the band of a 16-row tile spans 15 + 2d columns
int mma_ks(int d) { return (15 + 2 * d + 15) / 16; }

// per ring slot: the map window (16 + 16 KS pixels x FPITCH bf16), then
// the band (2 tiles x 16 rows x (16 KS + 8) f32; the pitch is 8 or 24
// modulo 32 banks, so a fragment's 8-byte reads do not conflict)
__host__ __device__ constexpr int mma_window(int ks) { return 16 + 16 * ks; }
__host__ __device__ constexpr int mma_gpitch(int ks) { return 16 * ks + 8; }
__host__ __device__ constexpr int mma_slot_bytes(int ks) {
  return mma_window(ks) * FPITCH * 2 + 2 * 16 * mma_gpitch(ks) * 4;
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

// 4 bytes global -> shared, asynchronously; valid = false writes zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the four 8x8 bf16 matrices at the 32 lanes' row addresses, transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// two adjacent f32 band values as one bf16x2 fragment register
__device__ __forceinline__ uint32_t bf16x2(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// As many blocks per SM as the ring lets in (4 at KS = 2), and registers up
// to what that occupancy allows: left to itself, ptxas held the KS = 2
// dFM1 kernel at 72 registers with a spill, and it ran 14% slower on an H100.
template <int KS, bool kFm1>
__global__ void __launch_bounds__(FTHREADS, kMaxSmemBytes / (FSTAGES * mma_slot_bytes(KS)))
    corr_bwd_mma_kernel(const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ fm,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C,
                        int d, int stride) {
  constexpr int WINDOW = mma_window(KS);  // staged map columns
  constexpr int GP = mma_gpitch(KS);
  constexpr int SLOT = mma_slot_bytes(KS);
  constexpr int BAND_OFF = WINDOW * FPITCH * 2;  // bytes into a slot
  constexpr int NW = WINDOW / (FTHREADS / FSEGS);  // window pixels per thread
  // band entries per thread: 2 tiles x 16 rows x 2d, d <= 8 KS - 8
  constexpr int NB = (2 * 16 * 2 * (8 * KS - 8) + FTHREADS - 1) / FTHREADS;
  extern __shared__ __align__(16) unsigned char smem_mma[];

  const int x0 = blockIdx.x * FX;
  const int y = blockIdx.y;
  const int cblocks = (C + FCB - 1) / FCB;
  const int b = blockIdx.z / cblocks;
  const int c0 = (blockIdx.z % cblocks) * FCB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int two_d = 2 * d;
  const int k = two_d + 1;
  const int plane = H * W;

  const float* g_b = g + static_cast<size_t>(b) * k * k * plane;
  const __nv_bfloat16* fm_b = fm + static_cast<size_t>(b) * plane * C;
  // first staged map column: dFM0 reads FM1 at x + dj - d, dFM1 reads FM0
  // at the source column x - dj + d
  const int wx0 = kFm1 ? x0 - d + 1 : x0 - d;
  const uint32_t ring = smem_u32(smem_mma);

  // the map row di reads; dFM1's g row is that source row, dFM0's the
  // output row y
  auto map_row = [&](int di) { return kFm1 ? y - di + d : y + di - d; };
  // dFM0: the output row's window mask (it puts the map row on the map);
  // dFM1: the source row is on the map and its mask holds
  auto live = [&](int di) {
    if (!kFm1) return window_ok(y, di, d, stride, H);
    const int s = map_row(di);
    return s >= 0 && s < H && window_ok(s, di, d, stride, H);
  };

  // Staging offsets, the same for every di. Window: thread tid copies the
  // 16-byte channel unit `seg` of window pixels jw0 + 8 n (their column
  // offsets in 16-byte units, -1 off the map). Band: entry e = tid + 128 n
  // is (tile t, row m, dj) of output column x = x0 + 16 t + m, read from
  // g's plane dj at column x into band column m + dj (dFM0), or at the
  // source column x + d - dj into band column m - dj + 2d - 1 (dFM1); -1:
  // masked, zero-filled.
  const int seg = tid % FSEGS;
  const int jw0 = tid / FSEGS;
  const int c16 = C / 8;
  const int cu = c0 / 8 + seg;
  int coff[NW];
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    const int col = wx0 + jw0 + 8 * n;
    coff[n] = (col >= 0 && col < W) ? col * c16 + cu : -1;
  }
  int bdst[NB], gsrc[NB];
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int e = tid + FTHREADS * n;
    const int m = e & 15;
    const int dj = (e >> 4) % two_d;
    const int t = (e >> 4) / two_d;
    const int x = x0 + 16 * t + m;
    const int col = kFm1 ? x + d - dj : x;
    const int bcol = kFm1 ? m - dj + two_d - 1 : m + dj;
    const bool ok = col >= 0 && col < W && window_ok(col, dj, d, stride, W);
    bdst[n] = e < 2 * 16 * two_d ? BAND_OFF + ((16 * t + m) * GP + bcol) * 4 : -1;
    gsrc[n] = ok ? dj * plane + col : -1;
  }

  // the band buffers' entries off the band stay zero; cp.async rewrites the
  // band (masked entries as zeros) for every di
  for (int slot = 0; slot < FSTAGES; ++slot) {
    float* band = reinterpret_cast<float*>(smem_mma + slot * SLOT + BAND_OFF);
    for (int e = tid; e < 2 * 16 * GP; e += FTHREADS) band[e] = 0.f;
  }

  // the map window and the banded gradient of di into ring slot `slot`
  auto load = [&](int di, int slot) {
    if (!live(di)) return;
    const int r = map_row(di);
    const uint32_t slot_base = ring + slot * SLOT;
    const uint4* row = reinterpret_cast<const uint4*>(fm_b + static_cast<size_t>(r) * W * C);
    const bool c_in = cu < c16;
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const bool valid = c_in && coff[n] >= 0;
      cp_async16(slot_base + ((jw0 + 8 * n) * FPITCH + seg * 8) * 2,
                 valid ? row + coff[n] : row, valid);
    }
    const float* g_row =
        g_b + static_cast<size_t>(di) * k * plane + static_cast<size_t>(kFm1 ? r : y) * W;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (bdst[n] < 0) continue;
      cp_async4(slot_base + bdst[n], gsrc[n] >= 0 ? g_row + gsrc[n] : g, gsrc[n] >= 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;

  for (int st = 0; st < FSTAGES - 1; ++st) {
    if (st < two_d) load(st, st);
    cp_async_commit();
  }
  for (int di = 0; di < two_d; ++di) {
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();  // di landed; slot (di - 1) % FSTAGES is free
    const int next = di + FSTAGES - 1;
    if (next < two_d) load(next, next % FSTAGES);
    cp_async_commit();
    if (!live(di)) continue;  // uniform over the block
    const __nv_bfloat16* win =
        reinterpret_cast<const __nv_bfloat16*>(smem_mma + (di % FSTAGES) * SLOT);
    const float* band = reinterpret_cast<const float*>(smem_mma + (di % FSTAGES) * SLOT + BAND_OFF);
    // window rows [16 kb, 16 kb + 16) are k-step kb of tile 0 and k-step
    // kb - 1 of tile 1
#pragma unroll
    for (int kb = 0; kb <= KS; ++kb) {
      uint32_t bf[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, win + (16 * kb + (lane & 7) + ((lane >> 3) & 1) * 8) * FPITCH +
                                 32 * warp + 16 * p + (lane >> 4) * 8);
        bf[2 * p][0] = r[0];
        bf[2 * p][1] = r[1];
        bf[2 * p + 1][0] = r[2];
        bf[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kstep = kb - t;
        if (kstep < 0 || kstep >= KS) continue;
        const float* a0 = band + (16 * t + grp) * GP + 16 * kstep + 2 * tig;
        const uint32_t a[4] = {bf16x2(a0), bf16x2(a0 + 8 * GP), bf16x2(a0 + 8),
                               bf16x2(a0 + 8 * GP + 8)};
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_bf16(acc[t][n], a, bf[n][0], bf[n][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // accumulator (m, n) of tile t is column x0 + 16 t + m, channel
  // c0 + 32 w + n: round to bf16 into a (FX, FCB) tile, then 16-byte stores
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem_mma);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(
            tile + (16 * t + grp + 8 * h) * FPITCH + 32 * warp + 8 * n + 2 * tig) =
            __floats2bfloat162_rn(acc[t][n][2 * h], acc[t][n][2 * h + 1]);
  __syncthreads();

  __nv_bfloat16* out_row = out + (static_cast<size_t>(b) * H + y) * W * C;
  for (int e = tid; e < FX * FSEGS; e += FTHREADS) {
    const int xl = e / FSEGS;
    const int x = x0 + xl;
    const int c = c0 + (e % FSEGS) * 8;
    if (x >= W || c >= C) continue;
    const __nv_bfloat16* src = tile + xl * FPITCH + (e % FSEGS) * 8;
    __nv_bfloat16* dst = out_row + static_cast<size_t>(x) * C + c;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
}

template <int KS, bool kFm1>
int launch_mma_ks(const void* g, const void* fm, void* out, int B, int H,
                  int W, int C, int d, int stride, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(FSTAGES) * mma_slot_bytes(KS);
  cudaError_t err = cudaFuncSetAttribute(
      corr_bwd_mma_kernel<KS, kFm1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + FX - 1) / FX, H, B * ((C + FCB - 1) / FCB));
  corr_bwd_mma_kernel<KS, kFm1><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(g), static_cast<const __nv_bfloat16*>(fm),
      static_cast<__nv_bfloat16*>(out), H, W, C, d, stride);
  return static_cast<int>(cudaGetLastError());
}

template <bool kFm1>
int launch_mma(const void* g, const void* fm, void* out, int B, int H, int W,
               int C, int d, int stride, cudaStream_t stream) {
  // whole, aligned 16-byte channel units; int offsets into one g batch item
  // (k^2 planes) and one map row
  if (C % 8 != 0 || reinterpret_cast<uintptr_t>(fm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      static_cast<long long>(2 * d + 1) * (2 * d + 1) * H * W >= (1LL << 31) ||
      static_cast<long long>(W) * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mma_ks(d)) {  // d 1-8, 9-16, 17-24
    case 2: return launch_mma_ks<2, kFm1>(g, fm, out, B, H, W, C, d, stride, stream);
    case 3: return launch_mma_ks<3, kFm1>(g, fm, out, B, H, W, C, d, stride, stream);
    case MAX_KS: return launch_mma_ks<MAX_KS, kFm1>(g, fm, out, B, H, W, C, d, stride, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 0, or the CUDA error for arguments no kernel takes (cblk: channels per
// block, which sets the grid's z extent)
int check_args(int B, int H, int W, int C, int d_max, int stride, int cblk) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || d_max <= 0 || stride <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * ((C + cblk - 1) / cblk) > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  return 0;
}

// bf16 on the tensor cores, f32 on the CUDA cores
template <bool kFm1>
int corr_bwd(const void* g, const void* fm, void* out, int B, int H, int W,
             int C, int d_max, int stride, int is_bf16, void* stream) {
  if (const int err = check_args(B, H, W, C, d_max, stride, is_bf16 ? FCB : CCH))
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_mma<kFm1>(g, fm, out, B, H, W, C, d_max, stride, s);
  return launch<kFm1>(g, fm, out, B, H, W, C, d_max, stride, s);
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block of either backward kernel needs at this
// d_max and dtype; the wrapper checks it against the card's limit before
// launching.
size_t d2t_corr_bwd_smem_bytes(int d_max, int is_bf16) {
  return is_bf16 ? static_cast<size_t>(FSTAGES) * mma_slot_bytes(mma_ks(d_max))
                 : make_geometry(d_max).smem_bytes;
}

// g: (B, (2d+1)^2, H, W) float32 contiguous. fm1, out: (B, H, W, C)
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1; C a multiple
// of 8, 16-byte aligned); out gets dFM0, every element written. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int d2t_corr_bwd_fm0(const void* g, const void* fm1, void* out, int B, int H,
                     int W, int C, int d_max, int stride, int is_bf16,
                     void* stream) {
  return corr_bwd<false>(g, fm1, out, B, H, W, C, d_max, stride, is_bf16, stream);
}

// As d2t_corr_bwd_fm0, from fm0 to dFM1.
int d2t_corr_bwd_fm1(const void* g, const void* fm0, void* out, int B, int H,
                     int W, int C, int d_max, int stride, int is_bf16,
                     void* stream) {
  return corr_bwd<true>(g, fm0, out, B, H, W, C, d_max, stride, is_bf16, stream);
}

}  // extern "C"
