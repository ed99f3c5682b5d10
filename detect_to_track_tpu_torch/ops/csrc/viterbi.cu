// Multi-path Viterbi tubelet extraction for Hopper (sm_90a), the whole
// extraction in one launch: one block per clip.
//
// Replaces detect_to_track_tpu/viterbi_device.py::viterbi_multi_link_scan,
// an XLA program (a fori_loop over final timesteps, a while_loop per
// extraction, a lax.scan DP and a reverse-scan backtrack per path), not a
// Pallas kernel. Semantics are those of the plain version,
// viterbi_device.py::viterbi_multi_link_ref:
//
//   for final_ts = T-1 .. 1, while matrix final_ts-1 holds a finite entry:
//     DP: score[t+1][dst] = max_src score[t][src] + seq[t][src][dst], first
//         src on ties; a best that is not > 0 starts a fresh path (parent
//         -1, score 0);
//     end node: the first maximal score at final_ts whose incoming column
//         still holds a finite entry, else the first maximal score;
//     backtrack to the first fresh parent; record (start, final_ts, score,
//         nodes); -inf the path nodes' incoming columns, outgoing rows and
//         (at t = 0) init scores;
//   then every node at t = 0 with a finite init score is a length-1 path.
//
// Every sum is one f32 add in the plain version's order, compares are
// strict '>' in source order (jnp.argmax's and torch.argmax's first-index
// rule), so spans, nodes and n_paths equal the plain version's and the
// scores are bitwise equal.
//
// What bounds it: not bytes or operations. The clip's score matrices
// (22 frames, D = 128: 1.4 MB) are read once from device memory, and the DP
// does 2 flops per matrix entry per step, microseconds of card time in all.
// The extraction is a chain of dependent DP steps (each extraction needs the
// nodes the previous one removed): 2,688 of them at 22 frames, each reading
// one 64 KB matrix, all on the one SM of the one block that walks the
// chain. A step is bound by that SM: by how fast it issues the D * D adds
// and compares and the block's barriers, and by how fast L2 feeds it one
// matrix. What the design does about it:
// - the score matrices are read only. A bitmap in shared memory (a global
//   scratch for long clips), removed[t][n] (T x D bits), marks the extracted
//   nodes. Entry (t, s, v) reads as -inf when removed[t][s] (its outgoing row
//   is masked) or removed[t + 1][v] (its incoming column is masked), and init
//   score n when removed[0][n]: the value a masked copy would hold in every
//   entry a later read touches (the one row such a mask leaves, the end node's
//   row of matrix final_ts, is never read again: later extractions end at
//   final_ts or before). So the caller's tensor needs no copy and no -inf is
//   written. A masked column's DP result is a fresh start whatever its sources
//   hold (every candidate is -inf + score, never > 0). A masked row's
//   candidates are -inf or NaN, never taken by '>' except source 0's, which a
//   scan takes unconditionally: so the scan adds each source's score with its
//   row's mask folded in (pm, -inf for a removed row) to the raw entry, and
//   source 0's candidate alone is the masked entry's sum. The chosen (best,
//   src) are the masked matrix's, for any input, NaN and +inf included;
// - each destination's sources are split over G thread groups, G the largest
//   power of two with G * D <= kMaxThreads and 4 * G * G <= D: 4 at D 128
//   (512 threads), 1 from D 1024. Threads run v fastest, so a warp reads 32
//   neighbouring destinations of one source row. Group g scans its
//   contiguous chunk in order with strict '>' (group 0 starting from source
//   0's candidate, as the sequential scan does; the others from -inf, which
//   every candidate a sequential scan could take beats), the partial
//   (value, source) pairs go to shared memory, and the slot's thread in
//   group 0 combines them in group order with strict '>': the sequential
//   scan's result, the same single add per candidate and the first maximal
//   index. Fewer groups cost a longer scan, more cost a longer combine and
//   more idle warps at the barriers;
// - where two D x D matrices fit in shared memory beside the rest (D even,
//   D up to about 160), the DP reads them from a two-matrix ring: thread 0
//   starts the bulk copy (TMA, cp.async.bulk, completing on an mbarrier) of
//   step t + 1's matrix before step t scans, so the copy runs under a step's
//   work. Past that, a thread loads the entries of 16 sources (16 / NS for
//   NS slots) before it compares any, 16 loads in flight;
// - the end node is the lexicographic maximum of (score, incoming column
//   still finite, -index) over the slots, one 64-bit key a thread reduced in
//   a tree in shared memory (a 64-bit shared-memory atomicMax is a
//   compare-and-swap loop, slow when a thousand threads contend for one
//   word);
// - the DP's prefix rows depend only on earlier matrices, so the block keeps
//   every step's scores and parents and re-runs the DP only from the first
//   step whose inputs the last extraction changed (max(0, start - 1)); a
//   path that starts late re-runs a few steps, not final_ts of them;
// - the per-column count of finite entries of matrix final_ts-1 is kept in
//   shared memory and updated with the bitmap, so the loop condition and the
//   end-node tie-break read no matrix.
// Parents and step scores move to a global scratch when they do not fit in
// shared memory (long clips), and so do the removed bitmap and the path when
// they do not fit beside the per-slot state (longer clips: past about 1,037
// frames at D 1500, 11,059 at D 128). Then the rows the hot loops read are
// staged in shared memory, in a ring of three row slots: a DP step reads
// rows t and t + 1 and copies row t + 2 for the next step (loaded at the
// step's start, stored at its end into the slot row t - 1 left, so the
// step's closing barrier is the only one), and the count pass copies its two
// rows first. The other reads and the removal writes, once per extraction,
// go to the scratch with plain loads and stores (the kernel writes it, so
// never `__ldg`; a block's global writes are visible to its threads after a
// barrier). Read in place from global memory, the bitmap cost the hot scan
// its batched loads. Where the bitmap fits, the layout is unchanged, and the
// bitmap's place is a template parameter: chosen at run time, it left the
// compiler unsure which pointers address shared memory, and generic loads
// and stores in place of shared ones slowed the whole kernel. Past
// kMaxThreads slots, G is 1 and a thread owns the slots tid, tid +
// kMaxThreads, ..., scanning them two at a time with the same adds and
// compares.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

// threads per block, and so the slots a block gives one thread each; the
// CPU build of the tests sets it small to run several slots per thread
#ifndef D2T_VITERBI_MAX_THREADS
#define D2T_VITERBI_MAX_THREADS 1024
#endif

namespace {

constexpr int kMaxThreads = D2T_VITERBI_MAX_THREADS;

// thread groups that split one destination's sources: the largest power of
// two G with G * D <= kMaxThreads and 4 * G * G <= D (a group's chunk of
// D / G sources at least 4 G, the G partials its combine reads)
int source_groups(int D) {
  int g = 1;
  while (2 * g * D <= kMaxThreads && 16 * g * g <= D) g *= 2;
  return g;
}

// G threads per slot up to kMaxThreads slots, then kMaxThreads
int block_threads(int D) { return D <= kMaxThreads ? source_groups(D) * D : kMaxThreads; }

// f(v) for each slot v this thread owns: with one slot per thread, group 0's
// threads own them (v = tid < D); else tid, tid + nth, ... below D
template <bool kOneSlot, typename F>
__device__ __forceinline__ void for_each_slot(int tid, int nth, int D, F f) {
  if (kOneSlot) {
    if (tid < D) f(tid);
    return;
  }
  for (int v = tid; v < D; v += nth) f(v);
}

// dynamic shared memory per block: Hopper's 232,448 bytes less room for the
// kernel's few static shared variables; the CPU build of the tests lowers it
// to reach the global bitmap at a short clip
#ifndef D2T_VITERBI_MAX_SMEM_BYTES
#define D2T_VITERBI_MAX_SMEM_BYTES (232448 - 1024)
#endif
constexpr size_t kMaxSmemBytes = D2T_VITERBI_MAX_SMEM_BYTES;

// the most shared memory the two-matrix ring may take; the CPU build of the
// tests sets it to 0 to run the scan that reads the matrices from L2
#ifndef D2T_VITERBI_MAX_RING_BYTES
#define D2T_VITERBI_MAX_RING_BYTES kMaxSmemBytes
#endif

size_t bitmap_words(int T1, int D) { return static_cast<size_t>(T1 + 1) * ((D + 31) / 32); }

// the groups' partial scores and sources (G x D each), when G > 1
size_t partial_words(int D) {
  const size_t G = source_groups(D);
  return G > 1 ? 2 * G * D : 0;
}

// shared memory: the end-node keys (8 bytes a thread), then in 4-byte
// words init scores (D), masked scores (2 x D), finite counts (D), when they
// fit the path (T) and the removed bitmap (T rows of ceil(D / 32) words),
// else three staged bitmap rows, the partials, then, when they fit, step
// scores and parents (T1 x D each)
size_t base_smem_bytes(int T1, int D, bool bitmap_in_smem) {
  return sizeof(unsigned long long) * block_threads(D) +
         sizeof(float) * (4 * static_cast<size_t>(D) + partial_words(D) +
                          (bitmap_in_smem ? T1 + 1 + bitmap_words(T1, D) : bitmap_words(2, D)));
}

// the kernel's only limit on D (13,632 slots): the per-slot state and three
// staged bitmap rows fit (and a thread stages at most one word of a row).
// T is bounded by the card's memory alone
bool fits(int D) { return base_smem_bytes(0, D, false) <= kMaxSmemBytes && (D + 31) / 32 <= block_threads(D); }

bool bitmap_in_smem(int T1, int D) { return base_smem_bytes(T1, D, true) <= kMaxSmemBytes; }

size_t table_bytes(int T1, int D) {
  return (sizeof(float) + sizeof(int)) * static_cast<size_t>(T1) * D;
}

size_t ring_bytes(int D) { return 2 * sizeof(float) * static_cast<size_t>(D) * D; }

// whether the DP stages its matrices through the two-matrix ring: one slot
// per thread, matrices of a multiple of 16 bytes at 16-byte addresses (D
// even, `seq` 16-byte aligned: the bulk copy's terms), and the ring fits
// beside the rest of the block's state
// step scores and parents beside the rest, the bitmap where it fits
bool tables_in_smem(int T1, int D) {
  return base_smem_bytes(T1, D, bitmap_in_smem(T1, D)) + table_bytes(T1, D) <= kMaxSmemBytes;
}

bool staged(const void* seq, int T1, int D, bool tables_in_smem, bool bitmap_in_smem) {
  return D <= kMaxThreads && D % 2 == 0 && reinterpret_cast<size_t>(seq) % 16 == 0 &&
         ring_bytes(D) <= static_cast<size_t>(D2T_VITERBI_MAX_RING_BYTES) &&
         ring_bytes(D) + base_smem_bytes(T1, D, bitmap_in_smem) + (tables_in_smem ? table_bytes(T1, D) : 0) <=
             kMaxSmemBytes;
}

size_t smem_bytes(const void* seq, int T1, int D, bool tables_in_smem, bool bitmap_in_smem) {
  return base_smem_bytes(T1, D, bitmap_in_smem) + (tables_in_smem ? table_bytes(T1, D) : 0) +
         (staged(seq, T1, D, tables_in_smem, bitmap_in_smem) ? ring_bytes(D) : 0);
}

// false for +-inf and NaN, as isfinite
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < CUDART_INF_F; }

// bit n of a bitmap row (in shared or global memory: a plain load)
__device__ __forceinline__ bool bit(const unsigned* row, int n) { return (row[n >> 5] >> (n & 31)) & 1u; }

#ifdef __CUDACC__
// the ring's transaction barriers (mbarrier) and bulk copies (TMA,
// cp.async.bulk): one thread arms a barrier with the byte count and starts
// the copy; every reader waits for the barrier's phase to complete
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\nfence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes, unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%2], %3;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %3, [%2];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(smem_addr(bar)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
#endif

// the DP's fold over sources [s0, s1), s0 >= 1, for NS slots v[k] of matrix
// m (kRing: its copy in shared memory, else the matrix itself, read from
// L2), continuing (best[k], src[k]) in source order with strict '>'. pm[s]
// is the source's score with removed rows at -inf: a removed row's candidate
// is then -inf or NaN, as it is with the row's masked entries, and neither
// is ever taken by '>' (source 0's candidate, the one a scan takes
// unconditionally, is the caller's, from the masked entry). From L2 the
// entries of 16 / NS sources are loaded before any is compared, so 16 loads
// are in flight per thread (a masked column's too: its result is set by the
// caller).
template <int NS, bool kRing>
__device__ __forceinline__ void scan_sources(const float* __restrict__ m, const float* pm, int D, int s0, int s1,
                                             const int (&v)[NS], float (&best)[NS], int (&src)[NS]) {
  auto take = [&](float x, int k, int s) {
    if (x > best[k]) {
      best[k] = x;
      src[k] = s;
    }
  };
  int s = s0;
  if (!kRing) {
    constexpr int kBatch = 16 / NS;
    for (; s + kBatch <= s1; s += kBatch) {
      float e[kBatch][NS];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
#pragma unroll
        for (int k = 0; k < NS; ++k) e[i][k] = __ldg(m + (s + i) * static_cast<size_t>(D) + v[k]);
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
#pragma unroll
        for (int k = 0; k < NS; ++k) take(pm[s + i] + e[i][k], k, s + i);
    }
  }
#pragma unroll 8
  for (; s < s1; ++s) {
    const float p = pm[s];
    for (int k = 0; k < NS; ++k) {
      const float* a = m + s * static_cast<size_t>(D) + v[k];
      take(p + (kRing ? *a : __ldg(a)), k, s);
    }
  }
}

// kOneSlot: D <= kMaxThreads, one slot per thread, G threads per slot;
// kStaged: the DP reads its matrices from the two-matrix ring;
// kBitmapSmem: the removed bitmap and the path in shared memory, else in
// removed_g and path_g
template <bool kOneSlot, bool kStaged, bool kBitmapSmem>
__global__ void __launch_bounds__(kMaxThreads)
    viterbi_multi_link_kernel(const float* __restrict__ seq, const float* __restrict__ init_scores,
                              float* step_scores_g, int* parents_g, unsigned* removed_g, int* path_g, int* spans,
                              float* scores_out, int* nodes, int* n_paths,
                              int T1, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int T = T1 + 1;
  const int W = (D + 31) / 32;  // bitmap words per frame
  // with one slot per thread, thread tid scans for slot tid % D the sources
  // [lo, hi) of group tid / D
  const int G = kOneSlot ? nth / D : 1;
  const int grp = kOneSlot ? tid / D : 0;
  const int slot = tid - grp * D;
  const int lo = grp * D / G, hi = (grp + 1) * D / G;
  const size_t DD = static_cast<size_t>(D) * D;
  float* ring = reinterpret_cast<float*>(smem_raw);  // 2 x D x D when staged
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(ring + (kStaged ? 2 * DD : 0));
  float* init_s = reinterpret_cast<float*>(keys + nth);
  float* pm_s = init_s + D;  // 2 x D: step t reads half t & 1
  int* cnt = reinterpret_cast<int*>(pm_s + 2 * D);
  // the path and the bitmap after the counts, or in the global scratch and
  // then three staged rows after the counts (row r in slot r % 3)
  int* path = kBitmapSmem ? cnt + D : path_g;
  unsigned* removed = kBitmapSmem ? reinterpret_cast<unsigned*>(path + T) : removed_g;
  unsigned* staged_rows = reinterpret_cast<unsigned*>(cnt + D);
  float* part_v = reinterpret_cast<float*>(kBitmapSmem ? removed + static_cast<size_t>(T) * W : staged_rows + 3 * W);
  int* part_s = reinterpret_cast<int*>(part_v + (G > 1 ? G * D : 0));
  float* S = step_scores_g;
  int* P = parents_g;
  if (S == nullptr) {
    S = reinterpret_cast<float*>(part_s + (G > 1 ? G * D : 0));
    P = reinterpret_cast<int*>(S + static_cast<size_t>(T1) * D);
  }
  __shared__ int s_n, s_dirty, s_start;
  __shared__ unsigned long long s_bar[2];  // the ring halves' barriers
  unsigned ring_phase = 0u;                // bit b: the parity half b waits for next
  const float kNegInf = -CUDART_INF_F;

  for_each_slot<kOneSlot>(tid, nth, D, [&](int v) { init_s[v] = init_scores[v]; });
  for (int i = tid; i < T * W; i += nth) removed[i] = 0u;
  if (tid == 0) {
    s_n = 0;
    s_dirty = 0;  // DP steps [0, s_dirty) are valid
    if (kStaged) {
      mbar_init(&s_bar[0]);
      mbar_init(&s_bar[1]);
    }
  }
  __syncthreads();

  // bitmap row r where the hot loops read it: in place in shared memory, or
  // its staged copy; stage(r) copies it there from the global scratch
  auto row = [&](int r) -> const unsigned* { return kBitmapSmem ? removed + r * W : staged_rows + (r % 3) * W; };
  // (W <= nth: fits() holds it, so a thread copies at most one word)
  auto stage = [&](int r) {
    if (!kBitmapSmem && tid < W) staged_rows[(r % 3) * W + tid] = removed[r * W + tid];
  };

  // staged: thread 0 copies matrix t into ring half t & 1 (one bulk copy)
  auto fill = [&](int t) {
    bulk_copy(ring + (t & 1) * DD, seq + t * DD, static_cast<unsigned>(DD * sizeof(float)), &s_bar[t & 1]);
  };

  for (int final_ts = T1; final_ts >= 1; --final_ts) {
    // finite entries of the incoming matrix's live rows, per live column
    bool any = false;
    {
      stage(final_ts - 1);
      stage(final_ts);
      if (!kBitmapSmem) __syncthreads();
      const float* m = seq + (final_ts - 1) * DD;
      const unsigned* rows = row(final_ts - 1);
      const unsigned* cols = row(final_ts);
      auto count = [&](int v, int s0, int s1) {
        int c = 0;
#pragma unroll 8
        for (int s = s0; s < s1; ++s)
          c += !bit(rows, s) && finite(__ldg(m + s * static_cast<size_t>(D) + v)) ? 1 : 0;
        return c;
      };
      if (kOneSlot) {
        int c = bit(cols, slot) ? 0 : count(slot, lo, hi);
        if (G > 1) {
          part_s[tid] = c;
          __syncthreads();
        }
        if (grp == 0) {
          for (int k = 1; k < G; ++k) c += part_s[k * D + slot];
          cnt[slot] = c;
          any = c > 0;
        }
      } else {
        for (int v = tid; v < D; v += nth) {
          cnt[v] = bit(cols, v) ? 0 : count(v, 0, D);
          any = any || cnt[v] > 0;
        }
      }
    }
    while (__syncthreads_or(any)) {
      // the DP re-runs steps [t0, final_ts): none when the last path was a
      // single node at final_ts + 1. Step t's fold reads pm_s[t & 1]: step
      // t - 1's scores with the rows removed at frame t at -inf (the init
      // scores at t = 0, already masked). Staged: thread 0 starts the copy
      // of step t + 1's matrix into the ring's other half before step t
      // scans, and every thread waits for its step's copy: one copy per wait
      const int t0 = s_dirty;
      if (t0 > 0 && t0 < final_ts)
        for_each_slot<kOneSlot>(tid, nth, D, [&](int v) {
          pm_s[(t0 & 1) * D + v] = bit(removed + t0 * W, v) ? kNegInf : S[static_cast<size_t>(t0 - 1) * D + v];
        });
      if (t0 < final_ts) {
        stage(t0);
        stage(t0 + 1);
      }
      __syncthreads();  // every thread has read s_dirty before thread 0 moves it
      if (kStaged && tid == 0 && t0 < final_ts) fill(t0);

      for (int t = t0; t < final_ts; ++t) {
        const float* pm = t == 0 ? init_s : pm_s + (t & 1) * D;
        const float* m = seq + t * DD;
        const unsigned* cols = row(t + 1);
        // the next step's row, loaded now and stored at the step's end, so
        // the load's latency hides under the scan
        const bool stage_next = !kBitmapSmem && t + 2 <= final_ts && tid < W;
        const unsigned next_word = stage_next ? removed[(t + 2) * W + tid] : 0u;
        // source 0's candidate for slot v as the sequential scan takes it:
        // the source's score plus its masked entry
        auto first = [&](const float* mat, int v, bool masked) {
          const float p0 = t == 0 ? init_s[0] : S[static_cast<size_t>(t - 1) * D];
          return p0 + (bit(row(t), 0) || masked ? kNegInf : (kStaged ? mat[v] : __ldg(mat + v)));
        };
        auto store = [&](int v, bool masked, float best, int src) {
          const bool fresh = masked || !(best > 0.f);
          const float score = fresh ? 0.f : best;
          P[static_cast<size_t>(t) * D + v] = fresh ? -1 : src;
          S[static_cast<size_t>(t) * D + v] = score;
          if (t + 1 < final_ts) pm_s[((t + 1) & 1) * D + v] = bit(cols, v) ? kNegInf : score;
        };
        if (kOneSlot) {
          if (kStaged) {
            if (tid == 0 && t + 1 < final_ts) fill(t + 1);
            mbar_wait(&s_bar[t & 1], (ring_phase >> (t & 1)) & 1u);
            ring_phase ^= 1u << (t & 1);
          }
          const float* mat = kStaged ? ring + (t & 1) * DD : m;
          // a masked column is scanned too (its warp scans for the others)
          // and its result set by store
          const bool masked = bit(cols, slot);
          const int v[1] = {slot};
          float best[1] = {kNegInf};
          int src[1] = {-1};
          int s = lo;
          if (s == 0) {
            best[0] = first(mat, slot, masked);
            src[0] = 0;
            s = 1;
          }
          scan_sources<1, kStaged>(mat, pm, D, s, hi, v, best, src);
          if (G > 1) {
            part_v[tid] = best[0];
            part_s[tid] = src[0];
            __syncthreads();
          }
          if (grp == 0) {
            for (int k = 1; k < G; ++k) {
              const float b = part_v[k * D + slot];
              if (b > best[0]) {
                best[0] = b;
                src[0] = part_s[k * D + slot];
              }
            }
            store(slot, masked, best[0], src[0]);
          }
        } else {
          // the slots two at a time, sharing each source's score
          for (int v0 = tid; v0 < D; v0 += 2 * nth) {
            if (v0 + nth < D) {
              const int v[2] = {v0, v0 + nth};
              const bool masked[2] = {bit(cols, v[0]), bit(cols, v[1])};
              float best[2] = {first(m, v[0], masked[0]), first(m, v[1], masked[1])};
              int src[2] = {0, 0};
              if (!(masked[0] && masked[1])) scan_sources<2, false>(m, pm, D, 1, D, v, best, src);
              store(v[0], masked[0], best[0], src[0]);
              store(v[1], masked[1], best[1], src[1]);
            } else {
              const int v[1] = {v0};
              const bool masked[1] = {bit(cols, v0)};
              float best[1] = {first(m, v0, masked[0])};
              int src[1] = {0};
              if (!masked[0]) scan_sources<1, false>(m, pm, D, 1, D, v, best, src);
              store(v0, masked[0], best[0], src[0]);
            }
          }
        }
        if (stage_next) staged_rows[((t + 2) % 3) * W + tid] = next_word;
        __syncthreads();
      }

      // end node: the lexicographic maximum of the key (score, incoming
      // column still finite, -index); the scores are >= 0 and never NaN, so
      // their bits order as the values do. Each thread's slots first, then a
      // tree over the slot-owning threads' keys in shared memory
      const float* e = S + static_cast<size_t>(final_ts - 1) * D;
      const int owners = nth < D ? nth : D;
      unsigned long long key = 0ull;
      for_each_slot<kOneSlot>(tid, nth, D, [&](int v) {
        const unsigned long long k = static_cast<unsigned long long>(__float_as_uint(e[v])) << 32 |
                                     (cnt[v] > 0 ? 0x80000000u : 0u) | static_cast<unsigned>(0x7fffffff - v);
        key = k > key ? k : key;
      });
      if (tid < owners) keys[tid] = key;
      __syncthreads();
      int half = 1;
      while (2 * half < owners) half *= 2;
      for (; half > 0; half /= 2) {
        if (tid < half && tid + half < owners) keys[tid] = keys[tid] > keys[tid + half] ? keys[tid] : keys[tid + half];
        __syncthreads();
      }

      if (tid == 0) {
        const int end = 0x7fffffff - static_cast<int>(keys[0] & 0x7fffffffull);
        for (int ts = 0; ts < T; ++ts) path[ts] = -1;
        path[final_ts] = end;
        int node = end, start = final_ts;
        for (int t = final_ts - 1; t >= 0; --t) {
          const int p = P[static_cast<size_t>(t) * D + node];
          if (p < 0) break;
          path[t] = p;
          node = p;
          start = t;
        }
        // each extraction consumes node (final_ts, end) -- its column is
        // masked and the tie-break never picks an all--inf column while a
        // finite one exists -- so there are at most T1 * D of them, plus D
        // singles: the T * D rows always suffice. The guard keeps the
        // writes in bounds regardless.
        const int n = s_n;
        if (n < T * D) {
          spans[2 * n] = start;
          spans[2 * n + 1] = final_ts;
          scores_out[n] = e[end];
          for (int ts = 0; ts < T; ++ts) nodes[static_cast<size_t>(n) * T + ts] = path[ts];
          s_n = n + 1;
        }
        s_start = start;
        // the earliest DP step whose inputs the masks below change: the
        // init scores (start 0) or matrix start - 1's column path[start]
        s_dirty = start > 0 ? start - 1 : 0;
      }
      __syncthreads();

      const int start = s_start;
      // the path's row of matrix final_ts - 1 leaves the counts: one less
      // in each column where its entry was finite and neither it nor the
      // column was masked yet
      if (start < final_ts) {
        const int r = path[final_ts - 1];
        if (!bit(removed + (final_ts - 1) * W, r)) {
          const float* row = seq + (final_ts - 1) * DD + static_cast<size_t>(r) * D;
          const unsigned* cols = removed + final_ts * W;
          for_each_slot<kOneSlot>(tid, nth, D, [&](int v) {
            if (!bit(cols, v) && finite(__ldg(row + v))) --cnt[v];
          });
        }
      }
      __syncthreads();
      // remove the path's nodes: row path[ts] of matrix ts and column
      // path[ts] of matrix ts - 1 now read as -inf, and init score path[0]
      for (int ts = start + tid; ts <= final_ts; ts += nth) {
        removed[ts * W + (path[ts] >> 5)] |= 1u << (path[ts] & 31);
        if (ts == 0) init_s[path[0]] = kNegInf;
      }
      const int end = path[final_ts];
      any = false;
      for_each_slot<kOneSlot>(tid, nth, D, [&](int v) {
        if (v == end) cnt[v] = 0;
        any = any || cnt[v] > 0;
      });
      // the loop condition's __syncthreads_or orders these writes
    }
  }
  __syncthreads();

  // length-1 paths at t = 0 from the surviving init scores, in node order
  if (tid == 0) {
    int n = s_n;
    for (int node = 0; node < D && n < T * D; ++node) {
      if (!finite(init_s[node])) continue;
      spans[2 * n] = 0;
      spans[2 * n + 1] = 0;
      scores_out[n] = init_s[node];
      nodes[static_cast<size_t>(n) * T] = node;
      for (int ts = 1; ts < T; ++ts) nodes[static_cast<size_t>(n) * T + ts] = -1;
      ++n;
    }
    s_n = n;
    *n_paths = n;
  }
  __syncthreads();

  // the unused rows: zero spans and scores, -1 nodes
  const int n = s_n;
  const size_t cap = static_cast<size_t>(T) * D;
  for (size_t i = static_cast<size_t>(n) * T + tid; i < cap * T; i += nth) nodes[i] = -1;
  for (size_t i = n + tid; i < cap; i += nth) {
    spans[2 * i] = 0;
    spans[2 * i + 1] = 0;
    scores_out[i] = 0.f;
  }
}

using Kernel = void (*)(const float*, const float*, float*, int*, unsigned*, int*, int*, float*, int*, int*, int, int);

// the kernel for a launch: the ring when staged, one slot per thread up to
// kMaxThreads slots, the bitmap where kBitmapSmem says
template <bool kBitmapSmem>
Kernel kernel_for(bool ring, int D) {
  return ring               ? viterbi_multi_link_kernel<true, true, kBitmapSmem>
         : D <= kMaxThreads ? viterbi_multi_link_kernel<true, false, kBitmapSmem>
                            : viterbi_multi_link_kernel<false, false, kBitmapSmem>;
}

}  // namespace

extern "C" {

// 1 when a clip's init scores, masked scores, counts, partials and three
// staged bitmap rows fit in shared memory (the kernel's only limit on D:
// 13,632 slots, at any T >= 0), else 0. The bitmap and the tables go to a
// global scratch when they do not fit beside it.
int d2t_viterbi_fits(int T1, int D) { return T1 >= 0 && D >= 1 && fits(D) ? 1 : 0; }

// 1 when a clip's removed bitmap and path fit in shared memory beside the
// per-slot state, 0 when the wrapper must pass a global scratch for them.
int d2t_viterbi_bitmap_in_smem(int T1, int D) { return bitmap_in_smem(T1, D) ? 1 : 0; }

// 1 when a clip's step scores and parents fit in shared memory beside the
// rest, 0 when the wrapper must pass a global scratch for them.
int d2t_viterbi_tables_in_smem(int T1, int D) { return tables_in_smem(T1, D) ? 1 : 0; }

#ifdef __CUDACC__

// seq: (T1, D, D) float32 score matrices, read only. init: (D,) float32.
// step_scores / parents: (T1, D) float32 / int32 global scratch, or both
// null when d2t_viterbi_tables_in_smem says they fit in shared memory.
// removed / path: (T, ceil(D / 32)) / (T,) int32 global scratch, or both
// null when d2t_viterbi_bitmap_in_smem says they fit (the kernel zeroes
// the bitmap itself). Outputs, every element written: spans (T*D, 2)
// int32, scores (T*D,) float32, nodes (T*D, T) int32 (-1 outside a path's
// span and in unused rows), n_paths (1,) int32, with T = T1 + 1. One block
// of block_threads(D) threads on `stream`; D up to 13,632 slots (the
// per-slot state in shared memory), any T. Returns cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for what the kernel does not take.
int d2t_viterbi_multi_link(const void* seq, const void* init, void* step_scores,
                           void* parents, void* removed, void* path, void* spans,
                           void* scores, void* nodes, void* n_paths, int T1, int D,
                           void* stream) {
  if (!d2t_viterbi_fits(T1, D) || (step_scores == nullptr) != (parents == nullptr) ||
      (removed == nullptr) != (path == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tables_smem = step_scores == nullptr;
  const bool bitmap_smem = removed == nullptr;
  const size_t smem = smem_bytes(seq, T1, D, tables_smem, bitmap_smem);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const bool ring = staged(seq, T1, D, tables_smem, bitmap_smem);
  const Kernel kernel = bitmap_smem ? kernel_for<true>(ring, D) : kernel_for<false>(ring, D);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, block_threads(D), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(seq), static_cast<const float*>(init),
      static_cast<float*>(step_scores), static_cast<int*>(parents),
      static_cast<unsigned*>(removed), static_cast<int*>(path),
      static_cast<int*>(spans), static_cast<float*>(scores),
      static_cast<int*>(nodes), static_cast<int*>(n_paths), T1, D);
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // extern "C"
