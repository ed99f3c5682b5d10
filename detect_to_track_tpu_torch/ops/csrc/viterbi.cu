// Multi-path Viterbi tubelet extraction for Hopper (sm_90a), the whole
// extraction in one launch: one block per clip, one thread per detection
// slot.
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
// The extraction is a chain of a few hundred dependent steps (each needs
// the previous one's -inf masks), so it is latency-bound: one block walks
// it. What the design does about that:
// - the DP's prefix rows depend only on earlier matrices, so the block keeps
//   every step's scores and parents in shared memory and re-runs the DP
//   only from the first step whose inputs the last extraction changed
//   (max(0, start - 1)); a path that starts late re-runs a few steps, not
//   final_ts of them. The values are the same adds on the same inputs, so
//   the reuse is exact;
// - the per-column count of finite entries of matrix final_ts-1 is kept in
//   shared memory and updated by the masks, so the loop condition and the
//   end-node tie-break read no matrix;
// - thread dst reads seq[t][src][dst] over src: the warp's loads are
//   coalesced rows, and the source scores are a shared-memory broadcast.
// Parents and step scores move to a global scratch when they do not fit in
// shared memory (long clips).

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kMaxSlots = 1024;           // D <= one block's threads
// dynamic shared memory per block: Hopper's 232,448 bytes less room for the
// kernel's few static shared variables
constexpr size_t kMaxSmemBytes = 232448 - 1024;

// shared memory: init scores (D), finite counts (D), the path (T), then, when
// they fit, step scores and parents (T1 x D each)
size_t base_smem_bytes(int T1, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(D) + T1 + 1);
}

size_t table_bytes(int T1, int D) {
  return (sizeof(float) + sizeof(int)) * static_cast<size_t>(T1) * D;
}

// false for +-inf and NaN, as isfinite
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < CUDART_INF_F; }

__global__ void __launch_bounds__(kMaxSlots)
    viterbi_multi_link_kernel(float* seq, const float* __restrict__ init_scores,
                              float* step_scores_g, int* parents_g, int* spans,
                              float* scores_out, int* nodes, int* n_paths,
                              int T1, int D) {
  // seq is read after this block's own -inf writes: plain loads (no
  // __restrict__ / read-only cache), ordered by __syncthreads.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;  // the destination slot this thread owns
  const int T = T1 + 1;
  float* init_s = reinterpret_cast<float*>(smem_raw);
  int* cnt = reinterpret_cast<int*>(init_s + D);
  int* path = cnt + D;
  float* S = step_scores_g;
  int* P = parents_g;
  if (S == nullptr) {
    S = reinterpret_cast<float*>(path + T);
    P = reinterpret_cast<int*>(S + static_cast<size_t>(T1) * D);
  }
  __shared__ int s_n, s_dirty, s_start;
  const float kNegInf = -CUDART_INF_F;
  const size_t DD = static_cast<size_t>(D) * D;

  init_s[tid] = init_scores[tid];
  if (tid == 0) {
    s_n = 0;
    s_dirty = 0;  // DP steps [0, s_dirty) are valid
  }
  __syncthreads();

  for (int final_ts = T1; final_ts >= 1; --final_ts) {
    {  // finite entries in this thread's column of the incoming matrix
      const float* col = seq + (final_ts - 1) * DD + tid;
      int c = 0;
#pragma unroll 16
      for (int s = 0; s < D; ++s) c += finite(col[s * static_cast<size_t>(D)]) ? 1 : 0;
      cnt[tid] = c;
    }
    while (__syncthreads_or(cnt[tid] > 0)) {
      const int t0 = s_dirty;
      __syncthreads();  // every thread has read s_dirty before thread 0 moves it

      // the DP over the steps whose inputs changed
      for (int t = t0; t < final_ts; ++t) {
        const float* prev = t == 0 ? init_s : S + static_cast<size_t>(t - 1) * D;
        const float* m = seq + t * DD + tid;
        float best = prev[0] + m[0];
        int src = 0;
#pragma unroll 16
        for (int s = 1; s < D; ++s) {
          const float v = prev[s] + m[s * static_cast<size_t>(D)];
          if (v > best) {
            best = v;
            src = s;
          }
        }
        const bool fresh = !(best > 0.f);
        P[static_cast<size_t>(t) * D + tid] = fresh ? -1 : src;
        S[static_cast<size_t>(t) * D + tid] = fresh ? 0.f : best;
        __syncthreads();
      }

      if (tid == 0) {
        // end node: first maximal score with a finite incoming entry, else
        // the first maximal score (the end scores are all >= 0)
        const float* e = S + static_cast<size_t>(final_ts - 1) * D;
        float mx = e[0];
        for (int d = 1; d < D; ++d) mx = e[d] > mx ? e[d] : mx;
        int end = -1;
        for (int d = 0; d < D && end < 0; ++d)
          if (e[d] == mx && cnt[d] > 0) end = d;
        for (int d = 0; d < D && end < 0; ++d)
          if (e[d] == mx) end = d;

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
        // each extraction consumes node (final_ts, end) -- its column goes
        // to -inf and the tie-break never picks an all--inf column while a
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
      // outgoing: row path[ts] of matrix ts, ts in [start, final_ts)
      for (int ts = start; ts < final_ts; ++ts) {
        float* row = seq + ts * DD + static_cast<size_t>(path[ts]) * D;
        if (ts == final_ts - 1 && finite(row[tid])) --cnt[tid];
        row[tid] = kNegInf;
      }
      __syncthreads();
      // incoming: column path[ts] of matrix ts - 1, ts in [max(start, 1), final_ts]
      for (int ts = start > 0 ? start : 1; ts <= final_ts; ++ts)
        seq[(ts - 1) * DD + static_cast<size_t>(tid) * D + path[ts]] = kNegInf;
      if (tid == path[final_ts]) cnt[tid] = 0;
      if (start == 0 && tid == path[0]) init_s[tid] = kNegInf;
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
  for (size_t i = static_cast<size_t>(n) * T + tid; i < cap * T; i += blockDim.x) nodes[i] = -1;
  for (size_t i = n + tid; i < cap; i += blockDim.x) {
    spans[2 * i] = 0;
    spans[2 * i + 1] = 0;
    scores_out[i] = 0.f;
  }
}

}  // namespace

extern "C" {

// 1 when a clip's step scores and parents fit in shared memory beside the
// rest, 0 when the wrapper must pass a global scratch for them.
int d2t_viterbi_tables_in_smem(int T1, int D) {
  return base_smem_bytes(T1, D) + table_bytes(T1, D) <= kMaxSmemBytes ? 1 : 0;
}

// seq: (T1, D, D) float32 scratch copy of the score matrices, masked in
// place. init: (D,) float32. step_scores / parents: (T1, D) float32 / int32
// global scratch, or both null when d2t_viterbi_tables_in_smem says they
// fit in shared memory. Outputs, every element written: spans (T*D, 2)
// int32, scores (T*D,) float32, nodes (T*D, T) int32 (-1 outside a path's
// span and in unused rows), n_paths (1,) int32, with T = T1 + 1. One block
// of D threads on `stream`; returns cudaGetLastError() (0 on success).
int d2t_viterbi_multi_link(void* seq, const void* init, void* step_scores,
                           void* parents, void* spans, void* scores,
                           void* nodes, void* n_paths, int T1, int D,
                           void* stream) {
  if (T1 < 0 || D < 1 || D > kMaxSlots ||
      (step_scores == nullptr) != (parents == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool in_smem = step_scores == nullptr;
  if (in_smem && !d2t_viterbi_tables_in_smem(T1, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = base_smem_bytes(T1, D) + (in_smem ? table_bytes(T1, D) : 0);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_multi_link_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_multi_link_kernel<<<1, D, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(seq), static_cast<const float*>(init),
      static_cast<float*>(step_scores), static_cast<int*>(parents),
      static_cast<int*>(spans), static_cast<float*>(scores),
      static_cast<int*>(nodes), static_cast<int*>(n_paths), T1, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
