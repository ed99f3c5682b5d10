// native multi-path Viterbi tubelet extraction.
//
// C++ replacement for the host-side CPU hot loop of tubelet linking: the
// reference implementation re-runs an O(T * |D|^2) pure-Python dynamic
// program once per extracted path (jfc4050/detect-to-track viterbi.py:95-159).
// Here the whole extraction loop runs natively; the Python oracle lives in
// detect_to_track_tpu_torch/viterbi.py and tests pin exact equality. (A
// copy of detect_to_track_tpu/native/viterbi.cpp: the port imports nothing
// of the JAX package.)
//
// Semantics (matching the reference):
// - DP with a fresh-path rule: at every destination node the running best
//   starts at 0.0 with no parent, comparisons strictly greater -- tubelets
//   may begin mid-sequence.
// - multi-path extraction: for final_ts descending, while the incoming
//   transition matrix has any finite entry, take the best path ending at
//   final_ts and -inf its nodes' incoming/outgoing transitions (and init
//   score at t=0); finally surviving t=0 nodes become length-1 tubelets.
// - one deviation (shared with the numpy and device linkers): end-node ties
//   break toward a node with finite incoming entries, so every extraction
//   consumes a transition and the loop provably terminates (the reference
//   spins forever when an exactly-0.0 transition is reachable). A defensive
//   removed-nothing break remains as belt-and-braces.
//
// Build: g++ -O3 -shared -fPIC into build/native/ (see viterbi_native.py).
// Plain C ABI.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

const double kNegInf = -std::numeric_limits<double>::infinity();

struct DP {
  std::vector<double> scores;
  std::vector<std::vector<int64_t>> parents;
};

// one full DP pass over the first `upto` transition matrices.
// trans[t] is row-major (dims[t] x dims[t+1]).
void run_dp(const std::vector<std::vector<double>>& trans,
            const int64_t* dims, int64_t upto,
            const std::vector<double>& init, DP* dp) {
  dp->scores = init;
  dp->parents.assign(upto, {});
  for (int64_t t = 0; t < upto; ++t) {
    const int64_t n_src = dims[t];
    const int64_t n_dst = dims[t + 1];
    const double* m = trans[t].data();
    std::vector<double> next(n_dst);
    dp->parents[t].resize(n_dst);
    for (int64_t d = 0; d < n_dst; ++d) {
      double best = 0.0;  // fresh-path seed
      int64_t best_src = -1;
      for (int64_t s = 0; s < n_src; ++s) {
        const double v = dp->scores[s] + m[s * n_dst + d];
        if (v > best) {
          best = v;
          best_src = s;
        }
      }
      next[d] = best;
      dp->parents[t][d] = best_src;
    }
    dp->scores.swap(next);
  }
}

bool any_finite(const std::vector<double>& m) {
  for (double v : m)
    if (std::isfinite(v)) return true;
  return false;
}

}  // namespace

extern "C" {

// Returns the number of extracted paths, or -1 on capacity overflow.
//
//   trans_flat:  concatenated row-major transition matrices
//   dims:        per-timestep detection counts, length n_trans + 1
//   n_trans:     number of transition matrices (T - 1)
//   init:        initial scores, length dims[0]
//   max_paths / nodes_cap: capacities of the output buffers
//   out_start/out_end/out_scores: per-path (start_ts, end_ts, score)
//   out_nodes + out_node_offsets: concatenated per-path node lists
int64_t d2t_viterbi_multi_link(
    const double* trans_flat, const int64_t* dims, int64_t n_trans,
    const double* init, int64_t max_paths, int64_t nodes_cap,
    int64_t* out_start, int64_t* out_end, double* out_scores,
    int64_t* out_nodes, int64_t* out_node_offsets) {
  // mutable copies
  std::vector<std::vector<double>> trans(n_trans);
  int64_t off = 0;
  for (int64_t t = 0; t < n_trans; ++t) {
    const int64_t n = dims[t] * dims[t + 1];
    trans[t].assign(trans_flat + off, trans_flat + off + n);
    off += n;
  }
  std::vector<double> init_s(init, init + dims[0]);

  int64_t n_paths = 0;
  int64_t node_pos = 0;
  DP dp;

  for (int64_t final_ts = n_trans; final_ts >= 1; --final_ts) {
    while (any_finite(trans[final_ts - 1])) {
      run_dp(trans, dims, final_ts, init_s, &dp);

      // best end node: first max, tie-broken toward nodes whose incoming
      // column still has a finite entry. Identical to plain first-argmax on
      // every input the reference's loop terminates on, but guarantees each
      // extraction consumes a transition entry -- with exactly-0.0
      // transitions a fresh 0-score path at a drained node would otherwise
      // be re-extracted until the defensive break below. Same rule in the
      // numpy (viterbi.py) and device (viterbi_device.py) linkers.
      int64_t end = 0;
      double best = dp.scores.empty() ? kNegInf : dp.scores[0];
      for (size_t i = 1; i < dp.scores.size(); ++i)
        if (dp.scores[i] > best) {
          best = dp.scores[i];
          end = static_cast<int64_t>(i);
        }
      {
        const std::vector<double>& last = trans[final_ts - 1];
        const int64_t n_src = dims[final_ts - 1];
        const int64_t n_dst = dims[final_ts];
        auto incoming_finite = [&](int64_t d) {
          for (int64_t s = 0; s < n_src; ++s)
            if (std::isfinite(last[s * n_dst + d])) return true;
          return false;
        };
        if (!incoming_finite(end)) {
          for (int64_t d = 0; d < n_dst; ++d)
            if (dp.scores[d] == best && incoming_finite(d)) {
              end = d;
              break;
            }
        }
      }

      // backtrack
      std::vector<int64_t> path = {end};
      for (int64_t t = final_ts - 1; t >= 0; --t) {
        const int64_t p = dp.parents[t][path.front()];
        if (p < 0) break;
        path.insert(path.begin(), p);
      }
      const int64_t start_ts = final_ts - static_cast<int64_t>(path.size()) + 1;

      if (n_paths >= max_paths ||
          node_pos + static_cast<int64_t>(path.size()) > nodes_cap)
        return -1;
      out_start[n_paths] = start_ts;
      out_end[n_paths] = final_ts;
      out_scores[n_paths] = best;
      out_node_offsets[n_paths] = node_pos;
      for (int64_t node : path) out_nodes[node_pos++] = node;
      ++n_paths;

      // remove the path's nodes; track whether anything changed so an
      // all-zero-score corner case cannot spin forever.
      bool removed = false;
      for (size_t i = 0; i < path.size(); ++i) {
        const int64_t ts = start_ts + static_cast<int64_t>(i);
        const int64_t node = path[i];
        if (ts == 0 && std::isfinite(init_s[node])) {
          init_s[node] = kNegInf;
          removed = true;
        }
        if (ts > 0) {  // incoming transitions
          std::vector<double>& m = trans[ts - 1];
          const int64_t n_dst = dims[ts];
          for (int64_t s = 0; s < dims[ts - 1]; ++s) {
            double& v = m[s * n_dst + node];
            if (std::isfinite(v)) removed = true;
            v = kNegInf;
          }
        }
        if (ts < final_ts) {  // outgoing transitions
          std::vector<double>& m = trans[ts];
          const int64_t n_dst = dims[ts + 1];
          for (int64_t d = 0; d < n_dst; ++d) {
            double& v = m[node * n_dst + d];
            if (std::isfinite(v)) removed = true;
            v = kNegInf;
          }
        }
      }
      if (!removed) break;  // defensive (see header comment)
    }
  }

  // length-1 tubelets at t=0
  for (int64_t node = 0; node < dims[0]; ++node) {
    if (std::isfinite(init_s[node])) {
      if (n_paths >= max_paths || node_pos + 1 > nodes_cap) return -1;
      out_start[n_paths] = 0;
      out_end[n_paths] = 0;
      out_scores[n_paths] = init_s[node];
      out_node_offsets[n_paths] = node_pos;
      out_nodes[node_pos++] = node;
      ++n_paths;
    }
  }
  return n_paths;
}
}
