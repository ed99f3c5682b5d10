"""tubelet linking on the host: Viterbi decoding over per-frame detections
(a copy of the JAX package's numpy `viterbi.py`; the port imports nothing of
that package).

The DP recursion is vectorized: each timestep is one (|S|, |D|) matrix
max-reduce with parent backtracking. The native C++ linker
(native/viterbi.cpp, loaded with ctypes) runs the whole multi-path
extraction; this numpy code is its oracle and the `use_native=False` path.

Semantics:
- link score s(a, b) = conf_a + conf_b + psi, psi = 1 iff some predicted
  track box overlaps both detections with IoU > thresh.
- the modified Viterbi seeds a fresh single-node path with score 0.0 at
  every destination node (strictly-greater comparisons), so tubelets can
  begin mid-sequence.
- multi-path extraction: repeatedly take the best path ending at the
  current final timestep, then -inf its nodes' incoming/outgoing transitions
  (and init score at t=0); pop the last transition matrix and repeat for the
  previous final timestep; finally, surviving t=0 nodes become length-1
  tubelets.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .boxes import compute_ious_np


def compute_link_scores(
    confs_a: np.ndarray,
    confs_b: np.ndarray,
    bboxes_a: np.ndarray,
    bboxes_b: np.ndarray,
    tracks: np.ndarray,
    iou_thresh: float,
) -> np.ndarray:
    """(|A|, |B|) link scores between adjacent frames."""
    confs = confs_a[:, None] + confs_b[None, :]  # (|A|, |B|)
    matches_a = compute_ious_np(bboxes_a, tracks) > iou_thresh  # (|A|, |T|)
    matches_b = compute_ious_np(bboxes_b, tracks) > iou_thresh  # (|B|, |T|)
    psi = (matches_a[:, None, :] & matches_b[None, :, :]).any(-1)  # (|A|, |B|)
    return confs + psi.astype(float)


def compute_score_seq(
    conf_seq: Sequence[np.ndarray],
    bbox_seq: Sequence[np.ndarray],
    track_seq: Sequence[np.ndarray],
    iou_thresh: float,
) -> List[np.ndarray]:
    """score matrices for every adjacent frame pair."""
    if len(conf_seq) != len(bbox_seq):
        raise ValueError(f"|conf_seq|={len(conf_seq)} but |bbox_seq|={len(bbox_seq)}")
    if len(track_seq) != len(conf_seq) - 1:
        raise ValueError(f"|track_seq|={len(track_seq)} but |det_seq|={len(conf_seq)}")
    return [
        compute_link_scores(
            conf_seq[t], conf_seq[t + 1], bbox_seq[t], bbox_seq[t + 1], track_seq[t], iou_thresh
        )
        for t in range(len(conf_seq) - 1)
    ]


def viterbi(
    score_seq: List[np.ndarray],
    init_scores: Optional[Sequence[float]] = None,
    prefer_end: Optional[np.ndarray] = None,
) -> Tuple[List[int], float]:
    """best path to the final timestep.

    The recursion at each step, for every destination node:
        best over sources of (source_score + transition), but if that best
        is not strictly positive, start a fresh path at the destination
        with score 0.0.

    prefer_end: optional (|D_final|,) bool mask -- among maximal final
        scores the first PREFERRED node wins (falling back to plain first
        argmax when no maximal node is preferred). viterbi_multi_link
        passes has-finite-incoming here so every extraction consumes a
        transition entry; see the termination note there.
    """
    if not score_seq and init_scores is None:
        raise ValueError("if no transitions, init_scores must be passed in")

    if init_scores is None:
        init_scores = [0.0] * score_seq[0].shape[0]
    scores = np.asarray(init_scores, dtype=float)  # (|D_0|,)

    parents: List[np.ndarray] = []
    for trans in score_seq:  # (|S|, |D|)
        if trans.shape[0] == 0:
            # an empty frame mid-sequence (every detection filtered out):
            # no sources exist, so every destination starts a fresh path --
            # exactly what the fresh-path rule yields when no incoming
            # candidate is strictly positive (np.argmax over the empty
            # source axis would raise instead).
            parents.append(np.full(trans.shape[1], -1, dtype=np.int64))
            scores = np.zeros(trans.shape[1])
            continue
        cand = scores[:, None] + trans  # (|S|, |D|)
        best_src = np.argmax(cand, axis=0)  # first max
        best_val = cand[best_src, np.arange(cand.shape[1])]
        fresh = ~(best_val > 0.0)  # not strictly positive -> fresh path
        parents.append(np.where(fresh, -1, best_src))
        scores = np.where(fresh, 0.0, best_val)

    if prefer_end is not None:
        cand = (scores == scores.max()) & np.asarray(prefer_end, bool)
        end = int(np.argmax(np.where(cand, scores, -np.inf))) if cand.any() else int(np.argmax(scores))
    else:
        end = int(np.argmax(scores))
    path = [end]
    for parent in reversed(parents):
        p = int(parent[path[0]])
        if p < 0:
            break
        path.insert(0, p)
    return path, float(scores[end])


def viterbi_multi_link(
    score_seq: List[np.ndarray],
    init_scores: Optional[List[float]] = None,
    use_native: bool = True,
) -> List[Tuple[Tuple[int, int], float, List[int]]]:
    """extract multiple non-overlapping paths.

    use_native: run the native C++ linker (raises RuntimeError when it
        cannot be built); False runs this numpy loop.

    Returns [(start_ts, end_ts), score, path] triples.
    """
    if not score_seq and init_scores is None:
        raise ValueError("if no transitions, init_scores must be passed in")
    score_seq = [np.array(s, dtype=float) for s in score_seq]
    if init_scores is None:
        init_scores = [0.0] * len(score_seq[0])
    init_scores = list(init_scores)

    if use_native:
        from .native import viterbi_native

        return viterbi_native.multi_link(score_seq, init_scores)

    n_time_steps = len(score_seq) + 1
    ans = []
    for final_ts in reversed(range(1, n_time_steps)):
        while np.any(np.isfinite(score_seq[final_ts - 1])):
            # end-node tie-break toward nodes with finite incoming entries:
            # identical extraction on every input the reference's loop
            # terminates on, but guarantees progress when transitions of
            # exactly 0.0 are reachable (confidence underflow) -- a fresh
            # 0-score path at an already-drained node would otherwise be
            # re-extracted forever. Same rule in the device
            # (viterbi_device.py, ops/csrc/viterbi.cu) and native
            # (native/viterbi.cpp) linkers.
            prefer = np.any(np.isfinite(score_seq[final_ts - 1]), axis=0)
            path, score = viterbi(score_seq, init_scores, prefer_end=prefer)
            start_ts = final_ts - len(path) + 1
            ans.append(((start_ts, final_ts), score, path))

            # remove the path's nodes from further consideration
            for ts, node in zip(range(start_ts, final_ts + 1), path):
                if ts == 0:
                    init_scores[node] = -np.inf
                if ts > 0:
                    score_seq[ts - 1][:, node] = -np.inf  # incoming
                if ts < final_ts:
                    score_seq[ts][node, :] = -np.inf  # outgoing
        score_seq.pop()

    # length-1 tubelets at t=0
    for node, s in enumerate(init_scores):
        if np.isfinite(s):
            ans.append(((0, 0), float(s), [node]))
    return ans


def viterbi_tracking(
    conf_seq: List[np.ndarray],
    bbox_seq: List[np.ndarray],
    track_seq: List[np.ndarray],
    iou_thresh: float,
    min_len: int,
    use_native: bool = True,
) -> List[Tuple[Tuple[int, int], np.ndarray]]:
    """end-to-end tubelet extraction.

    Returns [((start_ts, end_ts), boxes (len, 4))] for tubelets with
    length >= min_len.
    """
    init_scores = [float(c) for c in conf_seq[0]]
    score_seq = compute_score_seq(conf_seq, bbox_seq, track_seq, iou_thresh)
    track_paths = viterbi_multi_link(score_seq, init_scores, use_native)

    tubelets = []
    for (start_ts, end_ts), _score, path in track_paths:
        if end_ts - start_ts + 1 >= min_len:
            boxes = np.array([bbox_seq[ts][node] for ts, node in zip(range(start_ts, end_ts + 1), path)])
            tubelets.append(((start_ts, end_ts), boxes))
    return tubelets
