"""device-side Viterbi tubelet linking (port of the JAX package's
`viterbi_device.py`): link scoring and the whole multi-path extraction run
on the model's device, and only the final integer paths go to the host.

Inputs are padded: detections are fixed (T, D) slots and invalid slots carry
-inf link scores, the "removed node" representation the multi-path loop
already uses. Valid slots are compacted to the front and every live score is
>= 0 (sums of confidences + psi), so first-index tie-breaking never selects
a padded slot over a real one and results trim to the host linker's
(viterbi.py).

The extraction is `viterbi_multi_link_scan`: on a CUDA tensor it launches
one hand-written kernel (`ops/csrc/viterbi.cu`, `viterbi_multi_link_cuda`)
that runs the whole extraction in one block; on a CPU tensor it runs the
plain version, `viterbi_multi_link_ref`, a transcription of the JAX
program with Python loops. A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .boxes import compute_ious
from .ops import _build

NEG_INF = float("-inf")


def link_scores(
    confs_a: torch.Tensor,
    confs_b: torch.Tensor,
    boxes_a: torch.Tensor,
    boxes_b: torch.Tensor,
    tracks: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    iou_thresh: float,
) -> torch.Tensor:
    """(..., D, D) padded link-score matrices for adjacent frame pairs
    (device form of viterbi.compute_link_scores), batched over leading axes.

    s(a, b) = conf_a + conf_b + psi;  psi = 1 iff some predicted track box
    overlaps both detections with IoU > thresh. Invalid slots (either side)
    get -inf. `tracks` are the frame-(t+1) predicted positions of frame-t
    detections, so they share valid_a.
    """
    confs = confs_a[..., :, None] + confs_b[..., None, :]
    m_a = (compute_ious(boxes_a, tracks) > iou_thresh) & valid_a[..., None, :]
    m_b = (compute_ious(boxes_b, tracks) > iou_thresh) & valid_a[..., None, :]
    # psi = any over tracks of m_a & m_b: a 0/1 product counts the shared
    # tracks exactly in f32 (at most D of them)
    psi = (m_a.to(confs.dtype) @ m_b.to(confs.dtype).transpose(-1, -2)) > 0
    s = confs + psi.to(confs.dtype)
    live = valid_a[..., :, None] & valid_b[..., None, :]
    return torch.where(live, s, torch.full_like(s, NEG_INF))


def clip_link_scores(
    confs: torch.Tensor,  # (T, D) class-summed confidences
    boxes: torch.Tensor,  # (T, D, 4) ijhw
    track_boxes: torch.Tensor,  # (T-1, D, 4) decoded frame-(t+1) predictions
    valid: torch.Tensor,  # (T, D) bool
    iou_thresh: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T-1, D, D) score matrices + (D,) init scores for a whole clip, all
    adjacent pairs in one batched call (host equivalent:
    viterbi.compute_score_seq)."""
    seq = link_scores(
        confs[:-1], confs[1:], boxes[:-1], boxes[1:], track_boxes, valid[:-1], valid[1:], iou_thresh
    )
    init = torch.where(valid[0], confs[0], torch.full_like(confs[0], NEG_INF))
    return seq, init


def viterbi_scan(score_seq: torch.Tensor, init_scores: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """the DP recursion (host oracle: viterbi.viterbi).

    Each step, for every destination node: best over sources of
    (source_score + transition), first source on ties; if that best is not
    strictly positive the destination starts a fresh path (parent -1,
    score 0).

    Args:
        score_seq: (T-1, D, D) transition matrices (-inf = no link).
        init_scores: (D,) scores at t=0.

    Returns:
        parents: (T-1, D) int32, parents[t][d] = source of d at ts t+1
            (-1 = fresh path started at ts t+1).
        step_scores: (T-1, D) best-path score ending at each node of ts t+1
            (prefix results: row t is exact for a sequence truncated there).
    """
    scores = init_scores
    parents, step_scores = [], []
    for trans in score_seq:
        cand = scores[:, None] + trans  # (src, dst)
        best_src = torch.argmax(cand, dim=0).to(torch.int32)  # first max
        best_val = cand.amax(dim=0)
        fresh = ~(best_val > 0.0)
        parents.append(torch.where(fresh, torch.full_like(best_src, -1), best_src))
        scores = torch.where(fresh, torch.zeros_like(best_val), best_val)
        step_scores.append(scores)
    if not parents:
        d = init_scores.shape[0]
        empty = score_seq.new_empty((0, d))
        return empty.to(torch.int32), empty
    return torch.stack(parents), torch.stack(step_scores)


def viterbi_backtrack(parents: torch.Tensor, end: torch.Tensor, final_ts: int) -> torch.Tensor:
    """walk parents back from `end` at timestep `final_ts`.

    Returns nodes (T,) int32: the path's node at each timestep, -1 outside
    [start_ts, final_ts]. The walk starts at t = final_ts - 1 and stops at
    the first fresh (-1) parent (host oracle: viterbi.viterbi's backtrack
    loop).
    """
    t1 = parents.shape[0]
    nodes = torch.full((t1 + 1,), -1, dtype=torch.int32, device=parents.device)
    # one-element index tensors: a 0-dim tensor index would read it on the host
    node = end.reshape(1).to(torch.int64)
    active = torch.ones((1,), dtype=torch.bool, device=parents.device)
    for t in range(final_ts - 1, -1, -1):
        p = parents[t].index_select(0, node)
        active = active & (p >= 0)
        nodes[t : t + 1] = torch.where(active, p, torch.full_like(p, -1))
        node = torch.where(active, p.to(torch.int64), node)
    nodes[final_ts : final_ts + 1] = end.reshape(1).to(torch.int32)
    return nodes


class DevicePaths(NamedTuple):
    """fixed-capacity multi-path extraction result (trim with n_paths)."""

    spans: torch.Tensor  # (P, 2) int32 [start_ts, final_ts]
    scores: torch.Tensor  # (P,) float
    nodes: torch.Tensor  # (P, T) int32, -1 outside the span
    n_paths: torch.Tensor  # () int32


def viterbi_multi_link_ref(score_seq: torch.Tensor, init_scores: torch.Tensor) -> DevicePaths:
    """the plain version of the multi-path extraction (host oracle:
    viterbi.viterbi_multi_link), a transcription of the JAX package's
    `viterbi_multi_link_scan` with Python loops; one host read per
    extraction (its loop condition).

    For final_ts = T-1 .. 1: while the incoming matrix of final_ts has any
    finite entry, run the DP (its prefix rows are exact for every
    truncation, so the steps up to final_ts suffice), take the best path
    ending at final_ts, record it, and -inf its nodes' incoming/outgoing
    transitions (and t=0 init score). Surviving t=0 nodes become length-1
    tubelets. P = T * D rows: every extracted path consumes >= 1 node.
    """
    t1, d, _ = score_seq.shape
    t = t1 + 1
    cap = t * d
    dev = score_seq.device
    seq = score_seq.clone()
    init = init_scores.clone()
    neg_inf = torch.tensor(NEG_INF, dtype=seq.dtype, device=dev)

    spans = torch.zeros((cap, 2), dtype=torch.int32, device=dev)
    scores = torch.zeros((cap,), dtype=seq.dtype, device=dev)
    nodes = torch.full((cap, t), -1, dtype=torch.int32, device=dev)
    n = 0
    ts_idx = torch.arange(t, device=dev)
    for final_ts in range(t1, 0, -1):
        while bool(torch.isfinite(seq[final_ts - 1]).any()):
            parents, step_scores = viterbi_scan(seq[:final_ts], init)
            end_scores = step_scores[final_ts - 1]
            # end-node tie-break: among maximal scores prefer a node whose
            # incoming column still has a finite entry, so every extraction
            # consumes >= 1 finite entry (see viterbi.viterbi_multi_link)
            incoming_finite = torch.isfinite(seq[final_ts - 1]).any(dim=0)
            tied = end_scores == end_scores.max()
            pref = torch.where(tied & incoming_finite, end_scores, neg_inf)
            end = torch.where(torch.isfinite(pref).any(), torch.argmax(pref), torch.argmax(end_scores))
            path = torch.full((t,), -1, dtype=torch.int32, device=dev)
            path[: final_ts + 1] = viterbi_backtrack(parents, end, final_ts)
            start_ts = torch.argmax((path >= 0).to(torch.int32)).to(torch.int32)

            member = torch.zeros((t, d), dtype=torch.bool, device=dev)
            member[ts_idx, torch.where(path >= 0, path, 0).long()] = path >= 0
            # incoming of path nodes at ts>0: column node of matrix ts-1
            seq = torch.where(member[1:][:, None, :], neg_inf, seq)
            # outgoing of path nodes at ts<final_ts: row node of matrix ts
            out_mask = member[:-1] & (torch.arange(t1, device=dev)[:, None] != final_ts)
            seq = torch.where(out_mask[:, :, None], neg_inf, seq)
            init = torch.where(member[0], neg_inf, init)

            spans[n, 0] = start_ts
            spans[n, 1] = final_ts
            scores[n : n + 1] = end_scores.index_select(0, end.reshape(1))
            nodes[n] = path
            n += 1

    # length-1 tubelets at t=0 from surviving init scores, in node order
    alive = torch.nonzero(torch.isfinite(init)).flatten()
    k = alive.numel()
    scores[n : n + k] = init[alive]
    nodes[n : n + k, 0] = alive.to(torch.int32)
    n += k
    return DevicePaths(spans=spans, scores=scores, nodes=nodes, n_paths=torch.tensor(n, dtype=torch.int32, device=dev))


def _viterbi_lib() -> ctypes.CDLL:
    lib = _build.load("viterbi")
    lib.d2t_viterbi_multi_link.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.d2t_viterbi_multi_link.restype = ctypes.c_int
    for fn in (lib.d2t_viterbi_tables_in_smem, lib.d2t_viterbi_fits):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def _tables_in_smem(lib: ctypes.CDLL, t1: int, d: int) -> bool:
    """whether the kernel keeps a clip's step scores and parents in shared
    memory (else the wrapper passes a global scratch)."""
    return bool(lib.d2t_viterbi_tables_in_smem(t1, d))


def viterbi_multi_link_cuda(score_seq: torch.Tensor, init_scores: torch.Tensor) -> DevicePaths:
    """launch the linker kernel (ops/csrc/viterbi.cu) on (T-1, D, D) and
    (D,) float32 CUDA tensors: the whole extraction in one block of
    min(D, 1024) threads (ceil(D / 1024) slots each), on a scratch copy of
    score_seq. D is bounded only by the per-slot shared memory (about
    28,000 slots). Returns DevicePaths on the card without waiting for it.
    Counts each launch in `viterbi_multi_link_cuda.launches`."""
    if not (score_seq.is_cuda and init_scores.is_cuda) or score_seq.device != init_scores.device:
        raise ValueError(
            f"the linker kernel needs CUDA tensors on one device, got {score_seq.device} and {init_scores.device}"
        )
    if score_seq.dtype != torch.float32 or init_scores.dtype != torch.float32:
        raise ValueError(f"the linker kernel takes float32 scores, got {score_seq.dtype} and {init_scores.dtype}")
    if score_seq.dim() != 3 or score_seq.shape[1] != score_seq.shape[2] or init_scores.shape != score_seq.shape[1:2]:
        raise ValueError(
            f"expected (T-1, D, D) and (D,) scores, got {tuple(score_seq.shape)} and {tuple(init_scores.shape)}"
        )
    t1, d = score_seq.shape[0], score_seq.shape[1]
    lib = _viterbi_lib()
    if d < 1 or not lib.d2t_viterbi_fits(t1, d):
        raise ValueError(f"the linker kernel's shared memory does not hold D = {d} slots at T - 1 = {t1}")
    dev = score_seq.device
    t = t1 + 1
    cap = t * d
    seq = score_seq.contiguous().clone()  # the kernel masks it in place
    init = init_scores.contiguous()
    tables = (None, None)
    if not _tables_in_smem(lib, t1, d):
        tables = (
            torch.empty((t1, d), dtype=torch.float32, device=dev),
            torch.empty((t1, d), dtype=torch.int32, device=dev),
        )
    spans = torch.empty((cap, 2), dtype=torch.int32, device=dev)
    scores = torch.empty((cap,), dtype=torch.float32, device=dev)
    nodes = torch.empty((cap, t), dtype=torch.int32, device=dev)
    n_paths = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.d2t_viterbi_multi_link(
            seq.data_ptr(), init.data_ptr(),
            *(x.data_ptr() if x is not None else None for x in tables),
            spans.data_ptr(), scores.data_ptr(), nodes.data_ptr(), n_paths.data_ptr(),
            t1, d, stream,
        )
    if err != 0:
        raise RuntimeError(f"linker kernel launch failed: CUDA error {err}")
    viterbi_multi_link_cuda.launches += 1
    return DevicePaths(spans=spans, scores=scores, nodes=nodes, n_paths=n_paths)


viterbi_multi_link_cuda.launches = 0


def viterbi_multi_link_scan(score_seq: torch.Tensor, init_scores: torch.Tensor) -> DevicePaths:
    """multi-path extraction on the scores' device (host oracle:
    viterbi.viterbi_multi_link): the linker kernel for CUDA tensors, the
    plain version for CPU tensors. Extraction order (and therefore trimmed
    output) matches the host exactly."""
    if score_seq.is_cuda:
        return viterbi_multi_link_cuda(score_seq, init_scores)
    return viterbi_multi_link_ref(score_seq, init_scores)
