"""judge a pair call's outputs against the plain reference.

The program rounds to bfloat16 and the reference does not, so top-k and
NMS, which choose among near-equal scores, may pick other proposals on the
two sides. The comparison therefore follows the program's choices and
judges each by the reference, as a served model's tokens are judged by the
reference's logits:

- each valid detection is traced back to the anchor whose reference
  proposal lies nearest (the box heads move a box by well under an
  anchor spacing), and the reference computes the R-FCN at that proposal;
- `box_gap`: the widest gap between a detection's box and the reference's
  box for that anchor, in offset units (centre shift over the proposal's
  size, log size ratio);
- `logit_gap`: the widest gap between the logarithms of a detection's
  class confidences and the reference's, over the range of the
  reference's (largest less smallest) for that detection: the class
  logits' error relative to their spread, which rounding sets whatever
  the seed's logits' size. Compared over the detections whose PSROIPool
  bins do not move when each corner of the proposal moves by `slack`
  times its size. The cell sets `slack` to its `box_gap` limit, which
  bounds how far a correct run's proposal may lie from the reference's;
  a bin edge that crosses a pixel boundary within it changes the pooled
  average by more than rounding does, so such a detection's confidences
  are not compared;
- `count_gap`: the widest gap, over frames, between the number of valid
  detections the program reports and the number the reference's own
  pipeline keeps (proposal filter, R-FCN, the foreground gate, the cap),
  over the cap MAX_DETS. Near the gate, rounding moves a few detections
  across it; a gate or a cap left out, or detections dropped, move many;
- `nms_overlap`: how far the largest IoU between the proposals of two
  valid detections of one frame lies above the NMS threshold (0 where
  none does). The proposal filter's NMS keeps no two rois overlapping by
  more; two detections on one anchor read 1 minus the threshold;
- `track_gap`: the widest over pairs of the gap between a pair's tracks
  (its valid frame-0 slots) and the reference tracker's on the program's
  frame-0 boxes, as the norm of the difference over the norm of the
  reference's. The tracker takes the program's boxes as its rois: it
  follows the program's state there.

Each number is a widest gap over every judged pair; 0 is agreement.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import model as ref
from . import ops

NAMES = ("box_gap", "logit_gap", "count_gap", "nms_overlap", "track_gap")


def offset_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4) ijhw boxes -> the larger of |centre shift| / b's size and
    |log size ratio|, per box pair (broadcast)."""
    shift = ((a[..., :2] - b[..., :2]).abs() / b[..., 2:]).amax(-1)
    scale = (torch.log(a[..., 2:].clamp(min=1e-12) / b[..., 2:])).abs().amax(-1)
    return torch.maximum(shift, scale)


def logit_gap(confs: torch.Tensor, ref_confs: torch.Tensor) -> torch.Tensor:
    """(R, T) confidences -> per roi, the widest gap of their logarithms
    over the range of the reference's."""
    got, want = confs.clamp(min=1e-30).log(), ref_confs.clamp(min=1e-30).log()
    return (got - want).abs().amax(-1) / (want.amax(-1) - want.amin(-1)).clamp(min=1e-30)


def stable_bins(rois: torch.Tensor, eps: float, k: int, fm_hw) -> torch.Tensor:
    """(R,) bool: no bin edge of a roi (R, 4) crosses a pixel boundary of the
    (H, W) map when each of its corners moves by up to eps times the roi's
    size (the edges are the corners' convex combinations), nor the clamp
    at the map's border."""
    stable = torch.ones(rois.shape[0], dtype=torch.bool, device=rois.device)
    m = torch.arange(k + 1, device=rois.device, dtype=rois.dtype) / k
    for centre, size, n in ((rois[:, 0], rois[:, 2], fm_hw[0]), (rois[:, 1], rois[:, 3], fm_hw[1])):
        edges = (centre - size / 2)[:, None] + m[None] * size[:, None]  # (R, k + 1) fractions
        slack = (eps * size[:, None] + 1e-5) * n + 1e-5  # pixels, with the rounding's nudge
        pix = edges * n
        near = (pix - torch.round(pix)).abs() <= slack
        inside = (pix >= -slack) & (pix <= n + slack)
        stable &= ~(near & inside).any(-1)
    return stable


def judge_pair(W, pair: torch.Tensor, anchors: torch.Tensor, s: ref.Sizes, out: ref.PairOutputs,
               slack: float) -> Dict[str, float]:
    """the numbers for one (2, H, W, 3) uint8 pair and the program's outputs
    for it (device tensors)."""
    q = ref.EXACT
    parts = [ref.frame_parts(W, pair[f], anchors, s, q) for f in range(2)]
    got = dict.fromkeys(NAMES, 0.0)
    for f, p in enumerate(parts):
        v = out.valid[f]
        boxes, confs = out.boxes[f][v], out.confs[f][v]
        own, kept = ref.proposals(p.scores, p.props, s.eval_filter)
        anchor = offset_gap(boxes[:, None], p.props[None]).argmin(-1)
        rois = p.props[anchor]
        # one R-FCN pass over the reference's own rois and the detections' ones
        c_all, b2_all = ref.rfcn(W, p.pyr["c5"], torch.cat([own, rois]), s, q)
        n_ref = min(int(((c_all[:own.shape[0], 1:].sum(-1) > s.rcnn_conf) & kept).sum()), s.max_dets)
        got["count_gap"] = max(got["count_gap"], abs(boxes.shape[0] - n_ref) / s.max_dets)
        if boxes.shape[0] == 0:
            continue
        c_ref, b2_ref = c_all[own.shape[0]:], b2_all[own.shape[0]:]
        got["box_gap"] = max(got["box_gap"], float(offset_gap(boxes, ops.box_decode(rois, b2_ref)).max()))
        stable = stable_bins(rois, slack, s.k, s.fm_hw)
        if bool(stable.any()):
            got["logit_gap"] = max(got["logit_gap"], float(logit_gap(confs[stable], c_ref[stable]).max()))
        over = ops.ious(rois, rois).fill_diagonal_(0.0)
        got["nms_overlap"] = max(got["nms_overlap"], float(over.max()) - s.eval_filter.iou)
    v0 = out.valid[0]
    if bool(v0.any()):
        t_ref = ref.tracker(W, parts[0].pyr, parts[1].pyr, parts[0].reg, parts[1].reg, out.boxes[0], s, q)[v0]
        got["track_gap"] = float((out.tracks[v0] - t_ref).norm() / t_ref.norm().clamp(min=1e-30))
    return got


def judge(W, pairs, anchors, s: ref.Sizes, outs, slack: float) -> Dict[str, float]:
    """widest gaps over pairs (list of (2, H, W, 3) uint8 device tensors)
    and their outputs (list of PairOutputs)."""
    total = dict.fromkeys(NAMES, 0.0)
    with torch.no_grad(), ref.no_tf32():
        for pair, out in zip(pairs, outs):
            for k, v in judge_pair(W, pair, anchors, s, out, slack).items():
                total[k] = max(total[k], v)
    return total
