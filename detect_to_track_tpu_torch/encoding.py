"""label encoders and Faster-RCNN box offsets (port of the JAX package's
`encoding.py`).

The encoders run on the device inside the training step, batched over a
leading frame axis, on fixed-shape padded labels (data/types.py): boxes
(N, L, 4) fractional ijhw, classes (N, L) 1-based, track_ids (N, L), mask
(N, L) with the real labels first. Real labels first keeps the first-maximum
tie-break of `torch.argmax`, numpy and JAX, so targets match the reference.
Assigned boxes and classes are gathered by index, which is exact.

Parity notes (each as in the reference):
- with no labels, anchor loss weights are !crosses_boundary, c* = 0 and
  b* = 0;
- an anchor's loss is ignored when |IoU - thresh| <= margin (the boundary
  value included) or when it crosses the image boundary;
- a positive anchor has IoU > thresh with some label or is some label's
  best anchor;
- QUIRK (replicated unless cfg.FIX_REGION_MASK_POLARITY): the region
  encoder marks positives with best_iou < thresh.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .boxes import compute_ious
from .ops.nms import _take_rows


def frcnn_box_encode(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """t_ij = (b_ij - a_ij) / a_hw ; t_hw = log(b_hw / a_hw), with both hw
    floored at 1e-8 so padding or degenerate boxes stay finite.

    anchors, boxes: (..., 4) ijhw. Returns (..., 4) offsets.
    """
    a_ij, a_hw = anchors[..., :2], anchors[..., 2:].clamp(min=1e-8)
    b_ij, b_hw = boxes[..., :2], boxes[..., 2:].clamp(min=1e-8)
    return torch.cat([(b_ij - a_ij) / a_hw, torch.log(b_hw / a_hw)], dim=-1)


# max log-scale offset fed to exp() during decode: log(1000/16), the usual
# Faster-RCNN clip, so an untrained head never yields inf boxes.
BBOX_XFORM_CLIP = float(math.log(1000.0 / 16.0))


def frcnn_box_decode(
    anchors: torch.Tensor, offsets: torch.Tensor, clip: Optional[float] = BBOX_XFORM_CLIP
) -> torch.Tensor:
    """inverse of frcnn_box_encode; t_hw is clamped to +/-clip before exp
    (clip=None gives the raw inverse)."""
    a_ij, a_hw = anchors[..., :2], anchors[..., 2:]
    t_ij, t_hw = offsets[..., :2], offsets[..., 2:]
    if clip is not None:
        t_hw = t_hw.clamp(-clip, clip)
    return torch.cat([t_ij * a_hw + a_ij, torch.exp(t_hw) * a_hw], dim=-1)


def _frcnn_box_encode_np(anchors: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """numpy frcnn_box_encode, for host tooling."""
    a_hw = np.maximum(anchors[..., 2:], 1e-8)
    b_hw = np.maximum(boxes[..., 2:], 1e-8)
    return np.concatenate([(boxes[..., :2] - anchors[..., :2]) / a_hw, np.log(b_hw / a_hw)], axis=-1)


class AnchorTargets(NamedTuple):
    loss_weights: torch.Tensor  # (N, |A|) float32
    c_star: torch.Tensor  # (N, |A|) int32
    b_star: torch.Tensor  # (N, |A|, 4) float32


def anchor_encode(
    anchors: torch.Tensor,
    crosses_boundary: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_mask: torch.Tensor,
    iou_thresh: float = 0.5,
    iou_margin: float = 0.2,
) -> AnchorTargets:
    """anchorwise target assignment for N frames.

    anchors (|A|, 4); crosses_boundary (|A|,) bool; gt_boxes (N, L, 4);
    gt_classes, gt_mask (N, L).
    """
    gt_mask = gt_mask.bool()
    any_valid = gt_mask.any(dim=-1)  # (N,)
    ious = compute_ious(anchors, gt_boxes)  # (N, |A|, L)
    # invalid labels sit below any real IoU, so argmax prefers real ones
    ious = torch.where(gt_mask[:, None, :], ious, torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=2)  # (N, |A|), first maximum
    best_iou = ious.amax(dim=2)

    margin_ok = (best_iou - iou_thresh).abs() > iou_margin
    loss_weights = torch.where(any_valid[:, None], margin_ok, torch.ones_like(margin_ok)) & ~crosses_boundary

    # each valid label's best anchor is positive
    col_best = torch.argmax(ious, dim=1)  # (N, L)
    a_idx = torch.arange(anchors.shape[0], device=anchors.device)
    is_best_anchor = ((a_idx[None, :, None] == col_best[:, None, :]) & gt_mask[:, None, :]).any(dim=2)
    pos = (best_iou > iou_thresh) | is_best_anchor

    best_classes = _take_rows(gt_classes, best_gt)
    c_star = torch.where(pos, best_classes, torch.zeros_like(best_classes)).to(torch.int32)
    # with no labels, encoding an anchor against itself gives exact zeros
    assigned = torch.where(any_valid[:, None, None], _take_rows(gt_boxes, best_gt), anchors)
    b_star = frcnn_box_encode(anchors, assigned)
    return AnchorTargets(loss_weights.to(torch.float32), c_star, b_star)


class RegionTargets(NamedTuple):
    c_star: torch.Tensor  # (N, |R|) int32
    b_star: torch.Tensor  # (N, |R|, 4) float32


def region_encode(
    regions: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_classes: torch.Tensor,
    gt_mask: torch.Tensor,
    iou_thresh: float = 0.5,
    fix_mask_polarity: bool = False,
) -> RegionTargets:
    """regionwise target assignment for N frames: regions (N, |R|, 4)
    proposals (padding rows allowed; their targets are garbage and masked
    in the loss). fix_mask_polarity=False replicates the reference's
    `best_iou < thresh`; True uses `>` as its docstring intended."""
    gt_mask = gt_mask.bool()
    any_valid = gt_mask.any(dim=-1)[:, None]  # (N, 1)
    ious = compute_ious(regions, gt_boxes)  # (N, |R|, L)
    ious = torch.where(gt_mask[:, None, :], ious, torch.full_like(ious, -1.0))
    best_gt = torch.argmax(ious, dim=2)
    best_iou = ious.amax(dim=2)
    pos = best_iou > iou_thresh if fix_mask_polarity else best_iou < iou_thresh

    classes = _take_rows(gt_classes, best_gt)
    c_star = torch.where(pos & any_valid, classes, torch.zeros_like(classes)).to(torch.int32)
    assigned = torch.where(any_valid[..., None], _take_rows(gt_boxes, best_gt), regions)
    b_star = frcnn_box_encode(regions, assigned)
    b_star = torch.where(any_valid[..., None], b_star, torch.zeros_like(b_star))
    return RegionTargets(c_star, b_star)


class TrackTargets(NamedTuple):
    rois: torch.Tensor  # (B, L, 4) frame-0 label boxes
    t_star: torch.Tensor  # (B, L, 4) box transforms frame 0 -> frame 1
    valid: torch.Tensor  # (B, L) bool: the object is in both frames


def track_encode(boxes_0, classes_0, track_ids_0, mask_0, boxes_1, classes_1, track_ids_1, mask_1) -> TrackTargets:
    """track regression targets for B frame pairs, one slot per frame-0
    label. An object is its (class_id, track_id) pair; a target exists only
    for objects in both frames. Duplicate pairs within a frame follow the
    reference's dict construction: the LAST occurrence wins on both sides."""
    m0, m1 = mask_0.bool(), mask_1.bool()
    match = (
        m0[:, :, None] & m1[:, None, :]
        & (classes_0[:, :, None] == classes_1[:, None, :])
        & (track_ids_0[:, :, None] == track_ids_1[:, None, :])
    )  # (B, L, L)
    l = boxes_0.shape[1]
    idx = torch.arange(l, device=boxes_0.device)
    same_0 = (
        m0[:, :, None] & m0[:, None, :]
        & (classes_0[:, :, None] == classes_0[:, None, :])
        & (track_ids_0[:, :, None] == track_ids_0[:, None, :])
    )
    later_dup = (same_0 & (idx[None, None, :] > idx[None, :, None])).any(dim=2)
    valid = match.any(dim=2) & ~later_dup
    j = (l - 1) - torch.argmax(match.flip(-1).to(torch.uint8), dim=2)  # last match in frame 1

    # invalid slots encode a unit box against itself: exact zeros
    unit = torch.tensor([0.5, 0.5, 1.0, 1.0], dtype=boxes_0.dtype, device=boxes_0.device)
    safe_0 = torch.where(valid[..., None], boxes_0, unit)
    safe_1 = torch.where(valid[..., None], _take_rows(boxes_1, j), unit)
    return TrackTargets(boxes_0, frcnn_box_encode(safe_0, safe_1), valid)


def track_encode_np(labels_0, labels_1):
    """host version with the reference's exact dict semantics: sequences of
    data.types.ObjectLabel -> (rois (|R|, 4), t_star (|R|, 4)) numpy."""
    d0 = {(lb.class_id, lb.track_id): lb for lb in labels_0}
    d1 = {(lb.class_id, lb.track_id): lb for lb in labels_1}
    both = set(d0).intersection(d1)
    boxes_0 = np.array([d0[k].box for k in both]).reshape(-1, 4)
    boxes_1 = np.array([d1[k].box for k in both]).reshape(-1, 4)
    return boxes_0, _frcnn_box_encode_np(boxes_0, boxes_1)
