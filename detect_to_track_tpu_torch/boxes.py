"""bounding-box geometry on tensors, plus the numpy forms the host code uses.

Boxes are (i, j, h, w): fractional center coordinates plus height and width,
the reference's convention.
"""

from __future__ import annotations

import numpy as np
import torch


def ijhw_to_ijij(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center-size -> corner boxes (i0, j0, i1, j1)."""
    ij = boxes[..., :2]
    hw_half = boxes[..., 2:] / 2
    return torch.cat([ij - hw_half, ij + hw_half], dim=-1)


def ijij_to_ijhw(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner -> center-size boxes."""
    ij0 = boxes[..., :2]
    ij1 = boxes[..., 2:]
    return torch.cat([(ij0 + ij1) / 2, ij1 - ij0], dim=-1)


def box_areas(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) ijhw boxes -> (...,) areas."""
    return boxes[..., 2] * boxes[..., 3]


def compute_ious(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """pairwise IoU: (..., A, 4) and (..., B, 4) ijhw -> (..., A, B); zero
    where the union is empty. Leading batch dimensions broadcast."""
    a = ijhw_to_ijij(boxes_a)[..., :, None, :]
    b = ijhw_to_ijij(boxes_b)[..., None, :, :]
    lo = torch.maximum(a[..., :2], b[..., :2])
    hi = torch.minimum(a[..., 2:], b[..., 2:])
    inter_hw = (hi - lo).clamp(min=0.0)
    inter = inter_hw[..., 0] * inter_hw[..., 1]
    union = box_areas(boxes_a)[..., :, None] + box_areas(boxes_b)[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(inter))


def ijhw_to_ijij_np(boxes: np.ndarray) -> np.ndarray:
    ij = boxes[..., :2]
    hw_half = boxes[..., 2:] / 2
    return np.concatenate([ij - hw_half, ij + hw_half], axis=-1)


def compute_ious_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """host-side numpy IoU (ml_utils.boundingboxes.compute_ious parity)."""
    a = ijhw_to_ijij_np(boxes_a)[:, None, :]
    b = ijhw_to_ijij_np(boxes_b)[None, :, :]
    lo = np.maximum(a[..., :2], b[..., :2])
    hi = np.minimum(a[..., 2:], b[..., 2:])
    inter_hw = np.clip(hi - lo, 0.0, None)
    inter = inter_hw[..., 0] * inter_hw[..., 1]
    union = (
        (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
        + (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
        - inter
    )
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
