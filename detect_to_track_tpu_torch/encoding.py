"""Faster-RCNN box offsets (port of the JAX package's
`frcnn_box_encode` / `frcnn_box_decode`). The label encoders come with the
training step."""

from __future__ import annotations

import math
from typing import Optional

import torch


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
