"""plain float32 forms of the detector's geometry and pooling ops, frozen for
the benchmark: anchors, box offsets, IoU, greedy NMS, PSROIPool, ROIPool
and the pointwise correlation.

Copied from the port's plain versions (`anchors.py`, `boxes.py`,
`encoding.py`, `ops/torch_ref.py`) as they stood when the benchmark was
written, so that a later change to the program cannot move the yardstick.
The reference detector's quirks are kept: PSROIPool's (t+1)*(i*k+j)
channel selector, ROIPool's corner clamp, an empty bin pooling to 0, and
the correlation's zero +d_max row and column. Imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# log(1000/16): the Faster-RCNN clip on a decoded log-scale offset
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def build_anchors(fm_shape, areas, ratios) -> np.ndarray:
    """(H*W*|areas x ratios|, 4) ijhw anchors on a cell-centred grid, the
    per-cell anchor fastest; computed in float64, returned float32."""
    fm_h, fm_w = fm_shape
    a = np.asarray(areas, np.float64)
    r = np.asarray(ratios, np.float64)
    h = np.sqrt(a[:, None] * r[None, :])
    w = a[:, None] / h
    dims = np.stack([h, w], -1).reshape(-1, 2)
    iv = (np.arange(fm_h, dtype=np.float64) + 0.5) / fm_h
    jv = (np.arange(fm_w, dtype=np.float64) + 0.5) / fm_w
    grid = np.stack(np.meshgrid(iv, jv, indexing="ij"), -1)
    n = dims.shape[0]
    ij = np.broadcast_to(grid[:, :, None, :], (fm_h, fm_w, n, 2))
    hw = np.broadcast_to(dims[None, None], (fm_h, fm_w, n, 2))
    return np.concatenate([ij, hw], 3).astype(np.float32).reshape(-1, 4)


def box_decode(anchors: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """ij = t_ij * a_hw + a_ij; hw = exp(clamp(t_hw)) * a_hw."""
    a_ij, a_hw = anchors[..., :2], anchors[..., 2:]
    t_hw = offsets[..., 2:].clamp(-BBOX_XFORM_CLIP, BBOX_XFORM_CLIP)
    return torch.cat([offsets[..., :2] * a_hw + a_ij, torch.exp(t_hw) * a_hw], -1)


def to_corners(boxes: torch.Tensor) -> torch.Tensor:
    half = boxes[..., 2:] / 2
    return torch.cat([boxes[..., :2] - half, boxes[..., :2] + half], -1)


def ious(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pairwise IoU of (..., A, 4) and (..., B, 4) ijhw boxes; 0 where the
    union is empty."""
    ca = to_corners(a)[..., :, None, :]
    cb = to_corners(b)[..., None, :, :]
    inter_hw = (torch.minimum(ca[..., 2:], cb[..., 2:]) - torch.maximum(ca[..., :2], cb[..., :2])).clamp(min=0)
    inter = inter_hw[..., 0] * inter_hw[..., 1]
    union = (a[..., 2] * a[..., 3])[..., :, None] + (b[..., 2] * b[..., 3])[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(inter))


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """keep-mask of greedy NMS over score-descending (k, 4) boxes: slot i is
    kept iff valid and no kept slot j < i overlaps it by IoU > iou_thresh.
    The plain loop, on the host."""
    over = (ious(boxes, boxes) > iou_thresh).cpu().numpy()
    standing = valid.cpu().numpy().copy()
    keep = np.zeros_like(standing)
    for i in range(standing.shape[0]):
        if standing[i]:
            keep[i] = True
            standing[i + 1:] &= ~over[i, i + 1:]
    return torch.from_numpy(keep).to(boxes.device)


def bin_bounds(rois: torch.Tensor, k: int, fm_h: int, fm_w: int, clamp_corner: bool):
    """fractional ijhw rois (R, 4) -> int bin bounds i0, i1, j0, j1 (R, k):
    floor / ceil of the clamped bin edges, nudged by 1e-5."""
    r_i, r_j, r_h, r_w = rois.unbind(-1)
    b_h, b_w = (r_h / k)[:, None], (r_w / k)[:, None]
    top, left = r_i - r_h / 2, r_j - r_w / 2
    if clamp_corner:
        top, left = top.clamp(0.0, 1.0), left.clamp(0.0, 1.0)
    steps = torch.arange(k, dtype=rois.dtype, device=rois.device) + 0.5
    c_i = top[:, None] + steps[None] * b_h
    c_j = left[:, None] + steps[None] * b_w
    eps = 1e-5
    i0 = torch.floor((c_i - b_h / 2).clamp(0.0, 1.0) * fm_h + eps).long()
    i1 = torch.ceil((c_i + b_h / 2).clamp(0.0, 1.0) * fm_h - eps).long()
    j0 = torch.floor((c_j - b_w / 2).clamp(0.0, 1.0) * fm_w + eps).long()
    j1 = torch.ceil((c_j + b_w / 2).clamp(0.0, 1.0) * fm_w - eps).long()
    return i0, i1, j0, j1


def _masks(lo: torch.Tensor, hi: torch.Tensor, size: int) -> torch.Tensor:
    p = torch.arange(size, device=lo.device)
    return ((p >= lo[..., None]) & (p < hi[..., None])).float()


def _average(sums, i0, i1, j0, j1):
    n = ((i1 - i0)[:, :, None] * (j1 - j0)[:, None, :]).float()  # (R, k, k)
    while n.dim() < sums.dim():
        n = n[..., None]
    return torch.where(n > 0, sums / n.clamp(min=1.0), torch.zeros_like(sums))


def psroi_channels(n_targets: int, k: int, device=None) -> torch.Tensor:
    """(T, k, k): the reference's channel of target t, bin (i, j):
    (t + 1) * (i * k + j)."""
    t = torch.arange(n_targets, device=device)[:, None, None]
    i = torch.arange(k, device=device)[None, :, None]
    j = torch.arange(k, device=device)[None, None, :]
    return (t + 1) * (i * k + j)


def ps_roi_pool(fm: torch.Tensor, rois: torch.Tensor, n_targets: int, k: int) -> torch.Tensor:
    """position-sensitive average pooling: fm (H, W, T k^2) in the
    reference's channel layout, rois (R, 4) -> (R, T, k, k)."""
    fm_h, fm_w, _ = fm.shape
    i0, i1, j0, j1 = bin_bounds(rois, k, fm_h, fm_w, clamp_corner=False)
    fg = fm[:, :, psroi_channels(n_targets, k, fm.device)]  # (H, W, T, k, k)
    part = torch.einsum("rjw,hwtij->rhtij", _masks(j0, j1, fm_w), fg)
    sums = torch.einsum("rih,rhtij->rtij", _masks(i0, i1, fm_h), part)
    return _average(sums.permute(0, 2, 3, 1), i0, i1, j0, j1).permute(0, 3, 1, 2)


def roi_pool(fm: torch.Tensor, rois: torch.Tensor, k: int) -> torch.Tensor:
    """average ROI pooling with the corner clamp: fm (H, W, C), rois (R, 4)
    -> (R, k, k, C)."""
    fm_h, fm_w, _ = fm.shape
    i0, i1, j0, j1 = bin_bounds(rois, k, fm_h, fm_w, clamp_corner=True)
    part = torch.einsum("rjw,hwc->rjhc", _masks(j0, j1, fm_w), fm)
    sums = torch.einsum("rih,rjhc->rijc", _masks(i0, i1, fm_h), part)
    return _average(sums, i0, i1, j0, j1)


def _window_mask(size: int, offset: int, d_max: int, device) -> torch.Tensor:
    """positions i whose displaced i + offset lies in [max(0, i - d),
    min(i + d, size)) (stride 1): the +d_max displacement stays 0."""
    i = torch.arange(size, device=device)
    di = i + offset
    return ((di >= 0) & (di < size) & (di < i + d_max) & (di >= (i - d_max).clamp(min=0))).float()


def correlation(fm0: torch.Tensor, fm1: torch.Tensor, d_max: int) -> torch.Tensor:
    """pointwise correlation, stride 1: (B, H, W, C) maps -> (B, H, W,
    (2d+1)^2) raw dot products over the truncated window, displacement
    (ci, cj) at index ci * (2d+1) + cj."""
    b, h, w, _ = fm0.shape
    n = 2 * d_max + 1
    f1 = torch.nn.functional.pad(fm1, (0, 0, d_max, d_max, d_max, d_max))
    planes = []
    for ci in range(n):
        rmask = _window_mask(h, ci - d_max, d_max, fm0.device)
        for cj in range(n):
            cmask = _window_mask(w, cj - d_max, d_max, fm0.device)
            shifted = f1[:, ci:ci + h, cj:cj + w, :]
            planes.append((fm0 * shifted).sum(-1) * rmask[None, :, None] * cmask[None, None, :])
    return torch.stack(planes, -1)
