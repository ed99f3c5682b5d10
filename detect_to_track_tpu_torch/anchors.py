"""anchor grid construction (numpy; a copy of the JAX package's
`anchors.py`).

h = sqrt(area * ratio), w = area / h on a cell-centered fractional grid; the
flattened grid is (H * W * |areas x ratios|, 4) ijhw with the per-cell
anchor index fastest, the order of the RPN head's anchor-major flatten.
Computed in float64, then cast.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np


def build_anchors(
    fm_shape: Union[int, Tuple[int, int]],
    anchor_areas: Sequence[float],
    aspect_ratios: Sequence[float],
    flatten: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """(H*W*|AxR|, 4) if flatten else (H, W, |AxR|, 4) read-only ijhw
    anchors for a prediction map of fm_shape."""
    if isinstance(fm_shape, int):
        fm_shape = (fm_shape, fm_shape)
    fm_h, fm_w = (int(d) for d in fm_shape)

    areas = np.asarray(list(anchor_areas), dtype=np.float64)
    ratios = np.asarray(list(aspect_ratios), dtype=np.float64)

    h = np.sqrt(areas[:, None] * ratios[None, :])
    w = areas[:, None] / h
    anchor_dims = np.stack([h, w], axis=-1).reshape(-1, 2)  # (|AxR|, 2)

    iv = (np.arange(fm_h, dtype=np.float64) + 0.5) / fm_h
    jv = (np.arange(fm_w, dtype=np.float64) + 0.5) / fm_w
    ij_grid = np.stack(np.meshgrid(iv, jv, indexing="ij"), axis=-1)  # (H, W, 2)

    n = anchor_dims.shape[0]
    target = (fm_h, fm_w, n, 2)
    ij = np.broadcast_to(ij_grid[:, :, None, :], target)
    hw = np.broadcast_to(anchor_dims[None, None, :, :], target)
    anchors = np.concatenate([ij, hw], axis=3).astype(dtype)

    if flatten:
        anchors = anchors.reshape(-1, 4)
    anchors.flags.writeable = False
    return anchors


def anchor_boundary_mask(anchors: np.ndarray) -> np.ndarray:
    """(|A|,) bool: True where an anchor crosses the image boundary
    (touching it counts)."""
    ij0 = anchors[:, :2] - anchors[:, 2:] / 2
    ij1 = anchors[:, :2] + anchors[:, 2:] / 2
    ijij = np.concatenate([ij0, ij1], axis=1)
    return np.logical_or(np.any(ijij <= 0, axis=1), np.any(ijij >= 1, axis=1))
