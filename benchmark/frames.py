"""synthetic video frames from the seed: coloured rectangles drifting across
a noisy background, uint8 as a decoded video frame is.

Adapted from the port's `data/synthetic.py` (`SyntheticVIDManager`,
itself a copy of the JAX package's): the same scene per item (n objects,
centres in [0.2, 0.8], sizes in [0.1, 0.3], drift up to 0.05 a frame,
colours in [0.2, 1.0], background noise up to 0.1), drawn with numpy's
Generator straight into uint8.
"""

from __future__ import annotations

import numpy as np


def scene(rng: np.random.Generator, n_objects: int):
    centers = rng.random((n_objects, 2)) * 0.6 + 0.2
    sizes = rng.random((n_objects, 2)) * 0.2 + 0.1
    vel = (rng.random((n_objects, 2)) - 0.5) * 0.1
    colors = np.rint((rng.random((n_objects, 3)) * 0.8 + 0.2) * 255).astype(np.uint8)
    return centers, sizes, vel, colors


def render(rng, hw, objects, t: int, out: np.ndarray) -> None:
    """frame t of a scene into out (H, W, 3) uint8."""
    h, w = hw
    out[...] = rng.integers(0, 26, (h, w, 3), dtype=np.uint8)
    centers, sizes, vel, colors = objects
    for o in range(centers.shape[0]):
        ci, cj = centers[o] + t * vel[o]
        oh, ow = sizes[o]
        i0 = int(np.clip((ci - oh / 2) * h, 0, h - 1))
        i1 = int(np.clip((ci + oh / 2) * h, 1, h))
        j0 = int(np.clip((cj - ow / 2) * w, 0, w - 1))
        j1 = int(np.clip((cj + ow / 2) * w, 1, w))
        out[i0:i1, j0:j1] = colors[o]


def pairs(seed: int, n: int, hw, n_objects: int = 3) -> np.ndarray:
    """n frame pairs (t, t + 1) of n scenes: (n, 2, H, W, 3) uint8."""
    out = np.empty((n, 2, *hw, 3), np.uint8)
    for i in range(n):
        rng = np.random.default_rng([int(seed), i])
        objects = scene(rng, n_objects)
        for t in range(2):
            render(rng, hw, objects, t, out[i, t])
    return out


def labelled_pairs(seed: int, n: int, hw, n_objects: int, n_classes: int, capacity: int):
    """n labelled pairs: images (n, 2, H, W, 3) uint8 and padded labels,
    boxes (n, 2, L, 4) float32 ijhw (each object's centre drifted, its size
    kept), classes (n, 2, L) int32 in [1, n_classes], track ids (n, 2, L)
    int32 (the object's index), mask (n, 2, L) bool; L = capacity."""
    images = np.empty((n, 2, *hw, 3), np.uint8)
    boxes = np.zeros((n, 2, capacity, 4), np.float32)
    classes = np.zeros((n, 2, capacity), np.int32)
    track_ids = np.full((n, 2, capacity), -1, np.int32)
    mask = np.zeros((n, 2, capacity), bool)
    k = min(n_objects, capacity)
    for i in range(n):
        rng = np.random.default_rng([int(seed), i])
        objects = scene(rng, n_objects)
        cls = rng.integers(1, n_classes + 1, n_objects)
        centers, sizes, vel, _ = objects
        for t in range(2):
            render(rng, hw, objects, t, images[i, t])
            boxes[i, t, :k, :2] = (centers + t * vel)[:k]
            boxes[i, t, :k, 2:] = sizes[:k]
            classes[i, t, :k] = cls[:k]
            track_ids[i, t, :k] = np.arange(k)
            mask[i, t, :k] = True
    return images, (boxes, classes, track_ids, mask)
