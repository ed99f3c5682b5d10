"""data types (numpy; a copy of the JAX package's `data/types.py`).

The human-readable types mirror the reference's ObjectLabel,
RawImageInstance, ImageInstance, DataSampler, DataManager and
DataManagerWrapper. The padded types hold fixed-shape arrays: every frame's
variable-length label list is packed into (MAX_LABELS,) arrays and a
validity mask, real labels first (the encoders' argmax tie-break relies on
that order).
"""

from __future__ import annotations

import abc
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np


class ObjectLabel(NamedTuple):
    """one ground-truth object (box is fractional ijhw)."""

    class_id: int
    class_name: str
    box: Tuple[float, float, float, float]
    track_id: Optional[int] = None


class RawImageInstance(NamedTuple):
    """unprocessed instance: paths only, loaded lazily."""

    impath: Path
    labelpath: Path


class ImageInstance(NamedTuple):
    """decoded image (a PIL.Image or an (H, W, 3) array) and its labels."""

    im: object
    labels: Tuple[ObjectLabel, ...]


class DataSampler(abc.ABC):
    """non-deterministic sampler; handles IO and conversion to the common
    format."""

    @abc.abstractmethod
    def sample(self):
        raise NotImplementedError


class DataManager(abc.ABC):
    """deterministic, indexable dataset view."""

    @abc.abstractmethod
    def __getitem__(self, i):
        raise NotImplementedError

    @abc.abstractmethod
    def __len__(self):
        raise NotImplementedError


class DataManagerWrapper(DataManager):
    """adapts a DataSampler to the DataManager interface with a nominal
    length (reference types.py:57-68): every index draws a fresh sample."""

    def __init__(self, sampler: DataSampler, nominal_len: int) -> None:
        self.sampler = sampler
        self.nominal_len = nominal_len

    def __getitem__(self, i: int):
        return self.sampler.sample()

    def __len__(self) -> int:
        return self.nominal_len

    def reseed(self, salt: int) -> None:
        """resume support: salt the wrapped sampler's stream (if it is
        seeded) so a rebuilt process does not replay instances already
        trained on."""
        if hasattr(self.sampler, "reseed"):
            self.sampler.reseed(salt)


class PaddedFrame(NamedTuple):
    """one frame's labels, padded to capacity L (leading axes allowed)."""

    boxes: np.ndarray  # (..., L, 4) float32 ijhw
    classes: np.ndarray  # (..., L) int32, 1-based; 0 = background/pad
    track_ids: np.ndarray  # (..., L) int32; -1 = none
    mask: np.ndarray  # (..., L) bool


class PaddedPairBatch(NamedTuple):
    """a batch of frame pairs ready for the train and eval steps."""

    images: np.ndarray  # (B, 2, H, W, 3) float32 in [0, 1] or uint8 in [0, 255]
    labels: PaddedFrame  # arrays shaped (B, 2, L, ...)


def pack_labels(labels: Sequence[ObjectLabel], capacity: int) -> PaddedFrame:
    """pack a variable-length label list into fixed-shape arrays, real
    labels first; labels beyond capacity are dropped."""
    n = min(len(labels), capacity)
    boxes = np.zeros((capacity, 4), np.float32)
    classes = np.zeros((capacity,), np.int32)
    track_ids = np.full((capacity,), -1, np.int32)
    mask = np.zeros((capacity,), bool)
    for i, lbl in enumerate(labels[:n]):
        boxes[i] = lbl.box
        classes[i] = lbl.class_id
        track_ids[i] = -1 if lbl.track_id is None else lbl.track_id
        mask[i] = True
    return PaddedFrame(boxes, classes, track_ids, mask)
