"""host-side prediction filtering.

Rebuilds the `ml_utils.prediction_filtering` surface the reference imports
but does not vendor (reference trainer.py:14-19, inference.py:10-15):
PredictionFilterPipeline, ConfidenceFilter, MaxDetFilter, NMSFilter.

Each filter maps (confs, boxes) -> (confs, boxes) on numpy arrays. The
inference path filters on the device (ops/nms.py); this module exists for
API compatibility and host-side tooling. A copy of the JAX package's
`filtering.py` over the port's own `ops/nms.py::nms_np`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .ops.nms import nms_np

Pred = Tuple[np.ndarray, np.ndarray]  # (confs (N,), boxes (N, 4))


class PredictionFilter:
    def __call__(self, confs: np.ndarray, boxes: np.ndarray) -> Pred:
        raise NotImplementedError


class ConfidenceFilter(PredictionFilter):
    """keep predictions with conf > thresh."""

    def __init__(self, conf_thresh: float) -> None:
        self.conf_thresh = conf_thresh

    def __call__(self, confs, boxes):
        keep = confs > self.conf_thresh
        return confs[keep], boxes[keep]


class MaxDetFilter(PredictionFilter):
    """keep the top max_dets predictions by confidence."""

    def __init__(self, max_dets: int) -> None:
        self.max_dets = max_dets

    def __call__(self, confs, boxes):
        if len(confs) <= self.max_dets:
            return confs, boxes
        keep = np.argsort(-confs, kind="stable")[: self.max_dets]
        return confs[keep], boxes[keep]


class NMSFilter(PredictionFilter):
    """greedy non-maximum suppression at the given IoU threshold."""

    def __init__(self, iou_thresh: float) -> None:
        self.iou_thresh = iou_thresh

    def __call__(self, confs, boxes):
        if len(confs) == 0:
            return confs, boxes
        keep = nms_np(confs, boxes, self.iou_thresh)
        return confs[keep], boxes[keep]


class PredictionFilterPipeline(PredictionFilter):
    """applies filters in sequence."""

    def __init__(self, *filters: PredictionFilter) -> None:
        self.filters = filters

    def __call__(self, confs, boxes):
        for f in self.filters:
            confs, boxes = f(confs, boxes)
        return confs, boxes
