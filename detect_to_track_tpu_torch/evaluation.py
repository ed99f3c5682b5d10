"""detection evaluation: PASCAL-VOC-style mean average precision (port of
the JAX package's `evaluation.py`).

The reference computes no evaluation metric (model selection is by
validation loss only, reference trainer.py:354-360). This module gives the
VID/VOC detection mAP the D&T paper reports, so checkpoints can be compared
on it. `average_precision` and `detection_map` are numpy, as in the JAX
package; `evaluate_detector` runs the port's Detector on its device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .boxes import compute_ious_np


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """all-points interpolated AP (VOC2010+ convention)."""
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    # precision envelope
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def detection_map(
    det_confs: Sequence[np.ndarray],  # per image: (D_i, C+1) class confs
    det_boxes: Sequence[np.ndarray],  # per image: (D_i, 4) ijhw
    gt_classes: Sequence[np.ndarray],  # per image: (G_i,) 1-based ids
    gt_boxes: Sequence[np.ndarray],  # per image: (G_i, 4) ijhw
    n_classes: int,
    iou_thresh: float = 0.5,
) -> Dict[str, float]:
    """mAP over 1-based classes 1..n_classes.

    Detections are scored per class by their softmax confidence; matching is
    greedy by descending score with one-to-one gt assignment at
    IoU > iou_thresh.
    """
    n_images = len(gt_classes)
    if not (len(det_confs) == len(det_boxes) == n_images == len(gt_boxes)):
        # silently zipping unequal lists would DROP the ground truths of
        # images missing from the detection lists, inflating recall/mAP.
        raise ValueError(
            f"detection and ground-truth lists must cover the same images: "
            f"got {len(det_confs)}/{len(det_boxes)} detection entries vs "
            f"{n_images}/{len(gt_boxes)} ground-truth entries"
        )

    aps = {}
    for c in range(1, n_classes + 1):
        # one gt slice + one (D_i, G_i) IoU matrix per image per class --
        # NOT one 1xG IoU call per detection record (Python overhead
        # dominated eval wall-clock).
        gtb_c = [gt_boxes[i][gt_classes[i] == c] for i in range(n_images)]
        n_gt = sum(len(g) for g in gtb_c)
        if n_gt == 0:
            continue
        iou_c = [
            compute_ious_np(np.asarray(det_boxes[i]), gtb_c[i])
            if len(det_boxes[i]) and len(gtb_c[i])
            else None
            for i in range(n_images)
        ]

        records = []  # (score, image_idx, det_idx)
        for i, confs in enumerate(det_confs):
            for d in range(len(confs)):
                records.append((float(confs[d, c]), i, d))
        records.sort(key=lambda r: -r[0])

        matched = {i: np.zeros(len(gtb_c[i]), bool) for i in range(n_images)}
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for n, (score, i, d) in enumerate(records):
            if iou_c[i] is None:
                fp[n] = 1
                continue
            ious = iou_c[i][d]
            j = int(np.argmax(ious))
            if ious[j] > iou_thresh and not matched[i][j]:
                matched[i][j] = True
                tp[n] = 1
            else:
                fp[n] = 1
        cum_tp = np.cumsum(tp)
        cum_fp = np.cumsum(fp)
        recall = cum_tp / n_gt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-12)
        aps[c] = average_precision(recall, precision)

    m = float(np.mean(list(aps.values()))) if aps else 0.0
    out = {"mAP": m}
    out.update({f"AP_{c}": v for c, v in aps.items()})
    return out


def evaluate_detector(
    detector, manager, n_classes: int, iou_thresh: float = 0.5,
    batch_pairs: int = 8,
) -> Dict[str, float]:
    """run a Detector over a DataManager of frame pairs and compute mAP on
    every frame (both frames of each pair are evaluated).

    Pairs fold into Detector.detect_pairs calls of `batch_pairs` pairs,
    the tail batch padded by repetition and its padding discarded: the
    detections of per-pair `__call__`, with one device call and one copy
    to the host per batch."""
    from .utils import promote_mixed_image_dtypes

    det_confs: List[np.ndarray] = []
    det_boxes: List[np.ndarray] = []
    gt_classes: List[np.ndarray] = []
    gt_boxes: List[np.ndarray] = []

    def gt(inst):
        gt_classes.append(
            np.array([l.class_id for l in inst.labels], np.int32)
        )
        gt_boxes.append(
            np.array([l.box for l in inst.labels], np.float32).reshape(-1, 4)
        )

    p = max(1, min(batch_pairs, len(manager)))
    for start in range(0, len(manager), p):
        block = [manager[n] for n in range(start, min(start + p, len(manager)))]
        real = len(block)
        block = block + [block[-1]] * (p - real)  # pad to a whole batch
        pairs = [
            np.stack(
                promote_mixed_image_dtypes(
                    [detector._to_array(i0.im), detector._to_array(i1.im)]
                )
            )
            for i0, i1 in block
        ]
        out = detector.detect_pairs(pairs)
        confs, boxes, valid = (f.cpu().numpy() for f in (out.confs, out.boxes, out.valid))
        for j in range(real):
            for f, inst in enumerate(block[j]):
                v = valid[j, f]
                det_confs.append(confs[j, f][v])
                det_boxes.append(boxes[j, f][v])
                gt(inst)
    return detection_map(
        det_confs, det_boxes, gt_classes, gt_boxes, n_classes, iou_thresh
    )
