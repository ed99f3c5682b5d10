"""inference: the detect-and-track forward over frame pairs and clips (port
of the JAX package's `inference.py`):

    backbone -> RPN -> decode -> gate / top-k / NMS -> R-FCN -> decode ->
    non-background gate -> compaction to MAX_DETS -> tracker

All of it runs on the model's device; one copy to the host returns padded
detections and masks, and `Detector.__call__` trims them to the reference
API. `detect_clip` runs the per-frame stages once per frame of a clip and
the tracker on every adjacent pair (ClipTracker in clip.py links them). Each stage runs inside a `torch.profiler.record_function` range named
`d2t::<stage>`, so a profiler trace gives the device time per stage:

    confs0, confs1, bboxes0, bboxes1, tracks = detector(im0, im1)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from .anchors import build_anchors
from .config import Config
from .encoding import frcnn_box_decode
from .models import DetectTrackModule
from .ops.nms import _take_rows, _top_k, batched_proposal_filter
from .utils import check_model_device, image_to_input, promote_mixed_image_dtypes, resolve_device, split_pairs

Device = Optional[Union[str, torch.device]]


class PairDetections(NamedTuple):
    """fixed-shape per-pair outputs (leading axis 2 = frames)."""

    confs: torch.Tensor  # ([P,] 2, D, C+1) softmaxed class confidences
    boxes: torch.Tensor  # ([P,] 2, D, 4) ijhw
    valid: torch.Tensor  # ([P,] 2, D) bool
    tracks: torch.Tensor  # ([P,] D, 4) frame0 -> frame1 transforms (frame-0 slots)


def _detect_frames(model: DetectTrackModule, x: torch.Tensor, anchors: torch.Tensor, cfg: Config):
    """per-frame pipeline: backbone -> RPN -> decode -> proposal filter ->
    R-FCN -> second decode -> non-background gate -> compaction to
    cfg.max_dets slots, highest foreground confidence first.

    x: (N, H, W, 3) frames, uint8 (divided by 255 on the device) or float
    in [0, 1]. Returns (fmaps_t, fm_reg, confs, boxes, valid); fmaps_t has c3
    downsampled by 2 at full batch, before any pair split.
    """
    with record_function("d2t::backbone"):
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        fmaps = model.backbone(x)
    with record_function("d2t::rpn"):
        o_hat, b_hat, fm_reg = model.rpn(fmaps["c4"])
        rboxes = frcnn_box_decode(anchors[None], b_hat)  # (N, |A|, 4)

    with record_function("d2t::proposal_filter"):
        props = batched_proposal_filter(
            o_hat[:, :, 1],
            rboxes,
            cfg.pre_nms_topk_eval,
            cfg.EVAL_ROI_CONF_THRESH,
            cfg.EVAL_NMS_IOU_THRESH,
            cfg.MAX_ROIS,
            cfg.pre_nms_cap_eval,
        )  # boxes (N, R, 4), valid (N, R)

    with record_function("d2t::rcnn"):
        c_hat, b2_hat = model.rcnn(fmaps["c5"], props.boxes)  # (N, R, C+1), (N, R, 4)
        det_boxes = frcnn_box_decode(props.boxes, b2_hat)

        fg_conf = c_hat[:, :, 1:].sum(-1)  # (N, R)
        keep = (fg_conf > cfg.EVAL_RCNN_CONF_THRESH) & props.valid
        key = torch.where(keep, fg_conf, torch.full_like(fg_conf, -torch.inf))
        top, idx = _top_k(key, cfg.max_dets)
        confs = _take_rows(c_hat, idx)
        boxes = _take_rows(det_boxes, idx)
        valid = torch.isfinite(top)
        fmaps_t = {**fmaps, "c3": fmaps["c3"][:, ::2, ::2, :]}
    return fmaps_t, fm_reg, confs, boxes, valid


@torch.inference_mode()
def detect_pairs_batched(
    model: DetectTrackModule,
    images,
    anchors,
    cfg: Config,
    device: Device = None,
) -> PairDetections:
    """forward for a batch of frame pairs, folded into one frame batch.

    Args:
        images: (P, 2, H, W, 3) float32 in [0, 1] or uint8 in [0, 255]
            (uint8 is divided by 255 on the device).
        anchors: (|A|, 4).
        device: where it runs (cuda unless given); the model must be there.

    Returns PairDetections with a leading P axis on every field.
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    images = torch.as_tensor(images).to(dev)
    anchors = torch.as_tensor(anchors).to(dev)
    p, two, h, w, c = images.shape
    if two != 2:
        raise ValueError(f"expected (P, 2, H, W, 3) frame pairs, got {tuple(images.shape)}")
    x = images.reshape(p * 2, h, w, c)

    fmaps_t, fm_reg, confs, boxes, valid = _detect_frames(model, x, anchors, cfg)
    d = cfg.max_dets

    # tracker on the frame-0 final boxes
    with record_function("d2t::tracker"):
        split = {k: split_pairs(v) for k, v in fmaps_t.items()}
        pyr0 = {k: v[0] for k, v in split.items()}
        pyr1 = {k: v[1] for k, v in split.items()}
        reg0, reg1 = split_pairs(fm_reg)
        tracks = model.c_tracker(pyr0, pyr1, reg0, reg1, split_pairs(boxes)[0])  # (P, D, 4)

    return PairDetections(
        confs=confs.reshape(p, 2, d, -1),
        boxes=boxes.reshape(p, 2, d, 4),
        valid=valid.reshape(p, 2, d),
        tracks=tracks,
    )


def detect_pair(
    model: DetectTrackModule, images, anchors, cfg: Config, device: Device = None
) -> PairDetections:
    """single-pair forward: images (2, H, W, 3); fields without the P axis."""
    out = detect_pairs_batched(model, torch.as_tensor(images)[None], anchors, cfg, device)
    return PairDetections(*(f[0] for f in out))


class ClipDetections(NamedTuple):
    """fixed-shape per-clip outputs (leading axis F = frames)."""

    confs: torch.Tensor  # (F, D, C+1)
    boxes: torch.Tensor  # (F, D, 4)
    valid: torch.Tensor  # (F, D)
    tracks: torch.Tensor  # (F-1, D, 4) frame t -> t+1 transforms


@torch.inference_mode()
def detect_clip(model: DetectTrackModule, frames, anchors, cfg: Config, device: Device = None) -> ClipDetections:
    """forward for F consecutive frames: the backbone, RPN and R-FCN run once
    per frame and the tracker runs on every adjacent pair by slicing the
    shared feature batch (the pair API computes every interior frame twice).

    Args:
        frames: (F, H, W, 3) float32 in [0, 1] or uint8 in [0, 255] (uint8 is
            divided by 255 on the device).
        device: where it runs (cuda unless given); the model must be there.
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    frames = torch.as_tensor(frames).to(dev)
    anchors = torch.as_tensor(anchors).to(dev)
    fmaps_t, fm_reg, confs, boxes, valid = _detect_frames(model, frames, anchors, cfg)

    # the tracker over all adjacent pairs, sharing the per-frame features
    with record_function("d2t::tracker"):
        pyr0 = {k: v[:-1] for k, v in fmaps_t.items()}
        pyr1 = {k: v[1:] for k, v in fmaps_t.items()}
        tracks = model.c_tracker(pyr0, pyr1, fm_reg[:-1], fm_reg[1:], boxes[:-1])  # (F-1, D, 4)
    return ClipDetections(confs=confs, boxes=boxes, valid=valid, tracks=tracks)


class Detector:
    """host-facing detector with the reference's API: __call__(im0, im1) ->
    (confs0, confs1, bboxes0, bboxes1, tracks) as trimmed numpy arrays.

    Accepts PIL images (resized to cfg.INPUT_SHAPE) or pre-sized (H, W, 3)
    arrays, uint8 or float in [0, 1]. Runs on `device`, cuda unless given.
    """

    def __init__(self, model: DetectTrackModule, cfg: Config, device: Device = None) -> None:
        if cfg.HOST_S2D:
            raise NotImplementedError(
                "HOST_S2D (the 12-channel space-to-depth stem) is not ported yet (ROADMAP.md)"
            )
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.anchors = torch.from_numpy(
            np.array(build_anchors(cfg.fm_shape, cfg.ANCHOR_AREAS, cfg.ANCHOR_ASPECT_RATIOS))
        ).to(self.device)

    def _pack_input(self, x):
        """a numpy array or tensor passes through; a list of arrays or
        tensors is stacked after mixed uint8/float entries are brought to
        float32 / 255."""
        if isinstance(x, (list, tuple)):
            if all(isinstance(p, np.ndarray) for p in x):
                return np.asarray(promote_mixed_image_dtypes(list(x)))
            parts = [torch.as_tensor(p).to(self.device) for p in x]
            return torch.stack(promote_mixed_image_dtypes(parts))
        return x

    def detect_pairs(self, pairs) -> PairDetections:
        """batched raw API: pairs is (P, 2, H, W, 3); returns the padded
        PairDetections on the device, with a leading P axis."""
        return detect_pairs_batched(self.model, self._pack_input(pairs), self.anchors, self.cfg, self.device)

    def detect_clip(self, frames) -> ClipDetections:
        """consecutive-frame raw API: frames is (F, H, W, 3); the backbone
        runs once per frame (see detect_clip). Returns the padded
        ClipDetections on the device."""
        return detect_clip(self.model, self._pack_input(frames), self.anchors, self.cfg, self.device)

    def _to_array(self, im) -> np.ndarray:
        if isinstance(im, np.ndarray):
            # uint8 stays uint8 (divided by 255 on the device); float is
            # already in [0, 1]
            return im if im.dtype == np.uint8 else im.astype(np.float32)
        return image_to_input(im, self.cfg.INPUT_SHAPE, as_uint8=True)

    def __call__(self, im0, im1) -> Tuple[np.ndarray, ...]:
        x = np.stack(promote_mixed_image_dtypes([self._to_array(im0), self._to_array(im1)]))
        out = detect_pair(self.model, x, self.anchors, self.cfg, self.device)
        confs, boxes, valid, tracks = (f.cpu().numpy() for f in out)
        v0, v1 = valid[0], valid[1]
        return confs[0][v0], confs[1][v1], boxes[0][v0], boxes[1][v1], tracks[v0]
