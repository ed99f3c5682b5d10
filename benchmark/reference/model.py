"""the plain reference of Detect to Track (Feichtenhofer et al., ICCV 2017)
as the configuration runs it: an R-FCN on a ResNet with a dilated c5, an
RPN on c4, and the correlation tracker's regressor on c3, c4 and c5.

Plain PyTorch in float32 over a weights dict (the benchmark's own, keyed
as the reference detector's state_dict with each BatchNorm folded into a
frozen affine `scale` / `bias`), one frame pair at a time. Matrix
products and convolutions run with TF32 off (`no_tf32`). A `Quant`
rounds what the program holds in its compute dtype: every operand and
output of a convolution, every frozen-BatchNorm output and residual sum,
the correlation's maps and volumes and the tracker's Linear weight (its
input is the average of rounded maps). `EXACT` leaves them, `FP8` rounds
to float8 e4m3 with a per-tensor scale: the control, one step below the
configuration's bfloat16.

The tracker's head is the reference's materialized form: ROI-pool the
concatenated [rpn_0, rpn_1, corr_c3, corr_c4, corr_c5] maps, flatten in
(C, k, k) order, one Linear to 4. Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from . import ops

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# block counts of the ResNets the configurations name (He et al. 2016)
BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
FP8_MAX = 448.0  # largest finite float8 e4m3


class Quant:
    """operand rounding: None leaves operands exact (float32)."""

    def __init__(self, dtype=None):
        self.dtype = dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(self.dtype).float() * scale


EXACT = Quant()
FP8 = Quant(torch.float8_e4m3fn)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Filter(NamedTuple):
    """the proposal filter's keys: the gate, top-k slots, the cap, the NMS
    threshold, the rois kept."""

    conf: float
    topk: int
    cap: int
    iou: float
    max_rois: int


class Sizes(NamedTuple):
    """the configuration keys the reference reads."""

    arch: str
    fm_hw: tuple
    n_classes: int
    k: int
    d_max: int
    anchor_areas: tuple
    anchor_ratios: tuple
    eval_filter: Filter
    rcnn_conf: float
    max_dets: int

    @classmethod
    def from_config(cls, c: Dict) -> "Sizes":
        h, w = c["INPUT_SHAPE"]
        fm = (h // c["FM_STRIDE"], w // c["FM_STRIDE"])
        n_anchors = fm[0] * fm[1] * len(c["ANCHOR_AREAS"]) * len(c["ANCHOR_ASPECT_RATIOS"])

        rois = c["EVAL_MAX_ROIS"]  # top-k slots: rounded up to 128s, as the program pads them
        filt = Filter(c["EVAL_ROI_CONF_THRESH"], min(-(-rois // 128) * 128, n_anchors), min(rois, n_anchors),
                      c["EVAL_NMS_IOU_THRESH"], c["MAX_ROIS"])
        return cls(c["BACKBONE_ARCH"], fm, c["N_CLASSES"], c["K"], c["D_MAX"], tuple(c["ANCHOR_AREAS"]),
                   tuple(c["ANCHOR_ASPECT_RATIOS"]), filt, c["EVAL_RCNN_CONF_THRESH"], min(c["MAX_DETS"], c["MAX_ROIS"]))


def conv(x, W, name, q, stride=1, padding=0, dilation=1):
    """NCHW conv2d of q(x) with q(W[name.weight]) (+ W[name.bias]), its
    output rounded by q."""
    bias = W.get(f"{name}.bias")
    return q(F.conv2d(q(x), q(W[f"{name}.weight"]), bias, stride, padding, dilation))


def frozen_bn(x, W, name, q):
    return q(x * W[f"{name}.scale"][:, None, None] + W[f"{name}.bias"][:, None, None])


def backbone(W, frames: torch.Tensor, arch: str, q: Quant) -> Dict[str, torch.Tensor]:
    """(N, H, W, 3) uint8 frames -> {'c3', 'c4', 'c5'} NCHW maps at strides
    8, 16, 16 (layer4 dilated 2, its first block at dilation 1)."""
    x = frames.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)
    x = F.relu(frozen_bn(conv(x, W, "backbone.conv1", q, 2, 3), W, "backbone.bn1", q))
    x = F.max_pool2d(x, 3, 2, 1)
    feats = {}
    strides, dilations = (1, 2, 2, 1), (1, 1, 1, 2)
    for li, n_blocks in enumerate(BLOCKS[arch], start=1):
        for bi in range(n_blocks):
            p = f"backbone.layer{li}.{bi}"
            stride = strides[li - 1] if bi == 0 else 1
            dil = dilations[li - 2] if (bi == 0 and li > 1) else dilations[li - 1]
            y = F.relu(frozen_bn(conv(x, W, f"{p}.conv1", q), W, f"{p}.bn1", q))
            y = F.relu(frozen_bn(conv(y, W, f"{p}.conv2", q, stride, dil, dil), W, f"{p}.bn2", q))
            y = frozen_bn(conv(y, W, f"{p}.conv3", q), W, f"{p}.bn3", q)
            if bi == 0:
                x = frozen_bn(conv(x, W, f"{p}.downsample.0", q, stride), W, f"{p}.downsample.1", q)
            x = F.relu(q(x + y))
        if li >= 2:
            feats[f"c{li + 1}"] = x
    return feats


def rpn(W, c4: torch.Tensor, q: Quant):
    """c4 (N, C, H, W) -> softmaxed objectness (N, |A|, 2), offsets (N,
    |A|, 4) in the anchor-major order, RPN features (N, H, W, 512)."""
    n = c4.shape[0]
    t = F.relu(conv(c4, W, "rpn.conv", q, padding=1))
    o = conv(t, W, "rpn.cls_fc", q).permute(0, 2, 3, 1).reshape(n, -1, 2)
    b = conv(t, W, "rpn.reg_fc", q).permute(0, 2, 3, 1).reshape(n, -1, 4)
    return torch.softmax(o, -1), b, t.permute(0, 2, 3, 1)


def rfcn(W, c5: torch.Tensor, rois: torch.Tensor, s: Sizes, q: Quant):
    """c5 (1, C, H, W) of one frame, rois (R, 4) -> class confidences
    (R, C+1) softmaxed and box offsets (R, 4)."""
    t = F.relu(conv(c5, W, "rcnn.channel_reduce", q, padding=6, dilation=6))
    cls_maps = conv(t, W, "rcnn.cls_sm_conv", q)[0].permute(1, 2, 0)
    reg_maps = conv(t, W, "rcnn.reg_sm_conv", q)[0].permute(1, 2, 0)
    c = ops.ps_roi_pool(cls_maps, rois, s.n_classes + 1, s.k).mean((-2, -1))
    b = ops.ps_roi_pool(reg_maps, rois, 4, s.k).mean((-2, -1))
    return torch.softmax(c, -1), b


def candidates(scores: torch.Tensor, boxes: torch.Tensor, f: Filter):
    """one frame's gated top-k (stable, score-descending) under the cap ->
    candidate boxes (k, 4) and their valid mask."""
    gated = torch.where(scores > f.conf, scores, torch.full_like(scores, -torch.inf))
    top, idx = torch.sort(gated, descending=True, stable=True)
    top, idx = top[: f.topk], idx[: f.topk]
    return boxes[idx], torch.isfinite(top) & (torch.arange(top.numel(), device=top.device) < f.cap)


def proposals(scores: torch.Tensor, boxes: torch.Tensor, f: Filter):
    """one frame: the candidates, greedy NMS, the first max_rois survivors
    -> rois (max_rois, 4), valid."""
    cand, valid = candidates(scores, boxes, f)
    keep = ops.greedy_nms(cand, valid, f.iou)
    n = keep.numel()
    key = torch.where(keep, torch.arange(n, device=keep.device), torch.full((n,), n, device=keep.device))
    order = torch.argsort(key, stable=True)[: f.max_rois]
    rois, kept = cand[order], keep[order]
    if rois.shape[0] < f.max_rois:
        pad = f.max_rois - rois.shape[0]
        rois = F.pad(rois, (0, 0, 0, pad))
        kept = F.pad(kept, (0, pad))
    return rois, kept


def tracker(W, pyr0, pyr1, reg0, reg1, rois: torch.Tensor, s: Sizes, q: Quant) -> torch.Tensor:
    """one pair: NCHW pyramids (1, C, H, W), RPN features (1, H, W, 512),
    frame-0 rois (R, 4) -> frame-0 -> frame-1 transforms (R, 4)."""
    def nhwc(x):
        return q(x.permute(0, 2, 3, 1))

    c3_0, c3_1 = pyr0["c3"][:, :, ::2, ::2], pyr1["c3"][:, :, ::2, ::2]
    corr = [ops.correlation(nhwc(a), nhwc(b), s.d_max)
            for a, b in ((c3_0, c3_1), (pyr0["c4"], pyr1["c4"]), (pyr0["c5"], pyr1["c5"]))]
    feats = torch.cat([q(reg0), q(reg1), *(q(c) for c in corr)], -1)[0]  # (H, W, 2*512 + 3*(2d+1)^2)
    pooled = ops.roi_pool(feats, rois, s.k)  # (R, k, k, C)
    flat = pooled.permute(0, 3, 1, 2).reshape(rois.shape[0], -1)  # (C, k, k) order
    return flat @ q(W["c_tracker.reg_fc.weight"]).t() + W["c_tracker.reg_fc.bias"]


class PairOutputs(NamedTuple):
    confs: torch.Tensor  # (2, D, C+1)
    boxes: torch.Tensor  # (2, D, 4)
    valid: torch.Tensor  # (2, D)
    tracks: torch.Tensor  # (D, 4)


class FrameParts(NamedTuple):
    """what one frame's reference forward leaves for the comparison."""

    pyr: Dict[str, torch.Tensor]
    reg: torch.Tensor
    scores: torch.Tensor  # (|A|,) objectness
    props: torch.Tensor  # (|A|, 4) decoded anchors


def frame_parts(W, frame: torch.Tensor, anchors: torch.Tensor, s: Sizes, q: Quant) -> FrameParts:
    """backbone, RPN and the anchors' decode of one (H, W, 3) uint8 frame."""
    pyr = backbone(W, frame[None], s.arch, q)
    scores, offsets, reg = rpn(W, pyr["c4"], q)
    return FrameParts(pyr, reg, scores[0, :, 1], ops.box_decode(anchors, offsets[0]))


def detect_pair(W, pair: torch.Tensor, anchors: torch.Tensor, s: Sizes, q: Quant) -> PairOutputs:
    """the whole detector on one (2, H, W, 3) uint8 pair: what the program's
    pair call returns for it."""
    parts = [frame_parts(W, pair[f], anchors, s, q) for f in range(2)]
    confs, boxes, valid = [], [], []
    for p in parts:
        rois, kept = proposals(p.scores, p.props, s.eval_filter)
        c, b2 = rfcn(W, p.pyr["c5"], rois, s, q)
        det = ops.box_decode(rois, b2)
        fg = c[:, 1:].sum(-1)
        key = torch.where((fg > s.rcnn_conf) & kept, fg, torch.full_like(fg, -torch.inf))
        top, idx = torch.sort(key, descending=True, stable=True)
        top, idx = top[: s.max_dets], idx[: s.max_dets]
        confs.append(c[idx])
        boxes.append(det[idx])
        valid.append(torch.isfinite(top))
    tracks = tracker(W, parts[0].pyr, parts[1].pyr, parts[0].reg, parts[1].reg, boxes[0], s, q)
    return PairOutputs(torch.stack(confs), torch.stack(boxes), torch.stack(valid), tracks)
