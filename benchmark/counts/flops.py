"""model FLOPs counted from a configuration's shapes, for `mfu`.

A multiply-add counts 2. Counted: every convolution (dilated and grouped
ones included) at its output size, the RPN's and the R-FCN's 1x1 heads,
the correlation (2 C (2d+1)^2 H W a level and pair) and the tracker's
Linear on MAX_DETS rois a pair, in the reference's formulation. Not
counted: normalisation, activations, pooling, softmax, decode, NMS.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

from ..reference.model import BLOCKS

RPN_CHANNELS = 512


class Conv(NamedTuple):
    name: str
    flops: float  # forward


def out_size(n: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def conv_flops(h_out: int, w_out: int, c_in: int, c_out: int, k: int, groups: int = 1) -> float:
    return 2.0 * h_out * w_out * c_out * (c_in // groups) * k * k


def frame_convs(c: Dict) -> List[Conv]:
    """every convolution of one frame's forward, in order."""
    h, w = c["INPUT_SHAPE"]
    convs = []
    h, w = out_size(h, 7, 2, 3, 1), out_size(w, 7, 2, 3, 1)
    convs.append(Conv("conv1", conv_flops(h, w, 3, 64, 7)))
    h, w = out_size(h, 3, 2, 1, 1), out_size(w, 3, 2, 1, 1)
    in_ch, prev_dil = 64, 1
    for li, (planes, stride, dil) in enumerate(((64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 1, 2)), start=1):
        for bi in range(BLOCKS[c["BACKBONE_ARCH"]][li - 1]):
            s, d = (stride, prev_dil) if bi == 0 else (1, dil)
            h2, w2 = out_size(h, 3, s, d, d), out_size(w, 3, s, d, d)
            convs += [Conv(f"layer{li}.{bi}.conv1", conv_flops(h, w, in_ch, planes, 1)),
                      Conv(f"layer{li}.{bi}.conv2", conv_flops(h2, w2, planes, planes, 3)),
                      Conv(f"layer{li}.{bi}.conv3", conv_flops(h2, w2, planes, 4 * planes, 1))]
            if bi == 0:
                convs.append(Conv(f"layer{li}.{bi}.downsample", conv_flops(h2, w2, in_ch, 4 * planes, 1)))
            h, w, in_ch = h2, w2, 4 * planes
        prev_dil = dil
    # the RPN on c4 and the R-FCN on c5, both at the c4 / c5 map size
    a = len(c["ANCHOR_AREAS"]) * len(c["ANCHOR_ASPECT_RATIOS"])
    k2 = c["K"] ** 2
    convs += [Conv("rpn.conv", conv_flops(h, w, 1024, RPN_CHANNELS, 3)),
              Conv("rpn.cls_fc", conv_flops(h, w, RPN_CHANNELS, 2 * a, 1)),
              Conv("rpn.reg_fc", conv_flops(h, w, RPN_CHANNELS, 4 * a, 1)),
              Conv("rcnn.channel_reduce", conv_flops(h, w, 2048, RPN_CHANNELS, 3)),
              Conv("rcnn.cls_sm_conv", conv_flops(h, w, RPN_CHANNELS, (c["N_CLASSES"] + 1) * k2, 1)),
              Conv("rcnn.reg_sm_conv", conv_flops(h, w, RPN_CHANNELS, 4 * k2, 1))]
    return convs


def fm_hw(c: Dict):
    h, w = c["INPUT_SHAPE"]
    return h // c["FM_STRIDE"], w // c["FM_STRIDE"]


def pair_tracker(c: Dict, rois: int) -> List[Conv]:
    """the correlations (c3 at c4's size, c4, c5) and the tracker's Linear
    on `rois` frame-0 rois of one pair."""
    fh, fw = fm_hw(c)
    n = (2 * c["D_MAX"] + 1) ** 2
    fc = (3 * n + 2 * RPN_CHANNELS) * c["K"] ** 2
    return [Conv("corr.c3", 2.0 * 512 * n * fh * fw),
            Conv("corr.c4", 2.0 * 1024 * n * fh * fw),
            Conv("corr.c5", 2.0 * 2048 * n * fh * fw),
            Conv("tracker.reg_fc", 2.0 * rois * fc * 4)]


def pair_layers(c: Dict, rois: int) -> List[Conv]:
    return frame_convs(c) * 2 + pair_tracker(c, rois)


def pair_forward(c: Dict) -> float:
    """FLOPs of one pair's forward at inference (MAX_DETS tracker rois)."""
    return sum(x.flops for x in pair_layers(c, min(c["MAX_DETS"], c["MAX_ROIS"])))

