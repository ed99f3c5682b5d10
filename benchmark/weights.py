"""the detector's weights, made from the seed on the device.

The names and shapes are the reference detector's state_dict (each
BatchNorm folded into a frozen affine `scale` / `bias`), derived from the
configuration. Every convolution and linear weight is lecun-normal (std
1/sqrt(fan_in)), drawn in one call from a `torch.Generator` on the
device; biases are 0 and the frozen BatchNorms the identity. The
configuration's `weights.scale` multiplies named layers (the box
regression heads, to a trained net's magnitude; the R-FCN's class head,
so that its logits spread over rois as a trained head's do).

`set_background` then gives the channels that the background class pools
a bias, the same for each, such that the foreground gate keeps
GATE_SHARE of a frame's rois by the plain reference: most rois read as background, as a trained detector's do, and
the gate drops some. The class logits of a random head carry a large
offset that depends on the seed, so the bias is found for each seed's
weights on its first frame. Both the program and the reference are
handed these tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .reference import model as ref
from .reference.ops import build_anchors, ps_roi_pool, psroi_channels

RPN_CHANNELS = 512
GATE_SHARE = 0.4  # of the rois the foreground gate keeps on the seed's first frame


def shapes(c: Dict) -> List[Tuple[str, tuple]]:
    """(name, shape) of every tensor of the state_dict for configuration
    keys `c`."""
    out = [("backbone.conv1.weight", (64, 3, 7, 7))]

    def bn(name, n):
        out.extend([(f"{name}.scale", (n,)), (f"{name}.bias", (n,))])

    bn("backbone.bn1", 64)
    in_ch = 64
    for li, planes in enumerate((64, 128, 256, 512), start=1):
        for bi in range(ref.BLOCKS[c["BACKBONE_ARCH"]][li - 1]):
            p = f"backbone.layer{li}.{bi}"
            out.append((f"{p}.conv1.weight", (planes, in_ch, 1, 1)))
            bn(f"{p}.bn1", planes)
            out.append((f"{p}.conv2.weight", (planes, planes, 3, 3)))
            bn(f"{p}.bn2", planes)
            out.append((f"{p}.conv3.weight", (4 * planes, planes, 1, 1)))
            bn(f"{p}.bn3", 4 * planes)
            if bi == 0:
                out.append((f"{p}.downsample.0.weight", (4 * planes, in_ch, 1, 1)))
                bn(f"{p}.downsample.1", 4 * planes)
            in_ch = 4 * planes
    a = len(c["ANCHOR_AREAS"]) * len(c["ANCHOR_ASPECT_RATIOS"])
    k2 = c["K"] ** 2
    n_corr = (2 * c["D_MAX"] + 1) ** 2
    for name, shape in (("rpn.conv", (RPN_CHANNELS, 1024, 3, 3)), ("rpn.cls_fc", (2 * a, RPN_CHANNELS, 1, 1)),
                        ("rpn.reg_fc", (4 * a, RPN_CHANNELS, 1, 1)),
                        ("rcnn.channel_reduce", (RPN_CHANNELS, 2048, 3, 3)),
                        ("rcnn.cls_sm_conv", ((c["N_CLASSES"] + 1) * k2, RPN_CHANNELS, 1, 1)),
                        ("rcnn.reg_sm_conv", (4 * k2, RPN_CHANNELS, 1, 1)),
                        ("c_tracker.reg_fc", (4, (3 * n_corr + 2 * RPN_CHANNELS) * k2))):
        out += [(f"{name}.weight", shape), (f"{name}.bias", (shape[0],))]
    return out


def make(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """the weights of configuration file `config` (its `config` keys and its
    `weights`) for `seed`, float32 on `device`."""
    spec = shapes(config["config"])
    init = config.get("weights", {})
    scale = dict(init.get("scale", {}))
    dense = [(n, s) for n, s in spec if len(s) >= 2]
    numels = [torch.Size(s).numel() for _, s in dense]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(numels), generator=gen, device=device)
    std = torch.tensor([s[1:].numel() ** -0.5 * scale.get(n.rsplit(".", 1)[0], 1.0)
                        for n, s in ((n, torch.Size(s)) for n, s in dense)], device=device)
    flat *= torch.repeat_interleave(std, torch.tensor(numels, device=device))
    weights = {n: w.view(s) for (n, s), w in zip(dense, flat.split(numels))}
    for name, s in spec:
        if len(s) == 1:
            fill = 1.0 if name.endswith(".scale") else 0.0
            weights[name] = torch.full(s, fill, device=device)
    return weights


def set_background(weights: Dict[str, torch.Tensor], frame: torch.Tensor, s: "ref.Sizes") -> float:
    """give the background class's channels of the R-FCN class head (their
    bias 0 before) the bias b for which the foreground gate keeps
    GATE_SHARE of the rois that the plain reference's proposal filter
    keeps on one (H, W, 3) uint8 frame; returns b. A channel that the background pools at
    bin n is pooled by target t at bin n / (t + 1) too, so the bias raises
    each target's logit by b times its share of such bins, the
    background's by b: the kept share falls as b grows, and b is found by
    bisection."""
    t_all, k = s.n_classes + 1, s.k
    anchors = torch.from_numpy(build_anchors(s.fm_hw, s.anchor_areas, s.anchor_ratios)).to(frame.device)
    with torch.no_grad(), ref.no_tf32():
        p = ref.frame_parts(weights, frame, anchors, s, ref.EXACT)
        rois, kept = ref.proposals(p.scores, p.props, s.eval_filter)
        t = torch.relu(ref.conv(p.pyr["c5"], weights, "rcnn.channel_reduce", ref.EXACT, padding=6, dilation=6))
        maps = ref.conv(t, weights, "rcnn.cls_sm_conv", ref.EXACT)[0].permute(1, 2, 0)
        logits = ps_roi_pool(maps, rois[kept], t_all, k).mean((-2, -1))
        if logits.shape[0] == 0:
            return 0.0
        raised = (psroi_channels(t_all, k, frame.device) < k * k).float().mean((1, 2))
        lo, hi = -50.0, 50.0
        for _ in range(60):
            b = (lo + hi) / 2
            fg = 1.0 - torch.softmax(logits + b * raised, -1)[:, 0]
            if float((fg > s.rcnn_conf).float().mean()) > GATE_SHARE:
                lo = b
            else:
                hi = b
    b = (lo + hi) / 2
    weights["rcnn.cls_sm_conv.bias"][psroi_channels(1, k, frame.device).flatten()] = b
    return b
