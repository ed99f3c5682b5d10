"""stride-reduced ResNet / ResNeXt backbone (port of the JAX package's
`models/resnet.py`).

- torchvision's `replace_stride_with_dilation=(False, False, True)`: layer4
  keeps stride 1 with dilation-2 convs, so c3, c4, c5 come at strides 8,
  16, 16; the first block of the dilated layer runs at the previous
  dilation, as torchvision's `_make_layer` does.
- FrozenBatchNorm2d as its folded per-channel affine, scale and bias kept as
  buffers.
- ImageNet normalization of [0, 1] RGB input, in the input's dtype, before
  the cast to the compute dtype.
- the freeze boundary: with first_trainable_stage = s > 0 the activation
  entering layer s is detached, and so is every pyramid level produced only
  by frozen stages (c3 at s = 3), as the JAX package's stop_gradient cuts
  do; `set_trainable_stages` clears requires_grad on the frozen weights.
- a (B, H/2, W/2, 12) input is a frame already packed 2x2 space-to-depth
  on the host (HOST_S2D, `utils.space_to_depth2`): the stem runs as the
  equivalent 4x4/s1 convolution over 12 channels, from the same 7x7 weights
  (zero-padded to 8x8 and regrouped), so the state_dict is unchanged.
- remat: each bottleneck of the trainable stages runs under
  `torch.utils.checkpoint` (its activations are recomputed in the backward),
  as the JAX package wraps its blocks in `nn.remat`.

Public layout is NHWC, as in the JAX package. Inside, the convolutions take
`x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor, which is already a
channels-last NCHW tensor, so no copy is made.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# arch name -> (block counts, groups, width_per_group)
ARCHS: Dict[str, Tuple[Sequence[int], int, int]] = {
    "resnet50": ((3, 4, 6, 3), 1, 64),
    "resnet101": ((3, 4, 23, 3), 1, 64),
    "resnet152": ((3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ((3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": ((3, 4, 23, 3), 32, 8),
}


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to the input's dtype at
    each call, as flax casts params to the compute dtype per layer."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding, self.dilation, self.groups
        )


class FrozenBatchNorm(nn.Module):
    """per-channel affine y = x * scale + bias (the folded form of
    FrozenBatchNorm2d); scale and bias are buffers, in the input's dtype at
    each call. x is NCHW."""

    def __init__(self, features: int) -> None:
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision-compatible bottleneck block (1x1 -> 3x3 -> 1x1, x4)."""

    def __init__(
        self,
        in_ch: int,
        planes: int,
        stride: int = 1,
        dilation: int = 1,
        groups: int = 1,
        base_width: int = 64,
        has_downsample: bool = False,
    ) -> None:
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * 4
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        self.conv2 = Conv2d(
            width, width, 3, stride=stride, padding=dilation, dilation=dilation, groups=groups, bias=False
        )
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (
            nn.Sequential(Conv2d(in_ch, out_ch, 1, stride=stride, bias=False), FrozenBatchNorm(out_ch))
            if has_downsample
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class ResNetBackbone(nn.Module):
    """backbone returning the {c3, c4, c5} pyramid at strides {8, 16, 16}.

    Args:
        arch: one of ARCHS.
        dtype: compute dtype (parameters stay float32).
        first_trainable_stage: the freeze boundary (module docstring); 0
            cuts nothing.
        remat: recompute the trainable stages' bottlenecks in the backward.
    """

    def __init__(
        self,
        arch: str = "resnet50",
        dtype: torch.dtype = torch.float32,
        first_trainable_stage: int = 0,
        remat: bool = False,
    ):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown arch {arch!r} (one of {sorted(ARCHS)})")
        self.arch = arch
        self.dtype = dtype
        self.first_trainable_stage = first_trainable_stage
        self.remat = remat
        blocks, groups, base_width = ARCHS[arch]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        # (planes, stride, dilation) per layer; layer4 is dilated, and its
        # first block runs at the previous dilation (torchvision).
        layer_cfg = [(64, 1, 1), (128, 2, 1), (256, 2, 1), (512, 1, 2)]
        in_ch = 64
        prev_dilation = 1
        for li, ((planes, stride, dilation), n_blocks) in enumerate(zip(layer_cfg, blocks), start=1):
            layer = []
            for bi in range(n_blocks):
                layer.append(
                    Bottleneck(
                        in_ch if bi == 0 else planes * 4,
                        planes,
                        stride=stride if bi == 0 else 1,
                        dilation=prev_dilation if bi == 0 else dilation,
                        groups=groups,
                        base_width=base_width,
                        has_downsample=(bi == 0),
                    )
                )
            setattr(self, f"layer{li}", nn.Sequential(*layer))
            in_ch = planes * 4
            prev_dilation = dilation

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: (B, H, W, 3) float in [0, 1], or (B, H/2, W/2, 12) packed by
        `utils.space_to_depth2` -> {'c3', 'c4', 'c5'} NHWC maps in the
        compute dtype."""
        pre_s2d = x.shape[-1] == 12
        if not pre_s2d and x.shape[-1] != 3:
            raise ValueError(f"the backbone takes (B, H, W, 3) or (B, H/2, W/2, 12) frames, got {tuple(x.shape)}")
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        if pre_s2d:
            # RGB is the minor index of each (vi, vj) group of 3 channels
            mean, std = mean.repeat(4), std.repeat(4)
        x = (x - mean) / std
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if pre_s2d:
            # y[p] = sum_{i<7} w[i] x[2p+i-3]: with w zero-padded to 8 taps at
            # the leading edge, tap i' - 4 = 2u + v splits into a block offset
            # u in {-2..1} and a phase v, so the stem is a 4x4/s1 conv with
            # padding (2, 1) over the 12 (vi, vj, c) channels
            x = F.conv2d(F.pad(x, (2, 1, 2, 1)), s2d_stem_weight(self.conv1.weight).to(x.dtype))
        else:
            x = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        fts = self.first_trainable_stage
        for li in range(1, 5):
            if li == fts:
                x = x.detach()  # nothing below the boundary gets a gradient
            layer = getattr(self, f"layer{li}")
            if self.remat and li >= fts and torch.is_grad_enabled():
                for block in layer:
                    x = checkpoint(block, x, use_reentrant=False)
            else:
                x = layer(x)
            if li >= 2:
                out = x.permute(0, 2, 3, 1)
                if li < fts:
                    # a level made only by frozen stages: no consumer can
                    # reach a trainable weight through it
                    out = out.detach()
                feats[f"c{li + 1}"] = out
        return feats


def s2d_stem_weight(w: torch.Tensor) -> torch.Tensor:
    """the 7x7/s2 stem kernel (64, 3, 7, 7) as the 4x4/s1 kernel (64, 12, 4, 4)
    over space-to-depth input: zero-padded to 8x8 at the leading edge, each
    tap i' = 2u + v regrouped into the block tap u and the input channel
    v_i * 6 + v_j * 3 + c."""
    o = w.shape[0]
    w8 = F.pad(w, (1, 0, 1, 0)).reshape(o, 3, 4, 2, 4, 2)  # (o, c, ui, vi, uj, vj)
    return w8.permute(0, 3, 5, 1, 2, 4).reshape(o, 12, 4, 4)


def set_trainable_stages(model: nn.Module, first_trainable_stage: int) -> List[nn.Parameter]:
    """freeze the stem and the backbone stages below first_trainable_stage
    (requires_grad=False) and return the parameters that stay trainable, in
    `named_parameters` order. Backbone parameters are those named
    `backbone.*` (the DetectTrackModule's); the heads always train.
    FrozenBatchNorm affines are buffers and never train. The JAX package's
    `resnet_trainable_mask` makes the same choice."""
    trainable = []
    for name, param in model.named_parameters():
        parts = name.split(".")
        train = True
        if parts[0] == "backbone":
            stage = next((int(m.group(1)) for m in map(re.compile(r"layer(\d)").fullmatch, parts) if m), None)
            train = stage is not None and stage >= first_trainable_stage
        param.requires_grad_(train)
        if train:
            trainable.append(param)
    return trainable
