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

Public layout is NHWC, as in the JAX package. Inside, the convolutions take
`x.permute(0, 3, 1, 2)` of a contiguous NHWC tensor, which is already a
channels-last NCHW tensor, so no copy is made.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    """

    def __init__(self, arch: str = "resnet50", dtype: torch.dtype = torch.float32):
        super().__init__()
        if arch not in ARCHS:
            raise ValueError(f"unknown arch {arch!r} (one of {sorted(ARCHS)})")
        self.arch = arch
        self.dtype = dtype
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
        """x: (B, H, W, 3) float in [0, 1] -> {'c3', 'c4', 'c5'} NHWC maps in
        the compute dtype."""
        if x.shape[-1] != 3:
            raise NotImplementedError(
                f"the backbone takes (B, H, W, 3) frames, got {tuple(x.shape)}: the "
                "HOST_S2D 12-channel stem is not ported yet (ROADMAP.md)"
            )
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean) / std
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            if li >= 2:
                feats[f"c{li + 1}"] = x.permute(0, 2, 3, 1)
        return feats
