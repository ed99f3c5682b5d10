"""region proposal network (port of the JAX package's `models/rpn.py`):
3x3 conv -> 512 + ReLU, then 1x1 heads for objectness (2 per anchor,
softmaxed) and box offsets (4 per anchor); the 512-channel features go on to
the tracker.

Anchor-major flatten: the conv outputs are permuted to NHWC before the
(B, H*W*a, t) reshape, which is the reference's permute(0,2,3,1).view(...)
and the order of anchors.build_anchors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import Conv2d


class RPN(nn.Module):
    def __init__(
        self, n_anchors: int, in_channels: int = 1024, conv_channels: int = 512, dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(in_channels, conv_channels, 3, padding=1)
        self.cls_fc = Conv2d(conv_channels, 2 * n_anchors, 1)
        self.reg_fc = Conv2d(conv_channels, 4 * n_anchors, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) c4 map -> o_hat (B, H*W*a, 2) softmaxed
        objectness, b_hat (B, H*W*a, 4) offsets, fm_reg (B, H, W, 512) f32."""
        b = x.shape[0]
        t = F.relu(self.conv(x.to(self.dtype).permute(0, 3, 1, 2)))
        o = self.cls_fc(t).permute(0, 2, 3, 1).reshape(b, -1, 2).float()
        bx = self.reg_fc(t).permute(0, 2, 3, 1).reshape(b, -1, 4).float()
        return torch.softmax(o, dim=-1), bx, t.permute(0, 2, 3, 1).float()
