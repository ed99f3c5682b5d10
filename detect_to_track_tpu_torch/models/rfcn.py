"""R-FCN detection head (port of the JAX package's `models/rfcn.py`):
channel_reduce = 3x3 conv, dilation 6 -> 512 + ReLU; a classification and a
regression head, each a 1x1 conv to n_targets*k^2 position-sensitive score
maps -> PSROIPool -> mean over the k x k grid. Batched over frames."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import ps_roi_pool
from .resnet import Conv2d


class RFCN(nn.Module):
    """Args:
        n_classes: number of non-background classes.
        k: pooled grid height and width.
        paper_channel_layout: False replicates the reference's PSROIPool
            channel-selector quirk.
    """

    def __init__(
        self,
        n_classes: int,
        k: int = 7,
        in_channels: int = 2048,
        reduce_channels: int = 512,
        paper_channel_layout: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.n_classes = n_classes
        self.k = k
        self.paper_channel_layout = paper_channel_layout
        self.dtype = dtype
        self.channel_reduce = Conv2d(in_channels, reduce_channels, 3, padding=6, dilation=6)
        self.cls_sm_conv = Conv2d(reduce_channels, (n_classes + 1) * k * k, 1)
        self.reg_sm_conv = Conv2d(reduce_channels, 4 * k * k, 1)

    def forward(self, x: torch.Tensor, rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) c5 map; rois: (B, R, 4) fractional ijhw ->
        c_hat (B, R, n_classes+1) softmaxed, b_hat (B, R, 4)."""
        n_cls = self.n_classes + 1
        t = F.relu(self.channel_reduce(x.to(self.dtype).permute(0, 3, 1, 2)))
        cls_maps = self.cls_sm_conv(t).permute(0, 2, 3, 1).float()
        reg_maps = self.reg_sm_conv(t).permute(0, 2, 3, 1).float()
        pooled_cls = ps_roi_pool(cls_maps, rois, n_cls, self.k, self.paper_channel_layout)
        pooled_reg = ps_roi_pool(reg_maps, rois, 4, self.k, self.paper_channel_layout)
        c_hat = torch.softmax(pooled_cls.mean(dim=(-2, -1)), dim=-1)
        b_hat = pooled_reg.mean(dim=(-2, -1))
        return c_hat, b_hat
