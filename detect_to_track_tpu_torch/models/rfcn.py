"""R-FCN detection head (port of the JAX package's `models/rfcn.py`):
channel_reduce = 3x3 conv, dilation 6 -> 512 + ReLU; a classification and a
regression head, each a 1x1 conv to n_targets*k^2 position-sensitive score
maps -> PSROIPool -> mean over the k x k grid. Batched over frames.

The two 1x1 convs write their maps bin-major (channel (i k + j) T + t holds
target t of bin (i, j)), the layout PSROIPool's kernels read: each forward
gathers their weight and bias rows by the channel map
(`ops.pooling.BinMajorRows`), so the maps hold the same floats as the
reference's maps gathered by that map. The parameters, their keys and
their order stay the reference's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import BinMajorRows, psroi_bounds, psroi_fwd
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
        self.cls_rows = BinMajorRows(n_classes + 1, k, paper_channel_layout)
        self.reg_rows = BinMajorRows(4, k, paper_channel_layout)

    def forward(self, x: torch.Tensor, rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) c5 map; rois: (B, R, 4) fractional ijhw ->
        c_hat (B, R, n_classes+1) softmaxed, b_hat (B, R, 4)."""
        t = F.relu(self.channel_reduce(x.to(self.dtype).permute(0, 3, 1, 2)))
        bounds = psroi_bounds(rois, self.k, t.shape[2], t.shape[3])  # one set for both heads
        pooled_cls = self._pool(self.cls_sm_conv, self.cls_rows, t, bounds, self.n_classes + 1)
        pooled_reg = self._pool(self.reg_sm_conv, self.reg_rows, t, bounds, 4)
        c_hat = torch.softmax(pooled_cls.mean(dim=(-2, -1)), dim=-1)
        b_hat = pooled_reg.mean(dim=(-2, -1))
        return c_hat, b_hat

    @staticmethod
    def _pool(conv: nn.Conv2d, rows: BinMajorRows, t: torch.Tensor, bounds: torch.Tensor,
              n_targets: int) -> torch.Tensor:
        """conv's bin-major maps of t (channels-last: contiguous NHWC), then
        PSROIPool (the op d2t::psroi_fwd) -> (B, R, n_targets, k, k)."""
        weight, bias = rows(conv.weight, conv.bias)
        maps = F.conv2d(t, weight.to(t.dtype), bias.to(t.dtype)).permute(0, 2, 3, 1).float()
        return psroi_fwd(maps, bounds, n_targets)
