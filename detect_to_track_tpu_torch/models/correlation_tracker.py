"""correlation-based cross-frame tracking regressor (port of the JAX
package's `models/correlation_tracker.py`).

- correlation volumes at c3 (nearest-downsampled by 2 to c4's stride; an
  already-downsampled c3 is recognised by its shape and passed through),
  c4 and c5, each through ops.pointwise_correlation -- the hand-written
  kernel on the card;
- the reference concatenates [reg_fm_0, reg_fm_1, corr_c3, corr_c4,
  corr_c5], ROI-pools it, flattens in (C, k, k) order and applies one
  Linear -> 4 (fc_channels = (3*(2d+1)^2 + 2*reg_channels) * k^2).

fused_head=True (default) reorders that head: the Linear contracts into
each channel group first, G[h,w,i,j,o] += FM_g[h,w,c] . W_g[c,i,j,o], and
ops.roi_pool_linear pools the small G. The correlation volumes enter in the
kernel's own (K2, H, W) layout. fused_head=False is the materialized path,
kept as the oracle. With a bf16 compute dtype the products round their
inputs to bf16 and sum in f32, as the JAX package's
preferred_element_type=float32 does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops.correlation import pointwise_correlation
from ..ops.pooling import roi_pool, roi_pool_linear


class CorrelationTracker(nn.Module):
    """Args:
        d_max: maximum correlation displacement.
        r_hw: pooled map height and width.
        reg_channels: RPN feature channels (512).
        stride: correlation stride.
        corr_impl: forwarded to ops.pointwise_correlation ("auto", "cuda",
            "torch").
        fused_head: the reordered pool/fc contraction (module docstring).
    """

    def __init__(
        self,
        d_max: int = 8,
        r_hw: int = 7,
        reg_channels: int = 512,
        stride: int = 1,
        corr_impl: str = "auto",
        fused_head: bool = True,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.d_max = d_max
        self.r_hw = r_hw
        self.reg_channels = reg_channels
        self.stride = stride
        self.corr_impl = corr_impl
        self.fused_head = fused_head
        self.dtype = dtype
        self.reg_fc = nn.Linear(self.fc_channels, 4)

    @property
    def fc_channels(self) -> int:
        k2 = (2 * self.d_max + 1) ** 2
        return (3 * k2 + 2 * self.reg_channels) * self.r_hw**2

    def _corr(self, a: torch.Tensor, b: torch.Tensor, layout: str) -> torch.Tensor:
        return pointwise_correlation(a, b, self.d_max, self.stride, impl=self.corr_impl, layout=layout)

    def _rounded(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to the compute dtype, as float32 for the f32-summed
        products."""
        return x.to(self.dtype).float()

    def forward(
        self,
        fm_pyr_0: Dict[str, torch.Tensor],
        fm_pyr_1: Dict[str, torch.Tensor],
        reg_fm_0: torch.Tensor,
        reg_fm_1: torch.Tensor,
        rois: torch.Tensor,
    ) -> torch.Tensor:
        """
        Args:
            fm_pyr_0 / fm_pyr_1: {'c3', 'c4', 'c5'} NHWC pyramids of frames t
                and t+tau; c3 at c4's resolution or twice it.
            reg_fm_0 / reg_fm_1: (B, H, W, Cr) RPN features.
            rois: (B, R, 4) frame-0 rois.

        Returns:
            t_hat: (B, R, 4) f32 frame-0 -> frame-1 box transforms.
        """
        k2 = (2 * self.d_max + 1) ** 2
        khw = self.r_hw
        kernel = self.reg_fc.weight.t()  # (fc_channels, 4), rows (C, k, k)-major
        bias = self.reg_fc.bias

        if fm_pyr_0["c3"].shape[1:3] == fm_pyr_0["c4"].shape[1:3]:
            c3_0, c3_1 = fm_pyr_0["c3"], fm_pyr_1["c3"]
        else:
            c3_0 = fm_pyr_0["c3"][:, ::2, ::2, :]
            c3_1 = fm_pyr_1["c3"][:, ::2, ::2, :]

        if not self.fused_head:
            def corr_flat(a, b):
                out = self._corr(a, b, "nhwkk")
                return out.reshape(*out.shape[:3], k2)

            feats = torch.cat(
                [
                    reg_fm_0.float(),
                    reg_fm_1.float(),
                    corr_flat(c3_0, c3_1),
                    corr_flat(fm_pyr_0["c4"], fm_pyr_1["c4"]),
                    corr_flat(fm_pyr_0["c5"], fm_pyr_1["c5"]),
                ],
                dim=-1,
            )  # (B, H, W, 2*Cr + 3*(2d+1)^2)
            pooled = roi_pool(feats, rois, khw)  # (B, R, k, k, C)
            b, r = pooled.shape[:2]
            pooled = pooled.permute(0, 1, 4, 2, 3).reshape(b, r, -1)  # (C, k, k) order
            t_hat = pooled.to(self.dtype) @ kernel.to(self.dtype) + bias.to(self.dtype)
            return t_hat.float()

        # fused head: group c0's block of the fc weight is
        # kernel[c0*k^2 : (c0+C_g)*k^2]; the groups start at
        # 0, cr, 2cr, 2cr + k2, 2cr + 2*k2.
        cr = self.reg_channels

        def wslice(c0: int, c_g: int) -> torch.Tensor:
            w = kernel[c0 * khw * khw : (c0 + c_g) * khw * khw]
            return self._rounded(w.reshape(c_g, khw, khw, 4))

        def proj_nhwc(fm, c0):
            return torch.einsum("bhwc,cijo->bhwijo", self._rounded(fm), wslice(c0, fm.shape[-1]))

        def proj_corr(a, b, c0):
            vol = self._corr(a, b, "k2hw")  # (B, K2, H, W) f32
            return torch.einsum("bphw,pijo->bhwijo", self._rounded(vol), wslice(c0, k2))

        g = proj_nhwc(reg_fm_0, 0)
        g = g + proj_nhwc(reg_fm_1, cr)
        g = g + proj_corr(c3_0, c3_1, 2 * cr)
        g = g + proj_corr(fm_pyr_0["c4"], fm_pyr_1["c4"], 2 * cr + k2)
        g = g + proj_corr(fm_pyr_0["c5"], fm_pyr_1["c5"], 2 * cr + 2 * k2)
        # g: (B, H, W, k, k, 4) f32, the fc-projected pyramid
        return roi_pool_linear(g, rois, khw) + bias.float()
