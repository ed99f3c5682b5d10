"""the DetectTrackModule container (port of the JAX package's
`models/detect_track.py`): backbone / rpn / rcnn / c_tracker in one module,
one state_dict. The forward composition lives in inference.py, as in the
reference, so calling the module directly raises. Its submodules
`backbone`, `rpn`, `rcnn` and `c_tracker` are the four stages; their names
prefix the state_dict keys as in the reference.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from ..utils import resolve_device
from .correlation_tracker import CorrelationTracker
from .resnet import FrozenBatchNorm, ResNetBackbone
from .rfcn import RFCN
from .rpn import RPN


class DetectTrackModule(nn.Module):
    # stage output channels (hardcoded in the reference too)
    stage4_outchannels = 1024
    stage5_outchannels = 2048
    rpn_channels = 512

    def __init__(
        self,
        backbone_arch: str = "resnet50",
        n_anchors: int = 15,
        n_classes: int = 30,
        k: int = 7,
        d_max: int = 8,
        r_hw: int = 7,
        paper_channel_layout: bool = False,
        corr_impl: str = "auto",
        tracker_fused_head: bool = True,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNetBackbone(arch=backbone_arch, dtype=dtype)
        self.rpn = RPN(n_anchors, self.stage4_outchannels, self.rpn_channels, dtype=dtype)
        self.rcnn = RFCN(
            n_classes,
            k=k,
            in_channels=self.stage5_outchannels,
            reduce_channels=self.rpn_channels,
            paper_channel_layout=paper_channel_layout,
            dtype=dtype,
        )
        self.c_tracker = CorrelationTracker(
            d_max=d_max,
            r_hw=r_hw,
            reg_channels=self.rpn_channels,
            corr_impl=corr_impl,
            fused_head=tracker_fused_head,
            dtype=dtype,
        )

    @classmethod
    def from_config(
        cls,
        cfg,
        device: Optional[Union[str, torch.device]] = None,
        seed: int = 0,
    ) -> "DetectTrackModule":
        """build the module for `cfg` on `device` (cuda unless given), with
        random weights drawn from a torch.Generator seeded by `seed`
        (lecun-normal kernels, zero biases, identity FrozenBatchNorm, as the
        JAX package initializes). Load trained weights with
        `load_state_dict` afterwards."""
        if cfg.HOST_S2D:
            raise NotImplementedError(
                "HOST_S2D (the 12-channel space-to-depth stem) is not ported yet (ROADMAP.md)"
            )
        dev = resolve_device(device)
        with torch.device("meta"):
            model = cls(
                backbone_arch=cfg.BACKBONE_ARCH,
                n_anchors=cfg.n_anchors_per_cell,
                n_classes=cfg.N_CLASSES,
                k=cfg.K,
                d_max=cfg.D_MAX,
                r_hw=cfg.K,
                paper_channel_layout=cfg.FIX_PSROI_CHANNEL_MAP,
                dtype=cfg.compute_dtype,
            )
        model = model.to_empty(device="cpu")
        init_weights_(model, torch.Generator().manual_seed(seed))
        return model.to(dev)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "DetectTrackModule has no single forward; use inference.detect_pairs_batched "
            "or its backbone / rpn / rcnn / c_tracker submodules"
        )


def init_weights_(model: nn.Module, gen: torch.Generator) -> None:
    """lecun-normal (std 1/sqrt(fan_in)) conv and linear weights, zero
    biases, identity FrozenBatchNorm; all draws from `gen`."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in**-0.5, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
