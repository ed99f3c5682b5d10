"""serialized inference export (serving path).

Exports the batched pair-detection graph (backbone -> RPN -> NMS -> R-FCN
-> tracker, weights and anchors held in the program) with `torch.export`,
as a program that a serving process loads and runs without the model code.
Port of the JAX package's `export.py`.

The program calls the port's registered ops by name: on the card
`d2t::corr_fwd` (the correlation kernel) and `d2t::nms_mask` (the NMS
kernel), on the CPU `d2t::nms_mask` beside the plain correlation. A serving
process imports `detect_to_track_tpu_torch.ops` to register them; importing
this module does, and imports nothing of the models.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the d2t ops the program calls)
from .anchors import build_anchors
from .config import Config
from .utils import check_model_device, resolve_device

Device = Optional[Union[str, torch.device]]


class _PairDetector(torch.nn.Module):
    """detect_pairs_batched as a module: the model and the anchors (a
    buffer) are part of the exported program."""

    def __init__(self, model: torch.nn.Module, anchors: torch.Tensor, cfg: Config, device: torch.device) -> None:
        super().__init__()
        self.model = model
        self.register_buffer("anchors", anchors)
        self.cfg = cfg
        self.device = device

    def forward(self, images: torch.Tensor):
        from .inference import detect_pairs_batched

        return tuple(detect_pairs_batched(self.model, images, self.anchors, self.cfg, self.device))


def export_detector(
    model: torch.nn.Module,
    cfg: Config,
    path: str,
    pair_batch: int = 1,
    device: Device = None,
) -> None:
    """serialize the batched pair-detection graph to `path`.

    The exported function signature is images (P, 2, H, W, 3) float32 ->
    PairDetections tuple (confs, boxes, valid, tracks); weights and anchors
    are held in the program. Under cfg.HOST_S2D the input spec is the
    host pre-s2d layout (P, 2, H/2, W/2, 12) instead (the serving host
    applies utils.space_to_depth2 before the call, like Detector does).

    The program runs on the device it was exported on: `device`, cuda
    unless given, where the model must lie. The JAX function's `platforms`
    (lowering for other backends) has no counterpart: a program traced on
    the card holds the CUDA kernels' ops, one traced on the CPU the plain
    correlation.
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    anchors = torch.from_numpy(
        np.array(build_anchors(cfg.fm_shape, cfg.ANCHOR_AREAS, cfg.ANCHOR_ASPECT_RATIOS))
    ).to(dev)
    h, w = cfg.INPUT_SHAPE
    if cfg.HOST_S2D:
        shape = (pair_batch, 2, h // 2, w // 2, 12)
    else:
        shape = (pair_batch, 2, h, w, 3)
    program = torch.export.export(
        _PairDetector(model, anchors, cfg, dev), (torch.zeros(shape, device=dev),), strict=False
    )
    torch.export.save(program, path)


def load_detector(path: str, device: Device = None):
    """load an exported detector; returns a callable
    images (P, 2, H, W, 3) -> (confs, boxes, valid, tracks).

    `device` (cuda unless given) must be the one the program was exported
    on; it raises otherwise."""
    dev = resolve_device(device)
    program = torch.export.load(path)
    held = {t.device.type for t in program.state_dict.values()}
    if held != {dev.type}:
        raise ValueError(f"the program at {path} was exported on {sorted(held)}, not {dev.type}: it runs there only")
    module = program.module()

    def call(images):
        images = torch.as_tensor(images).to(dev)
        if not images.is_floating_point() and images.dtype != torch.bool:
            # the program was traced for float32 [0,1] inputs; the live
            # Detector's on-device uint8-normalize branch does NOT exist in
            # it, so a bare float cast would feed 0-255 values into a [0,1]
            # graph with no error. ANY integer dtype (uint8 frames, int32
            # decoded video) means 0-255 values.
            images = images.float() / 255.0
        with torch.inference_mode():
            return tuple(module(images.float()))

    return call
