"""small helpers: device choice, frame-pair split, image ingestion."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """the device an entry point runs on: `cuda` unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and there is
    none -- the port never drops to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU with the plain versions of its kernels"
        )
    return dev


def split_pairs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(2B, ...) interleaved frame pairs -> ((B, ...), (B, ...))."""
    r = x.reshape(x.shape[0] // 2, 2, *x.shape[1:])
    return r[:, 0], r[:, 1]


def image_to_input(
    im, net_input_shape: Union[int, Tuple[int, int]], as_uint8: bool = False
) -> np.ndarray:
    """PIL image -> (H, W, 3) network input: float32 in [0, 1], or the
    resized uint8 array itself (as_uint8=True; the /255 then runs on the
    device)."""
    from PIL import Image

    if isinstance(net_input_shape, int):
        net_input_shape = (net_input_shape, net_input_shape)
    h, w = net_input_shape
    im = im.convert("RGB").resize((w, h), Image.BILINEAR)
    if as_uint8:
        return np.asarray(im, np.uint8)
    return np.asarray(im, np.float32) / 255.0


def promote_mixed_image_dtypes(arrays):
    """bring a list of numpy arrays or tensors that mixes uint8 and float
    images to one dtype: uint8 entries become float32 / 255 (stacking raw
    would put 0-255 values into a float batch). A single-dtype list passes
    through, so uint8 stays uint8 for the device-side /255."""
    if len({a.dtype for a in arrays}) <= 1:
        return arrays
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(a.float() / 255.0 if a.dtype == torch.uint8 else a.float())
        else:
            out.append(
                a.astype(np.float32) / np.float32(255.0) if a.dtype == np.uint8 else a.astype(np.float32)
            )
    return out
