"""the least time an NVIDIA H100 could take for each hand-written kernel of
the detector, from the operations and bytes its algorithm needs on these
inputs: each input byte read once, each output byte written once, and
data-dependent work as these inputs need it. A roofline share is this time
over the kernel's measured device time.

Copied from the port's chip smoke test (`chip_smoke.py`: `corr_bound_ms`,
`nms_bound_ms`, `psroi_fwd_bound_ms`, `_psroi_bin_pixels`) and made
self-contained: the IoU and the bin masks come from the benchmark's
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ops as ref_ops

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
# float32 operations of one IoU compare in greedy NMS: 4 corner
# subtractions, 2 clamps, the intersection, the union's add and
# subtraction, its sign test, the division and the threshold compare
NMS_IOU_FLOPS = 14


def _larger(t_bytes_ms: float, t_ops_ms: float):
    return max((t_bytes_ms, "bytes"), (t_ops_ms, "operations"))


def corr_bound_ms(b, h, w, c, d_max, itemsize, f32_math):
    """one correlation kernel, forward or one backward map: two (B, H, W, C)
    maps and the (2d+1)^2 f32 planes each move once, against the
    multiply-adds of the (2d)^2 planes that are not always zero."""
    k2 = (2 * d_max + 1) ** 2
    nbytes = 2 * b * h * w * c * itemsize + b * k2 * h * w * 4
    flops = 2.0 * b * h * w * c * (2 * d_max) ** 2
    peak = F32_FLOPS if f32_math else BF16_TENSOR_FLOPS
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3)


def nms_compares(boxes: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor, iou: float) -> int:
    """IoU compares a sequential greedy NMS makes on these inputs: each kept
    slot, in order, against every later slot still standing."""
    over = (ref_ops.ious(boxes, boxes) > iou).cpu().numpy()
    standing_all, kept = valid.cpu().numpy().copy(), keep.cpu().numpy()
    compares = 0
    for f in range(over.shape[0]):
        standing = standing_all[f]
        for i in np.flatnonzero(kept[f]):
            compares += int(standing[i + 1:].sum())
            standing[i + 1:] &= ~over[f, i, i + 1:]
    return compares


def nms_bound_ms(boxes, valid, keep, iou):
    """one greedy NMS call over (B, k, 4) boxes: its compares at the float32
    rate, against the boxes and the valid mask read once and the keep-mask
    written once."""
    t_ops = NMS_IOU_FLOPS * nms_compares(boxes, valid, keep, iou) / F32_FLOPS * 1e3
    t_bytes = (boxes.numel() * 4 + valid.numel() + keep.numel()) / HBM_BYTES_PER_S * 1e3
    return _larger(t_bytes, t_ops)


def bin_pixels(bounds: torch.Tensor, h: int, w: int):
    """bounds (B, R, 4, k) (rows i0, i1, j0, j1) -> pixels of each bin (B,
    R, k, k), 0 for an empty bin, and the row and column masks."""
    i0, i1, j0, j1 = bounds.unbind(2)
    rmask = ref_ops._masks(i0, i1, h)
    cmask = ref_ops._masks(j0, j1, w)
    numel = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :]).float()
    pixels = rmask.sum(-1)[..., :, None] * cmask.sum(-1)[..., None, :]
    return torch.where(numel > 0, pixels, torch.zeros_like(pixels)), rmask, cmask


def psroi_fwd_bound_ms(bounds, n_t, k, h, w):
    """PSROIPool's forward on bin-major maps: each map element some roi's
    bin holds read once (a bin (i, j) of target t reads its own channel),
    the outputs written once, the bounds read once; against an add per
    pixel of a non-empty bin and target and a division per output (f32)."""
    b, r = bounds.shape[:2]
    pixels, rmask, cmask = bin_pixels(bounds, h, w)
    cover = torch.einsum("brih,brjw->bijhw", rmask, cmask) > 0
    ops = float(pixels.sum()) * n_t + b * r * n_t * k * k
    nbytes = 4 * (int(cover.sum()) * n_t + b * r * n_t * k * k + bounds.numel())
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3)

