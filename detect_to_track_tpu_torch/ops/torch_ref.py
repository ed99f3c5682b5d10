"""plain PyTorch versions of the three native ops (transcription of the JAX
package's `ops/lax_ref.py`).

They pin the semantics of the reference CUDA kernels, quirks included, in
differentiable torch code that runs on any device. The CPU tests hold them
against the JAX oracles, and the hand-written kernels are held against them
on the card.

Replicated quirks:
- PSROIPool channel selector (t+1)*(i*k + j), not the paper's t*k^2 + i*k + j
  (reference ps_roipool_cuda.cu:58); `paper_layout=True` gives the latter.
- an empty bin pools to 0 in both poolings (the reference ROIPool divides by
  zero there);
- ROIPool clamps the roi's top-left corner to [0, 1] before laying out bins;
  PSROIPool does not;
- correlation: the +d_max displacement row and column stay zero, and for
  stride > 1 the displacement phase is counted from max(0, i - d).

Layout: feature maps are NHWC / HWC, channels last.
"""

from __future__ import annotations

import torch


def _float_type(dtype: torch.dtype) -> torch.dtype:
    """promote_types(dtype, float32): bf16/f16/f32 -> f32, f64 stays."""
    return torch.promote_types(dtype, torch.float32)


def _bin_bounds(rois: torch.Tensor, r_hw: int, fm_h: int, fm_w: int, clamp_corner: bool):
    """fractional ijhw rois (R, 4) -> integer bin bounds i0, i1, j0, j1, each
    (R, k) int32, with the floor/ceil-of-clamped-coordinate geometry of
    roipool_cuda.cu:38-50 / ps_roipool_cuda.cu:42-54."""
    r_i, r_j, r_h, r_w = rois.unbind(-1)
    b_h = (r_h / r_hw)[:, None]
    b_w = (r_w / r_hw)[:, None]

    top = r_i - r_h / 2
    left = r_j - r_w / 2
    if clamp_corner:  # ROIPool only
        top = top.clamp(0.0, 1.0)
        left = left.clamp(0.0, 1.0)

    steps = torch.arange(r_hw, dtype=rois.dtype, device=rois.device) + 0.5
    b_i = top[:, None] + steps[None, :] * b_h  # (R, k) bin centers
    b_j = left[:, None] + steps[None, :] * b_w

    # a bin edge exactly on a pixel boundary is nudged by eps so that it
    # floors and ceils the same way everywhere.
    eps = 1e-5
    i0 = torch.floor((b_i - b_h / 2).clamp(0.0, 1.0) * fm_h + eps).to(torch.int32)
    i1 = torch.ceil((b_i + b_h / 2).clamp(0.0, 1.0) * fm_h - eps).to(torch.int32)
    j0 = torch.floor((b_j - b_w / 2).clamp(0.0, 1.0) * fm_w + eps).to(torch.int32)
    j1 = torch.ceil((b_j + b_w / 2).clamp(0.0, 1.0) * fm_w - eps).to(torch.int32)
    return i0, i1, j0, j1


def _range_masks(i0: torch.Tensor, i1: torch.Tensor, size: int) -> torch.Tensor:
    """(..., k) int bounds -> (..., k, size) {0, 1} float32 membership masks."""
    p = torch.arange(size, device=i0.device)
    return ((p >= i0[..., None]) & (p < i1[..., None])).to(torch.float32)


def _bin_numel(i0, i1, j0, j1) -> torch.Tensor:
    """(R, k, k) float32 pixel count of each bin."""
    return ((i1 - i0)[:, :, None] * (j1 - j0)[:, None, :]).to(torch.float32)


def roi_pool_ref(fm: torch.Tensor, rois: torch.Tensor, r_hw: int) -> torch.Tensor:
    """average ROI pooling (reference roipool_cuda.cu:6-63).

    fm: (H, W, C); rois: (R, 4) fractional ijhw. Returns (R, k, k, C).
    """
    fm_h, fm_w, _ = fm.shape
    i0, i1, j0, j1 = _bin_bounds(rois, r_hw, fm_h, fm_w, clamp_corner=True)
    rmask = _range_masks(i0, i1, fm_h)  # (R, k, H)
    cmask = _range_masks(j0, j1, fm_w)  # (R, k, W)
    f = fm.to(_float_type(fm.dtype))
    sums = torch.einsum("rih,hwc,rjw->rijc", rmask.to(f.dtype), f, cmask.to(f.dtype))
    numel = _bin_numel(i0, i1, j0, j1)[..., None]
    return torch.where(numel > 0, sums / numel.clamp(min=1.0), torch.zeros_like(sums))


def ps_roi_pool_channel_map(n_targets: int, r_hw: int, paper_layout: bool, device=None) -> torch.Tensor:
    """(T, k, k) int64: (t, i, j) -> feature-map channel."""
    t = torch.arange(n_targets, device=device)[:, None, None]
    i = torch.arange(r_hw, device=device)[None, :, None]
    j = torch.arange(r_hw, device=device)[None, None, :]
    if paper_layout:
        return t * r_hw * r_hw + i * r_hw + j
    return (t + 1) * (i * r_hw + j)


def ps_roi_pool_ref(
    fm: torch.Tensor,
    rois: torch.Tensor,
    n_targets: int,
    r_hw: int,
    paper_layout: bool = False,
) -> torch.Tensor:
    """position-sensitive average ROI pooling (reference
    ps_roipool_cuda.cu:10-71).

    fm: (H, W, n_targets * k^2); rois: (R, 4). Returns (R, T, k, k).
    """
    fm_h, fm_w, _ = fm.shape
    i0, i1, j0, j1 = _bin_bounds(rois, r_hw, fm_h, fm_w, clamp_corner=False)
    rmask = _range_masks(i0, i1, fm_h)
    cmask = _range_masks(j0, j1, fm_w)
    ch = ps_roi_pool_channel_map(n_targets, r_hw, paper_layout, fm.device)
    f = fm.to(_float_type(fm.dtype))
    fg = f[:, :, ch]  # (H, W, T, k, k)
    sums = torch.einsum("rih,hwtij,rjw->rtij", rmask.to(f.dtype), fg, cmask.to(f.dtype))
    numel = _bin_numel(i0, i1, j0, j1)[:, None]
    return torch.where(numel > 0, sums / numel.clamp(min=1.0), torch.zeros_like(sums))


def correlation_window_masks(
    size: int, offset: int, d_max: int, stride: int, device=None
) -> torch.Tensor:
    """(size,) {0, 1} float32 mask over positions i for displacement offset
    o = ci - d_max (pointwise_correlation_cuda.cu:92-93):
    di in [max(0, i-d), min(i+d, size)) stepping by stride, di = i + o."""
    i = torch.arange(size, device=device)
    di = i + offset
    in_range = (di >= 0) & (di < size) & (di < i + d_max)  # excludes +d itself
    start = (i - d_max).clamp(min=0)
    on_phase = torch.remainder(di - start, stride) == 0
    return (in_range & on_phase & (di >= start)).to(torch.float32)


def pointwise_correlation_ref(
    fm0: torch.Tensor, fm1: torch.Tensor, d_max: int, stride: int = 1
) -> torch.Tensor:
    """pointwise local correlation (reference
    pointwise_correlation_cuda.cu:63-111).

    out[b, i, j, ci, cj] = <fm0[b, i, j, :], fm1[b, i+ci-d, j+cj-d, :]> over
    the truncated window (raw dot product, no 1/C).

    fm0, fm1: (B, H, W, C). Returns (B, H, W, 2d+1, 2d+1) in
    promote_types(dtype, float32).
    """
    b, h, w, _ = fm0.shape
    chw = 2 * d_max + 1
    dt = _float_type(fm0.dtype)
    f0 = fm0.to(dt)
    f1p = torch.nn.functional.pad(fm1.to(dt), (0, 0, d_max, d_max, d_max, d_max))
    dev = fm0.device

    planes = []
    for ci in range(chw):
        oi = ci - d_max
        rmask = correlation_window_masks(h, oi, d_max, stride, dev).to(dt)
        for cj in range(chw):
            oj = cj - d_max
            cmask = correlation_window_masks(w, oj, d_max, stride, dev).to(dt)
            shifted = f1p[:, d_max + oi : d_max + oi + h, d_max + oj : d_max + oj + w, :]
            val = (f0 * shifted).sum(-1)  # (B, H, W)
            planes.append(val * rmask[None, :, None] * cmask[None, None, :])
    out = torch.stack(planes, dim=-1)
    return out.reshape(b, h, w, chw, chw)
