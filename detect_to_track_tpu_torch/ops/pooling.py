"""ROI pooling (port of the JAX package's `ops/pooling.py`), in two forms.

A bin average is a separable mask contraction

    out[r, i, j, c] = rmask[r, i, :] @ FM[:, :, c] @ cmask[r, j, :]^T / n

run as two batched matmuls (`impl="einsum"`, the default), with no gathers
or scatters; the backward is more matmuls through autograd. `impl="sat"`
sums each bin from four corners of a summed-area table (gathers, and a
scatter in the backward): O(1) per bin whatever the roi's size. Bin
geometry and quirks follow torch_ref in both forms. Every function takes
one frame (fm (H, W, C), rois (R, 4)) or a batch of frames (fm (B, H, W,
C), rois (B, R, 4)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .torch_ref import _bin_bounds, _float_type, _range_masks, ps_roi_pool_channel_map


def _check_impl(impl: str) -> None:
    if impl not in ("einsum", "sat"):
        raise ValueError(f"unknown impl {impl!r} (use 'einsum' or 'sat')")


def _sat(fm: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H+1, W+1, C) inclusive summed-area table in f32
    (or wider) with a zero top row and left column."""
    s = fm.to(_float_type(fm.dtype)).cumsum(1).cumsum(2)
    return F.pad(s, (0, 0, 1, 0, 1, 0))


def _sat_bounds(rois: torch.Tensor, r_hw: int, fm_h: int, fm_w: int, clamp_corner: bool):
    """rois (B, R, 4) -> i0, i1, j0, j1 as (B, R, k) int64 and the bins'
    pixel counts (B, R, k, k)."""
    b, r = rois.shape[:2]
    bounds = _bin_bounds(rois.reshape(b * r, 4), r_hw, fm_h, fm_w, clamp_corner)
    i0, i1, j0, j1 = (t.long().reshape(b, r, r_hw) for t in bounds)
    numel = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :]).to(torch.float32)
    return i0, i1, j0, j1, numel


def _batched(fm: torch.Tensor, rois: torch.Tensor, frame_ndim: int):
    """add a frame axis to single-frame inputs (fm of frame_ndim dims);
    returns (fm, rois, squeeze)."""
    if fm.dim() == frame_ndim:
        return fm[None], rois[None], True
    return fm, rois, False


def _masks(rois: torch.Tensor, r_hw: int, fm_h: int, fm_w: int, clamp_corner: bool, dtype):
    """rois (B, R, 4) -> rmask (B, R, k, H), cmask (B, R, k, W), numel
    (B, R, k, k)."""
    b, r = rois.shape[:2]
    i0, i1, j0, j1 = _bin_bounds(rois.reshape(b * r, 4), r_hw, fm_h, fm_w, clamp_corner)
    rmask = _range_masks(i0, i1, fm_h).reshape(b, r, r_hw, fm_h).to(dtype)
    cmask = _range_masks(j0, j1, fm_w).reshape(b, r, r_hw, fm_w).to(dtype)
    numel = ((i1 - i0)[:, :, None] * (j1 - j0)[:, None, :]).to(torch.float32)
    return rmask, cmask, numel.reshape(b, r, r_hw, r_hw)


def _average(sums: torch.Tensor, numel: torch.Tensor) -> torch.Tensor:
    return torch.where(numel > 0, sums / numel.clamp(min=1.0), torch.zeros_like(sums))


def roi_pool(fm: torch.Tensor, rois: torch.Tensor, r_hw: int, impl: str = "einsum") -> torch.Tensor:
    """average ROI pooling (reference roipool_cuda.cu:6-63).

    fm: ([B,] H, W, C); rois: ([B,] R, 4) fractional ijhw (padding rows are
    fine: a roi with empty bins pools to zeros). Returns ([B,] R, k, k, C).
    """
    _check_impl(impl)
    fm, rois, squeeze = _batched(fm, rois, 3)
    if impl == "sat":
        out = _roi_pool_sat(fm, rois, r_hw)
        return out[0] if squeeze else out
    _, fm_h, fm_w, _ = fm.shape
    f = fm.to(_float_type(fm.dtype))
    rmask, cmask, numel = _masks(rois, r_hw, fm_h, fm_w, True, f.dtype)
    # contract the wider W first: the intermediate is (B, R, k, H, C)
    p1 = torch.einsum("brjw,bhwc->brjhc", cmask, f)
    sums = torch.einsum("brih,brjhc->brijc", rmask, p1)
    out = _average(sums, numel[..., None])
    return out[0] if squeeze else out


def _roi_pool_sat(fm: torch.Tensor, rois: torch.Tensor, r_hw: int) -> torch.Tensor:
    b, fm_h, fm_w, c = fm.shape
    i0, i1, j0, j1, numel = _sat_bounds(rois, r_hw, fm_h, fm_w, True)
    s = _sat(fm).reshape(b, (fm_h + 1) * (fm_w + 1), c)
    bi = torch.arange(b, device=fm.device)[:, None, None, None]

    def corner(i, j):  # (B, R, k), (B, R, k) -> (B, R, k, k, C)
        return s[bi, i[..., :, None] * (fm_w + 1) + j[..., None, :]]

    sums = corner(i1, j1) - corner(i0, j1) - corner(i1, j0) + corner(i0, j0)
    return _average(sums, numel[..., None])


def roi_pool_linear(g: torch.Tensor, rois: torch.Tensor, r_hw: int) -> torch.Tensor:
    """ROI-pool a pre-projected map: the exact reordering of
    `flatten(roi_pool(fm, rois, k), (C, k, k) order) @ W` with
    `g[h, w, i, j, o] = sum_c fm[h, w, c] * W[c*k*k + i*k + j, o]`.

    Both the bin average and the linear head are linear, so the wide
    channel axis contracts before pooling (the tracker's fused head).

    g: ([B,] H, W, k, k, O); rois: ([B,] R, 4). Returns ([B,] R, O).
    """
    g, rois, squeeze = _batched(g, rois, 5)
    fm_h, fm_w = g.shape[1:3]
    gf = g.to(_float_type(g.dtype))
    rmask, cmask, numel = _masks(rois, r_hw, fm_h, fm_w, True, gf.dtype)
    t1 = torch.einsum("brjw,bhwijo->brhijo", cmask, gf)
    t2 = torch.einsum("brih,brhijo->brijo", rmask, t1)
    out = _average(t2, numel[..., None]).sum(dim=(2, 3))
    return out[0] if squeeze else out


def ps_roi_pool(
    fm: torch.Tensor,
    rois: torch.Tensor,
    n_targets: int,
    r_hw: int,
    paper_layout: bool = False,
    impl: str = "einsum",
) -> torch.Tensor:
    """position-sensitive average ROI pooling (reference
    ps_roipool_cuda.cu:10-71).

    fm: ([B,] H, W, n_targets * k^2) score maps; rois: ([B,] R, 4).
    paper_layout=False replicates the (t+1)*(i*k+j) channel quirk.
    Returns ([B,] R, n_targets, k, k).
    """
    if fm.shape[-1] != n_targets * r_hw * r_hw:
        raise ValueError(
            f"expected {n_targets * r_hw ** 2} channels, got feature map "
            f"of shape {tuple(fm.shape)}"
        )
    _check_impl(impl)
    fm, rois, squeeze = _batched(fm, rois, 3)
    if impl == "sat":
        out = _ps_roi_pool_sat(fm, rois, n_targets, r_hw, paper_layout)
        return out[0] if squeeze else out
    _, fm_h, fm_w, _ = fm.shape
    f = fm.to(_float_type(fm.dtype))
    rmask, cmask, numel = _masks(rois, r_hw, fm_h, fm_w, False, f.dtype)
    # one static channel gather: (B, H, W, T, k, k) indexed by (t, i, j)
    fg = f[..., ps_roi_pool_channel_map(n_targets, r_hw, paper_layout, fm.device)]
    p1 = torch.einsum("brjw,bhwtij->brhtij", cmask, fg)
    sums = torch.einsum("brih,brhtij->brtij", rmask, p1)
    out = _average(sums, numel[:, :, None])
    return out[0] if squeeze else out


def _ps_roi_pool_sat(fm, rois, n_targets: int, r_hw: int, paper_layout: bool) -> torch.Tensor:
    b, fm_h, fm_w, c = fm.shape
    i0, i1, j0, j1, numel = _sat_bounds(rois, r_hw, fm_h, fm_w, False)
    s = _sat(fm).reshape(b, -1)  # (B, (H+1) * (W+1) * C)
    ch = ps_roi_pool_channel_map(n_targets, r_hw, paper_layout, fm.device)  # (T, k, k)
    bi = torch.arange(b, device=fm.device)[:, None, None, None, None]

    def corner(i, j):  # output element (b, r, t, i, j) reads row i, column j, channel ch[t, i, j]
        rows = i[:, :, None, :, None]
        cols = j[:, :, None, None, :]
        return s[bi, (rows * (fm_w + 1) + cols) * c + ch]

    sums = corner(i1, j1) - corner(i0, j1) - corner(i1, j0) + corner(i0, j0)  # (B, R, T, k, k)
    return _average(sums, numel[:, :, None])
