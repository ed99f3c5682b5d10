"""ROI pooling as separable mask contractions (port of the JAX package's
`ops/pooling.py`, `impl="einsum"`).

A bin average is a separable mask contraction

    out[r, i, j, c] = rmask[r, i, :] @ FM[:, :, c] @ cmask[r, j, :]^T / n

run as two batched matmuls, with no gathers or scatters; the backward is
more matmuls through autograd. Bin geometry and quirks follow torch_ref.
Every function takes one frame (fm (H, W, C), rois (R, 4)) or a batch of
frames (fm (B, H, W, C), rois (B, R, 4)).

The summed-area-table form (`impl="sat"`) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch

from .torch_ref import _bin_bounds, _float_type, _range_masks, ps_roi_pool_channel_map


def _check_impl(impl: str) -> None:
    if impl == "sat":
        raise NotImplementedError(
            "the summed-area-table pooling (impl='sat') is not ported yet "
            "(ROADMAP.md, port of ops/pooling.py); use impl='einsum'"
        )
    if impl != "einsum":
        raise ValueError(f"unknown impl {impl!r} (use 'einsum' or 'sat')")


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
    _, fm_h, fm_w, _ = fm.shape
    f = fm.to(_float_type(fm.dtype))
    rmask, cmask, numel = _masks(rois, r_hw, fm_h, fm_w, True, f.dtype)
    # contract the wider W first: the intermediate is (B, R, k, H, C)
    p1 = torch.einsum("brjw,bhwc->brjhc", cmask, f)
    sums = torch.einsum("brih,brjhc->brijc", rmask, p1)
    out = _average(sums, numel[..., None])
    return out[0] if squeeze else out


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
    _, fm_h, fm_w, _ = fm.shape
    f = fm.to(_float_type(fm.dtype))
    rmask, cmask, numel = _masks(rois, r_hw, fm_h, fm_w, False, f.dtype)
    # one static channel gather: (B, H, W, T, k, k) indexed by (t, i, j)
    fg = f[..., ps_roi_pool_channel_map(n_targets, r_hw, paper_layout, fm.device)]
    p1 = torch.einsum("brjw,bhwtij->brhtij", cmask, fg)
    sums = torch.einsum("brih,brhtij->brtij", rmask, p1)
    out = _average(sums, numel[:, :, None])
    return out[0] if squeeze else out
