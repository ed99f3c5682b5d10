"""ROI pooling (port of the JAX package's `ops/pooling.py`), in two forms,
and ROIPool's and PSROIPool's hand-written Hopper kernels.

A bin average is a separable mask contraction

    out[r, i, j, c] = rmask[r, i, :] @ FM[:, :, c] @ cmask[r, j, :]^T / n

run as two batched matmuls (`impl="einsum"`, the default), with no gathers
or scatters; the backward is more matmuls through autograd. `impl="sat"`
sums each bin from four corners of a summed-area table (gathers, and a
scatter in the backward): O(1) per bin whatever the roi's size. Bin
geometry and quirks follow torch_ref in both forms. Every function takes
one frame (fm (H, W, C), rois (R, 4)) or a batch of frames (fm (B, H, W,
C), rois (B, R, 4)).

PSROIPool's einsum form is the plain version of two CUDA kernels
(`csrc/psroi.cu`, built by nvcc at first use and called through ctypes),
the registered op `d2t::psroi_fwd` and its autograd formula `d2t::psroi_bwd`,
a deterministic backward with no atomics. The ops take bin-major maps:
channel (i k + j) T + t holds target t of bin (i, j) (`bin_major_channels`),
so a bin's targets are contiguous. The R-FCN's 1x1 convolutions write them
directly, their weight and bias rows gathered by `BinMajorRows`, whose
backward folds the gathered rows' gradient in a fixed order; `ps_roi_pool`
takes maps in the reference's channel layout and gathers their channels
first. On CUDA tensors the ops launch the kernels (float32 maps of any
strides; other dtypes raise); on CPU tensors they run their plain versions.
The ops take the bins' integer bounds, computed by torch_ref._bin_bounds on
the maps' device, so the kernels' geometry is bitwise the plain version's;
each op has a fake, so `torch.export` traces them.

ROIPool's einsum forms are the plain versions of `csrc/roipool.cu`, likewise
registered ops with autograd formulas: the tracker's fused pool-fc head
`roi_pool_linear` is `d2t::roipool_linear_fwd` / `d2t::roipool_linear_bwd`
(its map g (B, H, W, k, k, O) is bin-major with T = O: the forward sums
each roi's bin averages in the kernel, the roi's pixels split evenly over
the block; the backward is PSROIPool's with the cotangent broadcast over
the bins), and the materialized `roi_pool` is `d2t::roipool_fwd` /
`d2t::roipool_bwd` (every bin reads the same C channels). Their bounds
carry ROIPool's corner clamp.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
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
    i0, i1, j0, j1 = psroi_bounds(rois, r_hw, fm_h, fm_w, clamp_corner).long().unbind(2)
    numel = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :]).to(torch.float32)
    return i0, i1, j0, j1, numel


def _batched(fm: torch.Tensor, rois: torch.Tensor, frame_ndim: int):
    """add a frame axis to single-frame inputs (fm of frame_ndim dims);
    returns (fm, rois, squeeze)."""
    if fm.dim() == frame_ndim:
        return fm[None], rois[None], True
    return fm, rois, False


def _average(sums: torch.Tensor, numel: torch.Tensor) -> torch.Tensor:
    return torch.where(numel > 0, sums / numel.clamp(min=1.0), torch.zeros_like(sums))


def roi_pool(fm: torch.Tensor, rois: torch.Tensor, r_hw: int, impl: str = "einsum") -> torch.Tensor:
    """average ROI pooling (reference roipool_cuda.cu:6-63).

    fm: ([B,] H, W, C); rois: ([B,] R, 4) fractional ijhw (padding rows are
    fine: a roi with empty bins pools to zeros). Returns ([B,] R, k, k, C)
    in fm's float type. impl="einsum": the op `d2t::roipool_fwd` (its
    backward `d2t::roipool_bwd`) on the maps in their float type: the
    kernels for CUDA tensors (float32; bf16 and f16 maps are cast first,
    float64 ones raise), the plain einsum form for CPU tensors;
    impl="sat": the summed-area form on any device.
    """
    _check_impl(impl)
    fm, rois, squeeze = _batched(fm, rois, 3)
    if impl == "sat":
        out = _roi_pool_sat(fm, rois, r_hw)
        return out[0] if squeeze else out
    bounds = psroi_bounds(rois, r_hw, fm.shape[1], fm.shape[2], clamp_corner=True)
    out = roipool_fwd(fm.to(_float_type(fm.dtype)), bounds)
    return out[0] if squeeze else out


def roi_pool_plain(fm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """the plain version of roipool_fwd_cuda (the einsum form,
    differentiable): fm (B, H, W, C), bounds (B, R, 4, k) (psroi_bounds with
    the corner clamp) -> (B, R, k, k, C) in fm's float type."""
    _, fm_h, fm_w, _ = fm.shape
    f = fm.to(_float_type(fm.dtype))
    rmask, cmask, numel = _bounds_masks(bounds, fm_h, fm_w, f.dtype)
    # contract the wider W first: the intermediate is (B, R, k, H, C)
    p1 = torch.einsum("brjw,bhwc->brjhc", cmask, f)
    sums = torch.einsum("brih,brjhc->brijc", rmask, p1)
    return _average(sums, numel[..., None])


def roipool_bwd_ref(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    """the plain version of roipool_bwd_cuda: the adjoint of roi_pool_plain
    written out (the average's division, the two einsums transposed), g (B,
    R, k, k, C) -> dfm (B, H, W, C), contiguous, in g's float type."""
    gf = g.to(_float_type(g.dtype))
    rmask, cmask, numel = _bounds_masks(bounds, fm_h, fm_w, gf.dtype)
    numel = numel[..., None]
    dsums = torch.where(numel > 0, gf, torch.zeros_like(gf)) / numel.clamp(min=1.0)
    dp1 = torch.einsum("brih,brijc->brjhc", rmask, dsums)
    return torch.einsum("brjw,brjhc->bhwc", cmask, dp1).contiguous()


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
    channel axis contracts before pooling (the tracker's fused head). The op
    `d2t::roipool_linear_fwd` (its backward `d2t::roipool_linear_bwd`) on g
    in its float type: the kernels for CUDA tensors (float32; bf16 and f16
    maps are cast first, float64 ones raise), the plain einsum form for CPU
    tensors.

    g: ([B,] H, W, k, k, O); rois: ([B,] R, 4). Returns ([B,] R, O).
    """
    g, rois, squeeze = _batched(g, rois, 5)
    bounds = psroi_bounds(rois, r_hw, g.shape[1], g.shape[2], clamp_corner=True)
    out = roipool_linear_fwd(g.to(_float_type(g.dtype)), bounds)
    return out[0] if squeeze else out


def roi_pool_linear_plain(g: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """the plain version of roipool_linear_fwd_cuda (the einsum form,
    differentiable): g (B, H, W, k, k, O), bounds (B, R, 4, k) (psroi_bounds
    with the corner clamp) -> (B, R, O) in g's float type."""
    fm_h, fm_w = g.shape[1:3]
    gf = g.to(_float_type(g.dtype))
    rmask, cmask, numel = _bounds_masks(bounds, fm_h, fm_w, gf.dtype)
    t1 = torch.einsum("brjw,bhwijo->brhijo", cmask, gf)
    t2 = torch.einsum("brih,brhijo->brijo", rmask, t1)
    return _average(t2, numel[..., None]).sum(dim=(2, 3))


def roipool_linear_bwd_ref(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    """the plain version of roipool_linear_bwd_cuda: the adjoint of
    roi_pool_linear_plain, PSROIPool's (psroi_bwd_ref) with g broadcast
    over the bins: g (B, R, O) -> dg (B, H, W, k, k, O), contiguous, in g's
    float type."""
    b, r, o = g.shape
    k = bounds.shape[-1]
    dg = psroi_bwd_ref(g[..., None, None].expand(b, r, o, k, k), bounds, o, fm_h, fm_w)
    return dg.reshape(b, fm_h, fm_w, k, k, o)


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

    fm: ([B,] H, W, n_targets * k^2) score maps in the reference's channel
    layout; rois: ([B,] R, 4). paper_layout=False replicates the
    (t+1)*(i*k+j) channel quirk. impl="einsum": the maps' channels gathered
    bin-major (`bin_major_channels`; autograd's index backward, which adds
    with atomics on the card), then the op `d2t::psroi_fwd` (its backward
    `d2t::psroi_bwd`): the kernels for CUDA tensors, the plain einsum form
    for CPU tensors; impl="sat": the summed-area form on any device. The
    R-FCN does not come here: its convolutions write bin-major maps.
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
    fg = fm[..., bin_major_channels(n_targets, r_hw, paper_layout, fm.device)]
    out = psroi_fwd(fg, psroi_bounds(rois, r_hw, fm.shape[1], fm.shape[2]), n_targets)
    return out[0] if squeeze else out


def psroi_bounds(rois: torch.Tensor, r_hw: int, fm_h: int, fm_w: int, clamp_corner: bool = False) -> torch.Tensor:
    """rois (B, R, 4) -> bin bounds (B, R, 4, k) int32, rows i0, i1, j0, j1
    (torch_ref._bin_bounds; PSROIPool's geometry has no corner clamp,
    ROIPool's has)."""
    b, r = rois.shape[:2]
    bounds = _bin_bounds(rois.reshape(b * r, 4), r_hw, fm_h, fm_w, clamp_corner)
    return torch.stack(bounds, dim=1).reshape(b, r, 4, r_hw)


def _bounds_masks(bounds: torch.Tensor, fm_h: int, fm_w: int, dtype):
    """bounds (B, R, 4, k) -> rmask (B, R, k, H), cmask (B, R, k, W), numel
    (B, R, k, k) float32 (int32 products, as the kernels form them)."""
    i0, i1, j0, j1 = bounds.unbind(2)
    rmask = _range_masks(i0, i1, fm_h).to(dtype)
    cmask = _range_masks(j0, j1, fm_w).to(dtype)
    numel = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :]).to(torch.float32)
    return rmask, cmask, numel


def ps_roi_pool_plain(fg: torch.Tensor, bounds: torch.Tensor, n_targets: int) -> torch.Tensor:
    """the plain version of psroi_fwd_cuda (the einsum form, differentiable):
    bin-major fg (B, H, W, k^2 T), bounds (B, R, 4, k) -> (B, R, T, k, k) in
    fg's float type (f32, or f64)."""
    b, fm_h, fm_w, _ = fg.shape
    r_hw = bounds.shape[-1]
    f = fg.to(_float_type(fg.dtype)).reshape(b, fm_h, fm_w, r_hw, r_hw, n_targets).permute(0, 1, 2, 5, 3, 4)
    rmask, cmask, numel = _bounds_masks(bounds, fm_h, fm_w, f.dtype)
    p1 = torch.einsum("brjw,bhwtij->brhtij", cmask, f)
    sums = torch.einsum("brih,brhtij->brtij", rmask, p1)
    return _average(sums, numel[:, :, None])


def psroi_bwd_ref(g: torch.Tensor, bounds: torch.Tensor, n_targets: int, fm_h: int, fm_w: int) -> torch.Tensor:
    """the plain version of psroi_bwd_cuda: the adjoint of ps_roi_pool_plain
    written out (the average's division, the two einsums transposed), g (B,
    R, T, k, k) -> bin-major dfg (B, H, W, k^2 T), contiguous, in g's float
    type."""
    b, _, _, r_hw, _ = g.shape
    gf = g.to(_float_type(g.dtype))
    rmask, cmask, numel = _bounds_masks(bounds, fm_h, fm_w, gf.dtype)
    numel = numel[:, :, None]
    dsums = torch.where(numel > 0, gf, torch.zeros_like(gf)) / numel.clamp(min=1.0)
    dp1 = torch.einsum("brih,brtij->brhtij", rmask, dsums)
    dfg = torch.einsum("brjw,brhtij->bhwijt", cmask, dp1)
    return dfg.reshape(b, fm_h, fm_w, -1).contiguous()


def bin_major_channels(n_targets: int, r_hw: int, paper_layout: bool, device=None) -> torch.Tensor:
    """(T k^2,) int64: the reference-layout channel ch(t, i, j) that
    bin-major channel (i k + j) T + t holds, so fm[..., perm] is fm's
    bin-major maps."""
    return ps_roi_pool_channel_map(n_targets, r_hw, paper_layout, device).permute(1, 2, 0).reshape(-1)


def bin_major_fold(n_targets: int, r_hw: int, paper_layout: bool):
    """the tables of a bin-major row gather, int64 on the CPU: perm
    (bin_major_channels); rows, the reference channels some bin-major
    channel reads, ascending; fold (len(rows), D): for each such channel
    the bin-major channels that read it, ascending, padded with T k^2 (a
    zero row) to D, the largest count (31 for the class head's channel 0
    under the quirk; 1 under the paper's layout, a permutation)."""
    perm = bin_major_channels(n_targets, r_hw, paper_layout, "cpu")  # on the CPU under any default device
    c = perm.numel()
    counts = torch.bincount(perm, minlength=c)
    order = torch.argsort(perm, stable=True)  # bin-major channels grouped by the channel they read
    rank = torch.arange(c, device="cpu") - (counts.cumsum(0) - counts)[perm[order]]  # their places in a group
    fold = torch.full((c, int(counts.max())), c, dtype=torch.int64, device="cpu")
    fold[perm[order], rank] = order
    rows = torch.nonzero(counts).flatten()
    return perm, rows, fold[rows]


class _BinMajorRows(torch.autograd.Function):
    """a 1x1 convolution's weight (C, ...) and bias (C,) rows gathered by perm
    (index_select), whose backward folds the gradients of the rows that read
    one row in a fixed order: weight and bias side by side with a zero row
    below, a padded gather by fold and a sum over the padding axis, then
    each folded row copied once into place. No atomics, so bitwise the same
    on a repeat, on the card too (index_select's own backward, index_add_,
    adds with atomics there)."""

    @staticmethod
    def forward(ctx, weight, bias, perm, rows, fold):
        ctx.save_for_backward(rows, fold)
        ctx.weight_shape = weight.shape
        return weight.index_select(0, perm), bias.index_select(0, perm)

    @staticmethod
    def backward(ctx, g_weight, g_bias):
        rows, fold = ctx.saved_tensors
        g = F.pad(torch.cat([g_weight.reshape(g_weight.shape[0], -1), g_bias[:, None]], 1), (0, 0, 0, 1))
        folded = g.index_select(0, fold.reshape(-1)).unflatten(0, fold.shape).sum(1)
        dx = g.new_zeros((ctx.weight_shape[0], g.shape[1])).index_copy_(0, rows, folded)
        return dx[:, :-1].reshape(ctx.weight_shape), dx[:, -1], None, None, None


class BinMajorRows(torch.nn.Module):
    """gathers the rows of a 1x1 convolution's weight (T k^2, ...) and bias
    (T k^2,), in the reference's channel order, bin-major: a convolution
    with them writes the bin-major maps of the one with the originals, the
    same floats, which the ops take. The gradient of a row sums the
    gradients of the rows that read it (several under the quirk) in a fixed
    order. The tables are buffers that move with the module and stay out of
    its state_dict; a module built on the meta device and materialized with
    to_empty gets them back from reset_tables."""

    def __init__(self, n_targets: int, r_hw: int, paper_layout: bool) -> None:
        super().__init__()
        self.layout = n_targets, r_hw, paper_layout
        for name, table in zip(("perm", "rows", "fold"), bin_major_fold(*self.layout)):
            self.register_buffer(name, table, persistent=False)

    @torch.no_grad()
    def reset_tables(self) -> None:
        for name, table in zip(("perm", "rows", "fold"), bin_major_fold(*self.layout)):
            getattr(self, name).copy_(table)

    def forward(self, weight: torch.Tensor, bias: torch.Tensor):
        return _BinMajorRows.apply(weight, bias, self.perm, self.rows, self.fold)


# ---------------------------------------------------------------- the kernels


def _psroi_lib() -> ctypes.CDLL:
    lib = _build.load("psroi")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.d2t_psroi_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4 + [ptr]
    lib.d2t_psroi_fwd.restype = i32
    lib.d2t_psroi_bwd.argtypes = [ptr] + [i64] * 5 + [ptr] * 4 + [i32] * 6 + [ptr]
    lib.d2t_psroi_bwd.restype = i32
    lib.d2t_psroi_bwd_smem_bytes.argtypes = [i32] * 2
    lib.d2t_psroi_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.d2t_psroi_bwd_blocks_per_sm.argtypes = [i32] * 2
    lib.d2t_psroi_bwd_blocks_per_sm.restype = i32
    return lib


def _check_bounds(bounds: torch.Tensor, device: torch.device, b: int) -> int:
    """raise unless bounds is a contiguous (b, R, 4, k) int32 tensor on
    device with k in 1-32 (a bin mask is 32 bits); returns k."""
    if (bounds.device != device or bounds.dtype != torch.int32 or bounds.dim() != 4 or bounds.shape[0] != b
            or bounds.shape[2] != 4 or not 1 <= bounds.shape[3] <= 32 or not bounds.is_contiguous()):
        raise ValueError(f"expected contiguous ({b}, R, 4, k) int32 bin bounds on {device}, k 1-32; got "
                         f"{bounds.dtype} {tuple(bounds.shape)} on {bounds.device}")
    return bounds.shape[3]


def psroi_fwd_cuda(fg: torch.Tensor, bounds: torch.Tensor, n_targets: int) -> torch.Tensor:
    """launch the forward kernel: bin-major fg (B, H, W, k^2 T) float32 CUDA
    maps of any strides, bounds (B, R, 4, k) int32 -> (B, R, T, k, k)
    float32. Counts each launch in `psroi_fwd_cuda.launches`."""
    if not fg.is_cuda or fg.dtype != torch.float32 or fg.dim() != 4:
        raise ValueError(f"the PSROIPool kernel takes (B, H, W, C) float32 CUDA maps, got {fg.dtype} "
                         f"{tuple(fg.shape)} on {fg.device}")
    b, h, w, c = fg.shape
    k = _check_bounds(bounds, fg.device, b)
    if c != n_targets * k * k:
        raise ValueError(f"expected {n_targets * k * k} channels, got maps of shape {tuple(fg.shape)}")
    r = bounds.shape[1]
    out = torch.empty((b, r, n_targets, k, k), dtype=torch.float32, device=fg.device)
    with torch.cuda.device(fg.device):
        stream = torch.cuda.current_stream(fg.device).cuda_stream
        err = _psroi_lib().d2t_psroi_fwd(fg.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, r, n_targets, k, h, w,
                                         *fg.stride(), stream)
    if err != 0:
        raise RuntimeError(f"PSROIPool forward kernel launch failed: CUDA error {err}")
    psroi_fwd_cuda.launches += 1
    return out


psroi_fwd_cuda.launches = 0


def psroi_bwd_cuda(g: torch.Tensor, bounds: torch.Tensor, n_targets: int, fm_h: int, fm_w: int) -> torch.Tensor:
    """launch the backward (its prologue, then the kernel): the forward's
    cotangent g (B, R, T, k, k) float32 CUDA tensor of any strides and
    bounds (B, R, 4, k) int32 -> bin-major dfg (B, H, W, k^2 T) contiguous
    (the R-FCN's maps' layout), every element written. Deterministic:
    bitwise the same on a repeat. Counts each call in
    `psroi_bwd_cuda.launches`."""
    if not g.is_cuda or g.dtype != torch.float32 or g.dim() != 5:
        raise ValueError(f"the PSROIPool backward kernel takes a (B, R, T, k, k) float32 CUDA cotangent, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    b, r, t, k = g.shape[:4]
    if _check_bounds(bounds, g.device, b) != k or g.shape != (b, bounds.shape[1], n_targets, k, k):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match bounds {tuple(bounds.shape)} and "
                         f"{n_targets} targets")
    c = n_targets * k * k
    lib = _psroi_lib()
    if lib.d2t_psroi_bwd_smem_bytes(n_targets, k) == 0:
        raise ValueError(f"{c} channels do not fit a backward block's shared memory")
    dfg = torch.empty((b, fm_h, fm_w, c), dtype=torch.float32, device=g.device)
    scaled = torch.empty((b, r, k, k, n_targets), dtype=torch.float32, device=g.device)  # g / n, bin-major
    masks = torch.empty(b * (fm_h + fm_w) * r, dtype=torch.int32, device=g.device)  # the bins holding a row, a column
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.d2t_psroi_bwd(g.data_ptr(), *g.stride(), bounds.data_ptr(), scaled.data_ptr(), masks.data_ptr(),
                                dfg.data_ptr(), b, r, n_targets, k, fm_h, fm_w, stream)
    if err != 0:
        raise RuntimeError(f"PSROIPool backward kernel launch failed: CUDA error {err}")
    psroi_bwd_cuda.launches += 1
    return dfg


psroi_bwd_cuda.launches = 0


@torch.library.custom_op("d2t::psroi_fwd", mutates_args=(), device_types="cpu")
def psroi_fwd(fg: torch.Tensor, bounds: torch.Tensor, n_targets: int) -> torch.Tensor:
    """PSROIPool's forward, the op `d2t::psroi_fwd`: bin-major fg (B, H, W,
    k^2 T), bounds (B, R, 4, k) int32 (psroi_bounds) -> (B, R, T, k, k). The
    kernel for CUDA tensors (psroi_fwd_cuda), the plain einsum form for CPU
    tensors; its backward is `d2t::psroi_bwd`. Returns a contiguous tensor."""
    return ps_roi_pool_plain(fg, bounds, n_targets).contiguous()


psroi_fwd.register_kernel("cuda")(psroi_fwd_cuda)


@psroi_fwd.register_fake
def _psroi_fwd_fake(fg: torch.Tensor, bounds: torch.Tensor, n_targets: int) -> torch.Tensor:
    b, r, _, k = bounds.shape
    return fg.new_empty((b, r, n_targets, k, k), dtype=_float_type(fg.dtype))


@torch.library.custom_op("d2t::psroi_bwd", mutates_args=(), device_types="cpu")
def psroi_bwd(g: torch.Tensor, bounds: torch.Tensor, n_targets: int, fm_h: int, fm_w: int) -> torch.Tensor:
    """PSROIPool's backward, the op `d2t::psroi_bwd`: the cotangent g (B, R,
    T, k, k) -> bin-major dfg (B, H, W, k^2 T) contiguous, whatever the
    maps' strides (autograd takes a gradient in any layout). The kernel for
    CUDA tensors (psroi_bwd_cuda), psroi_bwd_ref for CPU tensors."""
    return psroi_bwd_ref(g, bounds, n_targets, fm_h, fm_w)


psroi_bwd.register_kernel("cuda")(psroi_bwd_cuda)


@psroi_bwd.register_fake
def _psroi_bwd_fake(g: torch.Tensor, bounds: torch.Tensor, n_targets: int, fm_h: int, fm_w: int) -> torch.Tensor:
    return g.new_empty((g.shape[0], fm_h, fm_w, n_targets * g.shape[-1] ** 2), dtype=_float_type(g.dtype))


def _psroi_setup_context(ctx, inputs, output) -> None:
    fg, bounds, n_targets = inputs
    ctx.save_for_backward(bounds)  # not fg: the backward does not read the maps
    ctx.n_targets = n_targets
    ctx.fm_hw = fg.shape[1], fg.shape[2]


def _psroi_backward(ctx, grad):
    (bounds,) = ctx.saved_tensors
    return psroi_bwd(grad, bounds, ctx.n_targets, *ctx.fm_hw), None, None


psroi_fwd.register_autograd(_psroi_backward, setup_context=_psroi_setup_context)


def _roipool_lib() -> ctypes.CDLL:
    lib = _build.load("roipool")
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.d2t_roipool_linear_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4 + [ptr]
    lib.d2t_roipool_linear_bwd.argtypes = [ptr] + [i64] * 3 + [ptr] * 4 + [i32] * 6 + [ptr]
    lib.d2t_roipool_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4 + [ptr]
    lib.d2t_roipool_bwd.argtypes = [ptr] + [i64] * 5 + [ptr] * 4 + [i32] * 6 + [ptr]
    for fn in (lib.d2t_roipool_linear_fwd, lib.d2t_roipool_linear_bwd, lib.d2t_roipool_fwd, lib.d2t_roipool_bwd):
        fn.restype = i32
    return lib


def _check_f32_cuda(x: torch.Tensor, ndim: int, what: str) -> None:
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != ndim:
        raise ValueError(f"the ROIPool kernel takes {what} as a {ndim}-d float32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _launched(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"ROIPool {what} kernel launch failed: CUDA error {err}")


def roipool_linear_fwd_cuda(g: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """launch the fused head's forward kernel: g (B, H, W, k, k, O) float32
    CUDA map (its (k, k, O) axes flattened to one strided axis: a view for
    the tracker's contiguous map, else a copy), bounds (B, R, 4, k) int32
    -> (B, R, O) float32. Counts each launch in
    `roipool_linear_fwd_cuda.launches`."""
    _check_f32_cuda(g, 6, "the projected map g (B, H, W, k, k, O)")
    b, h, w, k, _, o = g.shape
    if _check_bounds(bounds, g.device, b) != k or g.shape[4] != k:
        raise ValueError(f"map {tuple(g.shape)} does not match bounds {tuple(bounds.shape)}")
    gv = g.reshape(b, h, w, k * k * o)
    r = bounds.shape[1]
    out = torch.empty((b, r, o), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        _launched(_roipool_lib().d2t_roipool_linear_fwd(gv.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, r, o, k,
                                                        h, w, *gv.stride(), stream), "fused forward")
    roipool_linear_fwd_cuda.launches += 1
    return out


roipool_linear_fwd_cuda.launches = 0


def roipool_linear_bwd_cuda(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    """launch the fused head's backward (PSROIPool's prologue and
    pixel-major kernel, the cotangent broadcast over the bins): g (B, R, O)
    float32 CUDA cotangent of any strides, bounds (B, R, 4, k) int32 -> dg
    (B, H, W, k, k, O) contiguous, every element written; bitwise the same
    on a repeat. Counts each call in `roipool_linear_bwd_cuda.launches`."""
    _check_f32_cuda(g, 3, "the cotangent (B, R, O)")
    b, r, o = g.shape
    k = _check_bounds(bounds, g.device, b)
    if bounds.shape[1] != r:
        raise ValueError(f"cotangent {tuple(g.shape)} does not match bounds {tuple(bounds.shape)}")
    dg = torch.empty((b, fm_h, fm_w, k, k, o), dtype=torch.float32, device=g.device)
    scaled = torch.empty((b, r, k, k, o), dtype=torch.float32, device=g.device)  # g / n, bin-major
    masks = torch.empty(b * (fm_h + fm_w) * r, dtype=torch.int32, device=g.device)  # the bins holding a row, a column
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        _launched(_roipool_lib().d2t_roipool_linear_bwd(g.data_ptr(), *g.stride(), bounds.data_ptr(), scaled.data_ptr(),
                                                        masks.data_ptr(), dg.data_ptr(), b, r, o, k, fm_h, fm_w,
                                                        stream), "fused backward")
    roipool_linear_bwd_cuda.launches += 1
    return dg


roipool_linear_bwd_cuda.launches = 0


def roipool_fwd_cuda(fm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """launch the materialized forward kernel: fm (B, H, W, C) float32 CUDA
    maps of any strides, bounds (B, R, 4, k) int32 -> (B, R, k, k, C)
    float32. Counts each launch in `roipool_fwd_cuda.launches`."""
    _check_f32_cuda(fm, 4, "the maps (B, H, W, C)")
    b, h, w, c = fm.shape
    k = _check_bounds(bounds, fm.device, b)
    r = bounds.shape[1]
    out = torch.empty((b, r, k, k, c), dtype=torch.float32, device=fm.device)
    with torch.cuda.device(fm.device):
        stream = torch.cuda.current_stream(fm.device).cuda_stream
        _launched(_roipool_lib().d2t_roipool_fwd(fm.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, r, c, k, h, w,
                                                 *fm.stride(), stream), "forward")
    roipool_fwd_cuda.launches += 1
    return out


roipool_fwd_cuda.launches = 0


def roipool_bwd_cuda(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    """launch the materialized backward (its prologue, then the pixel-major
    kernel): g (B, R, k, k, C) float32 CUDA cotangent of any strides,
    bounds (B, R, 4, k) int32 -> dfm (B, H, W, C) contiguous, every element
    written; bitwise the same on a repeat. Counts each call in
    `roipool_bwd_cuda.launches`."""
    _check_f32_cuda(g, 5, "the cotangent (B, R, k, k, C)")
    b, r, k, _, c = g.shape
    if _check_bounds(bounds, g.device, b) != k or g.shape[:4] != (b, bounds.shape[1], k, k):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match bounds {tuple(bounds.shape)}")
    dfm = torch.empty((b, fm_h, fm_w, c), dtype=torch.float32, device=g.device)
    numel = torch.empty(b * r * k * k, dtype=torch.int32, device=g.device)  # each bin's n
    masks = torch.empty(b * (fm_h + fm_w) * r, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        _launched(_roipool_lib().d2t_roipool_bwd(g.data_ptr(), *g.stride(), bounds.data_ptr(), numel.data_ptr(),
                                                 masks.data_ptr(), dfm.data_ptr(), b, r, c, k, fm_h, fm_w, stream),
                  "backward")
    roipool_bwd_cuda.launches += 1
    return dfm


roipool_bwd_cuda.launches = 0


@torch.library.custom_op("d2t::roipool_linear_fwd", mutates_args=(), device_types="cpu")
def roipool_linear_fwd(g: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """the tracker's fused ROIPool head, the op `d2t::roipool_linear_fwd`: g
    (B, H, W, k, k, O), bounds (B, R, 4, k) int32 (psroi_bounds with the
    corner clamp) -> (B, R, O). The kernel for CUDA tensors
    (roipool_linear_fwd_cuda), the plain einsum form for CPU tensors; its
    backward is `d2t::roipool_linear_bwd`."""
    return roi_pool_linear_plain(g, bounds).contiguous()


roipool_linear_fwd.register_kernel("cuda")(roipool_linear_fwd_cuda)


@roipool_linear_fwd.register_fake
def _roipool_linear_fwd_fake(g: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    return g.new_empty((bounds.shape[0], bounds.shape[1], g.shape[-1]), dtype=_float_type(g.dtype))


@torch.library.custom_op("d2t::roipool_linear_bwd", mutates_args=(), device_types="cpu")
def roipool_linear_bwd(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    """the fused head's backward, the op `d2t::roipool_linear_bwd`: the
    cotangent g (B, R, O) -> dg (B, H, W, k, k, O) contiguous. The kernels
    for CUDA tensors (roipool_linear_bwd_cuda), roipool_linear_bwd_ref for
    CPU tensors."""
    return roipool_linear_bwd_ref(g, bounds, fm_h, fm_w)


roipool_linear_bwd.register_kernel("cuda")(roipool_linear_bwd_cuda)


@roipool_linear_bwd.register_fake
def _roipool_linear_bwd_fake(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    k = bounds.shape[-1]
    return g.new_empty((g.shape[0], fm_h, fm_w, k, k, g.shape[-1]), dtype=_float_type(g.dtype))


@torch.library.custom_op("d2t::roipool_fwd", mutates_args=(), device_types="cpu")
def roipool_fwd(fm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """ROIPool's forward, the op `d2t::roipool_fwd`: fm (B, H, W, C), bounds
    (B, R, 4, k) int32 (psroi_bounds with the corner clamp) -> (B, R, k, k,
    C). The kernel for CUDA tensors (roipool_fwd_cuda), the plain einsum
    form for CPU tensors; its backward is `d2t::roipool_bwd`."""
    return roi_pool_plain(fm, bounds).contiguous()


roipool_fwd.register_kernel("cuda")(roipool_fwd_cuda)


@roipool_fwd.register_fake
def _roipool_fwd_fake(fm: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    b, r, _, k = bounds.shape
    return fm.new_empty((b, r, k, k, fm.shape[-1]), dtype=_float_type(fm.dtype))


@torch.library.custom_op("d2t::roipool_bwd", mutates_args=(), device_types="cpu")
def roipool_bwd(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    """ROIPool's backward, the op `d2t::roipool_bwd`: the cotangent g (B, R,
    k, k, C) -> dfm (B, H, W, C) contiguous, whatever the maps' strides. The
    kernels for CUDA tensors (roipool_bwd_cuda), roipool_bwd_ref for CPU
    tensors."""
    return roipool_bwd_ref(g, bounds, fm_h, fm_w)


roipool_bwd.register_kernel("cuda")(roipool_bwd_cuda)


@roipool_bwd.register_fake
def _roipool_bwd_fake(g: torch.Tensor, bounds: torch.Tensor, fm_h: int, fm_w: int) -> torch.Tensor:
    return g.new_empty((g.shape[0], fm_h, fm_w, g.shape[-1]), dtype=_float_type(g.dtype))


def _roipool_setup_context(ctx, inputs, output) -> None:
    fm, bounds = inputs
    ctx.save_for_backward(bounds)  # not the map: the backwards do not read it
    ctx.fm_hw = fm.shape[1], fm.shape[2]


def _roipool_linear_backward(ctx, grad):
    (bounds,) = ctx.saved_tensors
    return roipool_linear_bwd(grad, bounds, *ctx.fm_hw), None


def _roipool_backward(ctx, grad):
    (bounds,) = ctx.saved_tensors
    return roipool_bwd(grad, bounds, *ctx.fm_hw), None


roipool_linear_fwd.register_autograd(_roipool_linear_backward, setup_context=_roipool_setup_context)
roipool_fwd.register_autograd(_roipool_backward, setup_context=_roipool_setup_context)


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
