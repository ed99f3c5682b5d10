"""pointwise local correlation: the hand-written Hopper kernels and their
wrapper.

Semantics match reference pointwise_correlation_cuda.cu:63-111 (plain
version: torch_ref.pointwise_correlation_ref), including the truncated
+d_max row and column and the stride phase near the top/left boundary.

The kernels are built by nvcc at first use and called through ctypes on
PyTorch's current stream:
- `csrc/corr_fwd.cu`, the forward (port of the TPU kernel
  `detect_to_track_tpu/ops/correlation.py::_fwd_kernel`);
- `csrc/corr_bwd.cu`, the backward: `corr_bwd_fm0` (port of
  `_bwd_fm0_kernel`) and `corr_bwd_fm1` (port of both
  `_bwd_fm1_single_tile_kernel` and `_bwd_fm1_kernel`, for any height).
The maps' dtype picks the kernel: bf16 maps run the forward and both
backward gradients as banded products on the tensor cores (`mma.sync`, f32
sums); f32 maps run the CUDA-core kernels (f32 FMAs), because the f32 gate
of 1e-5 of the largest magnitude rules out bf16 tensor cores.
A CUDA tensor launches them or raises; only CPU tensors take the plain
version, whose autograd is the plain backward.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .torch_ref import pointwise_correlation_ref

# dynamic shared memory one block may use on Hopper (227 KB)
_MAX_SMEM_BYTES = 232448


def _corr_lib() -> ctypes.CDLL:
    lib = _build.load("corr_fwd")
    lib.d2t_corr_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.d2t_corr_fwd.restype = ctypes.c_int
    lib.d2t_corr_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.d2t_corr_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _corr_bwd_lib() -> ctypes.CDLL:
    lib = _build.load("corr_bwd")
    for fn in (lib.d2t_corr_bwd_fm0, lib.d2t_corr_bwd_fm1):
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    lib.d2t_corr_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.d2t_corr_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_maps(fm0: torch.Tensor, fm1: torch.Tensor, d_max: int, stride: int) -> None:
    """raise on what the kernels do not take: CPU tensors, mixed devices,
    dtypes other than f32 / bf16, unequal (B, H, W, C) maps, d or stride < 1."""
    if not (fm0.is_cuda and fm1.is_cuda):
        raise ValueError(
            f"the correlation kernel needs CUDA tensors, got {fm0.device} and {fm1.device}"
        )
    if fm0.device != fm1.device:
        raise ValueError(f"fm0/fm1 on different devices: {fm0.device} vs {fm1.device}")
    if fm0.dtype not in (torch.float32, torch.bfloat16) or fm1.dtype != fm0.dtype:
        raise ValueError(
            f"the correlation kernel takes float32 or bfloat16 maps of one dtype, "
            f"got {fm0.dtype} and {fm1.dtype}"
        )
    if fm0.dim() != 4 or fm0.shape != fm1.shape:
        raise ValueError(
            f"fm0/fm1 must be equal (B, H, W, C) maps, got {tuple(fm0.shape)} and {tuple(fm1.shape)}"
        )
    if d_max < 1 or stride < 1:
        raise ValueError(f"d_max and stride must be >= 1, got {d_max}, {stride}")


def _check_smem(smem: int, d_max: int) -> None:
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"d_max={d_max} needs {smem} bytes of shared memory per block, "
            f"more than the {_MAX_SMEM_BYTES} a Hopper block can use"
        )


def _tensor_core_map(fm: torch.Tensor) -> torch.Tensor:
    """a contiguous bf16 map as the tensor-core kernels stage it, in whole
    16-byte channel units: 16-byte aligned, C zero-padded to a multiple of 8
    (zeros add nothing to any sum). Copies only maps that are not so."""
    pad = -fm.shape[-1] % 8
    if pad:
        return torch.nn.functional.pad(fm, (0, pad))
    return fm.clone() if fm.data_ptr() % 16 else fm


def corr_fwd_cuda(fm0: torch.Tensor, fm1: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """launch the forward kernel: (B, H, W, C) bf16 (tensor cores) or f32
    (CUDA cores) CUDA tensors -> (B, (2d+1)^2, H, W) f32. Counts each launch
    in `corr_fwd_cuda.launches`."""
    _check_maps(fm0, fm1, d_max, stride)
    b, h, w, _ = fm0.shape
    k = 2 * d_max + 1
    is_bf16 = int(fm0.dtype == torch.bfloat16)
    lib = _corr_lib()
    _check_smem(lib.d2t_corr_fwd_smem_bytes(d_max, is_bf16), d_max)
    fm0 = fm0.contiguous()
    fm1 = fm1.contiguous()
    if is_bf16:
        fm0, fm1 = _tensor_core_map(fm0), _tensor_core_map(fm1)
    out = torch.empty((b, k * k, h, w), dtype=torch.float32, device=fm0.device)
    with torch.cuda.device(fm0.device):
        stream = torch.cuda.current_stream(fm0.device).cuda_stream
        err = lib.d2t_corr_fwd(
            fm0.data_ptr(), fm1.data_ptr(), out.data_ptr(),
            b, h, w, fm0.shape[-1], d_max, stride, is_bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {err}")
    corr_fwd_cuda.launches += 1
    return out


corr_fwd_cuda.launches = 0


def _corr_bwd_launch(fn_name: str, g: torch.Tensor, fm: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """one backward kernel: g (B, (2d+1)^2, H, W) and the other map fm
    (B, H, W, C) -> the gradient map, (B, H, W, C) in fm's dtype."""
    _check_maps(fm, fm, d_max, stride)
    b, h, w, c = fm.shape
    k = 2 * d_max + 1
    if not g.is_cuda or g.device != fm.device or g.shape != (b, k * k, h, w):
        raise ValueError(
            f"g must be a ({b}, {k * k}, {h}, {w}) tensor on {fm.device}, "
            f"got {tuple(g.shape)} on {g.device}"
        )
    is_bf16 = int(fm.dtype == torch.bfloat16)
    lib = _corr_bwd_lib()
    _check_smem(lib.d2t_corr_bwd_smem_bytes(d_max, is_bf16), d_max)
    g = g.to(torch.float32).contiguous()
    fm = fm.contiguous()
    if is_bf16:  # the tensor-core kernels
        fm = _tensor_core_map(fm)
    out = torch.empty_like(fm)
    with torch.cuda.device(fm.device):
        stream = torch.cuda.current_stream(fm.device).cuda_stream
        err = getattr(lib, fn_name)(
            g.data_ptr(), fm.data_ptr(), out.data_ptr(),
            b, h, w, fm.shape[-1], d_max, stride, is_bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"correlation backward kernel {fn_name} launch failed: CUDA error {err}")
    return out if out.shape[-1] == c else out[..., :c].contiguous()


def corr_bwd_fm0_cuda(g: torch.Tensor, fm1: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """launch the dFM0 kernel: the forward's cotangent g (B, (2d+1)^2, H, W)
    and fm1 (B, H, W, C), bf16 or f32 CUDA tensors -> dFM0 (B, H, W, C) in
    fm1's dtype (bf16 on the tensor cores, g rounded to bf16 as the TPU
    kernel does; f32 on the CUDA cores). Counts each launch in
    `corr_bwd_fm0_cuda.launches`."""
    out = _corr_bwd_launch("d2t_corr_bwd_fm0", g, fm1, d_max, stride)
    corr_bwd_fm0_cuda.launches += 1
    return out


corr_bwd_fm0_cuda.launches = 0


def corr_bwd_fm1_cuda(g: torch.Tensor, fm0: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """launch the dFM1 kernel: g and fm0 -> dFM1 (B, H, W, C) in fm0's dtype,
    for any H (bf16 on the tensor cores, g rounded to bf16 as the TPU kernel
    does; f32 on the CUDA cores). Counts each launch in
    `corr_bwd_fm1_cuda.launches`."""
    out = _corr_bwd_launch("d2t_corr_bwd_fm1", g, fm0, d_max, stride)
    corr_bwd_fm1_cuda.launches += 1
    return out


corr_bwd_fm1_cuda.launches = 0


def corr_bwd_fm0_ref(g: torch.Tensor, fm1: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """the plain version of corr_bwd_fm0_cuda: autograd through
    pointwise_correlation_ref (fm0's value does not enter dFM0)."""
    fm0 = torch.zeros_like(fm1, requires_grad=True)
    with torch.enable_grad():
        out = pointwise_correlation(fm0, fm1.detach(), d_max, stride, impl="torch", layout="k2hw")
        return torch.autograd.grad(out, fm0, g)[0]


def corr_bwd_fm1_ref(g: torch.Tensor, fm0: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """the plain version of corr_bwd_fm1_cuda (fm1's value does not enter
    dFM1)."""
    fm1 = torch.zeros_like(fm0, requires_grad=True)
    with torch.enable_grad():
        out = pointwise_correlation(fm0.detach(), fm1, d_max, stride, impl="torch", layout="k2hw")
        return torch.autograd.grad(out, fm1, g)[0]


class _CorrFunction(torch.autograd.Function):
    """the kernels as an autograd node (k2hw output): the forward kernel,
    and a backward that launches corr_bwd_fm0 / corr_bwd_fm1 for the inputs
    that need a gradient."""

    @staticmethod
    def forward(ctx, fm0, fm1, d_max, stride):
        fm0 = fm0.contiguous()
        fm1 = fm1.contiguous()
        ctx.save_for_backward(fm0, fm1)
        ctx.d_max, ctx.stride = d_max, stride
        return corr_fwd_cuda(fm0, fm1, d_max, stride)

    @staticmethod
    def backward(ctx, grad):
        fm0, fm1 = ctx.saved_tensors
        d_fm0 = d_fm1 = None
        if ctx.needs_input_grad[0]:
            d_fm0 = corr_bwd_fm0_cuda(grad, fm1, ctx.d_max, ctx.stride)
        if ctx.needs_input_grad[1]:
            d_fm1 = corr_bwd_fm1_cuda(grad, fm0, ctx.d_max, ctx.stride)
        return d_fm0, d_fm1, None, None


def pointwise_correlation(
    fm0: torch.Tensor,
    fm1: torch.Tensor,
    d_max: int,
    stride: int = 1,
    impl: str = "auto",
    layout: str = "nhwkk",
) -> torch.Tensor:
    """pointwise local correlation between two feature maps.

    Args:
        fm0, fm1: (B, H, W, C) feature maps at times t and t+tau (NHWC).
        d_max: maximum displacement.
        stride: displacement stride.
        impl: "auto" (the kernel for CUDA tensors, the plain version for
            CPU tensors), "cuda" (the kernel; raises on CPU tensors) or
            "torch" (the plain version, differentiable).
        layout: "nhwkk" -> (B, H, W, 2d+1, 2d+1), the reference layout;
            "k2hw" -> (B, (2d+1)^2, H, W), the kernel's own layout, which
            the tracker's fused head contracts without a transpose.

    Returns:
        f32 correlation volumes in the requested layout (f64 for f64 input
        on the plain version).
    """
    if fm0.dtype != fm1.dtype:
        raise ValueError(
            f"fm0/fm1 dtype mismatch: {fm0.dtype} vs {fm1.dtype} (the kernel "
            "stages both maps in one dtype)"
        )
    if layout not in ("nhwkk", "k2hw"):
        raise ValueError(f"unknown layout {layout!r}")
    if impl == "auto":
        impl = "cuda" if fm0.is_cuda else "torch"
    k = 2 * d_max + 1
    if impl == "torch":
        out = pointwise_correlation_ref(fm0, fm1, d_max, stride)
        if layout == "k2hw":
            b, h, w = out.shape[:3]
            out = out.reshape(b, h, w, k * k).permute(0, 3, 1, 2)
        return out
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r} (use 'auto', 'cuda' or 'torch')")
    out = _CorrFunction.apply(fm0, fm1, d_max, stride)  # (B, K2, H, W)
    if layout == "nhwkk":
        b, _, h, w = out.shape
        out = out.permute(0, 2, 3, 1).reshape(b, h, w, k, k)
    return out
