"""pointwise local correlation: the hand-written Hopper kernel and its wrapper.

Semantics match reference pointwise_correlation_cuda.cu:63-111 (plain
version: torch_ref.pointwise_correlation_ref), including the truncated
+d_max row and column and the stride phase near the top/left boundary.

The forward runs as `csrc/corr_fwd.cu` (the port of the TPU kernel
`detect_to_track_tpu/ops/correlation.py::_fwd_kernel`), built by nvcc at
first use and called through ctypes on PyTorch's current stream. The
backward kernels (the TPU package's `_bwd_fm0_kernel`,
`_bwd_fm1_single_tile_kernel` and `_bwd_fm1_kernel`) come with the training
step; until then a backward through the kernel raises.
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
    lib.d2t_corr_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.d2t_corr_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def corr_fwd_cuda(fm0: torch.Tensor, fm1: torch.Tensor, d_max: int, stride: int) -> torch.Tensor:
    """launch the forward kernel: (B, H, W, C) bf16 or f32 CUDA tensors ->
    (B, (2d+1)^2, H, W) f32. Counts each launch in `corr_fwd_cuda.launches`."""
    if not (fm0.is_cuda and fm1.is_cuda):
        raise ValueError(
            f"the correlation kernel needs CUDA tensors, got {fm0.device} and {fm1.device}"
        )
    if fm0.device != fm1.device:
        raise ValueError(f"fm0/fm1 on different devices: {fm0.device} vs {fm1.device}")
    if fm0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the correlation kernel takes float32 or bfloat16, got {fm0.dtype}")
    if fm0.dim() != 4 or fm0.shape != fm1.shape:
        raise ValueError(
            f"fm0/fm1 must be equal (B, H, W, C) maps, got {tuple(fm0.shape)} and {tuple(fm1.shape)}"
        )
    if d_max < 1 or stride < 1:
        raise ValueError(f"d_max and stride must be >= 1, got {d_max}, {stride}")
    b, h, w, c = fm0.shape
    k = 2 * d_max + 1
    lib = _corr_lib()
    smem = lib.d2t_corr_fwd_smem_bytes(d_max)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"d_max={d_max} needs {smem} bytes of shared memory per block, "
            f"more than the {_MAX_SMEM_BYTES} a Hopper block can use"
        )
    fm0 = fm0.contiguous()
    fm1 = fm1.contiguous()
    out = torch.empty((b, k * k, h, w), dtype=torch.float32, device=fm0.device)
    with torch.cuda.device(fm0.device):
        stream = torch.cuda.current_stream(fm0.device).cuda_stream
        err = lib.d2t_corr_fwd(
            fm0.data_ptr(), fm1.data_ptr(), out.data_ptr(),
            b, h, w, c, d_max, stride, int(fm0.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"correlation kernel launch failed: CUDA error {err}")
    corr_fwd_cuda.launches += 1
    return out


corr_fwd_cuda.launches = 0


class _CorrFunction(torch.autograd.Function):
    """the kernel as an autograd node (k2hw output)."""

    @staticmethod
    def forward(ctx, fm0, fm1, d_max, stride):
        return corr_fwd_cuda(fm0, fm1, d_max, stride)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the correlation backward kernels (K2 _bwd_fm0_kernel, K3 "
            "_bwd_fm1_single_tile_kernel, K4 _bwd_fm1_kernel) are not ported "
            "yet; they come with the training step (ROADMAP.md)"
        )


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
