"""the port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports no JAX and uses no conftest fixture, so it also runs on a GPU
machine that has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from detect_to_track_tpu_torch.ops import correlation

pytestmark = pytest.mark.gpu

# (B, H, W, C, d_max, stride, dtype)
CORR_CASES = [
    (2, 38, 75, 384, 8, 1, torch.float32),  # the tracker's map, C past a chunk multiple
    (2, 38, 75, 384, 8, 2, torch.bfloat16),
    (2, 38, 75, 5, 2, 1, torch.float32),
    (1, 5, 7, 3, 8, 1, torch.float32),  # map smaller than the window
    (3, 17, 40, 33, 3, 3, torch.bfloat16),  # stride 3, C not a multiple of 16
    (1, 20, 33, 64, 12, 1, torch.float32),  # wider window: more warps per block
    (1, 9, 64, 16, 1, 1, torch.float32),  # d_max 1: one warp
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _maps(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype) for _ in range(2)]


def _assert_matches_plain(got, fm0, fm1, d_max, stride, layout):
    """the kernel and the plain version sum the same f32 products (bf16
    products are exact in f32) in another order: f32 rounding of a C-term
    sum, relative to the largest magnitude."""
    ref = correlation.pointwise_correlation(fm0, fm1, d_max, stride, impl="torch", layout=layout)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item() + 1e-6)


@pytest.mark.parametrize("case", CORR_CASES, ids=str)
def test_correlation_kernel_matches_plain(cuda, case):
    b, h, w, c, d_max, stride, dtype = case
    fm0, fm1 = _maps((b, h, w, c), dtype, cuda)
    before = correlation.corr_fwd_cuda.launches
    got = correlation.pointwise_correlation(fm0, fm1, d_max, stride, impl="cuda", layout="k2hw")
    torch.cuda.synchronize()
    assert correlation.corr_fwd_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, (2 * d_max + 1) ** 2, h, w)
    _assert_matches_plain(got, fm0, fm1, d_max, stride, "k2hw")


def test_correlation_wrapper_on_card(cuda):
    """"auto" launches the kernel for CUDA tensors, strided inputs (the
    tracker's c3 slice) are taken, the nhwkk layout matches, and a backward
    through the kernel raises instead of falling back."""
    x0, x1 = _maps((2, 20, 30, 64), torch.bfloat16, cuda, seed=1)
    fm0, fm1 = x0[:, ::2, ::2], x1[:, ::2, ::2]
    before = correlation.corr_fwd_cuda.launches
    got = correlation.pointwise_correlation(fm0, fm1, 4)
    torch.cuda.synchronize()
    assert correlation.corr_fwd_cuda.launches == before + 1
    _assert_matches_plain(got, fm0, fm1, 4, 1, "nhwkk")
    leaf = fm0.float().requires_grad_()
    out = correlation.pointwise_correlation(leaf, fm1.float(), 4, impl="cuda")
    with pytest.raises(NotImplementedError, match="K2"):
        out.sum().backward()
