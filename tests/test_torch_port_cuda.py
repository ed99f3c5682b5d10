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

# (B, H, W, C, d_max, stride); each runs in bf16 (tensor-core kernels) and
# f32 (CUDA-core kernels)
CORR_CASES = [
    (2, 38, 75, 384, 8, 1),  # the tracker's map, C past a chunk multiple
    (2, 38, 75, 384, 8, 2),
    (2, 38, 75, 5, 2, 1),  # C not a multiple of 8: scalar staging
    (1, 5, 7, 3, 8, 1),  # map smaller than the window
    (3, 17, 40, 33, 3, 3),  # stride 3, C not a multiple of 16
    (1, 20, 33, 64, 12, 1),  # wider window: more warps per block
    (1, 9, 64, 16, 1, 1),  # d_max 1: one warp
]
DTYPES = [torch.bfloat16, torch.float32]


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
    products are exact in f32; the tensor cores' f32 accumulation included)
    in another order: f32 rounding of a C-term sum, relative to the largest
    magnitude."""
    ref = correlation.pointwise_correlation(fm0, fm1, d_max, stride, impl="torch", layout=layout)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item() + 1e-6)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", CORR_CASES, ids=str)
def test_correlation_kernel_matches_plain(cuda, case, dtype):
    b, h, w, c, d_max, stride = case
    fm0, fm1 = _maps((b, h, w, c), dtype, cuda)
    before = correlation.corr_fwd_cuda.launches
    got = correlation.pointwise_correlation(fm0, fm1, d_max, stride, impl="cuda", layout="k2hw")
    torch.cuda.synchronize()
    assert correlation.corr_fwd_cuda.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (b, (2 * d_max + 1) ** 2, h, w)
    _assert_matches_plain(got, fm0, fm1, d_max, stride, "k2hw")


def test_correlation_wrapper_on_card(cuda):
    """"auto" launches the kernel for CUDA tensors, strided inputs (the
    tracker's c3 slice) are taken and the nhwkk layout matches."""
    x0, x1 = _maps((2, 20, 30, 64), torch.bfloat16, cuda, seed=1)
    fm0, fm1 = x0[:, ::2, ::2], x1[:, ::2, ::2]
    before = correlation.corr_fwd_cuda.launches
    got = correlation.pointwise_correlation(fm0, fm1, 4)
    torch.cuda.synchronize()
    assert correlation.corr_fwd_cuda.launches == before + 1
    _assert_matches_plain(got, fm0, fm1, 4, 1, "nhwkk")


# the forward's cases plus H = 48, the height the TPU package runs through
# its halo'd multi-tile dFM1 kernel (K4), and d_max 20, the widest band (KS
# = 4) of the bf16 backward kernels (bf16 K1 refuses d_max >= 20)
BWD_CASES = CORR_CASES + [(2, 48, 75, 384, 8, 1), (1, 48, 40, 64, 8, 2), (1, 20, 45, 40, 20, 1)]


def _assert_grad_matches_plain(got, ref):
    """f32: both sum the same f32 products in another order, tolerance
    1e-5 of the largest magnitude. bf16: each rounds its f32 sum to bf16
    once, so they may differ by one bf16 rounding (2^-8 relative), and both
    tensor-core backward kernels round g to bf16 as the TPU kernels do (2^-9
    per term, ~1e-3 of the largest magnitude over a sum): 8e-3 of the
    largest magnitude."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    scale = ref.float().abs().max().item()
    rel = 8e-3 if ref.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=rel * scale + 1e-6)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_correlation_backward_kernels_match_plain(cuda, case, dtype):
    b, h, w, c, d_max, stride = case
    fm0, fm1 = _maps((b, h, w, c), dtype, cuda)
    k2 = (2 * d_max + 1) ** 2
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((b, k2, h, w), dtype=np.float32)).to(cuda)
    n0, n1 = correlation.corr_bwd_fm0_cuda.launches, correlation.corr_bwd_fm1_cuda.launches
    got0 = correlation.corr_bwd_fm0_cuda(g, fm1, d_max, stride)
    got1 = correlation.corr_bwd_fm1_cuda(g, fm0, d_max, stride)
    torch.cuda.synchronize()
    assert (correlation.corr_bwd_fm0_cuda.launches, correlation.corr_bwd_fm1_cuda.launches) == (n0 + 1, n1 + 1)
    _assert_grad_matches_plain(got0, correlation.corr_bwd_fm0_ref(g, fm1, d_max, stride))
    _assert_grad_matches_plain(got1, correlation.corr_bwd_fm1_ref(g, fm0, d_max, stride))


def test_correlation_backward_through_autograd(cuda):
    """a backward through the kernel launches one backward kernel per input
    that needs a gradient, takes the strided c3 view, and gives each input's
    dtype and shape: both inputs, then fm1 alone, then fm0 alone."""
    x0, x1 = _maps((2, 24, 40, 96), torch.bfloat16, cuda, seed=3)
    d_max = 4
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 12, 20, 81), dtype=np.float32)).to(cuda)
    g = g.permute(0, 2, 3, 1).reshape(2, 12, 20, 9, 9)  # a non-contiguous nhwkk cotangent
    for need0, need1 in ((True, True), (False, True), (True, False)):
        fm0 = x0[:, ::2, ::2].detach().requires_grad_(need0)
        fm1 = x1[:, ::2, ::2].detach().requires_grad_(need1)
        n0, n1 = correlation.corr_bwd_fm0_cuda.launches, correlation.corr_bwd_fm1_cuda.launches
        out = correlation.pointwise_correlation(fm0, fm1, d_max)
        grads = torch.autograd.grad(out, [t for t in (fm0, fm1) if t.requires_grad], g)
        torch.cuda.synchronize()
        assert correlation.corr_bwd_fm0_cuda.launches == n0 + need0
        assert correlation.corr_bwd_fm1_cuda.launches == n1 + need1
        ref_inputs = [t.detach().requires_grad_(t.requires_grad) for t in (fm0, fm1)]
        ref_out = correlation.pointwise_correlation(*ref_inputs, d_max, impl="torch")
        refs = torch.autograd.grad(ref_out, [t for t in ref_inputs if t.requires_grad], g)
        for got, ref, src in zip(grads, refs, [t for t in (fm0, fm1) if t.requires_grad]):
            assert got.dtype == src.dtype and got.shape == src.shape
            _assert_grad_matches_plain(got, ref)


def test_correlation_backward_rejects_bad_input(cuda):
    fm = torch.zeros(1, 4, 5, 3, device=cuda)
    with pytest.raises(ValueError, match="g must be"):
        correlation.corr_bwd_fm0_cuda(torch.zeros(1, 9, 4, 4, device=cuda), fm, 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        correlation.corr_bwd_fm1_cuda(torch.zeros(1, 9, 4, 5), fm.cpu(), 1, 1)
