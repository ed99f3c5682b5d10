"""the port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and nvcc and skips without them. The file
imports no JAX and uses no conftest fixture, so it also runs on a GPU
machine that has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from detect_to_track_tpu_torch import viterbi_device
from detect_to_track_tpu_torch.ops import correlation
from detect_to_track_tpu_torch.viterbi import viterbi_multi_link

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
# wide windows: d_max 20 (the bf16 forward's first tiled d, the f32
# forward's last untiled one), 24 (the bf16 backward's KS = 4 edge) and 32
# (KS = 5; both forwards tiled, the bf16 one in 4 x 4 tiles), stride 2 tiled
WIDE_CASES = [(1, 20, 45, 40, 20, 1), (1, 20, 45, 40, 24, 1), (1, 24, 50, 64, 32, 1), (2, 24, 40, 24, 24, 2)]
# the forward also at batch 7: the tracker over the 7 adjacent pairs of an
# 8-frame detect_clip chunk
FWD_CASES = CORR_CASES + [(7, 38, 75, 512, 8, 1)] + WIDE_CASES


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
@pytest.mark.parametrize("case", FWD_CASES, ids=str)
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
# its halo'd multi-tile dFM1 kernel (K4), and the wide windows
BWD_CASES = CORR_CASES + [(2, 48, 75, 384, 8, 1), (1, 48, 40, 64, 8, 2)] + WIDE_CASES


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


def _link_problem(seed, t, d, dyadic):
    """padded (T-1, D, D) link scores and (D,) init scores: per frame a
    random count of live slots in [D/2, D], -inf outside them. Scores are
    uniform f32 in [0, 2), or (dyadic) multiples of 1/4 in [0, 2): every DP
    sum is then exact in f32 and in f64, with many exact ties."""
    rng = np.random.default_rng(seed)
    dims = rng.integers(max(d // 2, 1), d + 1, size=t)
    seq = np.full((t - 1, d, d), -np.inf, np.float32)
    for i in range(t - 1):
        shape = (dims[i], dims[i + 1])
        seq[i, : shape[0], : shape[1]] = rng.integers(0, 8, shape) / 4.0 if dyadic else rng.random(shape) * 2
    init = np.full(d, -np.inf, np.float32)
    init[: dims[0]] = rng.integers(0, 4, dims[0]) / 4.0 if dyadic else rng.random(dims[0])
    return seq, init


def _assert_same_paths(got, ref):
    """DevicePaths: identical n_paths, spans and nodes, bitwise-equal scores."""
    assert int(got.n_paths) == int(ref.n_paths)
    assert torch.equal(got.spans, ref.spans) and torch.equal(got.nodes, ref.nodes)
    assert torch.equal(got.scores.view(torch.int32), ref.scores.view(torch.int32))


# (seed, T, D): D a warp multiple and not, one slot, 1024 slots (the most
# threads a block takes), the chip clip's 22 x 128, and 1500 and 2048 slots
# (two slots for some threads or for all)
LINK_CASES = [(0, 4, 6), (1, 8, 32), (2, 22, 128), (3, 12, 100), (4, 6, 1), (5, 3, 1024), (8, 3, 1500), (9, 3, 2048)]


@pytest.mark.parametrize("dyadic", [False, True], ids=["uniform", "dyadic"])
@pytest.mark.parametrize("case", LINK_CASES, ids=str)
def test_linker_kernel_matches_plain(cuda, case, dyadic):
    seq, init = (torch.from_numpy(x).to(cuda) for x in _link_problem(*case, dyadic))
    before = viterbi_device.viterbi_multi_link_cuda.launches
    got = viterbi_device.viterbi_multi_link_scan(seq, init)
    torch.cuda.synchronize()
    assert viterbi_device.viterbi_multi_link_cuda.launches == before + 1
    _assert_same_paths(got, viterbi_device.viterbi_multi_link_ref(seq, init))
    assert int(got.n_paths) > 0


def test_linker_kernel_global_tables(cuda, monkeypatch):
    """step scores and parents in a global scratch (the long-clip layout)
    give the shared-memory layout's result."""
    seq, init = (torch.from_numpy(x).to(cuda) for x in _link_problem(6, 9, 40, False))
    ref = viterbi_device.viterbi_multi_link_cuda(seq, init)
    monkeypatch.setattr(viterbi_device, "_tables_in_smem", lambda lib, t1, d: False)
    _assert_same_paths(viterbi_device.viterbi_multi_link_cuda(seq, init), ref)


def test_linker_kernel_matches_native(cuda):
    """T = 64, D = 128 with dyadic scores, against the native host linker
    (f64 sums, exact here): the same paths in the same order."""
    seq, init = _link_problem(7, 64, 128, True)
    got = viterbi_device.viterbi_multi_link_cuda(torch.from_numpy(seq).to(cuda), torch.from_numpy(init).to(cuda))
    ref = viterbi_multi_link(list(seq), list(init), use_native=True)
    n = int(got.n_paths)
    spans, scores, nodes = (x[:n].cpu().numpy() for x in (got.spans, got.scores, got.nodes))
    assert n == len(ref)
    for i, ((s, e), score, path) in enumerate(ref):
        assert (int(spans[i, 0]), int(spans[i, 1])) == (s, e)
        assert nodes[i, s : e + 1].tolist() == path
        assert float(scores[i]) == score


def test_linker_kernel_exact_zero_transition(cuda):
    seq = torch.tensor([[[-np.inf, 0.0], [-np.inf, -np.inf]]], dtype=torch.float32, device=cuda)
    init = torch.zeros(2, device=cuda)
    got = viterbi_device.viterbi_multi_link_cuda(seq, init)
    assert int(got.n_paths) == 3
    assert got.spans[:3].tolist() == [[1, 1], [0, 0], [0, 0]]
    assert got.nodes[:3].tolist() == [[-1, 1], [0, -1], [1, -1]]
    _assert_same_paths(got, viterbi_device.viterbi_multi_link_ref(seq, init))


def test_linker_kernel_rejects_bad_input(cuda):
    seq = torch.zeros(2, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        viterbi_device.viterbi_multi_link_cuda(seq.double(), torch.zeros(4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="D, D"):
        viterbi_device.viterbi_multi_link_cuda(seq, torch.zeros(3, device=cuda))
    # D is bounded by the per-slot shared memory (init scores, counts and
    # the path): 60,000 steps of a 4-slot clip do not fit
    with pytest.raises(ValueError, match="shared memory"):
        viterbi_device.viterbi_multi_link_cuda(torch.zeros(60000, 4, 4, device=cuda), torch.zeros(4, device=cuda))


def test_linker_raises_without_its_kernel(cuda, monkeypatch):
    """a CUDA tensor launches the linker kernel or raises: a library that
    cannot be built or a failed launch never falls back to the plain
    version."""
    seq, init = (torch.from_numpy(x).to(cuda) for x in _link_problem(0, 4, 6, False))

    def no_library():
        raise RuntimeError("kernel build failed: viterbi.cu")

    monkeypatch.setattr(viterbi_device, "_viterbi_lib", no_library)
    with pytest.raises(RuntimeError, match="viterbi.cu"):
        viterbi_device.viterbi_multi_link_scan(seq, init)

    class FailingLaunch:
        def __getattr__(self, name):
            return lambda *args: 1  # cudaErrorInvalidValue from every entry point

    monkeypatch.setattr(viterbi_device, "_viterbi_lib", FailingLaunch)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        viterbi_device.viterbi_multi_link_scan(seq, init)
