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
from detect_to_track_tpu_torch.anchors import build_anchors
from detect_to_track_tpu_torch.boxes import compute_ious
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.encoding import frcnn_box_decode
from detect_to_track_tpu_torch.ops import correlation, nms, pooling
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
# threads a block takes), the chip clip's 22 x 128 (4 source groups, the
# two-matrix ring), 22 frames at D 33 and 100 (2 and 4 groups, the block
# short of 1024 threads; D 33 odd: no ring), and 1500 and 2048 slots (two
# slots for some threads or for all)
LINK_CASES = [(0, 4, 6), (1, 8, 32), (2, 22, 128), (3, 12, 100), (4, 6, 1), (5, 3, 1024), (8, 3, 1500), (9, 3, 2048),
              (10, 22, 33), (11, 22, 100)]


@pytest.mark.parametrize("dyadic", [False, True], ids=["uniform", "dyadic"])
@pytest.mark.parametrize("case", LINK_CASES, ids=str)
def test_linker_kernel_matches_plain(cuda, case, dyadic):
    """the kernel's paths are the plain version's, bitwise, and the caller's
    score matrices and init scores are unchanged after the launch (the
    kernel reads them in place, without a copy)."""
    seq, init = (torch.from_numpy(x).to(cuda) for x in _link_problem(*case, dyadic))
    seq_before, init_before = seq.clone(), init.clone()
    before = viterbi_device.viterbi_multi_link_cuda.launches
    got = viterbi_device.viterbi_multi_link_scan(seq, init)
    torch.cuda.synchronize()
    assert viterbi_device.viterbi_multi_link_cuda.launches == before + 1
    assert torch.equal(seq.view(torch.int32), seq_before.view(torch.int32))
    assert torch.equal(init.view(torch.int32), init_before.view(torch.int32))
    _assert_same_paths(got, viterbi_device.viterbi_multi_link_ref(seq, init))
    assert int(got.n_paths) > 0


def test_linker_kernel_global_tables(cuda, monkeypatch):
    """step scores and parents in a global scratch (the long-clip layout)
    give the shared-memory layout's result."""
    seq, init = (torch.from_numpy(x).to(cuda) for x in _link_problem(6, 9, 40, False))
    ref = viterbi_device.viterbi_multi_link_cuda(seq, init)
    monkeypatch.setattr(viterbi_device, "_tables_in_smem", lambda lib, t1, d: False)
    _assert_same_paths(viterbi_device.viterbi_multi_link_cuda(seq, init), ref)


@pytest.mark.parametrize("dyadic", [False, True], ids=["uniform", "dyadic"])
@pytest.mark.parametrize("case", LINK_CASES, ids=str)
def test_linker_kernel_global_bitmap(cuda, case, dyadic, monkeypatch):
    """the removed-node bitmap and the path in a global scratch (the layout
    of clips past about 1,037 frames at D 1500), forced at every LINK_CASES
    shape, with the step tables wherever the size rule puts them: the plain
    version's paths bitwise, the caller's scores unchanged."""
    seq, init = (torch.from_numpy(x).to(cuda) for x in _link_problem(*case, dyadic))
    seq_before = seq.clone()
    monkeypatch.setattr(viterbi_device, "_bitmap_in_smem", lambda lib, t1, d: False)
    got = viterbi_device.viterbi_multi_link_cuda(seq, init)
    torch.cuda.synchronize()
    assert torch.equal(seq.view(torch.int32), seq_before.view(torch.int32))
    _assert_same_paths(got, viterbi_device.viterbi_multi_link_ref(seq, init))
    assert int(got.n_paths) > 0


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
    # D is bounded by the per-slot shared memory (keys, init and masked
    # scores, counts, three staged bitmap rows): 13,633 slots do not fit, at
    # any T
    with pytest.raises(ValueError, match="shared memory"):
        viterbi_device.viterbi_multi_link_cuda(torch.zeros(0, 13633, 13633, device=cuda), torch.zeros(13633, device=cuda))


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


# ---------------------------------------------------------------- NMS kernel and the registered ops


def _nms_problem(seed, b, k, n_valid=None):
    """(b, k, 4) clustered ijhw boxes (long suppression chains, exact
    duplicates) and (b, k) valid, the first n_valid slots eligible (all but
    a random 10% when None)."""
    rng = np.random.default_rng(seed)
    centers = rng.random((max(k // 12, 1), 2))
    ij = centers[rng.integers(0, len(centers), (b, k))] + rng.standard_normal((b, k, 2)) * 0.03
    boxes = np.concatenate([ij, rng.random((b, k, 2)) * 0.2 + 0.02], -1).astype(np.float32)
    if k >= 4:
        boxes[:, 3] = boxes[:, 1]
    valid = rng.random((b, k)) > 0.1 if n_valid is None else np.arange(k)[None].repeat(b, 0) < n_valid
    return torch.from_numpy(boxes), torch.from_numpy(valid)


@pytest.mark.parametrize("iou", [0.3, 0.5])
@pytest.mark.parametrize("case", [(8, 3072, 3000), (3, 1, None), (3, 63, None), (2, 64, None), (2, 65, None),
                                  (2, 1000, None), (1, 4099, None)], ids=str)
def test_nms_kernel_matches_plain(cuda, case, iou):
    """the kernel's keep-mask equals the plain fixed-point loop's bitwise,
    on the card and on the CPU, at the working point (8 frames x 3072 slots,
    3000 eligible) and at k around a 64-slot word."""
    b, k, n_valid = case
    boxes, valid = _nms_problem(k, b, k, n_valid)
    before = nms.nms_mask_cuda.launches
    got = torch.ops.d2t.nms_mask(boxes.to(cuda), valid.to(cuda), iou)
    torch.cuda.synchronize()
    assert nms.nms_mask_cuda.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (b, k) and got.is_cuda
    assert torch.equal(got, nms.nms_mask_ref(boxes.to(cuda), valid.to(cuda), iou))
    assert torch.equal(got.cpu(), nms.nms_mask_ref(boxes, valid, iou))


def _anchor_problem(seed, b, k):
    """(b, k, 4) boxes as the RPN's decode spreads them: k of the default
    configuration's anchors (38x75, its areas and ratios) in a random order
    a frame, moved by small random offsets."""
    cfg = Config()
    anchors = torch.from_numpy(np.array(build_anchors((38, 75), cfg.ANCHOR_AREAS, cfg.ANCHOR_ASPECT_RATIOS)))
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.stack([rng.permutation(len(anchors))[:k] for _ in range(b)]))
    offsets = torch.from_numpy(rng.standard_normal((b, k, 4)).astype(np.float32) * 0.1)
    return frcnn_box_decode(anchors[idx], offsets).float().contiguous()


# NaN and +-inf in each field, inf - inf corners, subnormal, zero, negative
# and huge sizes
_SPECIAL_BOXES = [[np.nan, 0.5, 0.2, 0.3], [0.5, np.nan, 0.2, 0.3], [0.5, 0.5, np.nan, 0.3], [0.5, 0.5, 0.2, np.nan],
                  [np.inf, 0.5, 0.2, 0.3], [0.5, -np.inf, 0.2, 0.3], [0.5, 0.5, np.inf, 0.3], [0.5, 0.5, 0.2, np.inf],
                  [np.inf, 0.5, np.inf, 0.3], [0.5, 0.5, 1e-40, 1e-40], [1e-39, 2e-39, 3e-39, 4e-39],
                  [0.5, 0.5, 0.0, 0.0], [0.5, 0.5, -0.2, 0.3], [0.5, 0.5, 1e30, 1e30], [3e38, 3e38, 3e38, 3e38]]


@pytest.mark.parametrize("iou", [0.3, 0.5])
@pytest.mark.parametrize("kind", ["anchors", "random", "special"])
def test_nms_iou_bits_match_compute_ious(cuda, kind, iou):
    """the NMS op's first launch alone (nms_iou_bits_cuda) into a poisoned
    scratch at 8 x 3072: the words at or above the diagonal bitwise
    nms_iou_bits_ref's (compute_ious > t, packed), the words below it
    untouched, at t = iou and at IoUs of pairs with the float32 step below
    each; decoded anchors, clustered random boxes, and random boxes with
    NaN, inf, subnormal and negative ones mixed in. A bit flipped between a
    suppressed row and a column would leave keep as it is: this holds every
    bit."""
    b, k = 8, 3072
    boxes = _anchor_problem(0, b, k) if kind == "anchors" else _nms_problem(1, b, k, k)[0]
    if kind == "special":
        boxes[:, 5::97] = torch.tensor(_SPECIAL_BOXES, dtype=torch.float32).repeat(32, 1)[: len(range(5, k, 97))]
    boxes = boxes.to(cuda)
    ious = compute_ious(boxes[0], boxes[0])
    pos = ious[torch.ones_like(ious, dtype=torch.bool).triu(1) & (ious > 0)].cpu()
    vals = pos.sort().values[[len(pos) // 10, len(pos) // 2, len(pos) * 9 // 10]]
    thresholds = [iou] + [float(x) for v in vals for x in (v, torch.nextafter(v, torch.zeros(())))]
    nw = -(-k // 64)
    poison = 0x5A5A5A5A5A5A5A5A
    upper = torch.arange(nw, device=cuda)[None] >= (torch.arange(k, device=cuda) // 64)[:, None]
    for t in thresholds:
        out = torch.full((b, k, nw), poison, dtype=torch.int64, device=cuda)
        assert nms.nms_iou_bits_cuda(boxes, t, out) is out
        ref = nms.nms_iou_bits_ref(boxes, t)
        torch.cuda.synchronize()
        assert torch.equal(out[:, upper], ref[:, upper]), t
        assert bool((out[:, ~upper] == poison).all()), t


def test_nms_kernel_rejects_bad_input(cuda):
    boxes, valid = (x.to(cuda) for x in _nms_problem(0, 2, 10))
    launches = nms.nms_mask_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        nms.nms_mask_cuda(boxes.double(), valid, 0.3)
    with pytest.raises(ValueError, match="k, 4"):
        nms.nms_mask_cuda(boxes[..., :3], valid, 0.3)
    with pytest.raises(ValueError, match="k >= 1"):
        nms.nms_mask_cuda(boxes[:, :0], valid[:, :0], 0.3)
    assert nms.nms_mask_cuda.launches == launches


def test_correlation_ops_opcheck(cuda):
    """torch.library.opcheck on the three correlation ops with CUDA inputs:
    schema, fakes against the kernels, the autograd registration of
    corr_fwd (its backward the two backward ops) and AOT dispatch."""
    for dtype in DTYPES:
        fm0, fm1 = (x.requires_grad_() for x in _maps((2, 9, 13, 12), dtype, cuda))
        torch.library.opcheck(torch.ops.d2t.corr_fwd.default, (fm0, fm1, 2, 1))
        g = torch.randn(2, 25, 9, 13, device=cuda)
        for op in (torch.ops.d2t.corr_bwd_fm0.default, torch.ops.d2t.corr_bwd_fm1.default):
            torch.library.opcheck(op, (g, fm1.detach(), 2, 2))


def test_export_on_card_holds_the_kernels(cuda, tmp_path):
    """a tiny detector (ResNet-50 at 64x96, bf16) exported on the card: its
    graph calls d2t::corr_fwd (3 times), d2t::nms_mask, d2t::psroi_fwd
    (twice) and d2t::roipool_linear_fwd (the tracker's fused head), the
    served call launches the kernels and its outputs equal the live
    call's."""
    from detect_to_track_tpu_torch.config import Config
    from detect_to_track_tpu_torch.export import export_detector, load_detector
    from detect_to_track_tpu_torch.inference import Detector
    from detect_to_track_tpu_torch.models import DetectTrackModule

    cfg = Config(N_CLASSES=5, INPUT_SHAPE=(64, 96), ANCHOR_AREAS=(0.05,), K=3, D_MAX=2, PRE_NMS_TOPK=None,
                 EVAL_MAX_ROIS=72, MAX_ROIS=72, MAX_DETS=72)
    det = Detector(DetectTrackModule.from_config(cfg, device=cuda), cfg, device=cuda)
    path = tmp_path / "detector.pt2"
    export_detector(det.model, cfg, str(path), pair_batch=2, device=cuda)
    code = torch.export.load(str(path)).graph_module.code
    assert code.count("torch.ops.d2t.corr_fwd.default") == 3 and code.count("torch.ops.d2t.nms_mask.default") == 1
    assert code.count("torch.ops.d2t.psroi_fwd.default") == 2
    assert code.count("torch.ops.d2t.roipool_linear_fwd.default") == 1
    serve = load_detector(str(path), device=cuda)
    pairs = np.random.default_rng(0).integers(0, 256, (2, 2, 64, 96, 3), dtype=np.uint8)
    counters = (correlation.corr_fwd_cuda, nms.nms_mask_cuda, pooling.psroi_fwd_cuda, pooling.roipool_linear_fwd_cuda)
    counts = [fn.launches for fn in counters]
    got = serve(pairs)
    torch.cuda.synchronize()
    assert tuple(fn.launches - c for fn, c in zip(counters, counts)) == (3, 1, 2, 1)
    for g, r in zip(got, det.detect_pairs(pairs)):
        assert torch.equal(g, r)


# ---------------------------------------------------------------- PSROIPool

# (T, C) of the R-FCN's two heads at k 7: the class head's 31 targets, the box head's 4
PSROI_HEADS = [(31, 1519), (4, 196)]


def _psroi_problem(seed, b, r, h, w, c, nchw, device):
    """(b, h, w, c) float32 maps (a view of NCHW storage, or contiguous) and
    (b, r, 4) proposal-like rois with rois past the border and empty bins."""
    rng = np.random.default_rng(seed)
    rois = np.concatenate([rng.uniform(0.0, 1.0, (b, r, 2)), rng.uniform(0.02, 0.62, (b, r, 2))], -1)
    rois[:, 1::16] = [0.98, 0.02, 1.1, 0.9]  # past the border
    rois[:, 3::32] = [0.5, 0.5, 0.0, 0.3]  # zero height on a pixel row: empty
    rois[:, 7::32] = [1.4, 0.5, 0.2, 0.2]  # below the map: empty
    shape = (b, c, h, w) if nchw else (b, h, w, c)
    base = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
    return base, torch.from_numpy(rois.astype(np.float32)).to(device)


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
@pytest.mark.parametrize("head", PSROI_HEADS, ids=["class", "box"])
def test_psroi_kernels_match_plain(cuda, head, paper, nchw):
    """d2t::psroi_fwd on bin-major CUDA maps (the reference maps' channels
    gathered by either channel map, in NCHW or contiguous NHWC storage) at
    the working shapes (8 frames, 38x75, 256 rois, k 7) launches the
    forward kernel, and its autograd the backward kernel; the forward
    within 1e-5 of the largest magnitude of the plain einsum form (another
    summation order), empty bins exactly 0; the gradient within 1e-5 of
    autograd through the plain form and bitwise the same on a repeat;
    ps_roi_pool on the reference maps gives the same forward."""
    n_t, c = head
    k, fh, fw = 7, 38, 75
    ref_maps, rois = _psroi_problem(n_t, 8, 256, fh, fw, c, nchw, cuda)
    perm = pooling.bin_major_channels(n_t, k, paper, cuda)
    base = ref_maps[:, perm] if nchw else ref_maps[..., perm]  # bin-major, in the same storage
    view = (lambda x: x.permute(0, 2, 3, 1)) if nchw else (lambda x: x)
    bounds = pooling.psroi_bounds(rois, k, fh, fw)
    g = torch.randn(8, 256, n_t, k, k, device=cuda)
    grads, counts = [], (pooling.psroi_fwd_cuda.launches, pooling.psroi_bwd_cuda.launches)
    for _ in range(2):
        x = base.detach().requires_grad_()
        out = torch.ops.d2t.psroi_fwd(view(x), bounds, n_t)
        out.backward(g)
        grads.append(x.grad)
    torch.cuda.synchronize()
    assert (pooling.psroi_fwd_cuda.launches - counts[0], pooling.psroi_bwd_cuda.launches - counts[1]) == (2, 2)
    x = base.detach().requires_grad_()
    ref = pooling.ps_roi_pool_plain(view(x), bounds, n_t)
    (want,) = torch.autograd.grad(ref, x, g)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-5 * ref.abs().max().item())
    i0, i1, j0, j1 = bounds.unbind(2)
    empty = (i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0
    assert empty.any() and (out.detach().permute(0, 1, 3, 4, 2)[empty] == 0).all()
    assert grads[0].is_contiguous() and torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], want, rtol=0.0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(pooling.ps_roi_pool(view(ref_maps), rois, n_t, k, paper), out)


def test_psroi_rejects_bad_input(cuda):
    """the kernels take float32 maps and int32 bounds; other input raises and
    launches nothing."""
    base, rois = _psroi_problem(0, 2, 16, 9, 11, 27, False, cuda)
    bounds = pooling.psroi_bounds(rois, 3, 9, 11)
    counts = pooling.psroi_fwd_cuda.launches, pooling.psroi_bwd_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        pooling.ps_roi_pool(base.to(torch.bfloat16), rois, 3, 3)
    with pytest.raises(ValueError, match="int32"):
        pooling.psroi_fwd_cuda(base, bounds.long(), 3)
    with pytest.raises(ValueError, match="channels"):
        pooling.psroi_fwd_cuda(base[..., :18], bounds, 3)
    with pytest.raises(ValueError, match="float32"):
        pooling.psroi_bwd_cuda(torch.zeros(2, 16, 3, 3, 3, device=cuda, dtype=torch.float64), bounds, 3, 9, 11)
    assert (pooling.psroi_fwd_cuda.launches, pooling.psroi_bwd_cuda.launches) == counts


def test_psroi_ops_opcheck(cuda):
    """torch.library.opcheck on both ops with CUDA inputs: schema, the fakes
    against the kernels (contiguous outputs: the backward's NHWC whatever
    the maps' strides), psroi_fwd's autograd."""
    for nchw in (True, False):
        base, rois = _psroi_problem(1, 2, 24, 9, 11, 27, nchw, cuda)
        fm = (base.permute(0, 2, 3, 1) if nchw else base).requires_grad_()
        bounds = pooling.psroi_bounds(rois, 3, 9, 11)
        torch.library.opcheck(torch.ops.d2t.psroi_fwd.default, (fm, bounds, 3))
        g = torch.randn(2, 24, 3, 3, 3, device=cuda)
        torch.library.opcheck(torch.ops.d2t.psroi_bwd.default, (g.transpose(3, 4) if nchw else g, bounds, 3, 9, 11))


def test_rfcn_maps_are_contiguous_nhwc(cuda, monkeypatch):
    """the R-FCN's convolutions run channels-last on a contiguous NHWC c5 (as
    the backbone gives it), so both heads hand PSROIPool contiguous NHWC
    bin-major maps: the layout the kernels are tuned and timed at."""
    from detect_to_track_tpu_torch.models import rfcn

    seen = []

    def spy(fg, *args, **kwargs):
        seen.append(fg.is_contiguous())
        return pooling.psroi_fwd(fg, *args, **kwargs)

    monkeypatch.setattr(rfcn, "psroi_fwd", spy)
    for dtype in (torch.float32, torch.bfloat16):
        head = rfcn.RFCN(5, k=3, in_channels=64, reduce_channels=32, dtype=dtype).to(cuda)
        x = torch.randn(2, 9, 13, 64, device=cuda)
        rois = torch.rand(2, 8, 4, device=cuda)
        head(x, rois)
    assert seen == [True] * 4


def test_rfcn_weight_gradient_is_deterministic(cuda):
    """an R-FCN head's gradients on the card, twice: bitwise the same (the
    bin-major weight gather folds its gradient without atomics, and the
    PSROIPool backward has none), finite, and nonzero for both 1x1 convs."""
    from detect_to_track_tpu_torch.models import rfcn

    torch.manual_seed(0)
    head = rfcn.RFCN(30, k=7, in_channels=64, reduce_channels=32).to(cuda)
    x = torch.randn(2, 9, 13, 64, device=cuda)
    rois = torch.rand(2, 16, 4, device=cuda)
    grads = []
    for _ in range(2):
        head.zero_grad()
        c_hat, b_hat = head(x, rois)
        (c_hat.square().sum() + b_hat.sum()).backward()
        grads.append({n: p.grad.clone() for n, p in head.named_parameters()})
    assert all(torch.equal(grads[0][n], grads[1][n]) and grads[0][n].isfinite().all() for n in grads[0])
    assert all(grads[0][f"{conv}.{p}"].abs().max() > 0 for conv in ("cls_sm_conv", "reg_sm_conv")
               for p in ("weight", "bias"))


# ---------------------------------------------------------------- ROIPool


def _roipool_problem(seed, b, r, h, w, k, device):
    """proposal-like rois with rois past the border and empty bins (as
    _psroi_problem's) and their corner-clamped ROIPool bounds."""
    _, rois = _psroi_problem(seed, b, r, 1, 1, 1, False, device)
    return rois, pooling.psroi_bounds(rois, k, h, w, clamp_corner=True)


@pytest.mark.parametrize("r", [128, 32], ids=["pair_call", "training_step"])
def test_roipool_linear_kernels_match_plain(cuda, r):
    """d2t::roipool_linear_fwd on the tracker's projected map (4 pairs, 38x75,
    k 7, 4 outputs) launches the fused forward kernel, and its autograd the
    backward; the forward within 1e-5 of the largest magnitude of the plain
    einsum form (another summation order), rois whose every bin is empty
    exactly 0; the gradient within 1e-5 of autograd through the plain form,
    bitwise the same on a repeat and for an expanded cotangent's
    contiguous copy; roi_pool_linear gives the same forward."""
    k, fh, fw = 7, 38, 75
    rois, bounds = _roipool_problem(r, 4, r, fh, fw, k, cuda)
    g = torch.randn(4, fh, fw, k, k, 4, device=cuda)
    cot = torch.randn(4, r, 4, device=cuda)
    grads, counts = [], (pooling.roipool_linear_fwd_cuda.launches, pooling.roipool_linear_bwd_cuda.launches)
    for _ in range(2):
        x = g.detach().requires_grad_()
        out = torch.ops.d2t.roipool_linear_fwd(x, bounds)
        out.backward(cot)
        grads.append(x.grad)
    torch.cuda.synchronize()
    assert (pooling.roipool_linear_fwd_cuda.launches - counts[0],
            pooling.roipool_linear_bwd_cuda.launches - counts[1]) == (2, 2)
    x = g.detach().requires_grad_()
    ref = pooling.roi_pool_linear_plain(x, bounds)
    (want,) = torch.autograd.grad(ref, x, cot)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-5 * ref.abs().max().item())
    i0, i1, j0, j1 = bounds.unbind(2)
    empty = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0).all(-1).all(-1)
    assert empty.any() and (out.detach()[empty] == 0).all()
    assert grads[0].is_contiguous() and torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], want, rtol=0.0, atol=1e-5 * want.abs().max().item())
    mean_cot = torch.randn(4, 1, 4, device=cuda).expand(4, r, 4)
    assert torch.equal(pooling.roipool_linear_bwd_cuda(mean_cot, bounds, fh, fw),
                       pooling.roipool_linear_bwd_cuda(mean_cot.contiguous(), bounds, fh, fw))
    assert torch.equal(pooling.roi_pool_linear(g, rois, k), out)


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
def test_roipool_kernels_match_plain(cuda, nchw):
    """d2t::roipool_fwd on the tracker's materialized features (2 pairs,
    38x75, 1891 channels, k 7, 64 rois; contiguous NHWC or a view of NCHW
    storage) launches the forward kernel, and its autograd the backward on
    the head's (C, k, k)-ordered cotangent; within 1e-5 of the largest
    magnitude of the plain einsum form and of autograd through it, empty
    bins exactly 0, the gradient bitwise the same on a repeat; roi_pool
    gives the same forward."""
    k, fh, fw, c, r = 7, 38, 75, 1891, 64
    rois, bounds = _roipool_problem(c, 2, r, fh, fw, k, cuda)
    base = torch.randn((2, c, fh, fw) if nchw else (2, fh, fw, c), device=cuda)
    view = (lambda x: x.permute(0, 2, 3, 1)) if nchw else (lambda x: x)
    cot = torch.randn(2, r, c, k, k, device=cuda).permute(0, 1, 3, 4, 2)
    grads, counts = [], (pooling.roipool_fwd_cuda.launches, pooling.roipool_bwd_cuda.launches)
    for _ in range(2):
        x = base.detach().requires_grad_()
        out = torch.ops.d2t.roipool_fwd(view(x), bounds)
        out.backward(cot)
        grads.append(view(x.grad))
    torch.cuda.synchronize()
    assert (pooling.roipool_fwd_cuda.launches - counts[0], pooling.roipool_bwd_cuda.launches - counts[1]) == (2, 2)
    x = base.detach().requires_grad_()
    ref = pooling.roi_pool_plain(view(x), bounds)
    (want,) = torch.autograd.grad(ref, x, cot)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-5 * ref.abs().max().item())
    i0, i1, j0, j1 = bounds.unbind(2)
    empty = (i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0
    assert empty.any() and (out.detach()[empty] == 0).all()
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], view(want), rtol=0.0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(pooling.roi_pool(view(base), rois, k), out)


def test_roipool_rejects_bad_input(cuda):
    """the kernels take float32 maps and int32 bounds; other input raises and
    launches nothing; bf16 maps are cast to float32 by the public
    functions."""
    rois, bounds = _roipool_problem(0, 2, 16, 9, 11, 3, cuda)
    counters = (pooling.roipool_linear_fwd_cuda, pooling.roipool_linear_bwd_cuda, pooling.roipool_fwd_cuda,
                pooling.roipool_bwd_cuda)
    counts = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="float32"):
        pooling.roi_pool(torch.zeros(2, 9, 11, 5, device=cuda, dtype=torch.float64), rois, 3)
    with pytest.raises(ValueError, match="float32"):
        pooling.roipool_linear_bwd_cuda(torch.zeros(2, 16, 4, device=cuda, dtype=torch.bfloat16), bounds, 9, 11)
    with pytest.raises(ValueError, match="int32"):
        pooling.roipool_fwd_cuda(torch.zeros(2, 9, 11, 5, device=cuda), bounds.long())
    with pytest.raises(ValueError, match="does not match"):
        pooling.roipool_linear_fwd_cuda(torch.zeros(2, 9, 11, 5, 5, 4, device=cuda), bounds)
    with pytest.raises(ValueError, match="does not match"):
        pooling.roipool_bwd_cuda(torch.zeros(2, 15, 3, 3, 5, device=cuda), bounds, 9, 11)
    assert [fn.launches for fn in counters] == counts
    out = pooling.roi_pool_linear(torch.randn(2, 9, 11, 3, 3, 4, device=cuda, dtype=torch.bfloat16), rois, 3)
    assert out.dtype == torch.float32 and pooling.roipool_linear_fwd_cuda.launches == counts[0] + 1


def test_roipool_ops_opcheck(cuda):
    """torch.library.opcheck on the four ROIPool ops with CUDA inputs: schema,
    the fakes against the kernels, the forwards' autograd; maps and
    cotangents of other strides."""
    rois, bounds = _roipool_problem(1, 2, 24, 9, 11, 3, cuda)
    for nchw in (True, False):
        base = torch.randn((2, 5, 9, 11) if nchw else (2, 9, 11, 5), device=cuda)
        fm = (base.permute(0, 2, 3, 1) if nchw else base).requires_grad_()
        torch.library.opcheck(torch.ops.d2t.roipool_fwd.default, (fm, bounds))
        g = torch.randn(2, 24, 5, 3, 3, device=cuda)
        torch.library.opcheck(torch.ops.d2t.roipool_bwd.default,
                              (g.permute(0, 1, 3, 4, 2) if nchw else g.reshape(2, 24, 3, 3, 5), bounds, 9, 11))
    g = torch.randn(2, 9, 11, 3, 3, 4, device=cuda, requires_grad=True)
    torch.library.opcheck(torch.ops.d2t.roipool_linear_fwd.default, (g, bounds))
    torch.library.opcheck(torch.ops.d2t.roipool_linear_bwd.default,
                          (torch.randn(2, 1, 4, device=cuda).expand(2, 24, 4), bounds, 9, 11))


def test_training_step_launches_the_fused_roipool_kernels(cuda):
    """a training step of a tiny configuration on the card launches one fused
    ROIPool forward and one backward (the tracker's head and its gradient),
    and no materialized ROIPool kernel."""
    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.config import Config
    from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
    from detect_to_track_tpu_torch.models import DetectTrackModule

    cfg = Config(N_CLASSES=5, INPUT_SHAPE=(64, 96), ANCHOR_AREAS=(0.05,), K=3, D_MAX=2, PRE_NMS_TOPK=None,
                 EVAL_MAX_ROIS=72, MAX_ROIS=72, MAX_DETS=72, BATCH_SIZE=2)
    model = DetectTrackModule.from_config(cfg, device=cuda)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model), device=cuda)
    manager = SyntheticVIDManager(n_samples=cfg.BATCH_SIZE, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES)
    loader = trainer.BatchLoader(manager, cfg.BATCH_SIZE, cfg, seed=0)
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    counters = (pooling.roipool_linear_fwd_cuda, pooling.roipool_linear_bwd_cuda, pooling.roipool_fwd_cuda,
                pooling.roipool_bwd_cuda)
    step(batch)  # warm-up
    counts = [fn.launches for fn in counters]
    losses = step(batch).vector()
    torch.cuda.synchronize()
    assert [fn.launches - c for fn, c in zip(counters, counts)] == [1, 1, 0, 0]
    assert torch.isfinite(losses).all()
