"""PSROIPool's ops and kernels on the CPU: the registered ops `d2t::psroi_fwd`
/ `d2t::psroi_bwd` (their CPU bodies, the plain versions) on bin-major maps
(the reference-layout maps' channels gathered by the channel map) against
the JAX package's ps_roi_pool and its jax.grad; the kernels' own source
(ops/csrc/psroi.cu) run on CPU threads against the plain forward and
autograd through it, for both channel maps and both storages of the
bin-major maps (contiguous NHWC, the R-FCN's, and NHWC views of NCHW
storage), with rois whose bin edges sit on pixel boundaries, rois past the
border, empty bins, a NaN roi and rois in several of the backward's staging
chunks; the backward bitwise the same on a repeat. The R-FCN's bin-major
weight gather (BinMajorRows): its rows, and its gradient's fold against
index_add_, bitwise on a repeat.

Tolerances: the kernels sum each bin (forward) and each element's terms
(backward) in another order than the einsum form: f32 rounding of sums of
tens of terms, within 1e-5 of the largest magnitude. The JAX package's
einsum form against the port's: the same bound. The fold sums a row's
gradients in another order than index_add_: 1e-6 of the largest magnitude
(at most 31 terms)."""

import ctypes
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from detect_to_track_tpu.ops import pooling as j_pool
from detect_to_track_tpu_torch.ops import pooling

from tests import torch_port_cuda_on_cpu as cuda_on_cpu

CSRC = Path(pooling.__file__).parent / "csrc"
TOL = 1e-5  # of the largest magnitude
# (T, k, H, W): the box head's 4 and the class head's 31 targets at k 3 and 7;
# H 12 / W 16 put the dyadic rois' bin edges on pixel boundaries
CASES = [(3, 3, 12, 16), (31, 3, 9, 11), (4, 7, 13, 17), (31, 7, 12, 16)]


def _rois(rng, b, n_random=8):
    """(b, R, 4) fractional ijhw rois: random ones, dyadic ones whose bin
    edges land on pixel boundaries at H 12 / W 16 (k 3 and 7), rois past the
    border or outside the map, zero-size and negative-size rois (empty bins)."""
    special = [
        [0.25 + 0.375, 0.125 + 0.09375, 0.75, 0.1875],  # k 3: bins 0.25 high, 1/16 wide
        [0.0 + 0.875, 0.25 + 0.21875, 1.75, 0.4375],  # k 7: the same bins, past the bottom
        [0.5 + 0.375, 0.5, 0.75, 1.0],  # edges on 0.5, 0.75, 1.0
        [0.95, 0.05, 0.6, 0.8],  # past the bottom and left borders
        [-0.2, 1.1, 0.5, 0.5],  # mostly outside
        [1.5, 0.5, 0.2, 0.2],  # outside: every bin empty
        [0.5, 0.5, 0.0, 0.3],  # zero height on a pixel boundary at H 12: empty
        [0.4, 0.6, -0.3, 0.2],  # negative height
        [0.3, 0.3, -0.2, -0.4],  # both negative: i1 < i0 and j1 < j0, n > 0
        [0.5, 0.5, 1.0, 1.0],  # the whole map
    ]
    out = []
    for _ in range(b):
        ij = rng.uniform(0.1, 0.9, (n_random, 2))
        hw = rng.uniform(0.05, 0.7, (n_random, 2))
        rois = np.concatenate([np.concatenate([ij, hw], 1), special])
        out.append(rois[rng.permutation(len(rois))])
    return np.stack(out).astype(np.float32)


def _maps(rng, b, h, w, c, nchw):
    """(b, h, w, c) float32 maps: contiguous, or a view of NCHW storage."""
    if nchw:
        return torch.from_numpy(rng.standard_normal((b, c, h, w), dtype=np.float32)).permute(0, 2, 3, 1)
    return torch.from_numpy(rng.standard_normal((b, h, w, c), dtype=np.float32))


def _bin_major(fm, n_t, k, paper):
    """fm's channels gathered bin-major, in fm's storage: an NHWC view of
    NCHW storage stays one."""
    perm = pooling.bin_major_channels(n_t, k, paper)
    if fm.is_contiguous():
        return fm[..., perm]
    return fm.permute(0, 3, 1, 2)[:, perm].permute(0, 2, 3, 1)


def _close(got, ref):
    scale = ref.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, ref, rtol=0.0, atol=TOL * scale)


# ---------------------------------------------------------------- the ops against JAX


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_op_cpu_path_matches_jax(case, paper, nchw):
    """torch.ops.d2t.psroi_fwd on CPU tensors, forward and autograd (its
    registered backward, d2t::psroi_bwd, then the channel gather's), on the
    maps gathered bin-major, against JAX's ps_roi_pool and jax.grad on the
    reference-layout maps, frame by frame, from the same numpy inputs."""
    n_t, k, h, w = case
    rng = np.random.default_rng(k * 100 + n_t)
    rois = _rois(rng, 2)
    fm = _maps(rng, 2, h, w, n_t * k * k, nchw)
    cot = rng.standard_normal((2, rois.shape[1], n_t, k, k), dtype=np.float32)
    base = (fm.permute(0, 3, 1, 2) if nchw else fm).detach().clone().requires_grad_()
    x = base.permute(0, 2, 3, 1) if nchw else base
    out = torch.ops.d2t.psroi_fwd(_bin_major(x, n_t, k, paper), pooling.psroi_bounds(torch.from_numpy(rois), k, h, w),
                                  n_t)
    (out * torch.from_numpy(cot)).sum().backward()
    grad = base.grad.permute(0, 2, 3, 1) if nchw else base.grad
    fm_np = fm.contiguous().numpy()
    for f in range(2):
        def loss(m, f=f):
            return (j_pool.ps_roi_pool(m, rois[f], n_t, k, paper) * cot[f]).sum()

        ref = torch.from_numpy(np.array(j_pool.ps_roi_pool(fm_np[f], rois[f], n_t, k, paper)))
        _close(out[f].detach(), ref)
        _close(grad[f], torch.from_numpy(np.array(jax.grad(loss)(fm_np[f]))))


@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_backward_matches_autograd(case, paper):
    """psroi_bwd_ref (the backward op's CPU body) against autograd through
    the plain forward on bin-major maps; ps_roi_pool's CPU path (the
    channel gather, then the forward op's CPU body) is the plain forward of
    the gathered maps, and its gradient the backward op's, summed back by
    the gather's backward; the backward op returns contiguous NHWC."""
    n_t, k, h, w = case
    rng = np.random.default_rng(k + n_t)
    rois = torch.from_numpy(_rois(rng, 2))
    bounds = pooling.psroi_bounds(rois, k, h, w)
    fm = _maps(rng, 2, h, w, n_t * k * k, False)
    fg = _bin_major(fm, n_t, k, paper).requires_grad_()
    out = pooling.ps_roi_pool_plain(fg, bounds, n_t)
    assert torch.equal(out, pooling.ps_roi_pool(fm, rois, n_t, k, paper))
    g = torch.from_numpy(rng.standard_normal(out.shape, dtype=np.float32))
    (ref,) = torch.autograd.grad(out, fg, g)
    got = pooling.psroi_bwd_ref(g, bounds, n_t, h, w)
    _close(got, ref)
    dfg = torch.ops.d2t.psroi_bwd(g, bounds, n_t, h, w)
    assert dfg.is_contiguous() and torch.equal(dfg, got)
    x = fm.detach().requires_grad_()  # ps_roi_pool's autograd: the backward op's, then the gather's
    pooling.ps_roi_pool(x, rois, n_t, k, paper).backward(g)
    perm = pooling.bin_major_channels(n_t, k, paper)
    _close(x.grad, torch.zeros_like(fm).index_add_(-1, perm, got))


def test_ops_opcheck_and_fakes():
    """torch.library.opcheck on both ops with CPU inputs (schema, the fakes
    against the CPU bodies, psroi_fwd's autograd registration); the fakes on
    meta tensors."""
    rng = np.random.default_rng(0)
    n_t, k, h, w = 3, 3, 9, 11
    bounds = pooling.psroi_bounds(torch.from_numpy(_rois(rng, 2, 2)), k, h, w)
    for nchw in (False, True):
        fg = _maps(rng, 2, h, w, n_t * k * k, nchw).requires_grad_()
        torch.library.opcheck(torch.ops.d2t.psroi_fwd.default, (fg, bounds, n_t))
        g = torch.randn(2, bounds.shape[1], n_t, k, k)
        torch.library.opcheck(torch.ops.d2t.psroi_bwd.default, (g if nchw else g.transpose(3, 4), bounds, n_t, h, w))
    meta = torch.ops.d2t.psroi_fwd(torch.empty(2, h, w, n_t * k * k, device="meta"), bounds.to("meta"), n_t)
    assert meta.shape == (2, bounds.shape[1], n_t, k, k) and meta.dtype == torch.float32
    meta = torch.ops.d2t.psroi_bwd(torch.empty(2, bounds.shape[1], n_t, k, k, device="meta"), bounds.to("meta"),
                                   n_t, h, w)
    assert meta.shape == (2, h, w, n_t * k * k)


def test_kernel_wrappers_refuse_cpu_tensors():
    """a CPU tensor never reaches a kernel wrapper: it raises, naming CUDA."""
    bounds = torch.zeros(1, 2, 4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pooling.psroi_fwd_cuda(torch.zeros(1, 4, 5, 18), bounds, 2)
    with pytest.raises(ValueError, match="CUDA"):
        pooling.psroi_bwd_cuda(torch.zeros(1, 2, 2, 3, 3), bounds, 2, 4, 5)


# ---------------------------------------------------------------- the kernels' source on CPU threads

# psroi.cu's kernels on CPU threads (tests/torch_port_cuda_on_cpu.py): the
# forward and the backward's kernel as fibers, the prologue too
_CPU_LAUNCH = r"""
extern "C" void cpu_psroi_fwd(const float* fg, const int* bounds, float* out, int b, int r, int t, int k, int h,
                              int w, long long sb, long long sh, long long sw, long long sc) {
  run_blocks(dim3(b * r), kFwdThreads, true,
             [=] { psroi_fwd_kernel(fg, bounds, out, r, t, k, h, w, sb, sh, sw, sc); });
}
// the prologue into gs and masks, then the kernel; warps 0: the launch's own choice (bwd_warps)
extern "C" void cpu_psroi_bwd(const float* g, long long gsb, long long gsr, long long gst, long long gsi,
                              long long gsj, const int* bounds, float* gs, unsigned* masks, float* dfg, int b, int r,
                              int t, int k, int h, int w, int warps) {
  unsigned* cols = masks + static_cast<long long>(b) * h * r;
  run_blocks(dim3(b * r), kPrologueThreads, true,
             [=] { psroi_bwd_prologue_kernel(g, gsb, gsr, gst, gsi, gsj, bounds, gs, masks, cols, r, t, k, h, w); });
  if (warps == 0) warps = bwd_warps(t, k);
  const int px = warps * warp_groups(t);
  run_blocks(dim3((w + px - 1) / px, h, b), warps * kWarp, true,
             [=] { bwd_kernel(k)(gs, masks, cols, dfg, r, t, k, h, w); });
}
extern "C" int cpu_bwd_warps(int t, int k) { return bwd_warps(t, k); }
"""


def _kernels_on_cpu(out):
    """ops/csrc/psroi.cu (and its header bin_pool.cuh) built for CPU threads
    into `out`."""
    lib = cuda_on_cpu.build("psroi.cu", _CPU_LAUNCH, out)
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.cpu_psroi_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4
    lib.cpu_psroi_bwd.argtypes = [ptr] + [i64] * 5 + [ptr] * 4 + [i32] * 7
    lib.cpu_bwd_warps.argtypes = [i32] * 2
    return lib


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    return _kernels_on_cpu(tmp_path_factory.mktemp("psroi_cpu"))


def _fwd(lib, fg, bounds, n_t):
    """the forward kernel on CPU threads into a NaN-poisoned output."""
    b, h, w, _ = fg.shape
    r, k = bounds.shape[1], bounds.shape[3]
    out = torch.full((b, r, n_t, k, k), float("nan"))
    lib.cpu_psroi_fwd(fg.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, r, n_t, k, h, w, *fg.stride())
    return out


def _bwd(lib, g, bounds, n_t, h, w, warps=0):
    """the backward (prologue and kernel) on CPU threads into poisoned
    scratches and a NaN-poisoned dfg (contiguous NHWC, bin-major)."""
    b, r, _, k, _ = g.shape
    scaled = torch.full((b, r, k, k, n_t), float("nan"))
    masks = torch.full((b * (h + w) * r,), -1, dtype=torch.int32)
    dfg = torch.full((b, h, w, n_t * k * k), float("nan"))
    lib.cpu_psroi_bwd(g.data_ptr(), *g.stride(), bounds.data_ptr(), scaled.data_ptr(), masks.data_ptr(),
                      dfg.data_ptr(), b, r, n_t, k, h, w, warps)
    return dfg


def _problem(case, seed, nchw, paper, nan_roi=False):
    """rng, bin-major maps (the reference maps' channels gathered by the
    channel map, in NHWC or NCHW storage) and bounds."""
    n_t, k, h, w = case
    rng = np.random.default_rng(seed)
    rois = _rois(rng, 2)
    if nan_roi:
        rois[1, 3] = np.nan
    fg = _bin_major(_maps(rng, 2, h, w, n_t * k * k, nchw), n_t, k, paper)
    return rng, fg, pooling.psroi_bounds(torch.from_numpy(rois), k, h, w)


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernels_match_plain(kernels, case, paper, nchw):
    """both kernels on bin-major maps against the plain forward and autograd
    through it; empty bins exactly 0; every dfg element written; the
    backward bitwise the same on a repeat (and with fewer warps a block:
    other rounds, idle warps)."""
    n_t, k, h, w = case
    rng, fg, bounds = _problem(case, seed=h * w + n_t, nchw=nchw, paper=paper, nan_roi=True)
    ref = pooling.ps_roi_pool_plain(fg, bounds, n_t)
    got = _fwd(kernels, fg, bounds, n_t)
    _close(got, ref)
    i0, i1, j0, j1 = bounds.unbind(2)
    empty = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0)[:, :, None].expand_as(got)
    assert empty.any() and (got[empty] == 0).all()

    g = torch.from_numpy(rng.standard_normal(ref.shape, dtype=np.float32))
    x = fg.detach().requires_grad_()
    (want,) = torch.autograd.grad(pooling.ps_roi_pool_plain(x, bounds, n_t), x, g)
    dfg = _bwd(kernels, g, bounds, n_t, h, w)
    _close(dfg, want)
    assert torch.equal(dfg, _bwd(kernels, g, bounds, n_t, h, w))
    assert torch.equal(dfg, _bwd(kernels, g, bounds, n_t, h, w, warps=3))


def test_backward_reads_cotangent_strides(kernels):
    """the cotangent of the head's mean over the k x k grid: an expanded
    (stride 0) tensor, read through its strides."""
    case = n_t, k, h, w = CASES[3]
    rng, _, bounds = _problem(case, seed=7, nchw=True, paper=False)
    g = torch.from_numpy(rng.standard_normal((2, bounds.shape[1], n_t, 1, 1), dtype=np.float32)).expand(-1, -1, -1, k,
                                                                                                          k)
    want = pooling.psroi_bwd_ref(g.contiguous(), bounds, n_t, h, w)
    _close(_bwd(kernels, g, bounds, n_t, h, w), want)


@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
def test_kernels_on_arbitrary_bounds(kernels, paper):
    """bounds the geometry never makes (unordered, negative, past the map,
    int32 products that wrap): a bin still holds the pixels 0 <= h < H with
    i0 <= h < i1, and n is the int32 product, as in the plain version."""
    n_t, k, h, w = 3, 3, 9, 11
    rng = np.random.default_rng(11)
    bounds = np.stack([rng.integers(-3, h + 4, (2, 12, k)), rng.integers(-3, h + 4, (2, 12, k)),
                       rng.integers(-3, w + 4, (2, 12, k)), rng.integers(-3, w + 4, (2, 12, k))], 2)
    bounds[0, 0] = [[-100000] * k, [100000] * k, [-100000] * k, [100000] * k]  # n wraps (int32)
    bounds[0, 1] = [[0] * k, [h] * k, [-70000] * k, [w] * k]
    bounds[1, 0] = [[-65530] * k, [6] * k, [-65530] * k, [6] * k]  # 2^16 x 2^16 wraps to n = 0
    bounds = torch.from_numpy(bounds.astype(np.int32))
    fg = _bin_major(_maps(rng, 2, h, w, n_t * k * k, True), n_t, k, paper)
    ref = pooling.ps_roi_pool_plain(fg, bounds, n_t)
    _close(_fwd(kernels, fg, bounds, n_t), ref)
    g = torch.from_numpy(rng.standard_normal(ref.shape, dtype=np.float32))
    _close(_bwd(kernels, g, bounds, n_t, h, w), pooling.psroi_bwd_ref(g, bounds, n_t, h, w))


@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
def test_backward_in_roi_chunks(kernels, paper):
    """300 rois a frame: the backward stages them 128 at a time (3 chunks,
    the last one partial) and holds against the plain backward, bitwise the
    same on a repeat; the forward too."""
    case = n_t, k, h, w = CASES[3]
    rng = np.random.default_rng(5)
    rois = torch.from_numpy(np.concatenate([_rois(rng, 2, n_random=280), _rois(rng, 2, n_random=0)], 1))
    assert rois.shape[1] == 300
    bounds = pooling.psroi_bounds(rois, k, h, w)
    fg = _bin_major(_maps(rng, 2, h, w, n_t * k * k, False), n_t, k, paper)
    _close(_fwd(kernels, fg, bounds, n_t), pooling.ps_roi_pool_plain(fg, bounds, n_t))
    g = torch.from_numpy(rng.standard_normal((2, rois.shape[1], n_t, k, k), dtype=np.float32))
    got = _bwd(kernels, g, bounds, n_t, h, w)
    assert torch.equal(got, _bwd(kernels, g, bounds, n_t, h, w))
    _close(got, pooling.psroi_bwd_ref(g, bounds, n_t, h, w))


def test_backward_block_size(kernels):
    """the backward's warps a block: 8 pixels (8 warps of one pixel at the
    class head's 31 targets, one warp of 8 pixels at the box head's 4), fewer
    warps while the accumulators do not fit, 0 when not one warp does."""
    assert kernels.cpu_bwd_warps(31, 7) == 8
    assert kernels.cpu_bwd_warps(4, 7) == 1
    assert kernels.cpu_bwd_warps(200, 7) == 5
    assert kernels.cpu_bwd_warps(1150, 7) == 1
    assert kernels.cpu_bwd_warps(1200, 7) == 0


# ---------------------------------------------------------------- the R-FCN's bin-major weight gather


@pytest.mark.parametrize("paper", [False, True], ids=["quirk", "paper"])
@pytest.mark.parametrize("n_t", [3, 4, 31])
def test_bin_major_rows_fold_matches_index_add(n_t, paper):
    """BinMajorRows on a 1x1 conv's weight and bias: the rows are the
    bin-major channels' (the reference rows gathered by the channel map);
    the gradients of the parameters, the padded fold of the gathered rows'
    gradients, equal index_add_ (autograd's own index_select backward)
    within f32 rounding, bitwise the same on a repeat; every row that no
    bin-major channel reads gets 0."""
    k = 7
    rows = pooling.BinMajorRows(n_t, k, paper)
    perm = pooling.bin_major_channels(n_t, k, paper)
    assert torch.equal(rows.perm, perm)
    rng = np.random.default_rng(n_t)
    params = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).requires_grad_()
              for shape in ((n_t * k * k, 16, 1, 1), (n_t * k * k,))]
    out = rows(*params)
    cots = [torch.from_numpy(rng.standard_normal(o.shape, dtype=np.float32)) for o in out]
    got = torch.autograd.grad(out, params, cots)
    again = torch.autograd.grad(rows(*params), params, cots)
    unread = torch.bincount(perm, minlength=perm.numel()) == 0
    assert (not paper) == bool(unread.any())
    for x, o, cot, d1, d2 in zip(params, out, cots, got, again):
        assert torch.equal(o, x.detach()[perm])
        want = torch.zeros_like(x).index_add_(0, perm, cot)
        assert torch.equal(d1, d2) and d1.shape == x.shape and (d1[unread] == 0).all()
        torch.testing.assert_close(d1, want, rtol=0.0, atol=1e-6 * want.abs().max().item())


def test_ctypes_signatures_match_the_source(monkeypatch):
    """the argument types the wrapper declares for each exported function are
    the C signature's in psroi.cu (a wrong count truncates pointers and
    64-bit strides without an error)."""
    import re

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    monkeypatch.setattr(pooling._build, "load", lambda name: lib)
    pooling._psroi_lib()
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
               "long long": ctypes.c_longlong}
    src = (CSRC / "psroi.cu").read_text()
    found = re.findall(r"^(?:int|size_t) (d2t_\w+)\(([^)]*)\)", src, flags=re.M)
    assert {name for name, _ in found} == {"d2t_psroi_fwd", "d2t_psroi_bwd", "d2t_psroi_bwd_smem_bytes",
                                           "d2t_psroi_bwd_blocks_per_sm"}
    for name, params in found:
        want = [c_types[" ".join(p.split()[:-1])] for p in params.replace("\n", " ").split(",")]
        assert getattr(lib, name).argtypes == want, name
