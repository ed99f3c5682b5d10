"""ROIPool's ops and kernels on the CPU: the plain versions (roi_pool_plain,
roi_pool_linear_plain and their written-out backwards) against the JAX
package's roi_pool / roi_pool_linear and jax.grad, and against autograd
through the plain forwards; the registered ops (`d2t::roipool_fwd` /
`_bwd`, `d2t::roipool_linear_fwd` / `_bwd`) through opcheck and their
fakes; the kernels' own source (ops/csrc/roipool.cu and its header
bin_pool.cuh) run on CPU threads against the plain versions, with rois whose
corner the clamp moves, rois past the border, empty bins, bounds the
geometry never makes, rois in several of the backwards' 32-roi scans, maps
and cotangents of other strides; both backwards bitwise the same on a
repeat.

Tolerances: the kernels sum each bin (forwards) and each element's terms
(backwards) in another order than the einsum forms: f32 rounding of sums
of tens of terms, within 1e-5 of the largest magnitude. The JAX package's
einsum forms against the port's: those of tests/test_torch_port_ops.py
(rtol 1e-5 and atol 1e-6, or 1e-5 for the fused head's sum of k^2 bins);
the gradients within 1e-5 of the largest magnitude."""

import ctypes
import re
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
# (k, C, H, W) of the materialized pooling; H 12 / W 16 put the dyadic rois'
# bin edges on pixel boundaries; C 133 takes two of the backward's
# 128-channel chunks
CASES = [(3, 5, 12, 16), (7, 37, 9, 11), (7, 133, 12, 16)]
O = 4  # the tracker's fused head: its 4 box transforms


def _rois(rng, b, n_random=8):
    """(b, R, 4) fractional ijhw rois: random ones, dyadic ones whose bin
    edges land on pixel boundaries at H 12 / W 16 (k 3 and 7), rois whose
    top-left corner ROIPool's clamp moves, one larger than the frame (one
    bin holds every pixel: the forwards split it into many slots), rois
    past the border or outside the map, zero-size and negative-size rois
    (empty bins)."""
    special = [
        [0.25 + 0.375, 0.125 + 0.09375, 0.75, 0.1875],  # k 3: bins 0.25 high, 1/16 wide
        [0.0 + 0.875, 0.25 + 0.21875, 1.75, 0.4375],  # k 7: the same bins, past the bottom
        [0.1, 0.05, 0.5, 0.4],  # top -0.15, left -0.15: the clamp moves the corner to (0, 0)
        [0.05, 0.6, 0.3, 0.2],  # top -0.1 clamped to 0
        [0.95, 0.05, 0.6, 0.8],  # past the bottom border, the left one clamped
        [1.5, 0.5, 0.2, 0.2],  # below the map: the corner clamped to 1, every bin empty
        [0.5, 0.5, 0.0, 0.3],  # zero height on a pixel boundary at H 12: empty
        [0.4, 0.6, -0.3, 0.2],  # negative height
        [0.3, 0.3, -0.2, -0.4],  # both negative: i1 < i0 and j1 < j0
        [0.5, 0.5, 1.0, 1.0],  # the whole map
        [0.6, 0.4, 3.0, 2.5],  # larger than the frame: the clamp puts the whole map into bin (0, 0)
    ]
    out = []
    for _ in range(b):
        ij = rng.uniform(0.1, 0.9, (n_random, 2))
        hw = rng.uniform(0.05, 0.7, (n_random, 2))
        rois = np.concatenate([np.concatenate([ij, hw], 1), special])
        out.append(rois[rng.permutation(len(rois))])
    return np.stack(out).astype(np.float32)


def _bounds(rois, k, h, w):
    return pooling.psroi_bounds(torch.from_numpy(rois), k, h, w, clamp_corner=True)


def _maps(rng, b, h, w, c, nchw):
    """(b, h, w, c) float32 maps: contiguous, or a view of NCHW storage."""
    if nchw:
        return torch.from_numpy(rng.standard_normal((b, c, h, w), dtype=np.float32)).permute(0, 2, 3, 1)
    return torch.from_numpy(rng.standard_normal((b, h, w, c), dtype=np.float32))


def _close(got, ref):
    scale = ref.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, ref, rtol=0.0, atol=TOL * scale)


def _empty(bounds):
    """(B, R, k, k) bool: the bins with n <= 0."""
    i0, i1, j0, j1 = bounds.unbind(2)
    return (i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0


# ---------------------------------------------------------------- the plain versions against JAX


@pytest.mark.parametrize("case", CASES[:2], ids=str)
def test_roi_pool_cpu_path_matches_jax(case):
    """roi_pool on CPU tensors (the op d2t::roipool_fwd's CPU body, the
    plain einsum form) and its gradient (d2t::roipool_bwd's, the written-out
    adjoint) against JAX's roi_pool and jax.grad, frame by frame, from the
    same numpy inputs; a single frame is the batch's first."""
    k, c, h, w = case
    rng = np.random.default_rng(k * 100 + c)
    rois = _rois(rng, 2)
    fm = rng.standard_normal((2, h, w, c), dtype=np.float32)
    cot = rng.standard_normal((2, rois.shape[1], k, k, c), dtype=np.float32)
    x = torch.from_numpy(fm).requires_grad_()
    out = pooling.roi_pool(x, torch.from_numpy(rois), k)
    (out * torch.from_numpy(cot)).sum().backward()
    for f in range(2):
        def loss(m, f=f):
            return (j_pool.roi_pool(m, rois[f], k) * cot[f]).sum()

        ref = np.asarray(j_pool.roi_pool(fm[f], rois[f], k))
        np.testing.assert_allclose(out[f].detach().numpy(), ref, rtol=1e-5, atol=1e-6)
        _close(x.grad[f], torch.from_numpy(np.array(jax.grad(loss)(fm[f]))))
    single = pooling.roi_pool(torch.from_numpy(fm[0]), torch.from_numpy(rois[0]), k)
    assert torch.equal(single, out[0].detach())


@pytest.mark.parametrize("k", [3, 7])
def test_roi_pool_linear_cpu_path_matches_jax(k):
    """roi_pool_linear on CPU tensors (d2t::roipool_linear_fwd's CPU body)
    and its gradient (d2t::roipool_linear_bwd's) against JAX's
    roi_pool_linear and jax.grad, frame by frame; the fused form is the
    materialized pooling flattened in (C, k, k) order times the projection
    it folds in."""
    h, w, c = 12, 16, 5
    rng = np.random.default_rng(k)
    rois = _rois(rng, 2)
    g = rng.standard_normal((2, h, w, k, k, O), dtype=np.float32)
    cot = rng.standard_normal((2, rois.shape[1], O), dtype=np.float32)
    x = torch.from_numpy(g).requires_grad_()
    out = pooling.roi_pool_linear(x, torch.from_numpy(rois), k)
    (out * torch.from_numpy(cot)).sum().backward()
    for f in range(2):
        def loss(m, f=f):
            return (j_pool.roi_pool_linear(m, rois[f], k) * cot[f]).sum()

        ref = np.asarray(j_pool.roi_pool_linear(g[f], rois[f], k))
        np.testing.assert_allclose(out[f].detach().numpy(), ref, rtol=1e-5, atol=1e-5)
        _close(x.grad[f], torch.from_numpy(np.array(jax.grad(loss)(g[f]))))
    # the fused head is the reordering of the materialized one
    fm = torch.from_numpy(rng.standard_normal((2, h, w, c), dtype=np.float32))
    weight = torch.from_numpy(rng.standard_normal((c * k * k, O), dtype=np.float32))
    pooled = pooling.roi_pool(fm, torch.from_numpy(rois), k).permute(0, 1, 4, 2, 3).reshape(2, rois.shape[1], -1)
    fused = pooling.roi_pool_linear(torch.einsum("bhwc,cijo->bhwijo", fm, weight.reshape(c, k, k, O)),
                                    torch.from_numpy(rois), k)
    _close(fused, pooled @ weight)


@pytest.mark.parametrize("case", CASES[:2], ids=str)
def test_plain_backwards_match_autograd(case):
    """roipool_bwd_ref and roipool_linear_bwd_ref (the backward ops' CPU
    bodies) against autograd through the plain forwards, for contiguous and
    strided cotangents; the backward ops return contiguous tensors."""
    k, c, h, w = case
    rng = np.random.default_rng(c)
    bounds = _bounds(_rois(rng, 2), k, h, w)
    r = bounds.shape[1]
    fm = _maps(rng, 2, h, w, c, True).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, r, c, k, k), dtype=np.float32)).permute(0, 1, 3, 4, 2)
    (want,) = torch.autograd.grad(pooling.roi_pool_plain(fm, bounds), fm, g)
    got = torch.ops.d2t.roipool_bwd(g, bounds, h, w)
    assert got.is_contiguous() and torch.equal(got, pooling.roipool_bwd_ref(g, bounds, h, w))
    _close(got, want)

    gm = torch.from_numpy(rng.standard_normal((2, h, w, k, k, O), dtype=np.float32)).requires_grad_()
    for cot in (torch.from_numpy(rng.standard_normal((2, r, O), dtype=np.float32)),
                torch.from_numpy(rng.standard_normal((2, 1, O), dtype=np.float32)).expand(2, r, O)):
        (want,) = torch.autograd.grad(pooling.roi_pool_linear_plain(gm, bounds), gm, cot)
        got = torch.ops.d2t.roipool_linear_bwd(cot, bounds, h, w)
        assert got.is_contiguous() and torch.equal(got, pooling.roipool_linear_bwd_ref(cot, bounds, h, w))
        _close(got, want)


def test_ops_opcheck_and_fakes():
    """torch.library.opcheck on the four ops with CPU inputs (schema, the
    fakes against the CPU bodies, the forwards' autograd registrations),
    maps and cotangents of other strides too; the fakes on meta tensors."""
    rng = np.random.default_rng(0)
    k, c, h, w = 3, 5, 9, 11
    bounds = _bounds(_rois(rng, 2, 2), k, h, w)
    r = bounds.shape[1]
    for nchw in (False, True):
        fm = _maps(rng, 2, h, w, c, nchw).requires_grad_()
        torch.library.opcheck(torch.ops.d2t.roipool_fwd.default, (fm, bounds))
        g = torch.randn(2, r, c, k, k)
        torch.library.opcheck(torch.ops.d2t.roipool_bwd.default,
                              (g.permute(0, 1, 3, 4, 2) if nchw else g.reshape(2, r, k, k, c), bounds, h, w))
    gm = torch.randn(2, h, w, k, k, O, requires_grad=True)
    torch.library.opcheck(torch.ops.d2t.roipool_linear_fwd.default, (gm, bounds))
    torch.library.opcheck(torch.ops.d2t.roipool_linear_bwd.default, (torch.randn(2, r, O), bounds, h, w))
    torch.library.opcheck(torch.ops.d2t.roipool_linear_bwd.default, (torch.randn(2, 1, O).expand(2, r, O), bounds, h, w))
    mb = bounds.to("meta")
    assert torch.ops.d2t.roipool_fwd(torch.empty(2, h, w, c, device="meta"), mb).shape == (2, r, k, k, c)
    assert torch.ops.d2t.roipool_bwd(torch.empty(2, r, k, k, c, device="meta"), mb, h, w).shape == (2, h, w, c)
    meta = torch.ops.d2t.roipool_linear_fwd(torch.empty(2, h, w, k, k, O, device="meta", dtype=torch.bfloat16), mb)
    assert meta.shape == (2, r, O) and meta.dtype == torch.float32
    assert torch.ops.d2t.roipool_linear_bwd(torch.empty(2, r, O, device="meta"), mb, h, w).shape == (2, h, w, k, k, O)


def test_kernel_wrappers_refuse_cpu_tensors():
    """a CPU tensor never reaches a kernel wrapper: it raises, naming CUDA."""
    bounds = torch.zeros(1, 2, 4, 3, dtype=torch.int32)
    for call in (lambda: pooling.roipool_linear_fwd_cuda(torch.zeros(1, 4, 5, 3, 3, O), bounds),
                 lambda: pooling.roipool_linear_bwd_cuda(torch.zeros(1, 2, O), bounds, 4, 5),
                 lambda: pooling.roipool_fwd_cuda(torch.zeros(1, 4, 5, 6), bounds),
                 lambda: pooling.roipool_bwd_cuda(torch.zeros(1, 2, 3, 3, 6), bounds, 4, 5)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_ctypes_signatures_match_the_source(monkeypatch):
    """the argument types the wrapper declares for each exported function are
    the C signature's in roipool.cu (a wrong count truncates pointers and
    64-bit strides without an error)."""

    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    lib = Lib()
    monkeypatch.setattr(pooling._build, "load", lambda name: lib)
    pooling._roipool_lib()
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
               "long long": ctypes.c_longlong}
    found = re.findall(r"^(?:int|size_t) (d2t_\w+)\(([^)]*)\)", (CSRC / "roipool.cu").read_text(), flags=re.M)
    assert {name for name, _ in found} == {"d2t_roipool_linear_fwd", "d2t_roipool_linear_bwd", "d2t_roipool_fwd",
                                           "d2t_roipool_bwd"}
    for name, params in found:
        want = [c_types[" ".join(p.split()[:-1])] for p in params.replace("\n", " ").split(",")]
        assert getattr(lib, name).argtypes == want, name
        assert getattr(lib, name).restype == ctypes.c_int, name


# ---------------------------------------------------------------- the kernels' source on CPU threads

# roipool.cu's kernels on CPU threads (tests/torch_port_cuda_on_cpu.py), as
# fibers, launched as d2t_roipool_* launch them (the fused backward is
# bin_pool.cuh's, its cotangent's (i, j) strides 0)
_CPU_LAUNCH = r"""
extern "C" void cpu_roipool_linear_fwd(const float* g, const int* bounds, float* out, int b, int r, int o, int k,
                                       int h, int w, long long sb, long long sh, long long sw, long long so) {
  run_blocks(dim3(b * r), kFwdThreads, true,
             [=] { roipool_linear_fwd_kernel(g, bounds, out, r, o, k, h, w, sb, sh, sw, so); });
}
extern "C" void cpu_roipool_linear_bwd(const float* g, long long sdb, long long sdr, long long sdo,
                                       const int* bounds, float* gs, unsigned* masks, float* dg, int b, int r, int o,
                                       int k, int h, int w) {
  unsigned* cols = masks + static_cast<long long>(b) * h * r;
  run_blocks(dim3(b * r), kPrologueThreads, true,
             [=] { psroi_bwd_prologue_kernel(g, sdb, sdr, sdo, 0, 0, bounds, gs, masks, cols, r, o, k, h, w); });
  const int warps = bwd_warps(o, k), px = warps * warp_groups(o);
  run_blocks(dim3((w + px - 1) / px, h, b), warps * kWarp, true,
             [=] { bwd_kernel(k)(gs, masks, cols, dg, r, o, k, h, w); });
}
extern "C" void cpu_roipool_fwd(const float* fm, const int* bounds, float* out, int b, int r, int c, int k, int h,
                                int w, long long sb, long long sh, long long sw, long long sc) {
  run_blocks(dim3(b * r, (c + kWarp - 1) / kWarp), kRoiFwdWarps * kWarp, true,
             [=] { roipool_fwd_kernel(fm, bounds, out, r, c, k, h, w, sb, sh, sw, sc); });
}
extern "C" void cpu_roipool_bwd(const float* g, long long sdb, long long sdr, long long sdi, long long sdj,
                                long long sdc, const int* bounds, int* nb, unsigned* masks, float* dfm, int b, int r,
                                int c, int k, int h, int w) {
  unsigned* cols = masks + static_cast<long long>(b) * h * r;
  run_blocks(dim3(b * r), kPrologueThreads, true,
             [=] { roipool_bwd_prologue_kernel(bounds, nb, masks, cols, r, k, h, w); });
  const int chunks = (c + kWarp * kRoiBwdVec - 1) / (kWarp * kRoiBwdVec);
  run_blocks(dim3((w + kRoiBwdWarps - 1) / kRoiBwdWarps, h, b * chunks), kRoiBwdWarps * kWarp, true,
             [=] { roipool_bwd_kernel(g, sdb, sdr, sdi, sdj, sdc, nb, masks, cols, dfm, r, c, k, h, w, chunks); });
}
"""


@pytest.fixture(scope="module")
def kernels(tmp_path_factory):
    lib = cuda_on_cpu.build("roipool.cu", _CPU_LAUNCH, tmp_path_factory.mktemp("roipool_cpu"))
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.cpu_roipool_linear_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4
    lib.cpu_roipool_linear_bwd.argtypes = [ptr] + [i64] * 3 + [ptr] * 4 + [i32] * 6
    lib.cpu_roipool_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4
    lib.cpu_roipool_bwd.argtypes = [ptr] + [i64] * 5 + [ptr] * 4 + [i32] * 6
    return lib


def _lin_fwd(lib, g, bounds):
    """the fused forward on CPU threads into a NaN-poisoned output."""
    b, h, w, k, _, o = g.shape
    gv = g.reshape(b, h, w, k * k * o)  # a view: the (k, k, O) axes flatten
    out = torch.full((b, bounds.shape[1], o), float("nan"))
    lib.cpu_roipool_linear_fwd(gv.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, bounds.shape[1], o, k, h, w,
                               *gv.stride())
    return out


def _lin_bwd(lib, g, bounds, h, w):
    """the fused backward on CPU threads into poisoned scratches and a
    NaN-poisoned dg."""
    b, r, o = g.shape
    k = bounds.shape[-1]
    scaled = torch.full((b, r, k, k, o), float("nan"))
    masks = torch.full((b * (h + w) * r,), -1, dtype=torch.int32)
    dg = torch.full((b, h, w, k, k, o), float("nan"))
    lib.cpu_roipool_linear_bwd(g.data_ptr(), *g.stride(), bounds.data_ptr(), scaled.data_ptr(), masks.data_ptr(),
                               dg.data_ptr(), b, r, o, k, h, w)
    return dg


def _fwd(lib, fm, bounds):
    """the materialized forward on CPU threads into a NaN-poisoned output."""
    b, h, w, c = fm.shape
    r, k = bounds.shape[1], bounds.shape[3]
    out = torch.full((b, r, k, k, c), float("nan"))
    lib.cpu_roipool_fwd(fm.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, r, c, k, h, w, *fm.stride())
    return out


def _bwd(lib, g, bounds, h, w):
    """the materialized backward (prologue and kernel) on CPU threads into
    poisoned scratches and a NaN-poisoned dfm."""
    b, r, k, _, c = g.shape
    numel = torch.full((b * r * k * k,), -7, dtype=torch.int32)
    masks = torch.full((b * (h + w) * r,), -1, dtype=torch.int32)
    dfm = torch.full((b, h, w, c), float("nan"))
    lib.cpu_roipool_bwd(g.data_ptr(), *g.stride(), bounds.data_ptr(), numel.data_ptr(), masks.data_ptr(),
                        dfm.data_ptr(), b, r, c, k, h, w)
    return dfm


@pytest.mark.parametrize("nchw", [False, True], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_materialized_kernels_match_plain(kernels, case, nchw):
    """the materialized forward on maps in both storages against the plain
    einsum form, empty bins exactly 0, every output written; the backward
    on a contiguous cotangent and on the tracker's (a (C, k, k)-ordered
    gradient viewed as (k, k, C)) against autograd through the plain form,
    every dfm element written, bitwise the same on a repeat."""
    k, c, h, w = case
    rng = np.random.default_rng(h * w + c)
    rois = _rois(rng, 2)
    rois[1, 3] = np.nan  # a NaN roi: its bounds are whatever the geometry makes of it, as in the plain version
    bounds = _bounds(rois, k, h, w)
    fm = _maps(rng, 2, h, w, c, nchw)
    ref = pooling.roi_pool_plain(fm, bounds)
    got = _fwd(kernels, fm, bounds)
    _close(got, ref)
    empty = _empty(bounds)
    assert empty.any() and (got[empty] == 0).all()

    r = bounds.shape[1]
    x = fm.detach().requires_grad_()
    out = pooling.roi_pool_plain(x, bounds)
    for g in (torch.from_numpy(rng.standard_normal((2, r, k, k, c), dtype=np.float32)),
              torch.from_numpy(rng.standard_normal((2, r, c, k, k), dtype=np.float32)).permute(0, 1, 3, 4, 2)):
        (want,) = torch.autograd.grad(out, x, g, retain_graph=True)
        dfm = _bwd(kernels, g, bounds, h, w)
        _close(dfm, want)
        assert torch.equal(dfm, _bwd(kernels, g, bounds, h, w))


@pytest.mark.parametrize("k", [3, 7])
def test_fused_kernels_match_plain(kernels, k):
    """the fused forward on a projected map with padded rows (its own
    strides) against the plain einsum form, a roi whose every bin is empty
    exactly 0; the fused backward on a contiguous and on an expanded
    cotangent (a mean's) against autograd through the plain form, every dg
    element written, bitwise the same on a repeat."""
    h, w = 12, 16
    rng = np.random.default_rng(k + 1)
    rois = _rois(rng, 2)
    bounds = _bounds(rois, k, h, w)
    g = torch.from_numpy(rng.standard_normal((2, h, w + 3, k, k, O), dtype=np.float32))[:, :, :w]
    ref = pooling.roi_pool_linear_plain(g, bounds)
    got = _lin_fwd(kernels, g, bounds)
    _close(got, ref)
    all_empty = _empty(bounds).all(-1).all(-1)
    assert all_empty.any() and (got[all_empty] == 0).all()

    r = bounds.shape[1]
    x = g.detach().requires_grad_()
    out = pooling.roi_pool_linear_plain(x, bounds)
    for cot in (torch.from_numpy(rng.standard_normal((2, r, O), dtype=np.float32)),
                torch.from_numpy(rng.standard_normal((2, 1, 1), dtype=np.float32)).expand(2, r, O)):
        (want,) = torch.autograd.grad(out, x, cot, retain_graph=True)
        dg = _lin_bwd(kernels, cot, bounds, h, w)
        _close(dg, want)
        assert torch.equal(dg, _lin_bwd(kernels, cot, bounds, h, w))


def test_backwards_in_roi_scans(kernels):
    """77 rois a frame: both backwards scan them 32 at a time (3 scans, the
    last one partial) and hold against the plain backwards, bitwise the same
    on a repeat; the forwards too."""
    k, c, h, w = CASES[1]
    rng = np.random.default_rng(5)
    rois = np.concatenate([_rois(rng, 2, n_random=55), _rois(rng, 2, n_random=0)], 1)
    assert rois.shape[1] == 77
    bounds = _bounds(rois, k, h, w)
    fm = _maps(rng, 2, h, w, c, False)
    _close(_fwd(kernels, fm, bounds), pooling.roi_pool_plain(fm, bounds))
    g = torch.from_numpy(rng.standard_normal((2, rois.shape[1], k, k, c), dtype=np.float32))
    got = _bwd(kernels, g, bounds, h, w)
    assert torch.equal(got, _bwd(kernels, g, bounds, h, w))
    _close(got, pooling.roipool_bwd_ref(g, bounds, h, w))
    gm = torch.from_numpy(rng.standard_normal((2, h, w, k, k, O), dtype=np.float32))
    _close(_lin_fwd(kernels, gm, bounds), pooling.roi_pool_linear_plain(gm, bounds))
    cot = torch.from_numpy(rng.standard_normal((2, rois.shape[1], O), dtype=np.float32))
    dg = _lin_bwd(kernels, cot, bounds, h, w)
    assert torch.equal(dg, _lin_bwd(kernels, cot, bounds, h, w))
    _close(dg, pooling.roipool_linear_bwd_ref(cot, bounds, h, w))


def test_kernels_on_arbitrary_bounds(kernels):
    """bounds the geometry never makes (unordered, negative, past the map,
    int32 products that wrap): a bin still holds the pixels 0 <= h < H with
    i0 <= h < i1, and n is the int32 product, as in the plain versions."""
    k, c, h, w = 3, 37, 9, 11
    rng = np.random.default_rng(11)
    bounds = np.stack([rng.integers(-3, h + 4, (2, 12, k)), rng.integers(-3, h + 4, (2, 12, k)),
                       rng.integers(-3, w + 4, (2, 12, k)), rng.integers(-3, w + 4, (2, 12, k))], 2)
    bounds[0, 0] = [[-100000] * k, [100000] * k, [-100000] * k, [100000] * k]  # n wraps (int32)
    bounds[0, 1] = [[0] * k, [h] * k, [-70000] * k, [w] * k]
    bounds[1, 0] = [[-65530] * k, [6] * k, [-65530] * k, [6] * k]  # 2^16 x 2^16 wraps to n = 0
    bounds = torch.from_numpy(bounds.astype(np.int32))
    fm = _maps(rng, 2, h, w, c, True)
    _close(_fwd(kernels, fm, bounds), pooling.roi_pool_plain(fm, bounds))
    g = torch.from_numpy(rng.standard_normal((2, 12, k, k, c), dtype=np.float32))
    _close(_bwd(kernels, g, bounds, h, w), pooling.roipool_bwd_ref(g, bounds, h, w))
    gm = torch.from_numpy(rng.standard_normal((2, h, w, k, k, O), dtype=np.float32))
    _close(_lin_fwd(kernels, gm, bounds), pooling.roi_pool_linear_plain(gm, bounds))
    cot = torch.from_numpy(rng.standard_normal((2, 12, O), dtype=np.float32))
    _close(_lin_bwd(kernels, cot, bounds, h, w), pooling.roipool_linear_bwd_ref(cot, bounds, h, w))
