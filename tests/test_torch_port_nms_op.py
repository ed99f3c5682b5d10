"""the port's registered ops on the CPU: `d2t::nms_mask` against its plain
version, the JAX package's nms_mask and nms_np; the NMS kernel's own source
(ops/csrc/nms.cu) run on CPU threads against the plain version, bitwise
(the keep-mask, and the IoU launch's words at or above the diagonal
against compute_ious > t, the words below it unwritten); and the
correlation ops' fakes against the plain versions' shapes."""

import ctypes
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from detect_to_track_tpu.ops import nms as j_nms
from detect_to_track_tpu_torch.boxes import compute_ious, ijhw_to_ijij
from detect_to_track_tpu_torch.ops import correlation, nms

CSRC = Path(nms.__file__).parent / "csrc"
KS = [1, 63, 64, 65, 72, 1000]


def _boxes(rng, b, k):
    """(b, k, 4) ijhw boxes in clusters (long suppression chains), with
    exact duplicates, zero-size boxes and boxes that touch; (b, k) valid
    with invalid slots mixed in."""
    centers = rng.rand(max(k // 12, 1), 2)
    ij = centers[rng.randint(0, len(centers), (b, k))] + rng.randn(b, k, 2) * 0.03
    hw = rng.rand(b, k, 2) * 0.2 + 0.02
    boxes = np.concatenate([ij, hw], -1).astype(np.float32)
    if k >= 8:
        boxes[:, 3] = boxes[:, 1]  # an exact duplicate
        boxes[:, 5, 2:] = 0.0  # zero size
        boxes[:, 6] = boxes[:, 5]  # two zero-size boxes: union 0, IoU 0
        boxes[:, 7, 0] = boxes[:, 2, 0] + boxes[:, 2, 2]  # touches box 2: IoU 0
        boxes[:, 7, 1:] = boxes[:, 2, 1:]
    return boxes, rng.rand(b, k) > 0.15


def _nms_np_keep(boxes, valid, iou):
    """nms_np over the valid slots (already score-descending) as a mask."""
    idx = np.flatnonzero(valid)
    keep = np.zeros(len(valid), bool)
    if len(idx):
        scores = np.linspace(1.0, 0.0, len(idx), dtype=np.float32)
        keep[idx[nms.nms_np(scores, boxes[idx], iou)]] = True
    return keep


@pytest.mark.parametrize("iou", [0.3, 0.5])
@pytest.mark.parametrize("k", KS)
def test_nms_op_matches_plain_jax_and_numpy(k, iou):
    rng = np.random.RandomState(k)
    boxes, valid = _boxes(rng, 2, k)
    got = torch.ops.d2t.nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), iou)
    assert got.dtype == torch.bool and got.shape == (2, k)
    ref = nms.nms_mask_ref(torch.from_numpy(boxes), torch.from_numpy(valid), iou)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    for f in range(2):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(j_nms.nms_mask(boxes[f], valid[f], iou)))
        np.testing.assert_array_equal(got[f].numpy(), _nms_np_keep(boxes[f], valid[f], iou))
    # one frame alone, without the leading axis
    np.testing.assert_array_equal(nms.nms_mask(torch.from_numpy(boxes[1]), torch.from_numpy(valid[1]), iou).numpy(),
                                  got[1].numpy())


def test_nms_output_never_aliases_valid():
    """disjoint boxes: the fixed point is reached at once and keep equals
    valid, but it is a tensor of its own (an op's output may not alias its
    input)."""
    k = 10
    boxes = torch.tensor([[0.1 * i + 0.05, 0.5, 0.04, 0.04] for i in range(k)], dtype=torch.float32)
    valid = torch.ones(k, dtype=torch.bool)
    valid[3] = False
    for fn in (nms.nms_mask, nms.nms_mask_ref):
        keep = fn(boxes, valid, 0.3)
        assert torch.equal(keep, valid) and keep.data_ptr() != valid.data_ptr()
        keep[0] = False
        assert valid[0]


def test_nms_opcheck():
    rng = np.random.RandomState(3)
    boxes, valid = _boxes(rng, 2, 65)
    args = (torch.from_numpy(boxes), torch.from_numpy(valid), 0.3)
    torch.library.opcheck(torch.ops.d2t.nms_mask.default, args)
    torch.library.opcheck(torch.ops.d2t.nms_mask.default, (args[0][0], args[1][0], 0.5))


def test_nms_kernel_wrapper_takes_only_cuda_tensors():
    launches = nms.nms_mask_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        nms.nms_mask_cuda(torch.zeros(4, 4), torch.ones(4, dtype=torch.bool), 0.3)
    assert nms.nms_mask_cuda.launches == launches


def test_nms_iou_bits_hook_takes_only_cuda_tensors():
    """the IoU launch's test hook raises on CPU boxes and on a scratch of
    the wrong shape; its plain version packs compute_ious > t."""
    with pytest.raises(ValueError, match="CUDA boxes"):
        nms.nms_iou_bits_cuda(torch.zeros(1, 4, 4), 0.3, torch.zeros(1, 4, 1, dtype=torch.int64))
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.5, 0.5, 0.2, 0.2], [0.55, 0.5, 0.2, 0.2], [0.9, 0.9, 0.1, 0.1]]])
    assert nms.nms_iou_bits_ref(boxes, 0.3).tolist() == [[[0b0110], [0b0100], [0], [0]]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("d_max", [1, 2, 8])
def test_correlation_op_fakes_match_plain(d_max, stride, dtype):
    """each op's fake on meta tensors: the shape and dtype of the plain
    forward (k2hw) and of the plain backward maps (the original C, not the
    C the tensor-core kernels pad to a multiple of 8)."""
    b, h, w, c = 2, 6, 9, 5
    rng = np.random.RandomState(d_max)
    fm0, fm1 = (torch.from_numpy(rng.rand(b, h, w, c).astype(np.float32)).to(dtype) for _ in range(2))
    ref = correlation.pointwise_correlation(fm0, fm1, d_max, stride, impl="torch", layout="k2hw")
    g = torch.from_numpy(rng.rand(*ref.shape).astype(np.float32))
    meta0, meta1, meta_g = (x.to("meta") for x in (fm0, fm1, g))
    fake = correlation.corr_fwd(meta0, meta1, d_max, stride)
    assert fake.device.type == "meta" and (fake.shape, fake.dtype) == (ref.shape, ref.dtype)
    for op, plain in ((correlation.corr_bwd_fm0, correlation.corr_bwd_fm0_ref),
                      (correlation.corr_bwd_fm1, correlation.corr_bwd_fm1_ref)):
        want = plain(g, fm1, d_max, stride)
        fake = op(meta_g, meta1, d_max, stride)
        assert (fake.shape, fake.dtype) == (want.shape, want.dtype) == ((b, h, w, c), dtype)


def test_correlation_ops_are_registered():
    for name in ("corr_fwd", "corr_bwd_fm0", "corr_bwd_fm1", "nms_mask"):
        assert hasattr(torch.ops.d2t, name), name
    assert "SymInt d_max" in str(torch.ops.d2t.corr_fwd.default._schema)


# ---------------------------------------------------------------- the kernel's source on CPU threads

# nms.cu's kernels compiled for the CPU: each CUDA block is a set of
# std::threads run one block after another, __syncthreads a std::barrier,
# shared memory a buffer (dynamic) and static variables (`__shared__`), the
# _rn intrinsics plain float operations (built without FMA contraction;
# __fmaf_rn is std::fma), a shared-memory atomicOr a std::atomic_ref
# fetch_or. It runs the kernels' own arithmetic, barriers and shared state
# (warp-level behaviour aside: the kernels have none; the IoU launch's warps
# are its threads grouped by index).
_CUDA_ON_CPU = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>
using std::min;
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline std::barrier<>* g_bar;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline unsigned long long atomicOr(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_or(v);
}
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
inline unsigned long long g_smem[1 << 15];
"""

_CPU_LAUNCH = r"""
template <typename F>
void run_blocks(dim3 grid, int nth, F f) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(nth);
        g_bar = &bar;
        blockDim = dim3(nth);
        std::vector<std::thread> threads;
        for (int t = 0; t < nth; ++t)
          threads.emplace_back([=] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            f();
          });
        for (auto& th : threads) th.join();
      }
}
// the IoU launch as d2t_nms_iou_bits makes it: its grid, threads and path
void cpu_iou(const float* boxes, unsigned long long* mask, int b, int k, float thresh) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  const int tasks = static_cast<int>(iou_tasks(nw));
  const float h = product_half_ulp(thresh);
  run_blocks(iou_grid(b, nw), kIouThreads, [=] {
    if (h > 0.0f)
      nms_mask_kernel<true>(boxes, mask, k, nw, tasks, thresh, h);
    else
      nms_mask_kernel<false>(boxes, mask, k, nw, tasks, thresh, h);
  });
}
extern "C" int cpu_nms_mask(const float* boxes, const uint8_t* valid, unsigned long long* mask, uint8_t* keep,
                            int b, int k, float thresh) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  cpu_iou(boxes, mask, b, k, thresh);
  run_blocks(dim3(b), sweep_threads(nw), [=] { nms_sweep_kernel(mask, valid, keep, k, nw); });
  return 0;
}
extern "C" int cpu_nms_iou_bits(const float* boxes, unsigned long long* mask, int b, int k, float thresh) {
  cpu_iou(boxes, mask, b, k, thresh);
  return 0;
}
extern "C" int cpu_sweep_threads(int nw) { return sweep_threads(nw); }
extern "C" float cpu_product_half_ulp(float t) { return product_half_ulp(t); }
extern "C" long long cpu_iou_blocks(int nw) { return iou_grid(1, nw).x; }
extern "C" int cpu_iou_threads() { return kIouThreads; }
extern "C" long long cpu_task_tile(int task, int nw) {
  int g, w;
  task_tile(task, nw, g, w);
  return static_cast<long long>(g) << 32 | w;
}
"""


def _nms_kernel_on_cpu(out, *defines):
    """ops/csrc/nms.cu built for CPU threads into `out`, with the given
    `-D` defines (its build options) or none."""
    src = (CSRC / "nms.cu").read_text()
    edits = [
        ("#include <cuda_runtime.h>\n", _CUDA_ON_CPU),
        ("  extern __shared__ unsigned long long dead[];\n", "  unsigned long long* dead = g_smem;\n"),
        ("namespace {", ""),
        ("}  // namespace", ""),
    ]
    for old, new in edits:
        assert old in src, f"nms.cu changed: update this emulation ({old.strip()!r} not found)"
        src = src.replace(old, new, 1)
    src = src[: src.index('extern "C" {')] + _CPU_LAUNCH
    (out / "nms_cpu.cpp").write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(out / "lib.so"),
           str(out / "nms_cpu.cpp"), "-lpthread"]
    cmd += [f"-D{d}" for d in defines]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.cpu_nms_mask.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.cpu_nms_iou_bits.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.cpu_sweep_threads.argtypes = [ctypes.c_int]
    lib.cpu_product_half_ulp.argtypes = [ctypes.c_float]
    lib.cpu_product_half_ulp.restype = ctypes.c_float
    lib.cpu_iou_blocks.argtypes = [ctypes.c_int]
    lib.cpu_iou_blocks.restype = ctypes.c_longlong
    lib.cpu_task_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cpu_task_tile.restype = ctypes.c_longlong
    return lib


@pytest.fixture(scope="module")
def nms_kernel_on_cpu(tmp_path_factory):
    return _nms_kernel_on_cpu(tmp_path_factory.mktemp("nms_cpu"))


@pytest.fixture(scope="module")
def nms_kernel_8_threads(tmp_path_factory):
    """the sweep built with at most 8 threads a block: at k 1000 (16 words)
    a thread owns two words, and every thread, thread 0 included, loads
    diagonal words."""
    return _nms_kernel_on_cpu(tmp_path_factory.mktemp("nms_cpu_8"), "D2T_NMS_MAX_THREADS=8")


@pytest.fixture(scope="module")
def nms_kernel_4_rows(tmp_path_factory):
    """the IoU launch built with 4 rows a lane (a warp's task is two 64-row
    blocks, the second one below the diagonal in the diagonal's word) and
    the smallest block, one warp (the default: 2 rows a lane, 4 warps)."""
    return _nms_kernel_on_cpu(tmp_path_factory.mktemp("nms_cpu_4_rows"), "D2T_NMS_IOU_ROWS=4",
                              "D2T_NMS_IOU_WARPS=1")


@pytest.fixture(scope="module", params=["default", "4 rows, 1 warp"])
def iou_build(request, nms_kernel_on_cpu, nms_kernel_4_rows):
    """each build of the IoU launch the tests make."""
    return nms_kernel_on_cpu if request.param == "default" else nms_kernel_4_rows


POISON = 0x5A5A5A5A5A5A5A5A


def _run_on_cpu(lib, boxes, valid, iou):
    """one cpu_nms_mask call on poisoned outputs -> (mask, keep)."""
    b, k = valid.shape
    mask = np.full((b, k, -(-k // 64)), POISON, np.uint64)
    keep = np.full((b, k), 7, np.uint8)
    v8 = valid.astype(np.uint8)
    lib.cpu_nms_mask(boxes.ctypes.data, v8.ctypes.data, mask.ctypes.data, keep.ctypes.data, b, k, iou)
    assert set(np.unique(keep)) <= {0, 1}
    return mask, keep.astype(bool)


def _packed_bits(ious, iou):
    """(..., k, k) IoUs -> the kernel's mask: bit t of word w of row i set
    iff j = 64 w + t > i and IoU > iou."""
    k = ious.shape[-1]
    nw = -(-k // 64)
    padded = np.zeros((*ious.shape[:-1], nw * 64), bool)
    padded[..., :k] = (ious > iou) & np.triu(np.ones((k, k), bool), 1)
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (padded.reshape(*ious.shape[:-1], nw, 64) * weights).sum(-1, dtype=np.uint64)


def _upper_words(k):
    """(k, ceil(k / 64)) bool: the words at or above the diagonal, w >= i // 64
    (the ones the IoU launch writes and the sweep reads)."""
    nw = -(-k // 64)
    return np.arange(nw)[None, :] >= (np.arange(k) // 64)[:, None]


def _assert_iou_words(mask, boxes, iou):
    """the words at or above the diagonal equal the packed compute_ious >
    iou bit for bit (bits j <= i and j >= k clear); the words below it still
    hold the poison: neither written nor needed."""
    tb = torch.from_numpy(boxes)
    upper = _upper_words(boxes.shape[1])
    want = _packed_bits(compute_ious(tb, tb).numpy(), iou)
    np.testing.assert_array_equal(nms.nms_iou_bits_ref(tb, iou).numpy().view(np.uint64), want)
    np.testing.assert_array_equal(mask[:, upper], want[:, upper])
    assert (mask[:, ~upper] == np.uint64(POISON)).all()


@pytest.mark.parametrize("iou", [0.3, 0.5])
@pytest.mark.parametrize("k", KS)
def test_nms_kernel_source_on_cpu_threads(iou_build, k, iou):
    """the kernel's words at or above the diagonal equal compute_ious > iou
    bit for bit, the words below it keep their poison, and its keep-mask
    equals nms_mask_ref's; in each build of the IoU launch."""
    boxes, valid = _boxes(np.random.RandomState(100 + k), 2, k)
    mask, keep = _run_on_cpu(iou_build, boxes, valid, iou)
    _assert_iou_words(mask, boxes, iou)
    np.testing.assert_array_equal(keep, nms.nms_mask_ref(torch.from_numpy(boxes), torch.from_numpy(valid),
                                                         iou).numpy())


@pytest.mark.parametrize("iou", [0.3, 0.5])
def test_nms_sweep_several_words_per_thread(nms_kernel_on_cpu, nms_kernel_8_threads, iou):
    """the sweep with 8 threads a block at k 1000 (thread 0 walks and loads
    words too, the other 7 share 64 word updates and the loads) and at the
    default cap (a walking warp, 4 threads a word for the updates and 128
    loading the next words: 192 threads for one word, 352 for 48): the
    keep-mask bitwise nms_mask_ref's, on clustered boxes with random, all
    and no valid slots (8 threads; the default build runs k 1000 above),
    and on one dense cluster whose kept slots suppress across many words
    (both builds)."""
    assert nms_kernel_8_threads.cpu_sweep_threads(16) == 8
    assert [nms_kernel_on_cpu.cpu_sweep_threads(n) for n in (1, 16, 48, 1000)] == [192, 224, 352, 1024]
    k = 1000
    boxes, valid = _boxes(np.random.RandomState(7), 3, k)
    valid[1], valid[2] = True, False
    rng = np.random.RandomState(8)
    dense = np.concatenate([0.5 + rng.randn(1, k, 2) * 0.05, rng.rand(1, k, 2) * 0.3 + 0.05], -1).astype(np.float32)
    for bx, vd, libs in ((boxes, valid, [nms_kernel_8_threads]),
                         (dense, np.ones((1, k), bool), [nms_kernel_8_threads, nms_kernel_on_cpu])):
        ref = nms.nms_mask_ref(torch.from_numpy(bx), torch.from_numpy(vd), iou).numpy()
        for lib in libs:
            np.testing.assert_array_equal(_run_on_cpu(lib, bx, vd, iou)[1], ref)
    assert not ref.all() and ref[0].sum() > 16  # kept slots in many words, suppressed ones between


def _thresholds_at_ious(boxes, n=3):
    """float32 thresholds v = compute_ious for pairs above the diagonal whose
    exact quotient inter / union lies above v (rounded down to it) and below
    it (rounded up), n of each: at t = v the first kind is the pair a product
    test without the half ulp gets wrong."""
    tb = torch.from_numpy(boxes[0])
    a = ijhw_to_ijij(tb)
    hw = (torch.minimum(a[:, None, 2:], a[None, :, 2:]) - torch.maximum(a[:, None, :2], a[None, :, :2])).clamp(min=0)
    inter = hw[..., 0] * hw[..., 1]
    area = tb[:, 2] * tb[:, 3]
    uni = (area[:, None] + area[None, :]) - inter
    ious = compute_ious(tb, tb).numpy()
    above, below = [], []
    for i, j in zip(*np.nonzero(np.triu(ious > 0, 1))):
        q = Fraction(float(inter[i, j])) / Fraction(float(uni[i, j]))
        side = above if q > Fraction(float(ious[i, j])) else below if q < Fraction(float(ious[i, j])) else None
        if side is not None and len(side) < n:
            side.append(float(ious[i, j]))
    assert len(above) == len(below) == n
    return above + below


def test_nms_kernel_iou_rounding_on_cpu_threads(nms_kernel_on_cpu):
    """thresholds at IoUs the plain version computes (of pairs whose exact
    quotient was rounded down to them and of pairs rounded up), one float32
    step below and one above them: a pair whose IoU the kernel rounded one
    ulp off the plain value, or whose product test missed the division's
    rounding, would flip its bit."""
    boxes, valid = _boxes(np.random.RandomState(5), 1, 200)
    tb = torch.from_numpy(boxes)
    for v in _thresholds_at_ious(boxes):
        for thr in (v, float(np.nextafter(np.float32(v), np.float32(0))),
                    float(np.nextafter(np.float32(v), np.float32(1)))):
            assert nms_kernel_on_cpu.cpu_product_half_ulp(thr) > 0  # the product test decides
            mask, keep = _run_on_cpu(nms_kernel_on_cpu, boxes, valid, thr)
            _assert_iou_words(mask, boxes, thr)
            np.testing.assert_array_equal(keep, nms.nms_mask_ref(tb, torch.from_numpy(valid), thr).numpy())

F32_MAX = float(np.finfo(np.float32).max)
# thresholds: the division's range (negative, 0, 2^-126, inf, NaN) and the
# product test's (2^-125, whose half ulp is the least subnormal, the IoUs,
# 1 and the largest float)
SPECIAL_THRESHOLDS = [-1.0, 0.0, 2.0**-126, 2.0**-125, 0.3, 0.5, 1.0, F32_MAX, float("inf"), float("nan")]


def test_nms_kernel_product_test_range(nms_kernel_on_cpu):
    """the product test takes t in [2^-125, FLT_MAX] with h = half t's ulp,
    the division every other threshold."""
    half_ulp = nms_kernel_on_cpu.cpu_product_half_ulp
    assert half_ulp(0.3) == 2.0**-26 and half_ulp(0.5) == 2.0**-25 and half_ulp(1.0) == 2.0**-24
    assert half_ulp(2.0**-125) == 2.0**-149 and half_ulp(F32_MAX) == 2.0**103
    for t in (-1.0, -0.0, 0.0, 2.0**-126, 1e-40, float("inf"), float("nan")):
        assert half_ulp(t) == 0.0, t


@pytest.mark.parametrize("lib_name", ["nms_kernel_on_cpu", "nms_kernel_4_rows"])
def test_nms_iou_launch_covers_the_triangle(request, lib_name):
    """the IoU launch's grid holds the tasks at or above the diagonal and no
    more (a warp each, spare warps only in a frame's last block), and every
    task decodes to its own tile, up to the largest k the sweep takes."""
    lib = request.getfixturevalue(lib_name)
    rows, warps = (2, 4) if lib_name == "nms_kernel_on_cpu" else (4, 1)
    group = rows // 2  # 64-row blocks of a task
    assert lib.cpu_iou_threads() == 32 * warps
    for nw in list(range(1, 70)) + [1000, 28125]:
        tiles = [(g, w) for g in range(-(-nw // group)) for w in range(g * group, nw)] if nw < 1000 else None
        n = len(tiles) if tiles else sum(nw - g * group for g in range(-(-nw // group)))
        assert lib.cpu_iou_blocks(nw) == -(-n // warps), nw
        if tiles:
            got = [lib.cpu_task_tile(t, nw) for t in range(n)]
            assert [(x >> 32, x & 0xFFFFFFFF) for x in got] == tiles, nw
        else:  # each group's first and last task, and the last group's
            start = 0
            for g in list(range(0, 40)) + list(range(-(-nw // group) - 40, -(-nw // group))):
                start = sum(nw - h * group for h in range(g))
                last = start + nw - g * group - 1
                assert lib.cpu_task_tile(start, nw) == g << 32 | g * group, (nw, g)
                assert lib.cpu_task_tile(last, nw) == g << 32 | (nw - 1), (nw, g)
            assert last == n - 1


def _special_boxes(rng, k):
    """(1, k, 4) ijhw boxes: NaN in each field, +-inf centres and sizes, inf
    - inf corners, subnormal, zero, negative and huge sizes, duplicates and
    nested boxes among clustered ordinary ones, in a random order."""
    box = [0.5, 0.5, 0.2, 0.3]
    nan, inf = float("nan"), float("inf")
    special = []
    for f in range(4):
        for v in (nan, inf, -inf):
            x = list(box)
            x[f] = v
            special.append(x)
    special += [[inf, 0.5, inf, 0.3], [0.5, -inf, 0.2, inf], [inf, inf, inf, inf], [nan] * 4,
                [0.5, 0.5, 1e-40, 1e-40], [0.5, 0.5, 1e-20, 3e-20], [1e-39, 2e-39, 3e-39, 4e-39],
                [1e-40, 1e-40, 1e-40, 1e-40], [0.5, 0.5, 0.0, 0.0], [0.5, 0.5, -0.0, 0.2],
                [0.5, 0.5, -0.2, 0.3], [0.5, 0.5, -0.2, -0.3], [0.55, 0.45, -0.4, 0.3], [0.5, 0.5, 1e30, 1e30],
                [3e38, 3e38, 3e38, 3e38], [-3e38, 0.5, 3e38, 0.3], [0.5, 0.5, 0.1, 0.15], box, box,
                [0.5, 0.5, 0.4, 0.6], [0.5, 0.5, 4.0, 6.0]]
    ordinary, _ = _boxes(rng, 1, k - len(special))
    boxes = np.concatenate([np.asarray(special, np.float32), ordinary[0] * 0.3 + 0.35])
    return boxes[rng.permutation(k)][None]


@pytest.mark.parametrize("iou", SPECIAL_THRESHOLDS, ids=str)
def test_nms_kernel_special_boxes_on_cpu_threads(iou_build, iou):
    """NaN, inf, subnormal, zero, negative and huge boxes at thresholds on
    both sides of the product test's range: the words at or above the
    diagonal bitwise compute_ious > t, the others poisoned, keep bitwise
    nms_mask_ref's (k 130: a diagonal tile in each of three words, the
    last one partial)."""
    rng = np.random.RandomState(11)
    boxes = _special_boxes(rng, 130)
    valid = rng.rand(1, 130) > 0.1
    with np.errstate(invalid="ignore", over="ignore"):
        mask, keep = _run_on_cpu(iou_build, boxes, valid, iou)
    _assert_iou_words(mask, boxes, iou)
    np.testing.assert_array_equal(keep, nms.nms_mask_ref(torch.from_numpy(boxes), torch.from_numpy(valid),
                                                         iou).numpy())


def test_nms_kernel_tiny_unions_on_cpu_threads(iou_build):
    """boxes from 2^-40 down to 2^-76 in size (unions from normal floats down
    to subnormal ones and 0): the product test's e crosses FLT_MIN there, so
    rows take the division for a word or keep the product test, at
    thresholds at computed IoUs and one ulp either side. Bitwise as above."""
    rng = np.random.RandomState(12)
    scales = 2.0 ** -np.repeat(np.arange(40, 77, 3), 10)
    boxes = (rng.rand(len(scales), 4) * [2.0, 2.0, 1.5, 1.5] + [0.0, 0.0, 0.5, 0.5]) * scales[:, None]
    boxes = boxes.astype(np.float32)[rng.permutation(len(scales))][None]
    k = boxes.shape[1]
    valid = np.ones((1, k), bool)
    tb = torch.from_numpy(boxes)
    uni_lo = (boxes[0, :, 2] * boxes[0, :, 3]).astype(np.float32)
    assert (uni_lo < 2.0**-126).sum() > 20 and (uni_lo > 2.0**-100).sum() > 20  # both sides of the band
    for v in [0.3] + _thresholds_at_ious(boxes, n=2):
        for thr in (v, float(np.nextafter(np.float32(v), np.float32(0))),
                    float(np.nextafter(np.float32(v), np.float32(1)))):
            mask, keep = _run_on_cpu(iou_build, boxes, valid, thr)
            _assert_iou_words(mask, boxes, thr)
            np.testing.assert_array_equal(keep, nms.nms_mask_ref(tb, torch.from_numpy(valid), thr).numpy())
