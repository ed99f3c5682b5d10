"""the port's registered ops on the CPU: `d2t::nms_mask` against its plain
version, the JAX package's nms_mask and nms_np; the NMS kernel's own source
(ops/csrc/nms.cu) run on CPU threads against the plain version, bitwise;
and the correlation ops' fakes against the plain versions' shapes."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from detect_to_track_tpu.ops import nms as j_nms
from detect_to_track_tpu_torch.boxes import compute_ious
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
# _rn intrinsics plain float operations (built without FMA contraction), a
# shared-memory atomicOr a std::atomic_ref fetch_or. It runs the kernels' own arithmetic, barriers and shared state
# (warp-level behaviour aside: the kernels have none).
_CUDA_ON_CPU = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
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
inline unsigned long long atomicOr(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_or(v);
}
#define __global__
#define __device__
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
extern "C" int cpu_nms_mask(const float* boxes, const uint8_t* valid, unsigned long long* mask, uint8_t* keep,
                            int b, int k, float thresh) {
  const int nw = (k + kWordBits - 1) / kWordBits;
  run_blocks(dim3(nw, nw, b), kWordBits, [=] { nms_mask_kernel(boxes, mask, k, nw, thresh); });
  run_blocks(dim3(b), sweep_threads(nw), [=] { nms_sweep_kernel(mask, valid, keep, k, nw); });
  return 0;
}
extern "C" int cpu_sweep_threads(int nw) { return sweep_threads(nw); }
"""


def _nms_kernel_on_cpu(out, max_threads=None):
    """ops/csrc/nms.cu built for CPU threads into `out`, with the sweep's
    default thread cap or `max_threads`."""
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
    if max_threads is not None:
        cmd.append(f"-DD2T_NMS_MAX_THREADS={max_threads}")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.cpu_nms_mask.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.cpu_sweep_threads.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def nms_kernel_on_cpu(tmp_path_factory):
    return _nms_kernel_on_cpu(tmp_path_factory.mktemp("nms_cpu"))


@pytest.fixture(scope="module")
def nms_kernel_8_threads(tmp_path_factory):
    """the sweep built with at most 8 threads a block: at k 1000 (16 words)
    a thread owns two words, and every thread, thread 0 included, loads
    diagonal words."""
    return _nms_kernel_on_cpu(tmp_path_factory.mktemp("nms_cpu_8"), max_threads=8)


def _run_on_cpu(lib, boxes, valid, iou):
    """one cpu_nms_mask call on poisoned outputs -> (mask, keep)."""
    b, k = valid.shape
    mask = np.full((b, k, -(-k // 64)), 0x5A5A5A5A5A5A5A5A, np.uint64)
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


@pytest.mark.parametrize("iou", [0.3, 0.5])
@pytest.mark.parametrize("k", KS)
def test_nms_kernel_source_on_cpu_threads(nms_kernel_on_cpu, k, iou):
    """the kernel's IoU bits equal compute_ious > iou above the diagonal
    (0 elsewhere), bit for bit, and its keep-mask equals nms_mask_ref's."""
    boxes, valid = _boxes(np.random.RandomState(100 + k), 2, k)
    tb = torch.from_numpy(boxes)
    mask, keep = _run_on_cpu(nms_kernel_on_cpu, boxes, valid, iou)
    np.testing.assert_array_equal(mask, _packed_bits(compute_ious(tb, tb).numpy(), iou))
    np.testing.assert_array_equal(keep, nms.nms_mask_ref(tb, torch.from_numpy(valid), iou).numpy())


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


def test_nms_kernel_iou_rounding_on_cpu_threads(nms_kernel_on_cpu):
    """thresholds at IoUs the plain version computes, and one float32 step
    below them: a pair whose IoU the kernel rounded one ulp off the plain
    value would flip its bit."""
    boxes, valid = _boxes(np.random.RandomState(5), 1, 200)
    tb = torch.from_numpy(boxes)
    ious = compute_ious(tb, tb).numpy()
    upper = ious[0][np.triu(np.ones((200, 200), bool), 1)]
    for v in np.quantile(upper[upper > 0], [0.1, 0.5, 0.9], method="nearest"):
        for thr in (float(v), float(np.nextafter(v, np.float32(0)))):
            mask, keep = _run_on_cpu(nms_kernel_on_cpu, boxes, valid, thr)
            np.testing.assert_array_equal(mask, _packed_bits(ious, thr))
            np.testing.assert_array_equal(keep, nms.nms_mask_ref(tb, torch.from_numpy(valid), thr).numpy())
