"""the port's tubelet linkers against the JAX package's: the host numpy and
native linkers (viterbi.py, native/), the device linker's plain version
(viterbi_device.viterbi_multi_link_ref) and link scoring, on the same score
matrices. Every comparison of paths is exact; the device linker's f32
scores are compared bitwise."""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from detect_to_track_tpu import viterbi as jv
from detect_to_track_tpu.viterbi_device import clip_link_scores as jax_clip_link_scores
from detect_to_track_tpu.viterbi_device import viterbi_multi_link_scan as jax_multi_link_scan
from detect_to_track_tpu_torch import viterbi as tv
from detect_to_track_tpu_torch import viterbi_device as tvd
from detect_to_track_tpu_torch.native import viterbi_native
from tests.test_viterbi import _random_problem as _host_problem
from tests.test_viterbi_device import _pad_problem
from tests.test_viterbi_device import _random_problem as _f32_problem


def _copies(score_seq, init):
    return [m.copy() for m in score_seq], list(init)


def _assert_same_paths(got, ref):
    """[((start, end), score, path)] lists: equal spans, paths and scores."""
    assert len(got) == len(ref)
    for (ra, sa, pa), (rb, sb, pb) in zip(got, ref):
        assert ra == rb and list(pa) == list(pb)
        assert sa == sb


# --- the host linkers: the port's copy against the JAX package's ----------


@pytest.mark.parametrize("seed", range(8))
def test_viterbi_matches_jax(seed):
    score_seq, init = _host_problem(np.random.RandomState(seed))
    assert tv.viterbi(score_seq, init) == jv.viterbi(score_seq, init)
    prefer = np.random.RandomState(seed + 1).rand(score_seq[-1].shape[1]) > 0.5
    assert tv.viterbi(score_seq, init, prefer) == jv.viterbi(score_seq, init, prefer)


def test_viterbi_fresh_path_mid_sequence_matches_jax():
    score_seq = [np.array([[0.1]]), np.array([[-np.inf]]), np.array([[5.0]])]
    assert tv.viterbi(score_seq, [0.1]) == jv.viterbi(score_seq, [0.1]) == ([0, 0], 5.0)


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_multi_link_matches_jax(seed, use_native):
    score_seq, init = _host_problem(np.random.RandomState(seed + 100), T=6, max_d=5)
    got = tv.viterbi_multi_link(*_copies(score_seq, init), use_native=use_native)
    ref = jv.viterbi_multi_link(*_copies(score_seq, init), use_native=False)
    _assert_same_paths(got, ref)


@pytest.mark.parametrize("seed", range(6))
def test_native_matches_numpy(seed):
    score_seq, init = _host_problem(np.random.RandomState(seed), T=6, max_d=5)
    a = tv.viterbi_multi_link(*_copies(score_seq, init), use_native=False)
    b = tv.viterbi_multi_link(*_copies(score_seq, init), use_native=True)
    _assert_same_paths(b, a)


def _empty_interior_clip():
    conf_seq = [np.array([0.9, 0.8]), np.array([], np.float64), np.array([0.7, 0.6]), np.array([0.5])]
    two = np.array([[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.2, 0.2]])
    bbox_seq = [two, np.zeros((0, 4)), two, two[:1]]
    track_seq = [two, np.zeros((0, 4)), two]
    return conf_seq, bbox_seq, track_seq


def _smooth_clip(T=4):
    base = np.array([[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.2, 0.2]])
    conf_seq = [np.array([0.9, 0.8])] * T
    bbox_seq = [base + t * 0.01 for t in range(T)]
    track_seq = [b + 0.005 for b in bbox_seq[:-1]]
    return conf_seq, bbox_seq, track_seq


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("clip", ["empty_interior", "smooth"])
def test_viterbi_tracking_matches_jax(clip, use_native):
    """the empty interior frame (zero-size matrices mid-sequence) and two
    smooth tracks: the same tubelets, boxes exact."""
    conf_seq, bbox_seq, track_seq = _empty_interior_clip() if clip == "empty_interior" else _smooth_clip()
    for min_len in (1, 2):
        got = tv.viterbi_tracking(conf_seq, bbox_seq, track_seq, 0.5, min_len, use_native=use_native)
        ref = jv.viterbi_tracking(conf_seq, bbox_seq, track_seq, 0.5, min_len, use_native=False)
        assert [s for s, _ in got] == [s for s, _ in ref]
        for (_, a), (_, b) in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    if clip == "smooth":
        assert [s for s, _ in got] == [(0, 3), (0, 3)]


def test_score_seq_matches_jax():
    rng = np.random.RandomState(7)
    dims = [3, 0, 4, 2]
    conf_seq = [rng.rand(n) for n in dims]
    bbox_seq = [np.c_[rng.rand(n, 2), 0.1 + 0.3 * rng.rand(n, 2)] for n in dims]
    track_seq = [b + 0.02 * rng.randn(*b.shape) for b in bbox_seq[:-1]]
    got = tv.compute_score_seq(conf_seq, bbox_seq, track_seq, 0.3)
    ref = jv.compute_score_seq(conf_seq, bbox_seq, track_seq, 0.3)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tv.compute_score_seq(conf_seq, bbox_seq, track_seq[:1], 0.3)


def test_native_build_failure_raises(monkeypatch):
    """use_native=True raises when the native linker cannot be built; it
    never drops to numpy on its own (use_native=False selects numpy)."""
    score_seq, init = _host_problem(np.random.RandomState(3))
    monkeypatch.setattr(viterbi_native, "_LIB", None)
    monkeypatch.setattr(viterbi_native, "GXX_FLAGS", ("--no-such-flag-for-gxx",))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tv.viterbi_multi_link(*_copies(score_seq, init), use_native=True)
    assert tv.viterbi_multi_link(*_copies(score_seq, init), use_native=False)


def test_native_library_built_under_build_dir():
    viterbi_native.load()
    path = viterbi_native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"


# --- the device linker's plain version against the JAX lax.scan linker ----


def _device_paths(out):
    """DevicePaths (torch or JAX) -> numpy (n, spans, scores, nodes)."""
    f = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in out]
    return int(f[3]), f[0], f[1], f[2]


def _assert_same_device_paths(got, ref):
    n, spans, scores, nodes = _device_paths(got)
    rn, rspans, rscores, rnodes = _device_paths(ref)
    assert n == rn
    np.testing.assert_array_equal(spans, rspans)
    np.testing.assert_array_equal(nodes, rnodes)
    assert scores.dtype == rscores.dtype == np.float32
    np.testing.assert_array_equal(scores.view(np.int32), rscores.view(np.int32))


def _padded(seed, T, d, max_d=4):
    score_seq, init, dims = _f32_problem(np.random.RandomState(seed), T=T, max_d=max_d)
    return _pad_problem(score_seq, init, dims, d)


@pytest.mark.parametrize("case", [(seed, 4, 6, 4) for seed in range(50, 58)] + [(1, 7, 9, 9), (2, 9, 12, 12)], ids=str)
def test_multi_link_ref_matches_jax(case):
    seed, T, d, max_d = case
    seq, ini = _padded(seed, T, d, max_d)
    got = tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini))
    _assert_same_device_paths(got, jax_multi_link_scan(seq, ini))
    # viterbi_multi_link_scan runs the plain version for CPU tensors
    _assert_same_device_paths(tvd.viterbi_multi_link_scan(torch.from_numpy(seq), torch.from_numpy(ini)), got)


def test_exact_zero_transition_terminates_and_agrees():
    """an exactly-0.0 link reachable from a 0-score source: every linker
    ends, with the same three paths."""
    score_seq = [np.array([[-np.inf, 0.0], [-np.inf, -np.inf]], np.float64)]
    init = [0.0, 0.0]
    expected = [((1, 1), 0.0, [1]), ((0, 0), 0.0, [0]), ((0, 0), 0.0, [1])]
    for use_native in (False, True):
        assert tv.viterbi_multi_link(*_copies(score_seq, init), use_native=use_native) == expected
    seq, ini = _pad_problem(score_seq, init, [2, 2], 2)
    got = tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini))
    _assert_same_device_paths(got, jax_multi_link_scan(seq, ini))
    n, spans, scores, nodes = _device_paths(got)
    assert [((int(spans[i, 0]), int(spans[i, 1])), float(scores[i]), list(nodes[i, spans[i, 0] : spans[i, 1] + 1]))
            for i in range(n)] == expected


@pytest.mark.parametrize("seed", [0, 3])
def test_multi_link_ref_time_padding_is_noop(seed):
    """trailing all--inf transition matrices change no extracted path."""
    seq, ini = _padded(seed + 130, 5, 6)
    base = tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini))
    padded_seq = np.concatenate([seq, np.full((3,) + seq.shape[1:], -np.inf, np.float32)])
    padded = tvd.viterbi_multi_link_ref(torch.from_numpy(padded_seq), torch.from_numpy(ini))
    n, spans, scores, nodes = _device_paths(base)
    pn, pspans, pscores, pnodes = _device_paths(padded)
    assert pn == n
    np.testing.assert_array_equal(pspans[:n], spans[:n])
    np.testing.assert_array_equal(pscores[:n].view(np.int32), scores[:n].view(np.int32))
    np.testing.assert_array_equal(pnodes[:n, : seq.shape[0] + 1], nodes[:n])


def _kernel_replay(seq, init):
    """the linker kernel's schedule (ops/csrc/viterbi.cu) in numpy: step
    scores and parents kept across extractions and the DP re-run only from
    the first step whose inputs changed, per-column finite counts kept by
    the masks (rows first, then columns). The same f32 adds in the same
    order as the plain version, so its result must equal it bitwise."""
    seq, init = seq.copy(), init.copy()
    t1, d, _ = seq.shape
    t = t1 + 1
    step = np.zeros((t1, d), np.float32)
    par = np.zeros((t1, d), np.int64)
    spans, scores, nodes = [], [], []
    dirty = 0
    for final_ts in range(t1, 0, -1):
        cnt = np.isfinite(seq[final_ts - 1]).sum(0)
        while (cnt > 0).any():
            for s in range(dirty, final_ts):
                prev = init if s == 0 else step[s - 1]
                cand = prev[:, None] + seq[s]
                src = np.argmax(cand, 0)
                best = cand[src, np.arange(d)]
                fresh = ~(best > 0)
                par[s] = np.where(fresh, -1, src)
                step[s] = np.where(fresh, np.float32(0), best)
            e = step[final_ts - 1]
            tied = e == e.max()
            end = int(np.argmax(tied & (cnt > 0))) if (tied & (cnt > 0)).any() else int(np.argmax(tied))
            path = np.full(t, -1)
            path[final_ts] = end
            start = final_ts
            for s in range(final_ts - 1, -1, -1):
                p = par[s, path[s + 1]]
                if p < 0:
                    break
                path[s], start = p, s
            spans.append((start, final_ts))
            scores.append(e[end])
            nodes.append(path)
            dirty = max(start - 1, 0)
            for s in range(start, final_ts):
                if s == final_ts - 1:
                    cnt -= np.isfinite(seq[s, path[s]])
                seq[s, path[s]] = -np.inf
            for s in range(max(start, 1), final_ts + 1):
                seq[s - 1, :, path[s]] = -np.inf
            cnt[path[final_ts]] = 0
            if start == 0:
                init[path[0]] = -np.inf
    for node in np.nonzero(np.isfinite(init))[0]:
        spans.append((0, 0))
        scores.append(init[node])
        nodes.append(np.r_[node, np.full(t1, -1)])
    return len(spans), np.array(spans), np.array(scores, np.float32), np.array(nodes)


@pytest.mark.parametrize("case", [(seed, 6, 8) for seed in range(4)] + [(9, 12, 16), (10, 20, 24)], ids=str)
def test_kernel_schedule_matches_plain(case):
    """the replayed kernel schedule on padded random problems, with dyadic
    scores (many exact ties) and exact-0.0 links, against the plain
    version."""
    seed, T, d = case
    rng = np.random.RandomState(seed)
    dims = rng.randint(d // 2, d + 1, size=T)
    seq = np.full((T - 1, d, d), -np.inf, np.float32)
    for s in range(T - 1):
        seq[s, : dims[s], : dims[s + 1]] = rng.randint(0, 8, (dims[s], dims[s + 1])) / 4.0
    seq[rng.rand(*seq.shape) < 0.2] = -np.inf
    ini = np.full(d, -np.inf, np.float32)
    ini[: dims[0]] = rng.randint(0, 4, dims[0]) / 4.0
    n, spans, scores, nodes = _kernel_replay(seq, ini)
    rn, rspans, rscores, rnodes = _device_paths(tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini)))
    assert n == rn
    np.testing.assert_array_equal(spans, rspans[:n])
    np.testing.assert_array_equal(scores.view(np.int32), rscores[:n].view(np.int32))
    np.testing.assert_array_equal(nodes, rnodes[:n])


# The linker kernel's own source, compiled for the CPU: a CUDA block becomes
# D std::threads, __syncthreads a std::barrier, shared memory a buffer. It
# runs the kernel's code, barriers and shared state included, on CPU
# threads (warp-level behaviour aside: the kernel has none).
_CUDA_ON_CPU = r"""
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
struct dim3 { int x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx;
inline dim3 blockDim;
inline std::barrier<>* g_bar;
inline std::atomic<int> g_or{0};
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  g_bar->arrive_and_wait();
  if (p) g_or = 1;
  g_bar->arrive_and_wait();
  int r = g_or;
  g_bar->arrive_and_wait();
  if (threadIdx.x == 0) g_or = 0;
  g_bar->arrive_and_wait();
  return r;
}
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define CUDART_INF_F __builtin_inff()
inline unsigned char smem_raw[1 << 20];
"""

_CPU_LAUNCH = r"""
extern "C" int cpu_launch(float* seq, const float* init, float* S, int* P, int* spans, float* scores,
                          int* nodes, int* n_paths, int T1, int D) {
  std::barrier<> bar(D);
  g_bar = &bar;
  blockDim.x = D;
  std::vector<std::thread> threads;
  for (int i = 0; i < D; ++i)
    threads.emplace_back([=] {
      threadIdx.x = i;
      viterbi_multi_link_kernel(seq, init, S, P, spans, scores, nodes, n_paths, T1, D);
    });
  for (auto& t : threads) t.join();
  return 0;
}
"""


@pytest.fixture(scope="module")
def linker_kernel_on_cpu(tmp_path_factory):
    src = (Path(tvd.__file__).parent / "ops" / "csrc" / "viterbi.cu").read_text()
    edits = [
        ("#include <cuda_runtime.h>\n#include <math_constants.h>\n", _CUDA_ON_CPU),
        ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n", ""),
        ("__shared__ int s_n, s_dirty, s_start;", "static int s_n, s_dirty, s_start;"),
        ("namespace {", ""),
        ("}  // namespace", ""),
    ]
    for old, new in edits:
        assert old in src, f"viterbi.cu changed: update this emulation ({old.strip()!r} not found)"
        src = src.replace(old, new, 1)
    src = src[: src.index('extern "C" {')] + _CPU_LAUNCH
    out = tmp_path_factory.mktemp("linker_cpu")
    (out / "viterbi_cpu.cpp").write_text(src)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-o", str(out / "lib.so"), str(out / "viterbi_cpu.cpp")]
    proc = subprocess.run(cmd + ["-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.cpu_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int]
    return lib


@pytest.mark.parametrize("case", [(0, 4, 6), (1, 8, 32), (3, 12, 20), (4, 6, 1), (9, 10, 33), (8, 2, 5)], ids=str)
def test_linker_kernel_source_on_cpu_threads(linker_kernel_on_cpu, case):
    """ops/csrc/viterbi.cu run on CPU threads (one per slot), with its step
    tables in shared memory and in a global scratch, on uniform and dyadic
    padded problems and the exact-0.0 case: the plain version's paths, bitwise."""
    seed, T, d = case
    rng = np.random.RandomState(seed)
    problems = []
    for dyadic in (False, True):
        dims = rng.randint(max(d // 2, 1), d + 1, size=T)
        seq = np.full((T - 1, d, d), -np.inf, np.float32)
        for s in range(T - 1):
            shape = (dims[s], dims[s + 1])
            seq[s, : shape[0], : shape[1]] = rng.randint(0, 8, shape) / 4.0 if dyadic else rng.rand(*shape) * 2
        ini = np.full(d, -np.inf, np.float32)
        ini[: dims[0]] = rng.randint(0, 4, dims[0]) / 4.0 if dyadic else rng.rand(dims[0])
        problems.append((seq, ini))
    problems.append((np.array([[[-np.inf, 0.0], [-np.inf, -np.inf]]], np.float32), np.zeros(2, np.float32)))
    for seq, ini in problems:
        ref = _device_paths(tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini)))
        t1, dd = seq.shape[0], seq.shape[1]
        for tables_in_smem in (True, False):
            work = seq.copy()
            tables = [np.zeros((t1, dd), np.float32), np.zeros((t1, dd), np.int32)]
            spans = np.full((t1 + 1) * dd * 2, 7, np.int32)
            scores = np.full((t1 + 1) * dd, 7, np.float32)
            nodes = np.full((t1 + 1) * dd * (t1 + 1), 7, np.int32)
            n = np.zeros(1, np.int32)
            ptrs = [None, None] if tables_in_smem else [x.ctypes.data for x in tables]
            linker_kernel_on_cpu.cpu_launch(work.ctypes.data, ini.ctypes.data, *ptrs, spans.ctypes.data,
                                            scores.ctypes.data, nodes.ctypes.data, n.ctypes.data, t1, dd)
            assert int(n[0]) == ref[0]
            np.testing.assert_array_equal(spans.reshape(-1, 2), ref[1])
            np.testing.assert_array_equal(scores.view(np.int32), ref[2].view(np.int32))
            np.testing.assert_array_equal(nodes.reshape(-1, t1 + 1), ref[3])


def test_linker_kernel_wrapper_takes_only_cuda_tensors():
    seq, ini = _padded(0, 4, 6)
    with pytest.raises(ValueError, match="CUDA"):
        tvd.viterbi_multi_link_cuda(torch.from_numpy(seq), torch.from_numpy(ini))


# --- link scoring ----------------------------------------------------------


def test_clip_link_scores_matches_jax():
    """padded device link scoring: -inf exactly where JAX has it, within
    1e-6 elsewhere; init scores likewise."""
    rng = np.random.RandomState(3)
    T, D = 5, 6
    dims = [3, 2, 6, 1, 4]
    confs = np.zeros((T, D), np.float32)
    boxes = np.zeros((T, D, 4), np.float32)
    tracks = np.zeros((T - 1, D, 4), np.float32)
    valid = np.zeros((T, D), bool)
    base = np.c_[rng.rand(D, 2), 0.1 + 0.2 * rng.rand(D, 2)]  # boxes that move a little per frame
    for t, nt in enumerate(dims):
        confs[t, :nt] = rng.rand(nt)
        boxes[t, :nt] = base[:nt] + 0.01 * rng.randn(nt, 4)
        valid[t, :nt] = True
        if t < T - 1:
            tracks[t, :nt] = boxes[t, :nt] + 0.02 * rng.randn(nt, 4)
    ref_seq, ref_init = (np.asarray(x) for x in jax_clip_link_scores(confs, boxes, tracks, valid, 0.5))
    seq, init = tvd.clip_link_scores(*(torch.from_numpy(x) for x in (confs, boxes, tracks, valid)), 0.5)
    for got, ref in ((seq.numpy(), ref_seq), (init.numpy(), ref_init)):
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=0, atol=1e-6)
    # psi = 1 on some links and 0 on others
    psi = (seq - (torch.from_numpy(confs[:-1])[:, :, None] + torch.from_numpy(confs[1:])[:, None, :])).numpy()
    live = np.isfinite(ref_seq)
    assert (psi[live] > 0.5).any() and (psi[live] < 0.5).any()
