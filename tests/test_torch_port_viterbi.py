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


def _source_groups(d, max_threads=1024):
    """the kernel's source_groups: the largest power of two G with
    G * d <= max_threads and 4 * G * G <= d."""
    g = 1
    while 2 * g * d <= max_threads and 16 * g * g <= d:
        g *= 2
    return g


def _kernel_replay(seq, init, groups=1):
    """the linker kernel's schedule (ops/csrc/viterbi.cu) in numpy: read-only
    score matrices and a removed-node bitmap (entry (t, s, v) reads -inf when
    node (t, s) or (t + 1, v) is removed, a removed column's DP result is a
    fresh start), each destination's sources split into `groups` contiguous
    chunks scanned in order with strict '>' (the first chunk from source 0's
    candidate, the others from -inf) and combined in chunk order with strict
    '>', step scores and parents kept across extractions and the DP re-run
    only from the first step whose inputs changed, the end node as the
    maximum of the 64-bit key (score bits, finite incoming column, -index),
    per-column finite counts kept with the bitmap. The same f32 adds as the
    plain version, so its result must equal it bitwise."""
    init = init.copy()
    t1, d, _ = seq.shape
    t = t1 + 1
    neg_inf = np.float32(-np.inf)
    removed = np.zeros((t, d), bool)
    step = np.zeros((t1, d), np.float32)
    par = np.zeros((t1, d), np.int64)
    bounds = [g * d // groups for g in range(groups + 1)]
    spans, scores, nodes = [], [], []
    dirty = 0
    for final_ts in range(t1, 0, -1):
        live = np.isfinite(seq[final_ts - 1]) & ~removed[final_ts - 1][:, None]
        cnt = np.where(removed[final_ts], 0, live.sum(0))
        while (cnt > 0).any():
            for s in range(dirty, final_ts):
                prev = init if s == 0 else step[s - 1]
                with np.errstate(invalid="ignore"):
                    cand = prev[:, None] + np.where(removed[s][:, None], neg_inf, seq[s])  # (src, dst)
                for g in range(groups):
                    lo, hi = bounds[g], bounds[g + 1]
                    gb, gs = (cand[0].copy(), np.zeros(d, np.int64)) if lo == 0 else (np.full(d, neg_inf), np.full(d, -1))
                    for i in range(max(lo, 1), hi):
                        take = cand[i] > gb
                        gb, gs = np.where(take, cand[i], gb), np.where(take, i, gs)
                    if g == 0:
                        best, src = gb, gs
                    else:
                        take = gb > best
                        best, src = np.where(take, gb, best), np.where(take, gs, src)
                fresh = removed[s + 1] | ~(best > 0)
                par[s] = np.where(fresh, -1, src)
                step[s] = np.where(fresh, np.float32(0), best)
            e = step[final_ts - 1]
            idx = np.arange(d, dtype=np.uint64)
            key = (e.view(np.uint32).astype(np.uint64) << 32) | ((cnt > 0).astype(np.uint64) << 31) | (0x7FFFFFFF - idx)
            end = int(0x7FFFFFFF - (int(key.max()) & 0x7FFFFFFF))
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
            if start < final_ts and not removed[final_ts - 1, path[final_ts - 1]]:
                cnt -= ~removed[final_ts] & np.isfinite(seq[final_ts - 1, path[final_ts - 1]])
            removed[np.arange(start, final_ts + 1), path[start : final_ts + 1]] = True
            if start == 0:
                init[path[0]] = neg_inf
            cnt[end] = 0
    for node in np.nonzero(np.isfinite(init))[0]:
        spans.append((0, 0))
        scores.append(init[node])
        nodes.append(np.r_[node, np.full(t1, -1)])
    return len(spans), np.array(spans), np.array(scores, np.float32), np.array(nodes)


@pytest.mark.parametrize("case", [(seed, 6, 8) for seed in range(4)] + [(9, 12, 16), (10, 20, 24)], ids=str)
def test_kernel_schedule_matches_plain(case):
    """the replayed kernel schedule on padded random problems, with dyadic
    scores (many exact ties) and exact-0.0 links, against the plain
    version: with the kernel's source groups, with one group (the
    sequential scan), with 3 uneven chunks and with one source per chunk.
    The input matrices stay as they were."""
    seed, T, d = case
    rng = np.random.RandomState(seed)
    dims = rng.randint(d // 2, d + 1, size=T)
    seq = np.full((T - 1, d, d), -np.inf, np.float32)
    for s in range(T - 1):
        seq[s, : dims[s], : dims[s + 1]] = rng.randint(0, 8, (dims[s], dims[s + 1])) / 4.0
    seq[rng.rand(*seq.shape) < 0.2] = -np.inf
    ini = np.full(d, -np.inf, np.float32)
    ini[: dims[0]] = rng.randint(0, 4, dims[0]) / 4.0
    rn, rspans, rscores, rnodes = _device_paths(tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini)))
    before = seq.tobytes()
    for groups in sorted({_source_groups(d), 1, 3, d}):
        n, spans, scores, nodes = _kernel_replay(seq, ini, groups)
        assert n == rn
        np.testing.assert_array_equal(spans, rspans[:n])
        np.testing.assert_array_equal(scores.view(np.int32), rscores[:n].view(np.int32))
        np.testing.assert_array_equal(nodes, rnodes[:n])
    assert seq.tobytes() == before


# The linker kernel's own source, compiled for the CPU: a CUDA block becomes
# block_threads(D) std::threads, __syncthreads a std::barrier, shared memory
# a buffer and static variables, __ldg a plain load, the ring's bulk copy
# (TMA) a memcpy that then completes its transaction barrier's phase (a
# counter), a wait on that barrier a blocking wait for the phase's parity to
# change. It runs the kernel's code, barriers and shared state included, on
# CPU threads (warp-level behaviour aside: the kernel has none). The source's
# launcher is nvcc-only (`#ifdef __CUDACC__`); its size queries
# (d2t_viterbi_fits, d2t_viterbi_bitmap_in_smem, d2t_viterbi_tables_in_smem)
# are built as they are.
_CUDA_ON_CPU = r"""
#include <atomic>
#include <barrier>
#include <bit>
#include <cmath>
#include <cstddef>
#include <cstring>
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
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float x) { return std::bit_cast<unsigned>(x); }
// an mbarrier with one arrival a phase: a bulk copy (TMA) is a memcpy that
// then completes the phase (a counter); a wait blocks until the phase's
// parity changes
inline void mbar_init(unsigned long long* bar) { std::atomic_ref<unsigned long long>(*bar).store(0); }
inline void bulk_copy(float* dst, const float* src, unsigned bytes, unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  std::atomic_ref<unsigned long long> phase(*bar);
  phase.fetch_add(1);
  phase.notify_all();
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  std::atomic_ref<unsigned long long> phase(*bar);
  for (unsigned long long v = phase.load(); (v & 1u) == parity; v = phase.load()) phase.wait(v);
}
#define __global__
#define __device__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define CUDART_INF_F __builtin_inff()
inline unsigned char smem_raw[1 << 20];
"""

_CPU_LAUNCH = r"""
extern "C" int cpu_launch(const float* seq, const float* init, float* S, int* P, unsigned* removed, int* path,
                          int* spans, float* scores, int* nodes, int* n_paths, int T1, int D) {
  const bool ring = staged(seq, T1, D, S == nullptr, removed == nullptr);
  const Kernel kernel = removed == nullptr ? kernel_for<true>(ring, D) : kernel_for<false>(ring, D);
  const int nth = block_threads(D);
  if (!fits(D) || smem_bytes(seq, T1, D, S == nullptr, removed == nullptr) > kMaxSmemBytes) return 1;
  std::barrier<> bar(nth);
  g_bar = &bar;
  blockDim.x = nth;
  std::vector<std::thread> threads;
  for (int i = 0; i < nth; ++i)
    threads.emplace_back([=] {
      threadIdx.x = i;
      kernel(seq, init, S, P, removed, path, spans, scores, nodes, n_paths, T1, D);
    });
  for (auto& t : threads) t.join();
  return 0;
}

extern "C" int cpu_block_threads(int D) { return block_threads(D); }
extern "C" int cpu_staged(int T1, int D, int tables_in_smem, int bitmap_in_smem) {
  return staged(nullptr, T1, D, tables_in_smem, bitmap_in_smem);
}
"""


def _linker_kernel_on_cpu(out, max_threads=None, max_ring_bytes=None, max_smem_bytes=None):
    """ops/csrc/viterbi.cu built for CPU threads into `out`, with the
    kernel's default thread cap or `max_threads`, its default ring budget
    or `max_ring_bytes` (0: the DP reads the matrices directly), and its
    default shared-memory budget or `max_smem_bytes` (small: the removed
    bitmap and the path go to the global scratch at a short clip)."""
    src = (Path(tvd.__file__).parent / "ops" / "csrc" / "viterbi.cu").read_text()
    edits = [
        ("#include <cuda_runtime.h>\n#include <math_constants.h>\n", _CUDA_ON_CPU),
        ("  extern __shared__ __align__(16) unsigned char smem_raw[];\n", ""),
        ("namespace {", ""),
        ("}  // namespace", ""),
    ]
    for old, new in edits:
        assert old in src, f"viterbi.cu changed: update this emulation ({old.strip()!r} not found)"
        src = src.replace(old, new, 1)
    (out / "viterbi_cpu.cpp").write_text(src + _CPU_LAUNCH)
    cmd = ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-o", str(out / "lib.so"), str(out / "viterbi_cpu.cpp")]
    if max_threads is not None:
        cmd.append(f"-DD2T_VITERBI_MAX_THREADS={max_threads}")
    if max_ring_bytes is not None:
        cmd.append(f"-DD2T_VITERBI_MAX_RING_BYTES={max_ring_bytes}")
    if max_smem_bytes is not None:
        cmd.append(f"-DD2T_VITERBI_MAX_SMEM_BYTES={max_smem_bytes}")
    proc = subprocess.run(cmd + ["-lpthread"], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.cpu_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int]
    lib.cpu_block_threads.argtypes = [ctypes.c_int]
    lib.cpu_staged.argtypes = [ctypes.c_int] * 4
    for fn in (lib.d2t_viterbi_fits, lib.d2t_viterbi_bitmap_in_smem, lib.d2t_viterbi_tables_in_smem):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def linker_kernel_on_cpu(tmp_path_factory):
    return _linker_kernel_on_cpu(tmp_path_factory.mktemp("linker_cpu"))


@pytest.fixture(scope="module")
def linker_kernel_direct_reads(tmp_path_factory):
    """the kernel built without the two-matrix ring: its one-slot DP scan
    reads the matrices from L2, as on the card where the ring does not fit
    (D past about 160)."""
    return _linker_kernel_on_cpu(tmp_path_factory.mktemp("linker_cpu_l2"), max_ring_bytes=0)


@pytest.fixture(scope="module")
def linker_kernel_32_threads(tmp_path_factory):
    """the kernel built with at most 32 threads per block, so D > 32 runs
    several slots per thread, as D > 1024 does on the card."""
    return _linker_kernel_on_cpu(tmp_path_factory.mktemp("linker_cpu_32"), max_threads=32)


# the shared-memory budget of the small-budget build: at D 100 (400
# threads) the per-slot state takes 8,000 bytes, so the bitmap and the path
# fit up to 9 frames and a 40-frame clip takes the global scratch
SMALL_SMEM_BYTES = 8192


@pytest.fixture(scope="module")
def linker_kernel_small_smem(tmp_path_factory):
    """the kernel built with an 8 KB shared-memory budget: the global
    bitmap at a short clip, chosen by the kernel's own size rule."""
    return _linker_kernel_on_cpu(tmp_path_factory.mktemp("linker_cpu_smem"), max_smem_bytes=SMALL_SMEM_BYTES)


# (step tables in shared memory, removed bitmap and path in shared memory):
# every layout the launcher takes
LAYOUTS = [(True, True), (False, True), (True, False), (False, False)]


def _run_cpu_kernel(lib, seq, ini, tables_in_smem=True, bitmap_in_smem=True):
    """one cpu_launch on copies of the problem -> (n, spans, scores, nodes).
    tables_in_smem / bitmap_in_smem: False passes a global scratch, None
    asks the kernel's size rule as the wrapper does. The bitmap scratch
    starts poisoned: the kernel zeroes it."""
    t1, dd = seq.shape[0], seq.shape[1]
    if tables_in_smem is None:
        tables_in_smem = bool(lib.d2t_viterbi_tables_in_smem(t1, dd))
    if bitmap_in_smem is None:
        bitmap_in_smem = bool(lib.d2t_viterbi_bitmap_in_smem(t1, dd))
    work = seq.copy()
    tables = [np.zeros((t1, dd), np.float32), np.zeros((t1, dd), np.int32)]
    bitmap = [np.full((t1 + 1, -(-dd // 32)), 0xA5A5A5A5, np.uint32), np.full(t1 + 1, 7, np.int32)]
    spans = np.full((t1 + 1) * dd * 2, 7, np.int32)
    scores = np.full((t1 + 1) * dd, 7, np.float32)
    nodes = np.full((t1 + 1) * dd * (t1 + 1), 7, np.int32)
    n = np.zeros(1, np.int32)
    ptrs = [None, None] if tables_in_smem else [x.ctypes.data for x in tables]
    ptrs += [None, None] if bitmap_in_smem else [x.ctypes.data for x in bitmap]
    rc = lib.cpu_launch(work.ctypes.data, ini.ctypes.data, *ptrs, spans.ctypes.data, scores.ctypes.data,
                        nodes.ctypes.data, n.ctypes.data, t1, dd)
    assert rc == 0
    return int(n[0]), spans.reshape(-1, 2), scores, nodes.reshape(-1, t1 + 1)


def _link_problems(seed, T, d):
    """uniform and dyadic padded problems of T frames and d slots, and the
    exact-0.0 case."""
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
    return problems


# (seed, T, D) at the default cap of 1024 threads: G = 1 source group at D
# 1, 5 and 6, 2 at D 20, 32 and 33, 4 at D 100 (400 threads: G * D short of
# the cap, D % 4 != 0)
@pytest.mark.parametrize(
    "case", [(0, 4, 6), (1, 8, 32), (3, 12, 20), (4, 6, 1), (9, 10, 33), (8, 2, 5), (11, 3, 100)], ids=str
)
def test_linker_kernel_source_on_cpu_threads(linker_kernel_on_cpu, case):
    """ops/csrc/viterbi.cu run on CPU threads (G per slot; at even D the DP
    staged through the two-matrix ring, at odd D read from the matrices),
    with its step tables and its removed bitmap and path each in shared
    memory and in a global scratch, on uniform and dyadic padded problems
    and the exact-0.0 case: the plain version's paths, bitwise."""
    _assert_cpu_kernel_matches_plain(linker_kernel_on_cpu, *case, ring=True)


def _assert_same_as(got, want, rows=None):
    """(n, spans, scores, nodes) of the kernel against `want`'s first n rows
    (every row with rows=slice(None)): equal spans and nodes, bitwise
    scores."""
    n = want[0]
    assert got[0] == n
    rows = slice(n) if rows is None else rows
    np.testing.assert_array_equal(got[1][rows], want[1][rows])
    np.testing.assert_array_equal(got[2][rows].view(np.int32), want[2][rows].view(np.int32))
    np.testing.assert_array_equal(got[3][rows], want[3][rows])


def _assert_cpu_kernel_matches_plain(lib, seed, T, d, ring):
    assert lib.cpu_block_threads(d) == _source_groups(d) * d
    assert all(lib.cpu_staged(T - 1, d, *layout) == (ring and d % 2 == 0) for layout in LAYOUTS)
    for seq, ini in _link_problems(seed, T, d):
        ref = _device_paths(tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini)))
        for layout in LAYOUTS:
            # every row, the unused ones too, against the poisoned buffers
            _assert_same_as(_run_cpu_kernel(lib, seq, ini, *layout), ref, rows=slice(None))


def _nan_inf_problems(seed, T, d):
    """scores drawn from NaN, +inf, -inf, negatives and exact ties."""
    rng = np.random.RandomState(seed)
    vals = np.array([-np.inf, np.inf, np.nan, 0.0, 0.25, 0.5, 1.0, -0.5, 2.0], np.float32)
    for _ in range(4):
        seq = rng.choice(vals, size=(T - 1, d, d), p=[0.2, 0.05, 0.05, 0.1, 0.15, 0.15, 0.15, 0.05, 0.1])
        ini = rng.choice(vals, size=d)
        yield seq.astype(np.float32), ini.astype(np.float32)


@pytest.mark.parametrize("case", [(20, 4, 6), (21, 5, 8), (22, 3, 33)], ids=str)
def test_linker_kernel_takes_nan_and_inf_as_the_masked_scan_does(linker_kernel_on_cpu, case):
    """scores with NaN, +inf, -inf, negatives and exact ties: the kernel
    (ring at D 6 and 8, L2 reads at D 33; tables, bitmap and path in shared
    memory and in a global scratch) gives the replay's paths bitwise, the
    sequential scan of the masked matrices (one source group). Its row-mask
    fold is exact for any input: a removed row's candidates are never
    taken."""
    for seq, ini in _nan_inf_problems(*case):
        replay = _kernel_replay(seq, ini, 1)
        for layout in LAYOUTS:
            _assert_same_as(_run_cpu_kernel(linker_kernel_on_cpu, seq, ini, *layout), replay)


@pytest.mark.parametrize("case", [(0, 4, 6), (9, 10, 33), (12, 4, 40)], ids=str)
def test_linker_kernel_direct_reads(linker_kernel_direct_reads, case):
    """the kernel without its ring (the DP reads the matrices from L2,
    skipping removed rows by the bitmap word in a register), G per slot,
    tables, bitmap and path in shared memory and in a global scratch: the
    plain version's paths, bitwise."""
    _assert_cpu_kernel_matches_plain(linker_kernel_direct_reads, *case, ring=False)


@pytest.mark.parametrize("case", [(0, 4, 6), (5, 8, 33)], ids=str)
def test_linker_kernel_leaves_its_input_unchanged(linker_kernel_on_cpu, case):
    """the kernel reads the score matrices and init scores it is given and
    writes neither: the buffers it was launched on are bitwise unchanged,
    with the step tables, the bitmap and the path in shared memory and in a
    global scratch."""
    for seq, ini in _link_problems(*case):
        t1, d = seq.shape[0], seq.shape[1]
        seq_before, ini_before = seq.tobytes(), ini.tobytes()
        for tables_in_smem, bitmap_in_smem in LAYOUTS:
            tables = [np.zeros((t1, d), np.float32), np.zeros((t1, d), np.int32)]
            bitmap = [np.zeros((t1 + 1, -(-d // 32)), np.uint32), np.zeros(t1 + 1, np.int32)]
            out = [np.zeros((t1 + 1) * d * 2, np.int32), np.zeros((t1 + 1) * d, np.float32),
                   np.zeros((t1 + 1) * d * (t1 + 1), np.int32), np.zeros(1, np.int32)]
            ptrs = [None, None] if tables_in_smem else [x.ctypes.data for x in tables]
            ptrs += [None, None] if bitmap_in_smem else [x.ctypes.data for x in bitmap]
            linker_kernel_on_cpu.cpu_launch(seq.ctypes.data, ini.ctypes.data, *ptrs, *(x.ctypes.data for x in out), t1, d)
            assert int(out[3][0]) > 0
            assert seq.tobytes() == seq_before and ini.tobytes() == ini_before


@pytest.mark.parametrize("seed", [0, 1])
def test_linker_kernel_several_slots_per_thread(linker_kernel_32_threads, seed):
    """the kernel built with 32 threads per block at D = 100 (4 slots for
    some threads, 3 for others, as D > 1024 gives on the card), dyadic
    scores with many exact ties, tables, bitmap and path in shared memory
    and in a global scratch: the plain version's paths bitwise, and the
    native linker's."""
    rng = np.random.RandomState(seed)
    T, d = 8, 100
    dims = rng.randint(d // 2, d + 1, size=T)
    seq = np.full((T - 1, d, d), -np.inf, np.float32)
    for s in range(T - 1):
        seq[s, : dims[s], : dims[s + 1]] = rng.randint(0, 8, (dims[s], dims[s + 1])) / 4.0
    seq[rng.rand(*seq.shape) < 0.3] = -np.inf
    ini = np.full(d, -np.inf, np.float32)
    ini[: dims[0]] = rng.randint(0, 4, dims[0]) / 4.0
    ref = _device_paths(tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini)))
    for layout in LAYOUTS:
        n, spans, scores, nodes = got = _run_cpu_kernel(linker_kernel_32_threads, seq, ini, *layout)
        _assert_same_as(got, ref, rows=slice(None))
    # dyadic scores: every DP sum is exact in f32 and f64, so the native
    # linker's trimmed paths are the kernel's
    native = tv.viterbi_multi_link(list(seq.astype(np.float64)), list(ini.astype(np.float64)), use_native=True)
    trimmed = [((int(a), int(b)), float(sc), nd[a : b + 1].tolist()) for (a, b), sc, nd in zip(spans[:n], scores[:n], nodes[:n])]
    _assert_same_paths(trimmed, native)


# (seed, T, D, problems): one problem a case, the dyadic one at 40 frames
# (one CPU thread per CUDA thread, 400 of them, makes it the slow case)
@pytest.mark.parametrize("case", [(30, 40, 100, slice(1, 2)), (32, 12, 100, slice(0, 1))], ids=str)
def test_linker_kernel_global_bitmap_by_its_size_rule(linker_kernel_small_smem, case):
    """the kernel built with an 8 KB shared-memory budget takes the layout
    its own size rule gives, as the wrapper does: at D 100 the bitmap and
    the path fit up to 9 frames, so 40 and 12 frames put them (and the
    tables) in the global scratch. The plain version's paths bitwise, the
    replay's on NaN / +inf scores, and the input unchanged."""
    lib = linker_kernel_small_smem
    seed, T, d, problems = case
    assert lib.d2t_viterbi_fits(T - 1, d) == 1
    assert lib.d2t_viterbi_bitmap_in_smem(T - 1, d) == 0 and lib.d2t_viterbi_tables_in_smem(T - 1, d) == 0
    assert lib.d2t_viterbi_bitmap_in_smem(8, 100) == 1 and lib.d2t_viterbi_bitmap_in_smem(9, 100) == 0
    for seq, ini in _link_problems(seed, T, d)[problems]:
        before = seq.tobytes()
        ref = _device_paths(tvd.viterbi_multi_link_ref(torch.from_numpy(seq), torch.from_numpy(ini)))
        _assert_same_as(_run_cpu_kernel(lib, seq, ini, None, None), ref, rows=slice(None))
        assert seq.tobytes() == before
    seq, ini = next(_nan_inf_problems(seed, min(T, 12), d))
    _assert_same_as(_run_cpu_kernel(lib, seq, ini, None, None), _kernel_replay(seq, ini, 1))


def test_linker_kernel_size_rule(linker_kernel_on_cpu):
    """the size queries the wrapper asks (d2t_viterbi_fits,
    d2t_viterbi_bitmap_in_smem), built at Hopper's budget: the bitmap fits
    in shared memory up to 1,037 frames at D 1500 and 11,059 at D 128;
    past that the kernel still takes the clip (global bitmap), at any T.
    The one limit is D: the per-slot state (8 bytes a thread, 16 a slot)
    and three staged bitmap rows fit up to 13,632 slots."""
    lib = linker_kernel_on_cpu
    assert tvd._bitmap_in_smem(lib, 1036, 1500) and not tvd._bitmap_in_smem(lib, 1037, 1500)
    assert tvd._bitmap_in_smem(lib, 11058, 128) and not tvd._bitmap_in_smem(lib, 11059, 128)
    for t1, d in ((1100, 1500), (11100, 128), (1600, 1024), (60000, 4), (0, 1)):
        assert lib.d2t_viterbi_fits(t1, d) == 1, (t1, d)
    assert not tvd._tables_in_smem(lib, 1100, 1500)
    for t1 in (0, 3, 100000):
        assert lib.d2t_viterbi_fits(t1, 13632) == 1 and lib.d2t_viterbi_fits(t1, 13633) == 0
    assert lib.d2t_viterbi_fits(-1, 4) == 0 and lib.d2t_viterbi_fits(3, 0) == 0


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
